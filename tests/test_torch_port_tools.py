"""The port's host tools (``python -m bluefog_tpu_torch.tools``) against
the JAX package's, byte for byte on the same input files.

- ``trace-merge`` / ``trace-summary``: the timelines the port's
  ``utils/timeline.py`` writes (its Python writer and its native writer
  with the sidecar anchor) and the JAX tool cases of
  ``tests/test_profiler.py`` and ``tests/test_probes.py`` (clock
  alignment, a truncated file, the sidecar anchor, an unmatched begin,
  the percentiles, the CLI, the fused-probe lanes): the merged file's
  bytes, the summary text, what each prints.
- ``trace-gossip``: the flight-recorder dumps the port's
  ``utils/flightrec.py`` writes and the fake-clock dumps of
  ``tests/test_tracing.py`` / ``tests/test_linkobs.py``: the merged file,
  the stats, the delay table, the ``--json`` document.
- ``schedule-dump``: the cases of ``tests/test_synthesis.py`` L467-477
  (the error cases' messages too) and the ``--hier``, ``--sharded``,
  ``--lowering fused`` and placement tables.
- ``bench-trend``: the repo's own ``BENCH_*.json`` and
  ``MULTICHIP_*.json``, and ``tests/test_tuner.py``'s multichip case.
- ``metrics_lint``: on the JAX tree equal to the JAX lint (its AST walk
  held to the original); on the port's tree the one Known difference.
Tolerance: exact throughout.
"""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from bluefog_tpu import tools as J
from bluefog_tpu.tools import metrics_lint as JML
from bluefog_tpu.tools import tracegossip as JG
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu_torch import tools as T
from bluefog_tpu_torch.ops import transport as TT
from bluefog_tpu_torch.tools import metrics_lint as TML
from bluefog_tpu_torch.tools import tracegossip as TG
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import flightrec as TF
from bluefog_tpu_torch.utils import timeline as TL

ROOT = Path(__file__).resolve().parents[1]


def _same_merge(prefix, out, capsys):
    """trace-merge of ``prefix`` by both packages into ``out``: the bytes
    and the standard error must be equal; returns the merged events."""
    J.trace_merge(prefix, out)
    want, want_err = Path(out).read_bytes(), capsys.readouterr().err
    T.trace_merge(prefix, out)
    got, got_err = Path(out).read_bytes(), capsys.readouterr().err
    assert got == want
    assert got_err == want_err
    return json.loads(got)


def _write_rank_file(path, anchor_mono, anchor_unix, spans,
                     truncate=False):
    """A Python-writer timeline with an inline clock anchor
    (``tests/test_profiler.py``'s helper)."""
    events = [{"name": "bf_clock_anchor", "ph": "M", "ts": anchor_mono,
               "pid": 4242, "tid": 0,
               "args": {"monotonic_us": anchor_mono,
                        "unix_us": anchor_unix, "rank": 0}}]
    for name, b, e in spans:
        events.append({"name": name, "cat": "op", "ph": "B", "ts": b,
                       "pid": 4242, "tid": 1})
        events.append({"name": name, "cat": "op", "ph": "E", "ts": e,
                       "pid": 4242, "tid": 1})
    text = "[\n" + ",\n".join(json.dumps(e) for e in events) + "\n]\n"
    if truncate:
        text = text[: text.rfind("},") + 1]
    with open(path, "w") as f:
        f.write(text)


def _aligned(prefix):
    _write_rank_file(prefix + "0.json", 1000, 1_000_000,
                     [("COMMUNICATE", 1000, 2000)])
    _write_rank_file(prefix + "1.json", 500_000, 1_000_500,
                     [("COMMUNICATE", 500_100, 500_400)])
    return {0: 0, 1: 600}


def _truncated(prefix):
    _write_rank_file(prefix + "0.json", 0, 5_000_000, [("ENQUEUE", 10, 20)])
    _write_rank_file(prefix + "1.json", 0, 5_000_000,
                     [("ENQUEUE", 10, 20), ("COMMUNICATE", 30, 40)],
                     truncate=True)
    return None


def _sidecar(prefix):
    _write_rank_file(prefix + "0.json", 1000, 1_000_000,
                     [("COMMUNICATE", 1000, 2000)])
    events = [{"name": "COMMUNICATE", "cat": "op", "ph": p, "ts": t,
               "pid": 7, "tid": 1}
              for p, t in (("B", 500_100), ("E", 500_400))]
    with open(prefix + "1.json", "w") as f:
        json.dump(events, f)
    with open(prefix + "1.json.anchor.json", "w") as f:
        json.dump({"monotonic_us": 500_000, "unix_us": 1_000_500,
                   "rank": 1}, f)
    return {0: 0, 1: 600}


def _unanchored(prefix):
    with open(prefix + "0.json", "w") as f:
        json.dump([{"name": "X", "cat": "op", "ph": "B", "ts": 70,
                    "pid": 1, "tid": 1},
                   {"name": "X", "cat": "op", "ph": "E", "ts": 90,
                    "pid": 1, "tid": 1}], f)
    return {0: 0}


def _percentiles(prefix):
    _write_rank_file(prefix + "0.json", 0, 0,
                     [("COMMUNICATE", i * 1000, i * 1000 + 100 + i)
                      for i in range(10)])
    return None


SCENARIOS = {"aligned": _aligned, "truncated": _truncated,
             "sidecar": _sidecar, "unanchored": _unanchored,
             "percentiles": _percentiles}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_trace_merge_and_summary_equal_jax(tmp_path, capsys, scenario):
    """``test_trace_merge_*`` / ``test_trace_summary_percentiles``: the
    merged bytes, the warnings on standard error and the summary table
    are the JAX tool's."""
    prefix = str(tmp_path / "tl_")
    starts = SCENARIOS[scenario](prefix)
    out = str(tmp_path / "m.json")
    merged = _same_merge(prefix, out, capsys)
    assert T.trace_summary(out) == J.trace_summary(out)
    assert T.phase_durations(merged) == J.phase_durations(merged)
    lanes = {e["pid"] for e in merged if e.get("ph") == "B"}
    assert lanes == set(T.rank_files(prefix))
    if starts is not None:
        assert {e["pid"]: e["ts"] for e in merged
                if e.get("ph") == "B"} == starts
    if scenario == "percentiles":
        durs, unmatched = T.phase_durations(merged)
        assert sorted(durs["COMMUNICATE"]) == [100 + i for i in range(10)]
        assert unmatched == 0


def test_trace_summary_warns_on_unmatched_begin(tmp_path):
    path = str(tmp_path / "x.json")
    with open(path, "w") as f:
        json.dump([{"name": "ENQUEUE", "cat": "op", "ph": "B", "ts": 10,
                    "pid": 0, "tid": 1},
                   {"name": "ENQUEUE", "cat": "op", "ph": "E", "ts": 30,
                    "pid": 0, "tid": 1},
                   {"name": "COMMUNICATE", "cat": "op", "ph": "B",
                    "ts": 40, "pid": 0, "tid": 1}], f)
    table = T.trace_summary(path)
    assert table == J.trace_summary(path)
    assert "WARNING: 1 begin event(s)" in table
    empty = str(tmp_path / "e.json")
    Path(empty).write_text("[]")
    assert T.trace_summary(empty) == J.trace_summary(empty)


@pytest.mark.parametrize("python_writer", [True, False],
                         ids=["python-writer", "native-writer"])
def test_port_timelines_merge_as_jax(tmp_path, capsys, monkeypatch,
                                     python_writer):
    """Timelines the port's ``utils/timeline.py`` writes for two ranks
    (activities, probe spans and a lane name), merged and summarised by
    both packages' tools: equal bytes and text."""
    if not python_writer and shutil.which("g++") is None:
        pytest.skip("no g++: the port's native timeline writer cannot be "
                    "built")
    monkeypatch.setenv("BLUEFOG_TPU_PYTHON_TIMELINE",
                       "1" if python_writer else "0")
    tconfig.reload()
    prefix = str(tmp_path / "port_")
    try:
        for rank in (0, 1):
            assert TL.start_timeline(f"{prefix}{rank}.json")
            for i in range(3):
                TL.timeline_start_activity(f"w{i}", "COMMUNICATE")
                time.sleep(0.001)
                TL.timeline_end_activity(f"w{i}", "COMMUNICATE")
            base = time.monotonic_ns() // 1000
            TL.probe_span("fused-step", base, 900, 999)
            TL.thread_name(999, "fused fused-step")
            TL.stop_timeline()
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_PYTHON_TIMELINE")
        tconfig.reload()
    out = str(tmp_path / "merged.json")
    merged = _same_merge(prefix, out, capsys)
    assert {e["pid"] for e in merged if e.get("ph") in ("B", "E", "X")} \
        == {0, 1}
    summary = T.trace_summary(out)
    assert summary == J.trace_summary(out)
    assert summary.splitlines()[2].split()[:2] == ["COMMUNICATE", "6"]


def test_trace_merge_cli_equals_jax(tmp_path, capsys):
    """``test_trace_merge_cli``: the commands print what the JAX ones
    print; ``chaos`` and ``top`` are refused, naming item 22c."""
    prefix = str(tmp_path / "tl_")
    _write_rank_file(prefix + "0.json", 0, 0, [("ENQUEUE", 1, 2)])
    assert J.main(["trace-merge", prefix]) == 0
    want = capsys.readouterr().out
    assert T.main(["trace-merge", prefix]) == 0
    assert capsys.readouterr().out == want
    assert "1 rank lane(s)" in want
    assert J.main(["trace-summary", prefix + "merged.json"]) == 0
    want = capsys.readouterr().out
    assert T.main(["trace-summary", prefix + "merged.json"]) == 0
    assert capsys.readouterr().out == want and "ENQUEUE" in want
    for cmd in ("chaos", "top"):
        assert T.main([cmd, "--help"]) == 2
        assert "item 22c" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        T.trace_merge(str(tmp_path / "nope_"))


# -- trace-gossip ---------------------------------------------------------

def _write_fake_dump(path, rank, unix_us, mono_us, events):
    arr = np.zeros(len(events), TF.EVENT_DTYPE)
    for i, e in enumerate(events):
        for k, v in e.items():
            arr[i][k] = v
    with open(path, "wb") as f:
        f.write(TF.HEADER.pack(TF.MAGIC, TF.VERSION, rank, 0, unix_us,
                               mono_us, len(arr)))
        f.write(arr.tobytes())


def _fake_gossip(prefix):
    """``tests/test_tracing.py``'s two ranks on different clock origins:
    one tagged put, enqueued on rank 0 and decoded on rank 1 250 us of
    wall time later, a frame-level SENDMSG and a DRAIN beside it."""
    _write_fake_dump(
        f"{prefix}.0.bin", 0, unix_us=10_000_000, mono_us=0,
        events=[dict(t_us=1_000, src=0, dst=1, seq=5, len=64,
                     etype=TF.ENQUEUE, op=TT.OP_PUT, name=b"w"),
                dict(t_us=1_200, src=-1, dst=9, seq=1, len=64,
                     etype=TF.SENDMSG, op=TT.OP_PUT, name=b"h:9")])
    _write_fake_dump(
        f"{prefix}.1.bin", 1, unix_us=10_000_000, mono_us=500_000,
        events=[dict(t_us=501_100, src=0, dst=1, seq=0, len=100,
                     etype=TF.DRAIN, op=TT.OP_BATCH, name=b""),
                dict(t_us=501_250, src=0, dst=1, seq=5, len=64,
                     etype=TF.DECODE, op=TT.OP_PUT | TT.OP_TRACE_FLAG,
                     name=b"w")])


def _port_dumps(prefix, monkeypatch):
    """Dumps the port's flight recorder writes for a 3-rank gang: each
    rank's ENQUEUEs of tagged puts, then the receivers' DECODEs."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port's flight recorder ring cannot be "
                    "built")
    assert TF.enable(256)
    for rank in range(3):
        TF.reset()
        monkeypatch.setenv("BFTPU_PROCESS_ID", str(rank))
        dst = (rank + 1) % 3
        src = (rank - 1) % 3
        for seq in range(1, 6):
            TF.note(TF.ENQUEUE, op=TT.OP_PUT, src=rank, dst=dst, seq=seq,
                    length=64, name="w")
            TF.note(TF.FLUSH, op=TT.OP_PUT, src=rank, dst=dst, length=64)
        for seq in range(1, 6):
            TF.note(TF.DECODE, op=TT.OP_PUT | TT.OP_TRACE_FLAG, src=src,
                    dst=rank, seq=seq, length=64, name="w")
        TF.dump(f"{prefix}.{rank}.bin", reason="test")
    TF.reset()


@pytest.mark.parametrize("source", ["fake-clock", "port-recorder"])
@pytest.mark.parametrize("as_json", [False, True])
def test_trace_gossip_equals_jax(tmp_path, capsys, monkeypatch, source,
                                 as_json):
    """``test_trace_gossip_fake_clock_two_rank_merge``,
    ``test_trace_gossip_json_roundtrip`` and ``_text_mode_unchanged``:
    the merged trace's bytes, the stats, the delay table and what the
    command prints (text, or the one JSON document) are the JAX tool's."""
    prefix = str(tmp_path / "flightrec")
    if source == "fake-clock":
        _fake_gossip(prefix)
    else:
        _port_dumps(prefix, monkeypatch)
    out = str(tmp_path / "gossip.json")
    assert JG.main_trace_gossip(prefix, out, as_json=as_json) == 0
    want, want_out = Path(out).read_bytes(), capsys.readouterr().out
    assert TG.main_trace_gossip(prefix, out, as_json=as_json) == 0
    got, got_out = Path(out).read_bytes(), capsys.readouterr().out
    assert got == want and got_out == want_out
    dumps = TG.load_dumps(prefix)
    delays = TG.edge_delays(dumps)
    jdelays = JG.edge_delays(JG.load_dumps(prefix))
    assert list(delays) == list(jdelays)
    for k in delays:
        np.testing.assert_array_equal(delays[k], jdelays[k])
    assert TG.delay_table(delays) == JG.delay_table(jdelays)
    _, stats = TG.merge_gossip(prefix, out, dumps=dumps)
    if source == "fake-clock":
        np.testing.assert_allclose(delays[(0, 1)], [250.0])
        assert stats["flows_matched"] == stats["tags_sent"] == 1
        merged = json.loads(got)
        s = [e for e in merged if e.get("ph") == "s"]
        f = [e for e in merged if e.get("ph") == "f"]
        assert f[0]["ts"] - s[0]["ts"] == 250
    else:
        assert stats["ranks"] == [0, 1, 2]
        assert stats["flows_matched"] == stats["tags_sent"] == 15
    if as_json:
        doc = json.loads(got_out)
        assert doc["stats"] == stats
    else:
        with pytest.raises(json.JSONDecodeError):
            json.loads(got_out)


def test_trace_gossip_missing_dumps_raise(tmp_path, capsys):
    with pytest.raises(FileNotFoundError):
        TG.load_dumps(str(tmp_path / "nope"))
    prefix = str(tmp_path / "flightrec")
    _fake_gossip(prefix)
    assert T.main(["trace-gossip", prefix, "-o", str(tmp_path / "a.json"),
                   "--json"]) == 0
    got = capsys.readouterr().out
    assert J.main(["trace-gossip", prefix, "-o", str(tmp_path / "a.json"),
                   "--json"]) == 0
    assert capsys.readouterr().out == got


# -- schedule-dump --------------------------------------------------------

def _dump_both(*args, **kw):
    try:
        want = J.schedule_dump(*args, **kw)
    except SystemExit as e:
        want = ("SystemExit", str(e))
    jconfig.reload()
    try:
        got = T.schedule_dump(*args, **kw)
    except SystemExit as e:
        got = ("SystemExit", str(e))
    return got, want


DUMPS = {
    "exp2-8x8": (("exp2", 64, "8x8"), {}),
    "random-regular-4-slices-rounds": (("random-regular", 64, "4x4"),
                                       {"slices": 4, "show_rounds": True}),
    "ring-placement": (("ring", 16, "4x4"), {"optimize_placement": True}),
    "exp2-hier": (("exp2", 32, "4x4"),
                  {"slices": 2, "hier": True, "hier_outer_every": 2,
                   "hier_compression": "bf16"}),
    "exp2-sharded": (("exp2", 16, "4x4"),
                     {"sharded": True, "num_shards": 4,
                      "replicated_frac": 0.25}),
    "star-fused": (("star", 16, "4x4"),
                   {"lowering": "fused", "fusion_buckets": 3,
                    "payload_mb": 8.0}),
    "err-node-count": (("exp2", 63, "8x8"), {}),
    "err-topology": (("nope", 64, "8x8"), {}),
    "err-sketch": (("exp2", 16, "4x4"), {"sketch": "nope"}),
    "err-hier-one-slice": (("exp2", 16, "4x4"), {"hier": True}),
    "err-hier-codec": (("exp2", 32, "4x4"),
                       {"slices": 2, "hier": True,
                        "hier_compression": "zip"}),
    "err-sharded-divide": (("exp2", 16, "4x4"),
                           {"sharded": True, "num_shards": 3}),
}


@pytest.mark.parametrize("case", sorted(DUMPS))
def test_schedule_dump_equals_jax(case):
    """``test_schedule_dump_report`` and its tables: the report text is
    the JAX report's, and an error case exits with the same message."""
    args, kw = DUMPS[case]
    got, want = _dump_both(*args, **kw)
    assert got == want
    if case.startswith("err-"):
        assert got[0] == "SystemExit"
    elif case == "exp2-8x8":
        assert "naive" in got and "konig" in got and "congestion" in got
        assert "synthesized:" in got and "serial_link_time" in got
    elif case.startswith("random-regular"):
        assert "4 slice(s)" in got and "round " in got


def test_schedule_dump_cli_equals_jax(capsys):
    argv = ["schedule-dump", "--topology", "ring", "--n", "16", "--torus",
            "4x4", "--rounds"]
    assert J.main(argv) == 0
    want = capsys.readouterr().out
    assert T.main(argv) == 0
    assert capsys.readouterr().out == want


# -- bench-trend ------------------------------------------------------------

def test_bench_trend_equals_jax_on_the_repo_records(capsys):
    """The repo's own ``BENCH_r*.json`` and ``MULTICHIP_r*.json``."""
    assert list(ROOT.glob("BENCH_r*.json"))
    got = T.bench_trend(str(ROOT))
    assert got == J.bench_trend(str(ROOT))
    assert "MULTICHIP" not in got and "devices" in got
    for argv in (["bench-trend", str(ROOT)],
                 ["bench-trend", str(ROOT), "--pattern", "BENCH_r0[12].json"]):
        assert J.main(argv) == 0
        want = capsys.readouterr().out
        assert T.main(argv) == 0
        assert capsys.readouterr().out == want


def test_bench_trend_multichip_table_equals_jax(tmp_path):
    """``test_bench_trend_multichip_table``, an unreadable record, a round
    without a parsed result and a missing directory."""
    (tmp_path / "MULTICHIP_r01.json").write_text(json.dumps(
        {"round": 1, "rc": 0, "n_devices": 8, "ok": True}))
    (tmp_path / "MULTICHIP_r02.json").write_text(json.dumps(
        {"round": 2, "rc": 0, "skipped": "no second chip"}))
    (tmp_path / "MULTICHIP_r03.json").write_text("{not json")
    lines = T._multichip_trend(str(tmp_path))
    assert lines == J._multichip_trend(str(tmp_path))
    assert "ok" in "\n".join(lines) and "skip" in "\n".join(lines)
    assert T.bench_trend(str(tmp_path)) == J.bench_trend(str(tmp_path))
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(
        {"n": 1, "rc": 0, "parsed": {"metric": "m", "value": 2.0,
                                     "unit": "x", "vs_baseline": 1.5}}))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps(
        {"n": 2, "rc": 1, "parsed": None}))
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(
        {"n": 3, "rc": 0, "parsed": {"metric": "m", "value": 3.0,
                                     "unit": "x"}}))
    assert T.bench_trend(str(tmp_path)) == J.bench_trend(str(tmp_path))
    empty = str(tmp_path / "none")
    assert T.bench_trend(empty) == J.bench_trend(empty)


# -- metrics_lint -------------------------------------------------------------

def test_metrics_lint_on_the_jax_tree_equals_the_jax_lint(capsys):
    """The port's lint over ``bluefog_tpu/``: the same registration sites
    (its AST walk), inventory, problems and output as the JAX lint."""
    root = str(ROOT)
    assert TML.registered_metrics(root, "bluefog_tpu") == \
        JML.registered_metrics(root)
    doc = str(ROOT / "docs" / "observability.md")
    assert TML.documented_metrics(doc) == JML.documented_metrics(doc)
    assert TML.inventory_rows(doc) == JML.inventory_rows(doc)
    assert TML.run_lint(root, "bluefog_tpu") == JML.run_lint(root)
    assert JML.main(["--root", root]) == 0
    want = capsys.readouterr()
    assert TML.main(["--root", root, "--package", "bluefog_tpu"]) == 0
    assert capsys.readouterr() == want


def test_metrics_lint_on_the_port_tree_is_the_known_difference(capsys):
    """On the port's own tree every registered metric is documented, and
    one inventory row has no registration: ``bf_throttle_waits_total``,
    the JAX package's dispatch throttle, which the port has no use for
    (torch queues work on a stream; there is no XLA dispatch to bound).
    A Known difference, pinned here."""
    root = str(ROOT)
    problems, n_reg, n_rows = TML.run_lint(root)
    assert len(problems) == 1
    assert problems[0].startswith(
        "STALE inventory row 'bf_throttle_waits_total'")
    reg = TML.registered_metrics(root)
    assert set(reg) <= TML.documented_metrics(str(ROOT / "docs" /
                                                  "observability.md"))
    assert n_rows == JML.run_lint(root)[2] and n_reg == n_rows - 1
    assert TML.main(["--root", root]) == 1
    assert "bf_throttle_waits_total" in capsys.readouterr().err
