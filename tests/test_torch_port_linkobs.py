"""The port's link observatory against the JAX package's.

``utils/linkobs.py`` is host arithmetic: the same note sequences, on the
same fake clocks, go through both packages and give the same edge
estimates, goodput, rates, divergence, SLO parses and verdicts, reports,
merged snapshots and ``/healthz`` blocks, compared exactly.  Then: the
observatory off is inert, the hygiene entry points, the commit path of the
window store feeding it, and ``link_report`` aggregated across two gloo
processes, with a breached SLO rule dumping the flight recorder.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from bluefog_tpu.utils import config as jconfig
from bluefog_tpu.utils import linkobs as JL
from bluefog_tpu.utils import telemetry as JT
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import linkobs as TL
from bluefog_tpu_torch.utils import telemetry as TT

ROOT = Path(__file__).resolve().parents[1]
KNOBS = ("BLUEFOG_TPU_LINK_OBS", "BLUEFOG_TPU_SLO")


class _Clock:
    """The ``time`` module of a linkobs module, with both clocks driven."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time_ns(self):
        return int(self.t * 1e9)


@pytest.fixture
def both(monkeypatch):
    """Reload both configs from ``set_env(**kv)``; both observatories and
    registries start and end clean, on fake clocks."""
    clocks = {}
    for name, mod in (("jax", JL), ("torch", TL)):
        clk = _Clock()
        monkeypatch.setattr(mod, "time", clk)
        clocks[name] = clk

    def set_env(**kv):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in kv.items():
            monkeypatch.setenv(k, str(v))
        jconfig.reload()
        tconfig.reload()
        return clocks
    for m in (JT, TT, JL, TL):
        m.reset()
    yield set_env
    for m in (JL, TL, JT, TT):
        m.reset()
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    jconfig.reload()
    tconfig.reload()


def _series(T):
    return {k: v for k, v in T.snapshot().items()
            if k.startswith(("bf_link_", "bf_slo_"))}


def _drive(L, T, clk, seq):
    """Feed one note sequence: ``("d", src, dst, us)`` delays, ``("t",
    peer, stripe, bytes)`` tx bytes, ``("r", peer, retries, errors)``
    transport counters, ``("s", step)`` step ticks, ``("w", seconds)``
    clock advances."""
    for ev in seq:
        if ev[0] == "d":
            L.note_delay(ev[1], ev[2], ev[3])
        elif ev[0] == "t":
            L.note_tx(ev[1], ev[2], ev[3])
        elif ev[0] == "r":
            if ev[2]:
                T.inc("bf_win_tx_retries_total", float(ev[2]), peer=ev[1])
            if ev[3]:
                T.inc("bf_win_tx_errors_total", float(ev[3]), peer=ev[1])
        elif ev[0] == "s":
            L.on_step(ev[1])
        elif ev[0] == "w":
            clk.t += ev[1]


SEQS = {
    "one_slow_edge": [("d", 1, 0, 500.0), ("d", 2, 0, 520.0),
                      ("d", 3, 0, 60000.0)] * 30 + [("s", 1)],
    "jitter": [("d", 1, 0, 100.0 + 37.0 * (i % 5)) for i in range(40)]
    + [("d", 0, 1, 250.0), ("s", 2)],
    "goodput_and_rates": [("t", "h:1", 0, 1e6), ("w", 0.3),
                          ("t", "h:1", 0, 2e6), ("w", 0.3),
                          ("t", "h:1", 0, 3e6), ("t", "h:2", 1, 5e5),
                          ("s", 1), ("r", "h:1", 3, 1), ("w", 0.5),
                          ("s", 2), ("w", 0.6), ("t", "h:2", 1, 7e5),
                          ("d", 4, 5, 900.0), ("s", 3)],
}

RULES = "link_delay_us>5000;goodput_bytes<1e9;retry_rate>=1;" \
    "link_divergence>3;bf_link_jitter_us>10"


@pytest.mark.parametrize("rules", [None, RULES])
@pytest.mark.parametrize("seq", sorted(SEQS))
def test_note_sequences_give_equal_reports(both, seq, rules):
    """Reports, series (estimates, goodput, rates, divergence), SLO state
    and the health block are equal in both packages, exactly."""
    clocks = both(**({} if rules is None else {"BLUEFOG_TPU_SLO": rules}))
    _drive(JL, JT, clocks["jax"], SEQS[seq])
    _drive(TL, TT, clocks["torch"], SEQS[seq])
    assert TL.local_report() == JL.local_report()
    assert _series(TT) == _series(JT)
    assert TL.report_from_snapshot(TT.snapshot()) == \
        JL.report_from_snapshot(JT.snapshot())
    assert TL.slo_state() == JL.slo_state()
    assert TL.health_summary() == JL.health_summary()
    assert TL.link_report(aggregate=False) == JL.link_report(aggregate=False)
    if rules is not None and seq == "one_slow_edge":
        assert TL.slo_state()["breached"]


@pytest.mark.parametrize("spec", [
    "link_delay_us>50000", "step_lag>=128;queue_depth<3",
    " link_jitter_us <= 1e3 ; bf_win_tx_queue_depth>4 ", "",
    "error_rate>0.5;retry_rate<2;goodput_bytes>=1.5e6"])
def test_slo_parse_equal(spec):
    t = [(r.raw, r.metric, r.op, r.threshold)
         for r in TL.parse_slo_rules(spec)]
    j = [(r.raw, r.metric, r.op, r.threshold)
         for r in JL.parse_slo_rules(spec)]
    assert t == j


@pytest.mark.parametrize("bad", ["link_delay_us", "nope>1", "x>>1",
                                 "link_delay_us>abc"])
def test_slo_parse_rejects_as_jax(bad, monkeypatch):
    with pytest.raises(ValueError) as te:
        TL.parse_slo_rules(bad)
    with pytest.raises(ValueError) as je:
        JL.parse_slo_rules(bad)
    assert str(te.value) == str(je.value)
    monkeypatch.setenv("BLUEFOG_TPU_SLO", bad)
    try:
        with pytest.raises(ValueError):
            tconfig.reload()
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_SLO")
        tconfig.reload()


def test_merge_and_report_equal(both):
    both()
    snaps = [{'bf_link_delay_us{dst="0",src="1"}': 10.0,
              'bf_link_divergence_ratio{dst="0",src="1"}': 1.0,
              "bf_win_ops_total": 3.0},
             {'bf_link_delay_us{dst="0",src="1"}': 30.0,
              'bf_link_delay_us{dst="1",src="2"}': 7.0,
              'bf_link_goodput_bytes{peer="h:1",stripe="0"}': 5.0}]
    assert TL.merge_link_snapshots(snaps) == JL.merge_link_snapshots(snaps)
    merged = TL.merge_link_snapshots(snaps)
    assert TL.report_from_snapshot(merged) == \
        JL.report_from_snapshot(merged)
    assert TL.report_from_snapshot(merged)["hot_edge"]["delay_us"] == 30.0


def test_off_is_inert(both):
    clocks = both(BLUEFOG_TPU_LINK_OBS="0",
                  BLUEFOG_TPU_SLO="link_delay_us>=1")
    assert not TL.enabled()
    TL.note_commit(1, 0, (1, 7, 0, 1, 3))
    _drive(TL, TT, clocks["torch"], SEQS["one_slow_edge"])
    TL.note_tx("h:1", 0, 1e6)
    assert TT.snapshot() == {}
    assert not TL._edges and not TL._tx
    assert TL.slo_state() == {"rules": [], "breached": {}}
    assert TL.health_summary() is None
    assert "links" not in TT.health()


def test_breach_degrades_health_and_dumps(both, tmp_path, monkeypatch):
    """A breached rule latches, bumps ``bf_slo_breaches_total``, degrades
    ``/healthz`` and dumps the flight recorder; a recovered one clears."""
    from bluefog_tpu_torch.utils import flightrec
    dumps = []
    monkeypatch.setattr(flightrec, "dump_on_error",
                        lambda reason: dumps.append(reason))
    clocks = both(BLUEFOG_TPU_SLO="link_delay_us>5000")
    _drive(TL, TT, clocks["torch"], [("d", 1, 0, 60000.0)] * 3 + [("s", 1)])
    assert TT.snapshot()['bf_slo_breaches_total{rule="link_delay_us>5000"}'] \
        == 1.0
    body = TT.health()
    assert body["status"] == "degraded"
    assert body["links"]["slo"]["breached"] == ["link_delay_us>5000"]
    assert dumps == ["SLO breach: link_delay_us>5000"]
    TL.on_step(2)   # latched: no second count
    assert TT.snapshot()[
        'bf_slo_breaches_total{rule="link_delay_us>5000"}'] == 1.0
    _drive(TL, TT, clocks["torch"], [("d", 1, 0, 10.0)] * 60 + [("s", 3)])
    assert TL.slo_state()["breached"] == {}


def test_clear_hygiene_equal(both):
    clocks = both()
    seq = SEQS["goodput_and_rates"] + SEQS["one_slow_edge"]
    for L, T, c in ((JL, JT, clocks["jax"]), (TL, TT, clocks["torch"])):
        _drive(L, T, c, seq)
        L.clear_edges([3])
    assert _series(TT) == _series(JT)
    for L in (JL, TL):
        L.clear_peer("h:1")
    assert _series(TT) == _series(JT)
    TL.clear_all()
    assert not any(k.startswith(("bf_link_delay_us", "bf_link_goodput"))
                   for k in TT.snapshot())


def test_traced_commit_feeds_the_edge(both, monkeypatch):
    """The window store's commit of a traced message notes its edge's
    delay (the receiver owns the measurement)."""
    import time as _time
    from bluefog_tpu_torch.ops import window as TW
    monkeypatch.setattr(TL, "time", _time)
    both()
    now_us = _time.time_ns() // 1000
    TW._note_contribution("w", 3, (3, 1, 0, now_us - 2000, 5), 1)
    rep = TL.local_report()
    assert [(e["src"], e["dst"]) for e in rep["edges"]] == [(3, 1)]
    assert rep["edges"][0]["delay_ewma_us"] >= 2000.0


def test_bench_links_block(both):
    """The port bench's ``links`` block, as the root ``bench.py``'s."""
    from bluefog_tpu_torch import bench
    clocks = both(BLUEFOG_TPU_SLO="link_delay_us>5000")
    _drive(TL, TT, clocks["torch"], [("d", 1, 0, 60000.0), ("s", 1)])
    block = bench._links_summary()
    assert block["enabled"] and block["slo_breached"] == [
        "link_delay_us>5000"]
    assert block["edges"] == TL.local_report()["edges"]
    both(BLUEFOG_TPU_LINK_OBS="0")
    assert bench._links_summary() == {"enabled": False}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, sys.argv[1])
    import torch
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import telemetry as T
    bf.init_distributed(device="cpu")
    n = bf.size()
    own = bf.owned_ranks()
    x = torch.arange(len(own) * 6, dtype=torch.float32).reshape(
        len(own), 6) + 100 * bf.process_ranks().process
    bf.win_create(x, "lk", zero_init=True)
    for step in range(5):
        W.set_async_step(step)
        bf.win_put(x, "lk")
        bf.win_fence()
        time.sleep(0.25)
    rep = bf.link_report()
    snap = T.snapshot()
    topo = bf.load_topology()
    owner = {r: r // 2 for r in range(n)}
    cross = [(s, d) for s, d in topo.edges() if s != d
             and owner[s] != owner[d]]
    breaches = sum(v for k, v in snap.items()
                   if k.startswith("bf_slo_breaches_total"))
    print("REP", json.dumps({"rep": rep, "breaches": breaches,
                             "cross": cross,
                             "health": T.health().get("links")}),
          flush=True)
    bf.win_free("lk")
    bf.shutdown()
""")


def test_link_report_across_two_gloo_processes(tmp_path):
    """Two processes of two ranks each on a ring, every data message
    traced: the aggregated report lists every cross-process edge with a
    delay from its trace tags, a goodput from the sent bytes, and a rule
    set to breach dumps each process's flight recorder."""
    port = _free_port()
    procs = []
    for p in range(2):
        env = dict(os.environ, BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                   BFTPU_NUM_PROCESSES="2", BFTPU_PROCESS_ID=str(p),
                   BFTPU_LOCAL_DEVICES="2", OMP_NUM_THREADS="2",
                   BFTPU_WIN_HOST="127.0.0.1",
                   BLUEFOG_TPU_TRACE_SAMPLE="1",
                   BLUEFOG_TPU_SLO="link_delay_us>=0",
                   BLUEFOG_TPU_FLIGHT_RECORDER="1",
                   BLUEFOG_TPU_FLIGHT_RECORDER_PATH=str(tmp_path / "fr"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(ROOT)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [pr.communicate(timeout=120) for pr in procs]
    for pr, (out, err) in zip(procs, outs):
        assert pr.returncode == 0, err[-3000:]
    res = [json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("REP"))[4:]) for out, _ in outs]
    assert res[0]["rep"] == res[1]["rep"]
    rep = res[0]["rep"]
    # The topology's edges between the processes' ranks {0,1} and {2,3}.
    cross = {tuple(e) for e in res[0]["cross"]}
    assert cross, res[0]
    got = {(e["src"], e["dst"]) for e in rep["edges"] if "delay_us" in e}
    assert cross <= got, rep
    assert len({g["peer"] for g in rep["goodput"]}) == 2, res
    assert all(g["goodput_bytes_s"] > 0 for g in rep["goodput"])
    for r in res:
        assert r["breaches"] == 1.0
        assert r["health"]["slo"]["breached"] == ["link_delay_us>=0"]
    assert len(list(tmp_path.glob("fr*"))) == 2
