"""``python -m bluefog_tpu_torch.tools chaos`` against the JAX package's
``tools chaos``.

- The two parsers have the same flags and defaults (the port adds
  ``--device``).
- ``_parse_results``, ``_median_ms`` and ``_robust_window_ms`` agree with
  the JAX ones on hypothesis-drawn inputs.
- Each scenario's verdict (the kill, delay, links, tune and join legs)
  agrees with the JAX driver's on the same recorded gang output, a run
  that passes and one that fails: both drivers run with the launches
  replaced by the recorded output; the exit code, the failures and the
  per-rank lines are equal.
- One short kill-scenario gang on the CPU (4 processes under the port's
  bfrun, gloo, 80 ms heartbeats and 500 ms of suspicion).  The other
  scenarios' gangs are slow-marked, as the JAX package's wrappers are
  (``tests/test_churn.py`` L663, ``tests/test_gang.py`` L513-530).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bluefog_tpu.tools import chaos as JC
from bluefog_tpu_torch.ops.gang import GangDirectory
from bluefog_tpu_torch.tools import chaos as TC
from bluefog_tpu_torch.utils import flightrec as TF

ROOT = Path(__file__).resolve().parents[1]


class _Captured(Exception):
    pass


def _jax_parser(monkeypatch):
    """The JAX harness's parser, caught at its ``parse_args``."""
    def catch(self, *a, **kw):
        raise _Captured(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    try:
        JC.main([])
    except _Captured as e:
        return e.args[0]
    raise AssertionError("the JAX chaos main built no parser")


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None, a.const,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parsers_have_the_same_flags_and_defaults(monkeypatch):
    port = _flags(TC.build_parser())
    device = port.pop("device")
    assert device == (("--device",), "cuda", None, ("cuda", "cpu"), None,
                      "_StoreAction")
    assert port == _flags(_jax_parser(monkeypatch))


_record = st.fixed_dictionaries({
    "rank": st.integers(0, 7),
    "x": st.floats(allow_nan=False, allow_infinity=False),
    "tags": st.lists(st.text(max_size=4), max_size=3)})


@settings(max_examples=60, deadline=None, database=None)
@given(recs=st.lists(_record, max_size=6),
       glue=st.lists(st.sampled_from(["\n", "", "noise ", "\nx"]),
                     min_size=7, max_size=7),
       torn=st.booleans())
def test_parse_results_equals_jax(recs, glue, torn):
    """Records interleaved as bfrun multiplexes them: several on one line,
    trailing bytes of another stream, and a record torn by a death."""
    text = ""
    for i, r in enumerate(recs):
        text += glue[i] + "CHAOS_RESULT " + json.dumps(r)
    if torn:
        text += "\nCHAOS_RESULT {\"rank\": 9, \"x\""
    text += glue[-1]
    assert TC._parse_results(text) == JC._parse_results(text)


_samples = st.lists(st.floats(0.0, 10.0, allow_nan=False), max_size=40)


@settings(max_examples=100, deadline=None, database=None)
@given(samples=_samples, parts=st.integers(1, 6))
def test_median_and_robust_window_equal_jax(samples, parts):
    assert TC._median_ms(samples) == JC._median_ms(samples)
    assert TC._robust_window_ms(samples, parts) == \
        JC._robust_window_ms(samples, parts)


# ---------------------------------------------------------------------------
# Verdicts on recorded gang output
# ---------------------------------------------------------------------------

def _out(recs, extra=""):
    return extra + "".join("CHAOS_RESULT " + json.dumps(r) + "\n"
                           for r in recs)


def _kill_recs(bad):
    recs = [{"rank": r, "proc": r, "epoch": 1, "active_ranks": [0, 1, 2],
             "changes_total": 1, "evicted": False, "steps": 300,
             "recovery_step": 141 + r, "x_mean": 0.95 + 0.05 * r,
             "put_errors": 21 * (r > 0), "pre_median_ms": 1.9,
             "post_median_ms": 2.0, "seg_ms": [2.0] * 6,
             "recovery_observed": True,
             "healthz_membership": {"epoch": 1, "active_ranks": [0, 1, 2]}}
            for r in range(3)]
    if bad:
        recs[1]["x_mean"] = 1.4
        recs[2].update(recovery_step=None, active_ranks=[0, 1, 2, 3])
        recs[0]["post_median_ms"] = 40.0
    return [_out(recs)]


def _delay_recs(bad):
    def leg(mode):
        recs = []
        for r in range(4):
            pre, fault = ((4.5, 64.0) if mode == "sync" else
                          (1.8, 62.9 if r == 3 else 1.9))
            recs.append({"rank": r, "proc": r, "mode": mode, "epoch": 0,
                         "changes_total": 0, "active_ranks": [0, 1, 2, 3],
                         "evicted": False, "steps": 160,
                         "z_mean": 1.45 + 0.03 * r,
                         "pre_median_ms": pre, "fault_median_ms": fault,
                         "stale_counters": (
                             {"bf_win_stale_rejected_total": 3.0}
                             if mode == "async" and r == 0 else {}),
                         "async_step_lag": 0.0 if mode == "async" else None})
        if bad and mode == "async":
            recs[1]["fault_median_ms"] = 20.0
            recs[2].update(epoch=1, changes_total=1)
            recs[0]["stale_counters"] = {}
        return _out(recs)
    return [leg("sync"), leg("async")]


def _links_recs(bad):
    rule = "link_delay_us>=20000"
    edges = [{"src": 0, "dst": 1, "delay_us": 2747.8, "jitter_us": 90.0,
              "divergence_ratio": 1.1},
             {"src": 2, "dst": 0, "delay_us": 2419.1, "jitter_us": 80.0,
              "divergence_ratio": 1.2},
             {"src": 3, "dst": 0, "delay_us": 64847.0, "jitter_us": 900.0,
              "divergence_ratio": 41.3}]
    recs = []
    for r in range(4):
        rec = r == 0
        recs.append({
            "rank": r, "proc": r, "mode": "links", "steps": 80,
            "evicted": False, "changes_total": 0,
            "hot_edge": {"src": 3, "dst": 0, "delay_us": 64847.0},
            "max_divergence": 41.3, "edges": edges,
            "slo_mid": {"rules": [rule],
                        "breached": {rule: 64847.0} if rec else {}},
            "hz_mid": {"status": "degraded" if rec else "ok",
                       "links": {"slo": {"rules": [rule],
                                         "breached": [rule] if rec else []}}},
            "slo_breach_counts": ({f'bf_slo_breaches_total{{rule="{rule}"}}':
                                   1.0} if rec else {}),
            "dump_exists": rec, "top_ok": True if r == 0 else None,
            "top_frame_lines": 22 if r == 0 else 0})
    if bad:
        recs[1]["dump_exists"] = True
        recs[0]["top_ok"] = False
        recs[2]["max_divergence"] = 1.5
    return [_out(recs)]


def _tune_recs(bad):
    def leg(tuned):
        recs = []
        for r in range(4):
            outs = [(r + 1) % 4] if tuned else [q for q in range(4) if q != r]
            sig = {"outs": outs, "self_weight": 0.5,
                   "dst_weights": {str(o): 0.5 for o in outs}}
            full = {"outs": [q for q in range(4) if q != r],
                    "self_weight": 0.25,
                    "dst_weights": {str(q): 0.25 for q in range(4)
                                    if q != r}}
            recs.append({
                "rank": r, "proc": r, "mode": "tune", "tuned": tuned,
                "steps": 70, "evicted": False, "changes_total": 0,
                "pre_ms": 3.4, "fault_ms": 186.0 if r == 3 else 4.0,
                "fault_early_ms": 186.0 if r == 3 else 4.0,
                "fault_late_ms": (67.0 if r == 3 else 7.0) if tuned else 0.0,
                "n_fault_late": 40 if tuned else 0,
                "epoch": 1 if tuned else 0, "reverts": 0,
                "last_knob": "topology=ring-1" if tuned else None,
                "topology_tag": "ring-1" if tuned else None, "knobs": None,
                "hz_mid": {"status": "ok",
                           "tuner": {"epoch": 1} if tuned else None},
                "tune_series": ["bf_tune_epoch"] if tuned else [],
                "sig_start": full, "sig_end": sig if tuned else full,
                "top_ok": True if r == 0 else None,
                "top_has_epoch": True if r == 0 else None,
                "top_frame_lines": 18 if r == 0 else 0})
        if bad and tuned:
            recs[2]["epoch"] = 2
        if bad and not tuned:
            recs[1]["tune_series"] = ["bf_tune_epoch"]
        return _out(recs)
    return [leg(True), leg(False)]


def _join_recs(bad):
    members = [{"role": "member", "rank": r, "proc": r, "epoch": 2,
                "active_ranks": [0, 1, 2, 3], "changes_total": 2,
                "x_mean": 1.45 + 0.04 * r, "gang": None, "evicted": False,
                "steps": 3500, "recovery_step": 90, "epochs": [1, 2],
                "put_errors": 0, "pre_median_ms": 1.0,
                "post_median_ms": 1.1} for r in (0, 1, 3)]
    joiner = {"role": "joiner", "rank": 2, "proc": 4, "epoch": 2,
              "active_ranks": [0, 1, 2, 3], "changes_total": 1,
              "x_mean": 1.37, "gang": None, "admitted": True,
              "admitted_after_sec": 0.203, "grant_epoch": 1,
              "granted_ranks": [2], "evicted": False, "steps": 2694,
              "epochs": [2], "put_errors": 0}
    if bad:
        joiner["granted_ranks"] = [1]
        members[2].update(epoch=3, changes_total=3)
    return [_out(members), _out([joiner])]


_SCENARIOS = {
    "kill": (["--smoke"], _kill_recs),
    "delay": (["--delay-smoke"], _delay_recs),
    "links": (["--links-smoke"], _links_recs),
    "tune": (["--tune-smoke"], _tune_recs),
    "join": (["--join-smoke"], _join_recs),
}


def _write_dump(path, rank):
    arr = np.zeros(2, TF.EVENT_DTYPE)
    for i, (etype, t) in enumerate(((TF.ENQUEUE, 1_000), (TF.DECODE,
                                                           2_000))):
        arr[i]["t_us"], arr[i]["etype"] = t, etype
        arr[i]["src"], arr[i]["dst"], arr[i]["seq"] = rank, rank, 1 + i
    with open(path, "wb") as f:
        f.write(TF.HEADER.pack(TF.MAGIC, TF.VERSION, rank, 0, 10_000_000,
                               0, len(arr)))
        f.write(arr.tobytes())


class _Replay:
    """The launches of a chaos driver, replaced by recorded output: each
    bfrun launch (``subprocess.run`` or ``Popen``) returns the next
    recorded stdout; a kill-scenario launch leaves the survivors'
    flight-recorder dumps (all three, or two in a failing run)."""

    def __init__(self, outs, dumps, tmp):
        self.outs, self.dumps, self.tmp = list(outs), dumps, tmp
        self.dirs = 0

    def _next(self, cmd, env):
        if "--worker" not in cmd:
            raise AssertionError(f"unexpected launch {cmd}")
        rec = (env or {}).get("BLUEFOG_TPU_FLIGHT_RECORDER_PATH")
        if rec and "--mode" not in cmd:
            for r in self.dumps:
                _write_dump(f"{rec}.{r}.bin", r)
        return self.outs.pop(0)

    def run(self, cmd, env=None, **kw):
        return subprocess.CompletedProcess(cmd, 0, self._next(cmd, env), "")

    def popen(self, cmd, env=None, stdout=None, stderr=None, **kw):
        stdout.write(self._next(cmd, env))
        stdout.flush()
        return _DoneProc()

    def mkdtemp(self, prefix="tmp", **kw):
        """A fresh directory; a gang's holds the shrink epoch's replica."""
        self.dirs += 1
        d = self.tmp / f"{prefix}{self.dirs}"
        d.mkdir()
        if prefix.startswith("bf-gang-demo"):
            GangDirectory(4, {p: f"127.0.0.1:{7000 + p}" for p in range(4)},
                          epoch=1, active=[0, 1, 3],
                          rank_owner={r: r for r in range(4)}).persist(
                str(d / "gang.0.json"))
        return str(d)


class _DoneProc:
    """A launch that is running at the first poll and done after."""
    returncode = 0

    def __init__(self):
        self.polls = 0

    def poll(self):
        self.polls += 1
        return None if self.polls == 1 else 0

    def wait(self, timeout=None):
        return 0

    def kill(self):
        pass


def _verdict(mod, argv, outs, dumps, tmp, monkeypatch, capsys):
    replay = _Replay(outs, dumps, tmp)
    with monkeypatch.context() as m:
        m.setattr(subprocess, "run", replay.run)
        m.setattr(subprocess, "Popen", replay.popen)
        m.setattr(tempfile, "mkdtemp", replay.mkdtemp)
        rc = mod.main(argv)
    cap = capsys.readouterr()
    failures = [ln for ln in cap.err.splitlines() if ln.startswith("  - ")]
    ranks = [re.sub(r", rows on \S+", "", ln)
             for ln in cap.out.splitlines() if ln.startswith("  ")]
    verdict = [re.sub(r"\(wall.*|\(walls.*", "", ln)
               for ln in cap.out.splitlines()
               if re.match(r"chaos(\s|\S+\s)(\S+ )?(OK|FAILED)", ln)]
    return rc, failures, ranks, verdict


@pytest.mark.parametrize("bad", [False, True], ids=["passes", "fails"])
@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_verdict_equals_jax_on_recorded_output(scenario, bad, tmp_path,
                                               monkeypatch, capsys):
    argv, recs = _SCENARIOS[scenario]
    dumps = (0, 1) if bad else (0, 1, 2)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    port = _verdict(TC, argv, recs(bad), dumps, tmp_path / "t",
                    monkeypatch, capsys)
    jax = _verdict(JC, argv, recs(bad), dumps, tmp_path / "j", monkeypatch,
                   capsys)
    assert port == jax
    assert port[0] == (1 if bad else 0)
    assert bool(port[1]) == bad and port[2]


def _gang_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BFTPU_", "BLUEFOG_TPU_", "MASTER_",
                                "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return env


def _tool(*args, timeout):
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tools", "chaos", *args,
         "--device", "cpu"], cwd=ROOT, env=_gang_env(), capture_output=True,
        text=True, timeout=timeout)


def test_kill_scenario_gang_on_the_cpu():
    """``chaos --smoke --device cpu``: 4 processes of one rank, rank 3
    SIGKILLed at step 120; the survivors commit one view, re-plan, reach
    the survivors' optimum, keep their step time, and dump the flight
    recorder (the harness's own verdict)."""
    p = _tool("--smoke", "--steps", "200", "--kill-step", "80",
              timeout=150)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "chaos OK: rank 3 killed at step 80, 3 survivors" in p.stdout
    assert "flight-recorder postmortem OK" in p.stdout


@pytest.mark.slow
@pytest.mark.parametrize("leg", ["--delay-smoke", "--join-smoke",
                                 "--kill0-smoke", "--links-smoke",
                                 "--tune-smoke"])
def test_scenario_gang_on_the_cpu(leg):
    p = _tool(leg, timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert re.search(r"^chaos \S* ?OK", p.stdout, re.M), p.stdout[-2000:]
