"""The port's probes against the JAX package's.

The ring is ``native/src/xlacall.cc``'s in both packages: events drain in
order on the clock of ``time.monotonic_ns()``, an over-full ring keeps the
newest.  ``reconcile`` is host arithmetic: the same event list gives the
same summary, the same ``bf_fused_*`` series and the same profiler phases
in both packages.  Then the fused step's probes on the CPU: each step's
seams in program order, attribution into an active ``step_profile``, and
``BLUEFOG_TPU_PROBE=0`` recording none (the profiler's ``fused-step``
remainder and ``/healthz``'s degraded note instead).
"""

import time

import pytest
import torch

from bluefog_tpu.utils import config as jconfig
from bluefog_tpu.utils import probes as JP
from bluefog_tpu.utils import profiler as JPR
from bluefog_tpu.utils import telemetry as JT
import bluefog_tpu_torch as tbf
from bluefog_tpu_torch.optim import window_optimizers as TWO
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import probes as TP
from bluefog_tpu_torch.utils import profiler as TPR
from bluefog_tpu_torch.utils import telemetry as TT

N = 4


@pytest.fixture
def fresh(monkeypatch):
    def set_env(**kv):
        for k, v in kv.items():
            monkeypatch.setenv(k, str(v))
        tconfig.reload()
        jconfig.reload()
    for m in (TP, JP, TPR, JPR):
        m._reset_for_tests()
    TT.reset()
    JT.reset()
    yield set_env
    monkeypatch.delenv("BLUEFOG_TPU_PROBE", raising=False)
    tconfig.reload()
    jconfig.reload()
    for m in (TP, JP, TPR, JPR):
        m._reset_for_tests()
    TT.reset()
    JT.reset()


def test_ring_drain_order_and_shared_clock(fresh):
    assert TP.arm()
    ids = [TP.GRAD_READY, TP.BUCKET_PRE, TP.BUCKET_POST, TP.STEP_END,
           TP.DRAIN_START]
    t0 = time.monotonic_ns()
    for pid in ids:
        TP.note(pid)
    t1 = time.monotonic_ns()
    ev = TP.drain()
    assert [p for _t, p, _s in ev] == ids
    assert [s for _t, _p, s in ev] == list(range(len(ids)))
    ts = [t for t, _p, _s in ev]
    assert ts == sorted(ts) and t0 <= ts[0] and ts[-1] <= t1
    assert TP.drain() == []


def test_ring_wraparound_keeps_newest(fresh):
    from bluefog_tpu_torch import native
    assert TP.arm()
    cap = int(native.lib().bf_probe_enable(0))
    for _ in range(cap + 50):
        TP.note(TP.GRAD_READY)
    assert TP.total() == cap + 50
    ev = TP.drain(cap=cap + 50)
    assert [s for _t, _p, s in ev] == list(range(50, cap + 50))


def _events(k, spread):
    """One step's seams: program entry, each bucket's pre/post, end, and
    the host's drain seams (``spread`` ns apart)."""
    t = 10_000_000
    ev = [(t, JP.GRAD_READY, 0)]
    for bi in range(k):
        t += spread
        ev.append((t, JP.BUCKET_PRE + bi, 0))
        t += spread // 3
        ev.append((t, JP.BUCKET_POST + bi, 0))
    t += spread
    ev += [(t, JP.STEP_END, 0), (t + 900, JP.DRAIN_START, 0),
           (t + 5000, JP.DRAIN_COMMIT, 0), (t + 7000, JP.FINISH_DONE, 0)]
    return ev


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("k,spread", [(1, 1000), (2, 3000), (4, 777)])
def test_reconcile_equals_jax(fresh, monkeypatch, k, spread, profiled):
    ev = _events(k, spread)
    out = {}
    for name, P, R, T in (("jax", JP, JPR, JT), ("torch", TP, TPR, TT)):
        monkeypatch.setattr(P, "drain", lambda cap=0, ev=ev: list(ev))
        prof = R.StepProfiler() if profiled else None
        if prof is not None:
            prof.__enter__()
        s = P.reconcile(k, modeled_mean=(k - 1) / (2 * k) if k > 1 else 0.5,
                        t_statuses_ns=ev[-4][0] + 300)
        phases = prof.phases() if prof is not None else None
        if prof is not None:
            prof.__exit__(None, None, None)
        s.pop("wall_ns")
        series = {kk: v for kk, v in T.snapshot().items()
                  if kk.startswith(("bf_fused", "bf_probe"))}
        out[name] = (s, series, phases)
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["attributed"] is profiled


def test_probe_names_equal():
    for pid in (1, 2, 10, 11, 12, 100, 103, 200, 205, 77):
        assert TP.probe_name(pid) == JP.probe_name(pid)


def _fused(steps, profile=False):
    tbf.init(N, device="cpu")
    p = torch.nn.Parameter(torch.randn(N, 12, generator=torch.Generator()
                                       .manual_seed(0)))
    opt = TWO.DistributedWinPutOptimizer(
        torch.optim.SGD([p], lr=0.1), fused=True, fusion_buckets=2,
        leaf_shapes=[(8,), (4,)])
    summaries = []
    try:
        for s in range(steps):
            p.grad = torch.full_like(p, 0.01 * (s + 1))
            if profile:
                with tbf.step_profile(straggler=False) as prof:
                    opt.step()
                summaries.append(prof.phases())
            else:
                opt.step()
                summaries.append(TP.last_summary())
    finally:
        opt.free()
        tbf.shutdown()
    return summaries


def test_fused_step_notes_its_seams(fresh):
    """A fused step on the CPU notes the program's seams in order and
    reconciles them into a summary with every bucket's issue window."""
    s = _fused(2)
    assert s[-1] is not None and s[-1]["events"] == 9
    assert sorted(s[-1]["bucket_issue_seconds"]) == [0, 1]
    assert s[-1]["modeled_overlap"] == 0.25
    assert 0.0 <= s[-1]["measured_overlap"] <= 1.0
    assert "bf_fused_overlap_ratio" in TT.snapshot()


def test_fused_profile_reports_real_phases(fresh):
    phases = _fused(2, profile=True)[-1]
    assert "optimizer-update" in phases and TPR.FUSED_PHASE not in phases
    assert not TPR.attribution_degraded()


def test_probe_off_is_inert_and_degrades(fresh):
    """``BLUEFOG_TPU_PROBE=0``: the ring records nothing, the profiled
    fused step's remainder is ``fused-step`` and the flag trips."""
    fresh(BLUEFOG_TPU_PROBE=0)
    phases = _fused(2, profile=True)[-1]
    assert TP.total() == 0
    assert TPR.FUSED_PHASE in phases
    assert TPR.attribution_degraded()
    TPR._last_report = {"ranks": 1}
    assert "degraded" in TT.health()["straggler"]["attribution"]
