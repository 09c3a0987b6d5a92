"""The port's step profiler against the JAX package's.

With an injected clock the phase attribution is host arithmetic, so the
phases and the histograms they land in equal the JAX package's exactly;
so do the straggler reports for the same step times.  The optimizers'
``profile_every=`` takes its synced samples on the JAX package's schedule
(the same counts of step samples, phases and straggler reports), inside
and outside an enclosing ``step_profile()`` (where the port's combine,
which runs in op spans, is billed to ``gossip-communicate``: the JAX
package's jitted step has no spans), and the framework's op spans land in
the same phases.
"""

import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu.utils import profiler as JP
from bluefog_tpu.utils import telemetry as JT
from bluefog_tpu.utils import timeline as JTL
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.utils import profiler as TP
from bluefog_tpu_torch.utils import telemetry as TT
from bluefog_tpu_torch.utils import timeline as TTL

N = 8


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (JT, TT):
        mod.reset()
    JP._reset_for_tests()
    TP._reset_for_tests()
    yield
    tbf.shutdown()
    for mod in (JT, TT):
        mod.reset()
    JP._reset_for_tests()
    TP._reset_for_tests()


def _script(prof_mod, clock):
    """One profiled step on ``clock``: explicit phases, attributed
    seconds, an unattributed remainder."""
    with prof_mod.step_profile(straggler=False, clock=clock) as p:
        with p.phase("gossip-communicate"):
            clock.advance(0.25)
        with p.phase("optimizer-update"):
            clock.advance(0.125)
        p.attribute("host-sync", 0.0625)
        clock.advance(0.5)  # -> grad-compute remainder (less host-sync)
    return p.phases()


@pytest.mark.parametrize("steps", [1, 3])
def test_phases_under_injected_clock_equal_jax(steps):
    for _ in range(steps):
        want = _script(JP, FakeClock())
        got = _script(TP, FakeClock())
        assert got == want
    assert set(got) == set(TP.PHASES)
    assert TT.snapshot() == JT.snapshot()
    assert TT.snapshot()["bf_step_seconds_count"] == steps


def test_op_spans_land_in_the_same_phases():
    """The span hook's classification, outermost spans only, drain-side
    ``win_apply`` spans not billed, the hook cleared on exit."""
    got = {}
    for prof_mod, tl in ((JP, JTL), (TP, TTL)):
        with prof_mod.step_profile(straggler=False) as p:
            with tl.op_span("neighbor_allreduce", "ENQUEUE"):
                with tl.op_span("neighbor_allreduce.edge", "COMMUNICATE"):
                    pass
            with tl.op_span("synchronize", "COMMUNICATE"):
                pass
            with tl.op_span("win_update.w", "UPDATE"):
                pass
            with tl.op_span("win_apply.w.3->0", "COMMUNICATE"):
                pass
        got[prof_mod] = sorted(p.phases())
        assert tl._span_hook is None
    assert got[TP] == got[JP] == sorted(TP.PHASES)
    for name in ("x", "synchronize", "win_apply.w.0->1"):
        for ph in ("ENQUEUE", "COMMUNICATE", "UPDATE"):
            assert TP._classify_span(name, ph) == JP._classify_span(name, ph)


@pytest.mark.parametrize("times", [
    [0.1] * 7 + [0.4], [0.2] * 8, [0.31, 0.29, 0.5, 0.1], [1.0],
    list(np.random.RandomState(3).gamma(2.0, 0.05, size=16))])
def test_straggler_report_equals_jax(times):
    assert TP.straggler_report(times) == JP.straggler_report(times)
    assert TP.straggler_report(np.asarray(times, np.float32)) == \
        JP.straggler_report(np.asarray(times, np.float32))


def _counts(snap):
    keep = ("_count", "_total")
    return {k: v for k, v in snap.items()
            if k.split("{")[0].endswith(keep)
            and not k.startswith(("bf_comm_", "bf_dispatch_",
                                  "bf_schedule_", "bf_throttle"))}


@pytest.mark.parametrize("wrapped", [False, True])
def test_profile_every_takes_its_sample_on_schedule(devices, wrapped):
    """``profile_every=2`` over 5 steps: synced samples (step seconds,
    the optimizer-update and host-sync phases) and straggler reports on
    steps 2 and 4, as in the JAX package; inside ``step_profile()`` the
    enclosing profiler records every step and gathers once a sample."""
    jbf.init(devices=devices)
    jp = {"w": np.ones((N, 4), np.float32)}
    jg = {"w": np.full((N, 4), 0.01, np.float32)}
    jopt = jbf.optim.DistributedNeighborAllreduceOptimizer(
        optax.sgd(0.01), profile_every=2)
    state = jopt.init(jp)
    tbf.init(N, device="cpu")
    p = torch.ones(N, 4)
    p.grad = torch.full((N, 4), 0.01)
    topt = tbf.optim.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD([p], lr=0.01), profile_every=2)
    for _ in range(5):
        if wrapped:
            with jbf.step_profile():
                jp, state = jopt.step(jp, jg, state)
            with tbf.step_profile():
                topt.step()
        else:
            jp, state = jopt.step(jp, jg, state)
            topt.step()
    want, got = _counts(JT.snapshot()), _counts(TT.snapshot())
    # The port's combine is in op spans, which the JAX package's jitted
    # step has not: inside step_profile() it is billed to its own phase.
    comm = 'bf_step_phase_seconds_count{phase="gossip-communicate"}'
    assert got.pop(comm, None) == (5 if wrapped else None)
    assert got == want
    assert got["bf_straggler_reports_total"] == 2
    assert got["bf_step_seconds_count"] == (5 if wrapped else 2)
    rep = TP.last_straggler_report()
    assert rep is not None and len(rep["step_seconds"]) == N
    assert rep["straggler_score"] == 0.0  # one process: equal times
    assert TT.health()["straggler"]["slowest_rank"] == rep["slowest_rank"]


def test_profile_period_and_env(monkeypatch):
    """The env-armed period (``BLUEFOG_TPU_PROFILE``, ``_PROFILE_EVERY``)
    and the explicit argument, as the JAX package reads them; nothing with
    telemetry off."""
    from bluefog_tpu.utils import config as jconfig
    from bluefog_tpu_torch.utils import config as tconfig
    cases = [({}, None), ({"BLUEFOG_TPU_PROFILE": "1"}, None),
             ({"BLUEFOG_TPU_PROFILE": "1",
               "BLUEFOG_TPU_PROFILE_EVERY": "3"}, None), ({}, 4),
             ({"BLUEFOG_TPU_TELEMETRY": "0"}, 4), ({}, -2)]
    for env, explicit in cases:
        for k in ("BLUEFOG_TPU_PROFILE", "BLUEFOG_TPU_PROFILE_EVERY",
                  "BLUEFOG_TPU_TELEMETRY"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        jconfig.reload()
        tconfig.reload()
        assert TP.profile_period(explicit) == JP.profile_period(explicit)
    monkeypatch.undo()
    jconfig.reload()
    tconfig.reload()


def test_window_optimizer_step_histogram_and_sample(monkeypatch):
    """The window family: one step-time sample a step and, under
    ``BLUEFOG_TPU_PROFILE=1`` with period 2, a synced sample on step 2."""
    from bluefog_tpu_torch.utils import config as tconfig
    monkeypatch.setenv("BLUEFOG_TPU_PROFILE", "1")
    monkeypatch.setenv("BLUEFOG_TPU_PROFILE_EVERY", "2")
    tconfig.reload()
    try:
        tbf.init(N, device="cpu",
                 topology_fn=lambda: ttopo.ExponentialTwoGraph(N))
        p = torch.ones(N, 4)
        p.grad = torch.zeros(N, 4)
        opt = tbf.optim.DistributedWinPutOptimizer(
            torch.optim.SGD([p], lr=0.0))
        try:
            for _ in range(3):
                opt.step()
        finally:
            opt.free()
        snap = TT.snapshot()
        assert snap['bf_optimizer_step_seconds_count{family="window"}'] == 3
        assert snap["bf_step_seconds_count"] == 1
        assert snap["bf_straggler_reports_total"] == 1
        assert snap["bf_win_wait_seconds_count"] >= 3
    finally:
        monkeypatch.undo()
        tconfig.reload()
