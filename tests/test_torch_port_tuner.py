"""The port's tuner against the JAX package's.

``utils/tuner.py`` is a step-driven state machine over host arithmetic:
the same fed link snapshots, step numbers and step-time histograms (an
injected ``counts_fn``, the fake clock) give the same epochs, knob values,
overrides, reverts and pins in both packages, compared exactly, with the
same ``bf_tune_*`` series and ``/healthz`` block.  The measured
re-pricing (``MeasuredModel``) gives the JAX package's placement
permutation, and ``BLUEFOG_TPU_TUNE=0`` and ``BLUEFOG_TPU_LINK_OBS=0``
leave every consumer bitwise as configured.
"""

import numpy as np
import pytest

from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import placement as JPL
from bluefog_tpu.ops import schedule as JS
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu.utils import linkobs as JL
from bluefog_tpu.utils import telemetry as JT
from bluefog_tpu.utils import tuner as JU
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import placement as TPL
from bluefog_tpu_torch.ops import schedule as TS
from bluefog_tpu_torch.ops import transport as TTR
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import linkobs as TL
from bluefog_tpu_torch.utils import telemetry as TT
from bluefog_tpu_torch.utils import tuner as TU

KNOBS = ("BLUEFOG_TPU_TUNE", "BLUEFOG_TPU_TUNE_DWELL_STEPS",
         "BLUEFOG_TPU_TUNE_DIVERGENCE", "BLUEFOG_TPU_LINK_OBS",
         "BLUEFOG_TPU_WIN_COMPRESSION", "BLUEFOG_TPU_WIN_STRIPES",
         "BLUEFOG_TPU_ASYNC", "BLUEFOG_TPU_ASYNC_STALENESS_STEPS",
         "BLUEFOG_TPU_HIER", "BLUEFOG_TPU_WIN_COALESCE_LINGER_MS")


@pytest.fixture
def env(monkeypatch):
    def set_env(**kv):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in kv.items():
            monkeypatch.setenv(k, str(v))
        jconfig.reload()
        tconfig.reload()
    for m in (JT, TT, JU, TU):
        m.reset()
    yield set_env
    for m in (JU, TU, JT, TT):
        m.reset()
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    jconfig.reload()
    tconfig.reload()


def _snap(edges):
    return {f'bf_link_delay_us{{src="{s}",dst="{d}"}}': float(us)
            for s, d, us in edges}


_HOT = _snap([(1, 0, 60_000.0), (1, 2, 60_000.0),
              (0, 1, 200.0), (2, 1, 210.0), (0, 2, 205.0)])
_HOTTER = _snap([(1, 0, 300_000.0), (1, 2, 300_000.0),
                 (0, 1, 200.0), (2, 1, 210.0), (0, 2, 205.0)])
_CALM = _snap([(0, 1, 200.0), (1, 0, 230.0), (2, 1, 210.0)])
_NB = len(JT._HIST_BUCKETS) + 1
_FAST, _SLOW = 2, _NB - 3


def _counts(idx, n):
    c = [0.0] * _NB
    c[idx] = float(n)
    return c


def _hermetic(U, holder, targets=None):
    """A tuner whose side effects stay in the instance (no live re-plan,
    no model, no transports), fed step times from ``holder``."""
    t = U.Tuner(counts_fn=lambda: list(holder["c"]))
    t._replan = lambda rel: (None, False, None)
    t._base_model = lambda: None
    t._live_transports = lambda: []
    if targets is not None:
        t._targets = targets
    return t


def _state(U, T, t):
    knobs = {k: (v.value, v.pinned_until) for k, v in t.knobs.items()}
    tune = {k: v for k, v in T.snapshot().items() if k.startswith("bf_tune")}
    return (t.epoch, t.reverts, t.last_knob, knobs, dict(U._overrides),
            t.health(), tune, t._probation is not None)


# Scenarios: (snapshot per step or None, slow step-time observations).
SCENARIOS = {
    "one_epoch": [(s, _HOT if s == 10 else None, False)
                  for s in range(10, 40)],
    "revert_and_pin": [(10, _HOT, False)] + [(s, None, s == 14)
                                            for s in range(11, 60)],
    "no_divergence": [(s, _CALM, False) for s in range(0, 30)],
    "changed_matrix": [(10, _HOT, False), (12, _HOTTER, False)]
    + [(s, None, False) for s in range(13, 30)],
}


@pytest.mark.parametrize("knobs", [
    {}, {"BLUEFOG_TPU_WIN_COMPRESSION": "sparse:0.5",
         "BLUEFOG_TPU_HIER": "1", "BLUEFOG_TPU_ASYNC": "1",
         "BLUEFOG_TPU_ASYNC_STALENESS_STEPS": "4",
         "BLUEFOG_TPU_WIN_COALESCE_LINGER_MS": "2.5"}],
    ids=["defaults", "every_knob"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fed_snapshots_give_equal_epochs(env, scenario, knobs):
    env(BLUEFOG_TPU_TUNE="1", BLUEFOG_TPU_TUNE_DWELL_STEPS="5",
        BLUEFOG_TPU_TUNE_DIVERGENCE="3", **knobs)
    targets = (lambda rel, cfg: {"coalesce_linger_ms": min(
        16.0, max(rel.values()) / 100.0)}) \
        if scenario == "changed_matrix" else None
    runs = []
    for U, T in ((JU, JT), (TU, TT)):
        holder = {"c": _counts(_FAST, 10)}
        t = _hermetic(U, holder, targets)
        trace = []
        for step, snap, slow in SCENARIOS[scenario]:
            if snap is not None:
                t.feed([snap])
            if slow:
                holder["c"] = [a + b for a, b in
                               zip(holder["c"], _counts(_SLOW, 10))]
            t.on_step(step)
            trace.append(_state(U, T, t))
        runs.append(trace)
    assert runs[1] == runs[0]
    last = runs[1][-1]
    if scenario == "revert_and_pin":
        assert last[1] == 1
        assert any(st[2] == "revert" and any(p > 0 for _v, p in
                                             st[3].values())
                   for st in runs[1])
    if scenario == "no_divergence":
        assert last[0] == 0


def test_feed_is_order_free_and_equal(env):
    env(BLUEFOG_TPU_TUNE="1")
    per_rank = [_snap([(1, 0, 60_000.0), (0, 2, 205.0)]),
                _snap([(1, 2, 60_000.0), (2, 1, 210.0)]),
                _snap([(0, 1, 200.0)])]
    divs = set()
    for U in (JU, TU):
        for order in (per_rank, per_rank[::-1], per_rank[1:] + per_rank[:1]):
            t = U.Tuner(counts_fn=lambda: None)
            t.feed(order)
            divs.add(t.max_divergence())
    assert len(divs) == 1 and divs.pop() > 3.0


@pytest.mark.parametrize("seed", [0, 3])
def test_measured_repricing_gives_the_jax_permutation(env, seed):
    """A measured model of the same base and matrix, in both packages,
    has the same sketch, prices every edge alike, and the placement search
    over it returns the JAX package's permutation and costs."""
    env(BLUEFOG_TPU_TUNE="1")
    n = 16
    meas = [(s, d, c) for s, d, c in
            [(0, 1, 4.0), (1, 0, 4.0), (5, 9, 11.0), (9, 5, 7.5),
             (3, 12, 2.0), (12, 3, 2.0)]]
    jb = JPL.synthetic_torus((4, 4))
    tb = TPL.synthetic_torus((4, 4))
    jm = JPL.MeasuredModel.from_measurements(jb, meas, dcn_link_cost=6.0)
    tm = TPL.MeasuredModel.from_measurements(tb, meas, dcn_link_cost=6.0)
    assert tm.sketch == jm.sketch and tm.name == jm.name
    JPL.set_active(jm, None)
    TPL.set_active(tm, None)
    try:
        for s in range(n):
            for d in range(n):
                if s != d:
                    assert TPL.predicted_edge_cost(s, d) == \
                        JPL.predicted_edge_cost(s, d)
        ja = [JS.compile_static(jtopo.ExponentialTwoGraph(n))]
        ta = [TS.compile_static(ttopo.ExponentialTwoGraph(n))]
        want = JPL.optimize_placement(jm, ja, n, iters=200, seed=seed)
        got = TPL.optimize_placement(tm, ta, n, iters=200, seed=seed)
        np.testing.assert_array_equal(got.perm, want.perm)
        assert vars(got.optimized_cost) == vars(want.optimized_cost)
        assert got.model_name == want.model_name
    finally:
        JPL.set_active(None, None)
        TPL.set_active(None, None)
    # maybe_measured swaps the model in only for its own geometry.
    TU._measured_model = tm
    assert TU.maybe_measured(tb) is tm
    other = TPL.synthetic_torus((2, 2))
    assert TU.maybe_measured(other) is other


def test_tune_off_is_inert(env):
    """``BLUEFOG_TPU_TUNE=0``: no tuner, no series, every override read
    passes the configured value through, bitwise."""
    env()
    assert TU.maybe_tuner() is None
    TU.feed_snapshots([_HOT])
    TU.tick(5)
    assert TU.health_summary() is None
    assert TT.snapshot() == {}
    assert TU.override_int("stripes", 3) == 3
    assert TU.override_int("hier_outer_every", 7) == 7
    assert TU.override_float("sparse_frac", 0.25) == 0.25
    assert TTR.resolve_stripes() == TTR.resolve_stripes_static() == 1
    assert "tuner" not in TT.health()
    base = TPL.synthetic_torus((2, 2))
    TU._measured_model = TPL.MeasuredModel.from_measurements(
        base, [(0, 1, 3.0)], dcn_link_cost=5.0)
    assert TU.maybe_measured(base) is base


def test_link_obs_off_leaves_the_tuner_no_signal(env):
    """With the observatory off nothing is measured, so an armed tuner
    fed the (empty) local matrix never opens an epoch."""
    env(BLUEFOG_TPU_TUNE="1", BLUEFOG_TPU_LINK_OBS="0")
    TL.note_delay(1, 0, 60_000.0)
    TU.feed_snapshots([TT.snapshot()])
    for s in range(50):
        TU.tick(s)
    t = TU.maybe_tuner()
    assert t.epoch == 0 and t.max_divergence() == 0.0
    assert dict(TU._overrides) == {}
    JL.reset()


def test_adapted_knobs_reach_their_consumers(env):
    """An epoch's stripes and sparse fraction reach the transport's
    resolver and the window encoder's read site; the health block shows
    them."""
    env(BLUEFOG_TPU_TUNE="1", BLUEFOG_TPU_WIN_COMPRESSION="sparse:0.5")
    TU._set_override("stripes", 4.0)
    TU._set_override("sparse_frac", 0.25)
    assert TTR.resolve_stripes() == 4
    assert TU.override_float("sparse_frac", 0.5) == 0.25
    t = TU.maybe_tuner()
    t.feed([_HOT])
    t._replan = lambda rel: (None, False, None)
    t.on_step(30)
    assert TT.health()["tuner"]["epoch"] == t.epoch == 1
