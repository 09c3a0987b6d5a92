"""The port's schedule synthesis (``ops/synthesis.py``) against the JAX
package's, on the same schedules, models and placements.

The synthesis is deterministic host arithmetic (no RNG), so the port's
artifacts are the JAX package's exactly: the same rounds (pairs and weight
bits), the same ``synthesized:<sketch>`` provenance and sketch, the same
``modeled_cost``; ``select_schedule`` chooses the same schedule with the
same ratio; ``serial_time`` and ``serial_lower_bound`` agree to the bit;
and the memo keys the same way."""

import numpy as np
import pytest

from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import placement as JPL
from bluefog_tpu.ops import schedule as JS
from bluefog_tpu.ops import schedule_opt as JSO
from bluefog_tpu.ops import synthesis as JSY
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import placement as TPL
from bluefog_tpu_torch.ops import schedule as TS
from bluefog_tpu_torch.ops import schedule_opt as TSO
from bluefog_tpu_torch.ops import synthesis as TSY

from test_torch_port_placement import assert_same_rounds


def _case(name):
    """``(jax schedule, port schedule, jax model, port model, n)``."""
    if name == "exp2-ring16":
        n, dims, slices = 16, (16,), 1
        g = lambda m: m.ExponentialTwoGraph(n)  # noqa: E731
    elif name == "exp2-4x4":
        n, dims, slices = 16, (4, 4), 1
        g = lambda m: m.ExponentialTwoGraph(n)  # noqa: E731
    elif name == "rr-4x4":
        n, dims, slices = 16, (4, 4), 1
        g = lambda m: m.RandomRegularGraph(n, 4, seed=0)  # noqa: E731
    elif name == "rr-2x8":
        n, dims, slices = 16, (2, 8), 1
        g = lambda m: m.RandomRegularGraph(n, 4, seed=0)  # noqa: E731
    else:  # two slices of a 2x4 torus behind one DCN link each way
        n, dims, slices = 16, (2, 4), 2
        g = lambda m: m.ExponentialTwoGraph(n)  # noqa: E731
    jm = JPL.synthetic_torus(dims, n_slices=slices)
    tm = TPL.synthetic_torus(dims, n_slices=slices)
    return (JS.compile_static(g(jtopo)), TS.compile_static(g(ttopo)), jm, tm,
            n)


CASES = ["exp2-ring16", "exp2-4x4", "rr-4x4", "rr-2x8", "exp2-2slices"]


@pytest.mark.parametrize("sketch", ["auto", "ring-within-slice",
                                    "hierarchical", "chunked-pipelined"])
@pytest.mark.parametrize("name", CASES)
def test_synthesize_schedule_equals_jax(name, sketch):
    ja, tb, jm, tm, n = _case(name)
    perm = JPL.optimize_placement(jm, ja, n, iters=100, seed=1).perm
    for p in (None, perm):
        jp = JSO.congestion_aware_repack(ja, jm, p, budget_factor=2.0)
        tp = TSO.congestion_aware_repack(tb, tm, p, budget_factor=2.0)
        want = JSY.synthesize_schedule(ja, jm, p, sketch=sketch,
                                       baseline=jp)
        got = TSY.synthesize_schedule(tb, tm, p, sketch=sketch, baseline=tp)
        assert (want is None) == (got is None)
        if want is not None:
            assert got.provenance.startswith("synthesized:")
            assert_same_rounds(want, got)


@pytest.mark.parametrize("budget", [2.0, 1.0, 0.0])
@pytest.mark.parametrize("name", CASES)
def test_select_schedule_equals_jax(name, budget):
    ja, tb, jm, tm, n = _case(name)
    perm = JPL.optimize_placement(jm, ja, n, iters=100, seed=0).perm
    jp = JSO.congestion_aware_repack(ja, jm, perm, budget_factor=budget)
    tp = TSO.congestion_aware_repack(tb, tm, perm, budget_factor=budget)
    want, w_ratio = JSY.select_schedule(ja, jp, jm, perm,
                                        budget_factor=budget)
    got, g_ratio = TSY.select_schedule(tb, tp, tm, perm,
                                       budget_factor=budget)
    assert g_ratio == w_ratio
    assert_same_rounds(want, got)
    assert TSY.serial_time(tm, got, perm) == JSY.serial_time(jm, want, perm)
    assert TSY.serial_lower_bound(tm, tb, perm) == \
        JSY.serial_lower_bound(jm, ja, perm)
    # Never worse than the packed schedule it is chosen against.
    assert TSY.serial_time(tm, got, perm) <= TSY.serial_time(tm, tp, perm)


def test_synthesis_bows_out_as_jax():
    """No model, a rank count the model does not cover, or the budget at 0:
    no artifact."""
    ja, tb, jm, tm, _ = _case("exp2-4x4")
    assert TSY.synthesize_schedule(tb, None) is None
    assert TSY.synthesize_schedule(tb, tm, budget_factor=0.0) is None
    small = TS.compile_static(ttopo.RingGraph(4))
    assert TSY.synthesize_schedule(small, tm) is None
    assert JSY.synthesize_schedule(JS.compile_static(jtopo.RingGraph(4)),
                                   jm) is None


def test_synth_cache_keys_as_jax():
    """The memo hits on an identity permutation given as None or as an
    arange, misses on another sketch, and tallies by provenance."""
    JSY.clear_synth_cache()
    TSY.clear_synth_cache()
    ja, tb, jm, tm, n = _case("exp2-ring16")
    for sy, s, m in ((JSY, ja, jm), (TSY, tb, tm)):
        a = sy.synthesize_schedule(s, m, None)
        assert sy.synthesize_schedule(s, m, np.arange(n)) is a
        sy.synthesize_schedule(s, m, None, sketch="hierarchical")
    assert TSY.synth_cache_info() == JSY.synth_cache_info()
    assert TSY.synth_cache_info()["entries"] == 2
    TSY.clear_synth_cache()
    assert TSY.synth_cache_info()["entries"] == 0


def test_compile_cache_info_tallies_provenance():
    TSO.clear_compile_cache()
    TS.compile_static(ttopo.ExponentialTwoGraph(8))
    TS.compile_static(ttopo.RandomRegularGraph(12, 4, seed=0))
    info = TSO.compile_cache_info()
    assert info["entries"] == 2
    assert info["by_provenance"] == {"naive": 1, "konig": 1}
