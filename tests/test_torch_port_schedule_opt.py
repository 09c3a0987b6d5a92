"""The port's min-round repack (``ops/schedule_opt.py``) against the JAX
package's ``optimize_schedule``: on random weight matrices, the same rounds
in the same order, bit for bit, at König's bound."""

import numpy as np
import pytest

from bluefog_tpu.ops import schedule as jsched
from bluefog_tpu.ops import schedule_opt as jopt
from bluefog_tpu_torch.ops import schedule as tsched
from bluefog_tpu_torch.ops import schedule_opt as topt


def _random_matrix(n, density, seed):
    rng = np.random.RandomState(seed)
    w = np.where(rng.rand(n, n) < density, rng.rand(n, n), 0.0)
    np.fill_diagonal(w, rng.rand(n))
    return w


def _naive(mod, w):
    if mod is jsched:
        return jsched._build_schedule(w, optimize=False)
    return tsched._naive_schedule(w)


@pytest.mark.parametrize("n,density,seed", [
    (5, 0.5, 0), (8, 0.3, 1), (12, 0.25, 2), (16, 0.2, 3), (32, 0.12, 4),
    (32, 0.5, 5), (9, 1.0, 6), (7, 0.0, 7)])
def test_optimize_schedule_equals_jax(n, density, seed):
    w = _random_matrix(n, density, seed)
    naive_t = _naive(tsched, w)
    want = jopt.optimize_schedule(_naive(jsched, w))
    got = topt.optimize_schedule(naive_t)
    assert len(got.rounds) == len(want.rounds) == topt.min_rounds(naive_t)
    assert len(got.rounds) <= len(naive_t.rounds)
    for ra, rb in zip(want.rounds, got.rounds):
        assert ra.pairs == rb.pairs
        for f in ("send_scale", "recv_mask", "src_of"):
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    # The compiled schedule (through the cache) is the repacked one.
    compiled = tsched._schedule_from_matrix(w)
    assert [r.pairs for r in compiled.rounds] == [r.pairs for r in got.rounds]
    assert tsched._schedule_from_matrix(w) is compiled


@pytest.mark.parametrize("seed", range(4))
def test_color_edges_equals_jax(seed):
    rng = np.random.RandomState(seed)
    n = 10
    edges = sorted({(int(s), int(d)) for s, d in rng.randint(0, n, (40, 2))
                    if s != d})
    order = [edges[i] for i in rng.permutation(len(edges))]
    assert topt._color_edges(order, n) == jopt._color_edges(order, n)


def test_repack_keeps_every_edge_and_weight():
    w = _random_matrix(20, 0.2, 9)
    naive = _naive(tsched, w)
    packed = topt.optimize_schedule(naive)
    edges = lambda s: sorted((p, float(r.send_scale[p[0]]))  # noqa: E731
                             for r in s.rounds for p in r.pairs)
    assert edges(packed) == edges(naive)
    for r in packed.rounds:   # each round a partial permutation
        srcs, dsts = zip(*r.pairs)
        assert len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)
