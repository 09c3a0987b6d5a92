"""The port's topology and schedule copies agree bit for bit with the JAX
package's."""

import numpy as np
import pytest

from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import schedule as jsched
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.ops import schedule as tsched

SIZES = [2, 3, 4, 5, 8, 16]


def _same_phases(a, b):
    assert [p.send_to for p in a] == [p.send_to for p in b]
    assert [p.pairs for p in a] == [p.pairs for p in b]


def _same_schedule(a, b):
    assert a.n == b.n and len(a.rounds) == len(b.rounds)
    np.testing.assert_array_equal(a.self_scale, b.self_scale)
    np.testing.assert_array_equal(a.indegree, b.indegree)
    np.testing.assert_array_equal(a.outdegree, b.outdegree)
    for ra, rb in zip(a.rounds, b.rounds):
        assert ra.pairs == rb.pairs
        np.testing.assert_array_equal(ra.send_scale, rb.send_scale)
        np.testing.assert_array_equal(ra.recv_mask, rb.recv_mask)
        np.testing.assert_array_equal(ra.src_of, rb.src_of)


@pytest.mark.parametrize("n", SIZES)
def test_weight_matrices_equal(n):
    for name in ("ExponentialGraph", "ExponentialTwoGraph",
                 "SymmetricExponentialGraph", "MeshGrid2DGraph", "StarGraph",
                 "RingGraph", "FullyConnectedGraph"):
        a = jtopo.weight_matrix(getattr(jtopo, name)(n))
        b = ttopo.weight_matrix(getattr(ttopo, name)(n))
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n", SIZES)
def test_dynamic_phase_table_equal(n):
    _same_phases(jtopo.dynamic_phase_table(jtopo.ExponentialGraph(n)),
                 ttopo.dynamic_phase_table(ttopo.ExponentialGraph(n)))


@pytest.mark.parametrize("n", SIZES)
def test_one_peer_exp2_phases_equal(n):
    _same_phases(jtopo.one_peer_exp2_phases(n), ttopo.one_peer_exp2_phases(n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("table", ["phase_table", "exp2"])
def test_compile_dynamic_equal(n, table):
    if table == "phase_table":
        ja = jtopo.dynamic_phase_table(jtopo.ExponentialGraph(n))
        tb = ttopo.dynamic_phase_table(ttopo.ExponentialGraph(n))
    else:
        ja, tb = jtopo.one_peer_exp2_phases(n), ttopo.one_peer_exp2_phases(n)
    a = jsched.compile_dynamic(ja, n)
    b = tsched.compile_dynamic(tb, n)
    assert a.period == b.period
    for pa, pb in zip(a.phases, b.phases):
        _same_schedule(pa, pb)


@pytest.mark.parametrize("n", SIZES)
def test_compile_static_same_weights(n):
    """Both packages repack static rounds (``schedule_opt``): the rounds,
    and the weights they carry, are equal round for round, on shift-
    structured and on irregular topologies."""
    for name in ("ExponentialGraph", "MeshGrid2DGraph", "StarGraph"):
        for weighted in (True, False):
            a = jsched.compile_static(getattr(jtopo, name)(n),
                                      use_topo_weights=weighted)
            b = tsched.compile_static(getattr(ttopo, name)(n),
                                      use_topo_weights=weighted)
            _same_schedule(a, b)
            assert a.max_indegree == b.max_indegree
            for ta, tb in zip(a.slot_tables, b.slot_tables):
                np.testing.assert_array_equal(ta, tb)
            for ra, rb in zip(a.rounds, b.rounds):
                np.testing.assert_array_equal(ra.dst_of, rb.dst_of)


@pytest.mark.parametrize("targets", [[1, 0, 3, 2], [2, -1, 0, -1, 5, 4],
                                     [1, 2, 0]],
                         ids=["pairs", "some-sit-out", "not-mutual"])
def test_compile_pair_gossip_equal(targets):
    n = len(targets)
    try:
        a = jsched.compile_pair_gossip(targets, n, self_weight=0.25,
                                       target_weight=0.75)
    except AssertionError as e:
        with pytest.raises(AssertionError) as got:
            tsched.compile_pair_gossip(targets, n)
        assert str(got.value) == str(e)
        return
    b = tsched.compile_pair_gossip(targets, n, self_weight=0.25,
                                   target_weight=0.75)
    assert a.n == b.n and a.round.pairs == b.round.pairs
    for f in ("send_scale", "recv_mask", "src_of"):
        np.testing.assert_array_equal(getattr(a.round, f),
                                      getattr(b.round, f))
    np.testing.assert_array_equal(a.self_scale, b.self_scale)
