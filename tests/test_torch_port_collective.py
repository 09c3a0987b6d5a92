"""The port's rank-major neighbor averaging against the JAX package's eager
ops on the virtual CPU mesh."""

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu_torch import topology as ttopo


@pytest.fixture
def port():
    yield tbf
    tbf.shutdown()


@pytest.mark.parametrize("n", [4, 8])
def test_dynamic_neighbor_allreduce_matches_jax(devices, port, n):
    jbf.init(devices=devices[:n])
    port.init(n, device="cpu")
    period = len(ttopo.dynamic_phase_table(ttopo.ExponentialGraph(n)))
    rng = np.random.RandomState(n)
    x = rng.randn(n, 5, 7).astype(np.float32)
    xj, xt = x, torch.from_numpy(x)
    for step in range(period + 2):
        xj = np.asarray(jbf.dynamic_neighbor_allreduce(xj, step))
        xt = port.dynamic_neighbor_allreduce(xt, step)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [4, 8])
def test_exp2_phases_reach_consensus_as_jax(devices, port, n):
    """One-peer Exp-2 phases: a full period averages exactly, in both."""
    jbf.init(devices=devices[:n])
    port.init(n, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(n, 16).astype(np.float32)
    jph, tph = jtopo.one_peer_exp2_phases(n), ttopo.one_peer_exp2_phases(n)
    xj, xt = x, torch.from_numpy(x)
    for step in range(len(tph)):
        xj = np.asarray(jbf.dynamic_neighbor_allreduce(xj, step, phases=jph))
        xt = port.dynamic_neighbor_allreduce(xt, step, phases=tph)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.numpy(), np.broadcast_to(x.mean(0), x.shape),
                               atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_static_neighbor_allreduce_matches_jax(devices, port, weighted):
    n = 8
    jbf.init(devices=devices[:n], is_weighted=weighted)
    port.init(n, device="cpu", is_weighted=weighted)
    x = np.random.RandomState(1).randn(n, 33).astype(np.float32)
    out_j = np.asarray(jbf.neighbor_allreduce(x))
    out_t = port.neighbor_allreduce(torch.from_numpy(x)).numpy()
    # Rounds may be ordered differently (no schedule_opt repack here), so
    # sums may differ in the last bit: float32 rounding tolerance.
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-6)


def test_rank_major_shape_checked(port):
    port.init(4, device="cpu")
    with pytest.raises(ValueError, match="leading dim 4"):
        port.dynamic_neighbor_allreduce(torch.zeros(3, 2), 0)
