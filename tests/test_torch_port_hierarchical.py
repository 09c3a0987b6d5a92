"""The port's hierarchical family against the JAX package's, in one process.

8 ranks in machines of ``local_size`` 2 and 4 (the rank-major leading dim
reshaped to ``(machines, local_size)``, the JAX package's machine x local
mesh): ``hierarchical_neighbor_allreduce`` (static, weighted, with weight
overrides, and dynamic) within 1e-6 of the JAX ops, float32: the local sums
run in rank order, XLA's CPU ``psum_scatter`` order, but XLA's ``jit`` may
contract a weighted sum into fused multiply-adds with weights that are not
powers of two.  ``hierarchical_gossip`` (outer codec none, ``bf16`` and
``sparse:0.25``; outer cadence 1 and 2) within 1e-6 too, and with ``bf16``
bit for bit against the JAX op run op by op (``jax.disable_jit()``).  The
two hierarchical optimizers' trajectories on the linear problem of
``tests/test_optimizers.py`` within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.optim import optimizers as TO
from bluefog_tpu_torch.utils import config as tconfig

N = 8
TOL = 1e-6


@pytest.fixture
def hier_env(monkeypatch):
    """Set ``BLUEFOG_TPU_HIER*`` knobs for both packages' configs."""
    def set_knobs(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(f"BLUEFOG_TPU_{k.upper()}", str(v))
        jconfig.reload()
        tconfig.reload()
    yield set_knobs
    monkeypatch.undo()
    jconfig.reload()
    tconfig.reload()


def _init(devices, local, machine_graph=None, weighted=False):
    jbf.init(lambda: jtopo.ExponentialGraph(N), devices=devices[:N],
             local_size=local)
    tbf.init(N, device="cpu", local_size=local)
    if machine_graph is not None:
        jbf.set_machine_topology(getattr(jtopo, machine_graph)(N // local),
                                 is_weighted=weighted)
        tbf.set_machine_topology(getattr(ttopo, machine_graph)(N // local),
                                 is_weighted=weighted)


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL)


def _x(seed=0, shape=(N, 33)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def close_port():
    yield
    tbf.shutdown()


@pytest.mark.parametrize("local", [2, 4])
@pytest.mark.parametrize("machines", [None, "RingGraph-weighted",
                                      "FullyConnectedGraph"])
def test_hierarchical_neighbor_allreduce_matches_jax(devices, close_port,
                                                     local, machines):
    graph, weighted = (None, False) if machines is None else (
        machines.split("-")[0], machines.endswith("weighted"))
    _init(devices, local, graph, weighted)
    x = _x(local)
    _close(jbf.hierarchical_neighbor_allreduce(x),
           tbf.hierarchical_neighbor_allreduce(torch.from_numpy(x)))
    m = N // local
    w = np.abs(np.random.RandomState(1).randn(m, m))
    _close(jbf.hierarchical_neighbor_allreduce(
        x, self_weight=0.4, src_machine_weights=w),
        tbf.hierarchical_neighbor_allreduce(
            torch.from_numpy(x), self_weight=0.4, src_machine_weights=w))


def test_hierarchical_matches_the_reference_pipeline(close_port):
    """Local sums, a machine-level combine of the sums, and the division by
    local_size after it (``tests/test_hierarchical.py``'s oracle)."""
    local, m = 2, N // 2
    tbf.init(N, device="cpu", local_size=local)
    tbf.set_machine_topology(ttopo.RingGraph(m))
    x = _x(2)
    out = tbf.hierarchical_neighbor_allreduce(torch.from_numpy(x)).numpy()
    sums = x.reshape(m, local, -1).sum(1)
    for r in range(N):
        mm = r // local
        want = (sums[mm] + sums[(mm - 1) % m] + sums[(mm + 1) % m]) / 3 / local
        np.testing.assert_allclose(out[r], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("local", [2, 4])
def test_dynamic_hierarchical_neighbor_allreduce_matches_jax(devices,
                                                             close_port,
                                                             local):
    _init(devices, local)
    xj = _x(3)
    xt = torch.from_numpy(xj)
    period = len(ttopo.dynamic_phase_table(ttopo.ExponentialGraph(N // local)))
    for step in range(period + 2):
        xj = np.asarray(jbf.dynamic_hierarchical_neighbor_allreduce(xj, step))
        xt = tbf.dynamic_hierarchical_neighbor_allreduce(xt, step)
        _close(xj, xt)
    h = tbf.dynamic_hierarchical_neighbor_allreduce_nonblocking(xt, 1)
    assert tbf.poll(h)
    _close(jbf.dynamic_hierarchical_neighbor_allreduce(xj, 1), tbf.wait(h))


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("compression", ["none", "bf16", "sparse:0.25"])
@pytest.mark.parametrize("local", [2, 4])
def test_hierarchical_gossip_matches_jax(devices, close_port, hier_env,
                                         local, compression, every):
    hier_env(hier=1, hier_outer_every=every,
             hier_outer_compression=compression)
    _init(devices, local)
    xj = _x(4, (N, 6, 5))
    xt = torch.from_numpy(xj)
    # Under jit XLA keeps the bf16 outer mix's sum in float32 (a bf16 ulp
    # apart, up to 5.4e-3): that codec is held op by op
    # (``jax.disable_jit()``, ~6 s a step), bit for bit; the others under
    # jit, within 1e-6 (its multiply-adds).
    bf16 = compression == "bf16"
    for step in range(2 if bf16 else 6):
        with jax.disable_jit(bf16):
            xj = np.asarray(jbf.hierarchical_gossip(xj, step))
        xt = tbf.hierarchical_gossip(xt, step)
        if bf16:
            np.testing.assert_array_equal(xt.numpy(), xj)
        else:
            _close(xj, xt)


def test_hierarchical_gossip_needs_the_knob_and_machines(devices, close_port,
                                                         hier_env):
    tbf.init(N, device="cpu", local_size=2)
    with pytest.raises(RuntimeError, match="BLUEFOG_TPU_HIER=1"):
        tbf.hierarchical_gossip(torch.zeros(N, 3), 0)
    hier_env(hier=1)
    tbf.init(N, device="cpu")
    with pytest.raises(RuntimeError, match="more than one machine"):
        tbf.hierarchical_gossip(torch.zeros(N, 3), 0)
    with pytest.raises(RuntimeError, match="set_machine_topology"):
        tbf.hierarchical_neighbor_allreduce(torch.zeros(N, 3))


def test_make_combiner_builds_both_hierarchical_types():
    from bluefog_tpu_torch.ops import schedule as S
    sched = S.compile_static(ttopo.RingGraph(4), use_topo_weights=False)
    x = torch.from_numpy(_x(5))
    for comb in (TF.make_combiner(
            TF.CommunicationType.hierarchical_neighbor_allreduce,
            sched=sched, local_size=2),
            TF.make_combiner(
                TF.CommunicationType.hierarchical_neighbor_allreduce,
                dyn_sched=S.compile_dynamic(
                    ttopo.dynamic_phase_table(ttopo.RingGraph(4)), 4),
                local_size=2)):
        assert comb(x, 0).shape == x.shape
    with pytest.raises(ValueError, match="local_size"):
        TF.make_combiner(TF.CommunicationType.hierarchical_gossip)


# ---------------------------------------------------------------------------
# The two hierarchical factories on the linear problem
# ---------------------------------------------------------------------------

DIM, SAMPLES, LR, STEPS = 4, 16, 0.05, 4


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    w_star = rng.randn(DIM, 1)
    A = rng.randn(N, SAMPLES, DIM)
    y = A @ w_star + 0.01 * rng.randn(N, SAMPLES, 1)
    return (A.astype(np.float32), y.astype(np.float32),
            (rng.randn(N, DIM, 1) * 2.0).astype(np.float32))


FACTORIES = {
    "hier_static": ("DistributedHierarchicalNeighborAllreduceOptimizer", {}),
    "hier_dynamic": ("DistributedHierarchicalNeighborAllreduceOptimizer",
                     {"use_dynamic_topology": True}),
    "hier_every_2nd_step": (
        "DistributedHierarchicalNeighborAllreduceOptimizer",
        {"num_steps_per_communication": 2}),
    "gossip_awc": ("DistributedHierarchicalGossipOptimizer", {}),
    "gossip_atc_sparse": ("DistributedHierarchicalGossipOptimizer",
                          {"order": "atc"}),
}


@pytest.mark.parametrize("case", sorted(FACTORIES))
def test_hierarchical_factories_match_jax(devices, close_port, hier_env,
                                          case):
    cls, kw = FACTORIES[case]
    hier_env(hier=1, hier_outer_every=2, hier_outer_compression=(
        "sparse:0.5" if case.endswith("sparse") else "none"))
    local = 2
    _init(devices, local)
    A, y, w0 = _problem()

    def loss(w, A_r, y_r):
        return jnp.mean((A_r @ w - y_r) ** 2)

    grad = jax.jit(jax.vmap(jax.grad(loss)))
    jopt = getattr(jbf.optim, cls)(optax.sgd(LR), **kw)
    params = {"w": jnp.asarray(w0)}
    state = jopt.init(params)
    for _ in range(STEPS):
        params, state = jopt.step(params, {"w": grad(params["w"], A, y)},
                                  state)

    w = torch.tensor(w0, requires_grad=True)
    topt = getattr(TO, cls)(torch.optim.SGD([w], lr=LR), **kw)
    for _ in range(STEPS):
        w.grad = None
        ((torch.from_numpy(A) @ w - torch.from_numpy(y)) ** 2).mean(
            dim=(1, 2)).sum().backward()
        topt.step()
    assert topt.step_count == STEPS
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]),
                               rtol=0, atol=TOL)
