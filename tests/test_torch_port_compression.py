"""The port's wire compression against the JAX package's
``compress_combiner`` on the virtual CPU mesh.

``sparse:<frac>`` is bitwise equal in float32 (the same products, the rounds
added in the same serial order, the block at the same columns of a row in
the JAX ravel order); ``bf16`` is held at 1e-6 absolute against the JAX
combine evaluated op by op, each op rounded to bfloat16 as its program
says (under ``jit`` XLA may keep a fused sum in float32, one bfloat16 ulp of
the result away); the global average at 1e-6 (``psum`` may add the ranks in
another order).

The trajectory test trains the small ResNet (``test_torch_port_resnet``) 3
ATC steps on 4 ranks over the dynamic one-peer topology, momentum 0.9, as
``examples/benchmark.py`` does, under each compression, and holds losses,
parameters and the rank-local BN statistics at 1e-4.  Under ``bf16`` a
parameter whose float32 value lies within the two packages' last-bit
difference of a bfloat16 rounding boundary rounds the other way in one of
them, and the combine carries that rounding to its neighbor's parameter; such
a parameter may differ by two bfloat16 ulps of its value more than 1e-4, and
no more than 0.1% of them may."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import schedule as JS
from bluefog_tpu.optim import functional as JF
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.models.convert import jax_ravel_order, params_from_jax
from bluefog_tpu_torch.ops import schedule as TS
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.optim import optimizers as TO
from bluefog_tpu_torch.replicas import RankReplicas
from test_torch_port_resnet import CLASSES, MODELS, _variables

N = 4
AXIS = "r"


def _combiners(comm, dynamic):
    """The same combiner in both packages, over ExponentialGraph(N)."""
    jc, tc = JF.CommunicationType(comm), TF.CommunicationType(comm)
    if comm == "allreduce":
        return (JF.make_combiner(jc, axis_name=AXIS), TF.make_combiner(tc))
    if dynamic:
        return (JF.make_combiner(jc, axis_name=AXIS, dyn_sched=JS.compile_dynamic(
                    jtopo.one_peer_exp2_phases(N), N)),
                TF.make_combiner(tc, dyn_sched=TS.compile_dynamic(
                    ttopo.one_peer_exp2_phases(N), N)))
    return (JF.make_combiner(jc, axis_name=AXIS, sched=JS.compile_static(
                jtopo.ExponentialGraph(N), use_topo_weights=False)),
            TF.make_combiner(tc, sched=TS.compile_static(
                ttopo.ExponentialGraph(N), use_topo_weights=False)))


def _run_jax(devices, combine, x, step, op_by_op=False):
    mesh = Mesh(np.asarray(devices[:N]), (AXIS,))
    fn = jax.shard_map(lambda xb, s: combine(xb[0], step=s)[None], mesh=mesh,
                       in_specs=(P(AXIS), P()), out_specs=P(AXIS))
    args = (jnp.asarray(x), jnp.asarray(step, jnp.int32))
    if op_by_op:
        with jax.disable_jit():
            return np.asarray(fn(*args))
    return np.asarray(jax.jit(fn)(*args))


def _row(seed, cols=103):
    return np.random.RandomState(seed).randn(N, cols).astype(np.float32)


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("frac,spc", [(0.25, 1), (0.3, 1), (0.25, 2)])
def test_sparse_combine_is_bitwise_jax(devices, dynamic, frac, spc):
    """Several steps rotate the block; 0.3 of 103 columns (kk = 31) wraps
    around the row at the fourth round; with ``steps_per_comm = 2`` the
    block moves once every two steps."""
    jc, tc = _combiners("neighbor.allreduce", dynamic)
    comp = f"sparse:{frac}"
    jc = JF.compress_combiner(jc, comp, steps_per_comm=spc)
    tc = TF.compress_combiner(tc, comp, steps_per_comm=spc)
    assert tc.whole_row
    for step in range(0, 6 * spc, spc):
        x = _row(step)
        want = _run_jax(devices, jc, x, step)
        got = tc(torch.from_numpy(x), step=step).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        changed = np.flatnonzero((got != x).any(0))
        kk = int(np.ceil(frac * x.shape[1]))
        assert 0 < len(changed) <= kk


@pytest.mark.parametrize("dynamic", [False, True])
def test_bf16_combine_matches_jax(devices, dynamic):
    jc, tc = _combiners("neighbor.allreduce", dynamic)
    jc = JF.compress_combiner(jc, "bf16")
    tc = TF.compress_combiner(tc, "bf16")
    for step in range(3):
        x = _row(10 + step)
        want = _run_jax(devices, jc, x, step, op_by_op=True)
        got = tc(torch.from_numpy(x), step=step).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("comp", ["none", "bf16"])
def test_allreduce_combine_matches_jax(devices, comp):
    """The global average; under ``bf16`` without the residual, so every
    rank ends with the same bits."""
    jc, tc = _combiners("allreduce", False)
    jc = JF.compress_combiner(jc, comp, residual=False)
    tc = TF.compress_combiner(tc, comp, residual=False)
    x = _row(20)
    want = _run_jax(devices, jc, x, 0)
    got = tc(torch.from_numpy(x), step=0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got == got[0]).all()


def test_sparse_runs_on_the_whole_row(monkeypatch):
    """A row longer than the combine's chunk still rotates one block over
    the whole row: the flat buffer is not split for ``sparse``."""
    monkeypatch.setattr(TF, "COMBINE_CHUNK", 16)
    tbf.init(N, device="cpu")
    try:
        x = torch.from_numpy(_row(30, cols=40))
        opt = TO.DistributedOptimizer(
            torch.optim.SGD([x], lr=0.0), order="atc",
            use_dynamic_topology=True, compression="sparse:0.5")
        before = x.clone()
        x.grad = torch.zeros_like(x)
        opt.step()
        changed = np.flatnonzero((x != before).any(0).numpy())
        assert changed.min() == 0 and changed.max() < 20 and len(changed) > 16
    finally:
        tbf.shutdown()


@pytest.mark.parametrize("comp,comm,residual,match", [
    ("topk:0.1", "neighbor.allreduce", True, "top-k gossip does not converge"),
    ("sparse", "neighbor.allreduce", True, "malformed 'sparse'"),
    ("sparse:x", "neighbor.allreduce", True, "the fraction must be a float"),
    ("sparse:1.5", "neighbor.allreduce", True, "must be in \\(0, 1\\]"),
    ("sparse:0.25", "allreduce", True, "needs a \\(static or dynamic\\)"),
    ("sparse:0.25", "neighbor.allreduce", False, "requires residual"),
    ("zip", "neighbor.allreduce", True, "unknown compression 'zip'"),
])
def test_refusals_match_jax(comp, comm, residual, match):
    jc, tc = _combiners(comm, True)
    with pytest.raises(ValueError, match=match) as want:
        JF.compress_combiner(jc, comp, residual=residual)
    with pytest.raises(ValueError, match=match) as got:
        TF.compress_combiner(tc, comp, residual=residual)
    assert str(got.value) == str(want.value)


def test_optimizer_refuses_unknown_compression():
    with pytest.raises(ValueError) as want:
        jbf.optim.DistributedOptimizer(optax.sgd(0.1), compression="zip")
    with pytest.raises(ValueError) as got:
        TO.DistributedOptimizer(torch.optim.SGD([torch.zeros(N, 1)], lr=0.1),
                                compression="zip")
    assert str(got.value) == str(want.value)


STEPS, LR = 3, 0.0125 * N


def _jax_trajectory(devices, var, x, y, compression):
    jbf.init(devices=devices[:N])
    model = MODELS["small-bottleneck"][0]()
    rank_major = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), t)
    params, bstats = rank_major(var["params"]), rank_major(
        var["batch_stats"])
    opt = jbf.optim.DistributedAdaptThenCombineOptimizer(
        optax.sgd(LR, momentum=0.9), use_dynamic_topology=True,
        compression=compression)
    state = opt.init(params)

    def loss_fn(p, bs, xb, yb):
        logits, new = model.apply({"params": p, "batch_stats": bs}, xb,
                                  train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean(), new["batch_stats"]
    vgrad = jax.jit(jax.vmap(jax.value_and_grad(loss_fn, has_aux=True)))
    losses = []
    for _ in range(STEPS):
        (loss, bstats), grads = vgrad(params, bstats, x, y)
        # On host arrays: the same jitted vmap over parameters that
        # opt.step left sharded over the CPU mesh gives other losses
        # (2.5998 instead of 2.3590 for rank 0 at step 2, where one rank's
        # apply gives 2.3590); see ROADMAP Queue 3.
        grads, bstats = jax.device_get((grads, bstats))
        params, state = opt.step(params, grads, state)
        params = jax.device_get(params)
        losses.append(np.asarray(loss))
    return (np.stack(losses), jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, bstats))


def _port_trajectory(var, x, y, compression):
    tbf.init(N, device="cpu")
    try:
        make = MODELS["small-bottleneck"][1]
        rep = RankReplicas(make, N, "cpu", order=jax_ravel_order(make()))
        rep.load_state_dict(params_from_jax(make(), var))
        opt = TO.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD([rep.flat], lr=LR, momentum=0.9, dampening=0),
            use_dynamic_topology=True, compression=compression)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
        losses = []
        for _ in range(STEPS):
            rep.zero_grad()
            step = []
            for r in range(N):
                loss = F.cross_entropy(rep.modules[r](xt[r]), yt[r])
                loss.backward()
                step.append(loss.item())
            opt.step()
            losses.append(step)
        return np.asarray(losses), rep
    finally:
        tbf.shutdown()


@pytest.mark.parametrize("compression", ["none", "bf16", "sparse:0.25"])
def test_atc_trajectory_matches_jax(devices, compression):
    rng = np.random.RandomState(6)
    x = rng.randn(N, 2, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, (N, 2)).astype(np.int32)
    var = _variables(MODELS["small-bottleneck"][0](), x[0], seed=6)
    j_losses, j_params, j_stats = _jax_trajectory(devices, var, x, y,
                                                  compression)
    t_losses, rep = _port_trajectory(var, x, y, compression)
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-4)
    assert np.ptp(t_losses[-1]) > 1e-3   # the ranks drifted apart
    make = MODELS["small-bottleneck"][1]
    flips = total = 0
    for r in range(N):
        want = params_from_jax(make(), {
            "params": jax.tree.map(lambda a: a[r], j_params),
            "batch_stats": jax.tree.map(lambda a: a[r], j_stats)})
        got = dict(rep.rank_params(r))
        got.update(rep.rank_buffers(r))
        for name, w in want.items():
            diff = np.abs(got[name].detach().numpy() - w.numpy())
            off = diff > 1e-4
            if compression == "bf16":
                ulp = 2.0 ** (np.floor(np.log2(np.abs(w.numpy()[off]))) - 7)
                assert (diff[off] <= 2 * ulp + 1e-4).all(), f"rank {r} {name}"
                flips += int(off.sum())
            else:
                assert not off.any(), (f"rank {r} {name}: "
                                       f"{diff.max()} over 1e-4")
            total += diff.size
    assert flips <= 1e-3 * total, (flips, total)
