"""The port's gradient allreduce, fusion buckets and per-step weight
overrides against the JAX package's ``DistributedOptimizer`` on the virtual
CPU mesh, on a five-leaf parameter set with per-rank gradients made from a
seed.

Tolerance 1e-6 (float32; XLA may fuse a weighted sum into multiply-adds
under ``jit``), and gradient allreduce keeps the port's replicas equal bit
for bit.  The rank sum is XLA's on the CPU, rank after rank, bfloat16
accumulated in float32 (``ops.collective._rank_sum``), so ``bf16`` holds
at the same tolerance."""

import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.optim import functional as JF
from bluefog_tpu_torch.optim import functional as TF
from bluefog_tpu_torch.optim import optimizers as TO

N, LR, MOMENTUM = 4, 0.05, 0.9
SHAPES = {"a": (7,), "b": (5, 3), "c": (11,), "d": (2, 4), "e": (13,)}
KEYS = sorted(SHAPES)   # the JAX package's flatten order of the dict


def _params(seed, replicated):
    rng = np.random.RandomState(seed)
    if replicated:   # every rank starts from the same values
        return {k: np.broadcast_to(rng.randn(*s), (N,) + s).astype(np.float32)
                for k, s in SHAPES.items()}
    return {k: rng.randn(N, *s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed, steps):
    rng = np.random.RandomState(seed)
    return [{k: rng.randn(N, *s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(steps)]


def _run_jax(devices, params, grads, make, step_kw=lambda t: {}):
    jbf.init(devices=devices[:N])
    opt = make(optax.sgd(LR, momentum=MOMENTUM))
    state = opt.init(params)
    for t, g in enumerate(grads):
        params, state = opt.step(params, g, state, **step_kw(t))
    return {k: np.asarray(v) for k, v in params.items()}


def _run_port(params, grads, make, step_kw=lambda t: {}, flat=False,
              trace=None):
    """The port's optimizer on the five leaves as five tensors, or (``flat``)
    as one ``(N, P)`` buffer with ``leaf_sizes``; ``trace`` receives the
    parameters after every step."""
    tbf.init(N, device="cpu")
    try:
        sizes = [int(np.prod(SHAPES[k])) for k in KEYS]

        def cat(tree):
            return np.concatenate([tree[k].reshape(N, -1) for k in KEYS], 1)
        if flat:
            ts = [torch.tensor(cat(params))]
        else:
            ts = [torch.tensor(params[k]) for k in KEYS]
        base = torch.optim.SGD(ts, lr=LR, momentum=MOMENTUM, dampening=0)
        opt = make(base, sizes if flat else None)
        for t, g in enumerate(grads):
            if flat:
                ts[0].grad = torch.tensor(cat(g))
            else:
                for k, tt in zip(KEYS, ts):
                    tt.grad = torch.tensor(g[k])
            opt.step(**step_kw(t))
            if trace is not None:
                trace.append([tt.detach().clone() for tt in ts])
        assert opt.step_count == len(grads)
        if flat:
            cols = np.split(ts[0].numpy(), np.cumsum(sizes)[:-1], axis=1)
            return {k: c.reshape((N,) + SHAPES[k]) for k, c in zip(KEYS, cols)}
        return {k: tt.numpy() for k, tt in zip(KEYS, ts)}
    finally:
        tbf.shutdown()


def _close(got, want, atol=1e-6):
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


GA_CASES = {   # J, compression, fusion buckets, one flat buffer
    "J1-none": (1, "none", None, False),
    "J1-bf16": (1, "bf16", None, False),
    "J3-none": (3, "none", None, False),
    "J3-bf16": (3, "bf16", None, False),
    "J2-flat-3-buckets": (2, "none", 3, True),
}


@pytest.mark.parametrize("case", sorted(GA_CASES))
def test_gradient_allreduce_trajectory_matches_jax(devices, case):
    """``DistributedGradientAllreduceOptimizer``: at J=3 the gradients of
    three steps add up and the base optimizer runs only on the third
    (``(step + 1) % J == 0``); every rank applies the same update."""
    J, comp, buckets, flat = GA_CASES[case]
    steps = 3 if J != 2 else 4
    params = _params(1, replicated=True)
    grads = _grads(2, steps)
    want = _run_jax(devices, dict(params), grads,
                    lambda b: jbf.optim.DistributedGradientAllreduceOptimizer(
                        b, num_steps_per_communication=J, compression=comp,
                        fusion_buckets=buckets))
    trace = []
    got = _run_port(params, grads,
                    lambda b, sizes: TO.DistributedGradientAllreduceOptimizer(
                        b, num_steps_per_communication=J, compression=comp,
                        fusion_buckets=buckets, leaf_sizes=sizes),
                    flat=flat, trace=trace)
    _close(got, want)
    for after in trace:   # the replicas stay bit-identical
        for t in after:
            assert bool((t == t[0]).all())
    start = torch.tensor(np.concatenate(
        [params[k].reshape(N, -1) for k in KEYS], 1))
    moved = [not torch.equal(torch.cat([t.reshape(N, -1) for t in after], 1),
                             start) for after in trace]
    # Silent steps leave the parameters where they were.
    assert moved[:J - 1] == [False] * (J - 1) and moved[J - 1]


@pytest.mark.parametrize("k", [None, 1, 2, 3, 4, 7, 40])
def test_bucket_groups_equal_jax(k):
    rng = np.random.RandomState(3 if k is None else k)
    for _ in range(5):
        leaves = [np.zeros(rng.randint(1, 300), np.float32)
                  for _ in range(rng.randint(1, 12))]
        want = JF._bucket_groups(leaves, k)
        got = TF._bucket_groups([leaf.nbytes for leaf in leaves], k)
        assert got == want


@pytest.mark.parametrize("flat", [False, True], ids=["tensors", "flat"])
def test_atc_sparse_with_fusion_buckets_matches_jax(devices, flat):
    """ATC over the dynamic one-peer topology under ``sparse:0.25`` with
    three fusion buckets: each bucket rotates its own block of
    ``ceil(0.25 * bucket columns)``, so the trajectory is not the one-bucket
    one."""
    params = _params(4, replicated=False)
    grads = _grads(5, 3)

    def make_jax(buckets):
        return lambda b: jbf.optim.DistributedAdaptThenCombineOptimizer(
            b, use_dynamic_topology=True, compression="sparse:0.25",
            fusion_buckets=buckets)

    def make_port(buckets):
        return lambda b, sizes: TO.DistributedAdaptThenCombineOptimizer(
            b, use_dynamic_topology=True, compression="sparse:0.25",
            fusion_buckets=buckets, leaf_sizes=sizes)
    want = _run_jax(devices, dict(params), grads, make_jax(3))
    got = _run_port(params, grads, make_port(3), flat=flat)
    _close(got, want)
    one = _run_port(params, grads, make_port(None), flat=flat)
    assert max(np.abs(one[k] - got[k]).max() for k in SHAPES) > 1e-3


def _weights(t):
    """Step ``t``'s override of ExponentialGraph(N)'s weights."""
    rng = np.random.RandomState(10 + t)
    w = jtopo.weight_matrix(jtopo.ExponentialGraph(N)) * rng.rand(N, N)
    np.fill_diagonal(w, 0.5)
    return w


OVERRIDES = {
    "atc-static-matrix": (dict(order="atc"),
                          lambda t: dict(src_weights=_weights(t))),
    "awc-static-src-dict": (
        dict(order="awc"),
        lambda t: dict(self_weight=0.3 + 0.1 * t,
                       src_weights={r: 0.1 * (r + 1) for r in range(N)})),
    "atc-dynamic-matrix": (dict(order="atc", use_dynamic_topology=True),
                           lambda t: dict(src_weights=_weights(t))),
    "awc-static-dst-dict": (dict(order="awc"),
                            lambda t: dict(self_weight=0.25,
                                           dst_weights={1: 0.2, 3: 0.4})),
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_weight_override_trajectory_matches_jax(devices, case):
    """``step(self_weight=, src_weights=, dst_weights=)``: a new weight
    matrix every step over the schedule's edges."""
    kw, step_kw = OVERRIDES[case]
    params = _params(6, replicated=False)
    grads = _grads(7, 3)
    want = _run_jax(devices, dict(params), grads,
                    lambda b: jbf.optim.DistributedOptimizer(
                        b, "neighbor.allreduce", **kw), step_kw)
    got = _run_port(params, grads,
                    lambda b, sizes: TO.DistributedOptimizer(
                        b, "neighbor.allreduce", **kw), step_kw)
    _close(got, want)
    plain = _run_port(params, grads, lambda b, sizes: TO.DistributedOptimizer(
        b, "neighbor.allreduce", **kw))
    assert max(np.abs(plain[k] - got[k]).max() for k in SHAPES) > 1e-3


@pytest.mark.parametrize("comm,compression", [
    ("allreduce", "none"), ("neighbor.allreduce", "sparse:0.25"),
    ("empty", "none")])
def test_weight_override_refusals_match_jax(devices, comm, compression):
    """Under ``allreduce`` and sparse compression a weight override raises
    the JAX package's error; under ``empty`` nothing is combined, so it is
    ignored, as there."""
    params = _params(8, replicated=False)
    grads = _grads(9, 1)
    step_kw = lambda t: dict(src_weights=_weights(t))  # noqa: E731
    outcome = []
    for run in (
            lambda: _run_jax(devices, dict(params), grads,
                             lambda b: jbf.optim.DistributedOptimizer(
                                 b, comm, order="atc",
                                 compression=compression), step_kw),
            lambda: _run_port(params, grads,
                              lambda b, sizes: TO.DistributedOptimizer(
                                  b, comm, order="atc",
                                  compression=compression), step_kw)):
        try:
            outcome.append(("ok", run()))
        except ValueError as e:
            outcome.append(("raised", str(e)))
    assert outcome[0][0] == outcome[1][0]
    if outcome[0][0] == "raised":
        assert outcome[0][1] == outcome[1][1]
    else:
        _close(outcome[1][1], outcome[0][1])


def test_gradient_allreduce_refuses_what_jax_refuses():
    tbf.init(N, device="cpu")
    try:
        p = torch.zeros(N, 3)
        p.grad = torch.ones(N, 3)
        with pytest.raises(ValueError, match="fusion_buckets must be >= 1"):
            TO.DistributedGradientAllreduceOptimizer(
                torch.optim.SGD([p], lr=0.1), fusion_buckets=0)
        with pytest.raises(ValueError, match="unknown execution order"):
            TO.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                    order="push_sum")
        opt = TO.DistributedGradientAllreduceOptimizer(
            torch.optim.SGD([p], lr=0.1), compression="sparse:0.5")
        with pytest.raises(ValueError, match="neighbor_allreduce combiner"):
            opt.step()
    finally:
        tbf.shutdown()
    with pytest.raises(ValueError, match="neighbor_allreduce combiner"):
        JF.compress_combiner(lambda x, **kw: x, "sparse:0.5", residual=False)
