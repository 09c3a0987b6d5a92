"""The port's distributed optimizers against the JAX package's on a
two-leaf parameter set, with per-rank gradients made from a seed.

Several leaves take the raveled (non-single-buffer) path of the fused
combine.  Tolerance 1e-6: float32, the same arithmetic in both; static
rounds may be summed in another order (no schedule_opt repack)."""

import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.optim import optimizers as TO

N, STEPS, LR, MOMENTUM = 4, 5, 0.05, 0.9
SHAPES = {"b": (7,), "w": (5, 3)}


def _grads(seed):
    rng = np.random.RandomState(seed)
    return [{k: rng.randn(N, *s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(STEPS)]


def _run_jax(devices, params, grads, comm, kw):
    jbf.init(devices=devices[:N])
    kw.pop("halves", False)
    if kw.pop("exp2_phases", False):
        kw["phases"] = jtopo.one_peer_exp2_phases(N)
    opt = jbf.optim.DistributedOptimizer(
        optax.sgd(LR, momentum=MOMENTUM), comm, **kw)
    state = opt.init(params)
    for g in grads:
        params, state = opt.step(params, g, state)
    return {k: np.asarray(v) for k, v in params.items()}


def _run_port(params, grads, comm, kw):
    tbf.init(N, device="cpu")
    try:
        halves = kw.pop("halves", False)
        if kw.pop("exp2_phases", False):
            kw["phases"] = ttopo.one_peer_exp2_phases(N)
        ts = {k: torch.tensor(v) for k, v in params.items()}
        base = torch.optim.SGD(list(ts.values()), lr=LR, momentum=MOMENTUM,
                               dampening=0)
        opt = TO.DistributedOptimizer(base, comm, **kw)
        for g in grads:
            for k, t in ts.items():
                t.grad = torch.from_numpy(g[k])
            if halves:
                opt.adapt()
                opt.combine()
            else:
                opt.step()
        assert opt.step_count == STEPS
        return {k: t.numpy() for k, t in ts.items()}
    finally:
        tbf.shutdown()


CASES = {
    "atc-dynamic": ("neighbor.allreduce",
                    dict(order="atc", use_dynamic_topology=True)),
    # The benchmark's observed step: adapt(), read, combine().
    "atc-dynamic-halves": ("neighbor.allreduce",
                           dict(order="atc", use_dynamic_topology=True,
                                halves=True)),
    "awc-dynamic": ("neighbor.allreduce",
                    dict(order="awc", use_dynamic_topology=True)),
    "atc-exp2-phases": ("neighbor.allreduce",
                        dict(order="atc", use_dynamic_topology=True,
                             exp2_phases=True)),
    "atc-static": ("neighbor.allreduce", dict(order="atc")),
    "awc-static-unfused": ("neighbor.allreduce",
                           dict(order="awc", fusion=False)),
    "atc-dynamic-unfused": ("neighbor.allreduce",
                            dict(order="atc", use_dynamic_topology=True,
                                 fusion=False)),
    "atc-every-2nd-step": ("neighbor.allreduce",
                           dict(order="atc", use_dynamic_topology=True,
                                num_steps_per_communication=2)),
    "awc-every-3rd-step": ("neighbor.allreduce",
                           dict(order="awc", num_steps_per_communication=3)),
    "empty": ("empty", dict(order="atc")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(devices, case):
    comm, kw = CASES[case]
    rng = np.random.RandomState(1)
    params = {k: rng.randn(N, *s).astype(np.float32) for k, s in SHAPES.items()}
    grads = _grads(2)
    want = _run_jax(devices, dict(params), grads, comm, dict(kw))
    got = _run_port(params, grads, comm, dict(kw))
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    if comm == "empty":
        # No communication: every rank followed its own gradients.
        assert np.ptp(got["w"], axis=0).max() > 1e-2


def test_refuses_params_that_are_not_rank_major():
    tbf.init(N, device="cpu")
    try:
        p = torch.zeros(N + 1, 3)
        p.grad = torch.zeros_like(p)
        opt = TO.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD([p], lr=0.1))
        with pytest.raises(ValueError, match="rank-major"):
            opt.step()
    finally:
        tbf.shutdown()


def test_functional_atc_step_matches_optimizer():
    """``functional.atc_step`` (the functional API) and the optimizer's ATC
    step give the same parameters, bit for bit."""
    from bluefog_tpu_torch.optim import functional as TF
    rng = np.random.RandomState(1)
    params = {k: rng.randn(N, *s).astype(np.float32) for k, s in SHAPES.items()}
    grads = _grads(2)
    want = _run_port(params, grads, "neighbor.allreduce",
                     dict(order="atc", use_dynamic_topology=True))
    tbf.init(N, device="cpu")
    try:
        ts = [torch.tensor(params[k]) for k in SHAPES]
        base = torch.optim.SGD(ts, lr=LR, momentum=MOMENTUM, dampening=0)
        combine = TF.make_combiner(TF.CommunicationType.neighbor_allreduce,
                                   dyn_sched=tbf.basics.dynamic_schedule())
        step = 0
        for g in grads:
            for k, t in zip(SHAPES, ts):
                t.grad = torch.from_numpy(g[k])
            step = TF.atc_step(base, combine, ts, step)
        assert step == STEPS
    finally:
        tbf.shutdown()
    for k, t in zip(SHAPES, ts):
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
