"""dp x tp x pp (x ep) in one step: the compositions of
``__graft_entry__.dryrun_multichip`` (L258-380).

Each dp replica runs a 1F1B pipeline (``pipeline_train_step``, a rank-major
pp axis) of Megatron MLP stages: column-parallel in, ReLU, row-parallel out,
the tp shards rank-major and their partial products summed in rank order.
:func:`dp_tp_pp_ep_step` adds a switch-MoE sublayer to each stage whose
experts live on the same model-parallel ranks as the tp shards (``mp``, as on
8 devices there), through ``moe_apply``, with one router copy a rank.  After
an SGD step the replicas are combined over dp by the decentralized
``neighbor_allreduce`` (a uniform ring at dp 2, the exact average).

Rank-major every gradient is whole: the shards' sum and the experts' sum
are ordinary autograd, so the JAX package's replicated-loss division (by the
tp or mp axis size) has no counterpart here.  The router copies' gradients
are summed over the mp ranks, as the JAX package's ``psum``.
"""

from __future__ import annotations

import torch

from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.parallel.moe import moe_apply
from bluefog_tpu_torch.parallel.pipeline import pipeline_train_step

__all__ = ["dp_tp_pp_step", "dp_tp_pp_ep_step"]


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _tp_mlp(wi, wo, x):
    """A Megatron MLP over rank-major shards ``wi`` ``(tp, d, h / tp)`` and
    ``wo`` ``(tp, h / tp, d)``."""
    return C._rank_sum(torch.relu(x @ wi) @ wo)


def _step(stage_fn, params, microbatches, targets, lr, sched, pp, fix=None):
    dp = params[0].shape[0]
    new, losses = [], []
    for r in range(dp):
        mine = tuple(p[r] for p in params)
        loss, grads = pipeline_train_step(stage_fn, mine, microbatches[r],
                                          targets[r], _mse, axis=pp)
        if fix is not None:
            grads = fix(grads)
        new.append([p - lr * g for p, g in zip(mine, grads)])
        losses.append(loss)
    stacked = [torch.stack(ps) for ps in zip(*new)]
    return (tuple(C.neighbor_allreduce(p, sched) for p in stacked),
            torch.stack(losses))


def dp_tp_pp_step(params, microbatches, targets, *, lr: float, sched):
    """One step of dp x tp x pp: ``params`` ``(wi, wo)`` lead with ``(dp,
    pp, tp)`` (``wi`` ``(..., d, h / tp)``, ``wo`` ``(..., h / tp, d)``);
    ``microbatches`` and ``targets`` ``(dp, M, mb, d)``; ``sched`` the dp
    combine's static schedule.  Returns the combined parameters and each dp
    replica's loss (the mean squared error over its microbatches)."""
    return _step(lambda p, x: _tp_mlp(p[0], p[1], x), params, microbatches,
                 targets, lr, sched, params[0].shape[1])


def dp_tp_pp_ep_step(params, microbatches, targets, *, lr: float, sched,
                     capacity: int):
    """One step of dp x tp x pp x ep with tp and ep on one ``mp`` axis:
    ``params`` ``(wi, wo, we, wr)`` lead with ``(dp, pp, mp)``: the MLP's tp
    shards, rank ``k``'s expert ``we`` ``(..., d, d)`` (E = mp) and its
    router copy ``wr`` ``(..., d, E)``.  A stage is ``y + moe(y)`` with ``y``
    the MLP's output, the expert ``tanh(z @ w)``, ``capacity`` slots an
    expert.  Returns the combined parameters and each dp replica's loss."""
    mp = params[0].shape[2]

    def stage(p, x):
        wi, wo, we, wr = p
        y = _tp_mlp(wi, wo, x)
        y2 = moe_apply(lambda w, z: torch.tanh(z @ w[0]), (we,),
                       y.expand((mp,) + tuple(y.shape)), y @ wr,
                       capacity=capacity)
        return y + y2[0]

    def router_psum(grads):
        gwi, gwo, gwe, gwr = grads
        return gwi, gwo, gwe, gwr.sum(1, keepdim=True).expand(gwr.shape)
    return _step(stage, params, microbatches, targets, lr, sched,
                 params[0].shape[1], fix=router_psum)
