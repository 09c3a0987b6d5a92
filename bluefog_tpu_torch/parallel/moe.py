"""Switch-routed mixture of experts: the routing plan and expert parallelism.

The port of ``bluefog_tpu/parallel/moe.py``, plain torch as it is plain
``jnp`` there.  Routing is top-1 (Switch Transformer) with a static capacity
per expert; tokens past an expert's capacity drop to zero.  The plan is built
from one-hot tensors, so ``TransformerLM``'s MoE blocks dispatch and combine
with matmuls (``models.transformer.SwitchMlp``).

:func:`moe_apply` is the expert-parallel layer.  Its expert axis has
``ops.p2p.shard_axis``'s form: rank-major on one device (row ``e`` of a ``(E,
...)`` tensor is rank ``e``, which applies its own expert, and the JAX
package's ``psum`` over the expert axis becomes ``ops.collective.
allreduce``'s sum over the leading dim, replicated to every row), or an
``ops.p2p.ProcessRanks``: each process holds its owned ranks' rows and
experts, sums them in rank order and adds the processes' sums with
``ProcessRanks.all_reduce``, the backward the same sum of the cotangents
(the JAX package's ``psum`` and its transpose).

Every function takes leading batch dims before ``(T, E)``: the routing
groups of ``SwitchMlp``, where the JAX package ``vmap``s.  The one-hot slot
of a token is built by comparison (``jax.nn.one_hot`` gives a zero row for
an index past the capacity, where ``F.one_hot`` raises): a token beyond its
expert's capacity has no slot.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.ops.p2p import ProcessRanks, shard_axis

__all__ = ["moe_apply", "switch_dispatch", "load_balance_loss"]


def _onehot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all-zero rows for indices outside ``[0, n)``."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(dtype)


def load_balance_loss(router_logits: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch Transformer load-balancing auxiliary loss (eq. 4):
    ``E * sum_e f_e * p_e`` over ``(..., T, E)`` logits, where ``f_e`` is the
    share of tokens whose top-1 choice is expert ``e`` (before capacity) and
    ``p_e`` the mean router probability; 1 at a perfectly uniform router.

    ``valid``: optional ``(..., T)`` {0, 1} mask; padding tokens count in
    neither statistic.  Returns one value per leading index."""
    E = router_logits.shape[-1]
    probs = torch.softmax(router_logits, dim=-1)
    routed = _onehot(probs.argmax(-1), E, probs.dtype)
    if valid is None:
        return E * (routed.mean(-2) * probs.mean(-2)).sum(-1)
    w = valid.to(probs.dtype)
    w = w / w.sum(-1, keepdim=True).clamp(min=1.0)
    f = (routed * w[..., None]).sum(-2)
    p = (probs * w[..., None]).sum(-2)
    return E * (f * p).sum(-1)


def _plan(router_logits: torch.Tensor, n_experts: int, capacity: int,
          valid: Optional[torch.Tensor] = None):
    """``(gate, keep, slot)`` of ``(..., T, E)`` logits: ``gate`` ``(..., T)``
    the router probability of each kept token, ``keep`` ``(..., T, E)`` its
    expert if within capacity, ``slot`` ``(..., T, C)`` its place in that
    expert's queue.  Masked-out tokens take no queue position."""
    E = router_logits.shape[-1]
    if E != n_experts:
        raise ValueError(
            f"router emits {E} expert logits but the layer has "
            f"{n_experts} experts")
    probs = torch.softmax(router_logits, dim=-1)
    onehot = _onehot(probs.argmax(-1), E, probs.dtype)
    if valid is not None:
        onehot = onehot * valid.to(probs.dtype)[..., None]
    # Position of each token within its expert's queue.
    pos = (onehot.cumsum(-2) - onehot) * onehot
    keep = (pos < capacity) * onehot
    slot = _onehot(pos.sum(-1), capacity, probs.dtype)
    gate = (probs * keep).sum(-1)
    return gate, keep, slot


def switch_dispatch(router_logits: torch.Tensor, n_experts: int,
                    capacity: int, valid: Optional[torch.Tensor] = None):
    """Top-1 dispatch plan ``(combine, dispatch)`` from ``(..., T, E)``
    logits: ``dispatch`` ``(..., E, C, T)`` one-hot, slot ``c`` of expert
    ``e`` takes token ``t``; ``combine`` ``(..., T, E, C)`` the same plan
    weighted by the router probability (the router's gradient path)."""
    gate, keep, slot = _plan(router_logits, n_experts, capacity, valid)
    dispatch = torch.einsum("...te,...tc->...ect", keep, slot)
    combine = torch.einsum("...t,...ect->...tec", gate, dispatch)
    return combine, dispatch


class _ExpertSum(torch.autograd.Function):
    """The expert-parallel ``psum`` across processes: every owned row gets
    the sum of the world's rows (this process's in rank order, in float32,
    then over the processes); its transpose is the same sum of the
    cotangents."""

    @staticmethod
    def _sum(x, transport):
        s = C._rank_sum(x, rounded=False)
        transport.all_reduce(s).wait()
        return s.to(x.dtype).expand(x.shape).clone()

    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return _ExpertSum._sum(x, transport)

    @staticmethod
    def backward(ctx, g):
        return _ExpertSum._sum(g, ctx.transport), None


def moe_apply(expert_fn: Callable, expert_params, x: torch.Tensor,
              router_logits: torch.Tensor, *,
              axis: Union[None, int, ProcessRanks] = None,
              capacity: Optional[int] = None, with_aux: bool = False):
    """An ``E``-rank MoE layer: ``x`` ``(m, T, d)`` tokens and
    ``router_logits`` ``(m, T, E)``, the same on every row (a replicated
    router), for the ``m`` ranks this process holds of the expert ``axis``
    (None: rank-major, every rank, ``E = x.shape[0]``); ``expert_params`` a
    tuple of tensors leading with the same ranks, row ``i`` the expert of
    rank ``lo + i``, applied as ``expert_fn(params_i, xe)``.  Returns ``(m, T,
    d)``, the gated sum of every expert's output on each row, or with
    ``with_aux=True`` also each row's load-balancing loss ``(m,)``.

    **Gradient convention** (the JAX package's): every rank computes the
    same loss from the summed output, and the sum's backward adds the
    ranks' cotangents, so divide each rank's objective by ``E``; each
    expert's gradient is then exact, and the router logits' gradient is
    exact once summed over the ranks."""
    E, lo, m, transport = shard_axis(x.shape[0] if axis is None else axis)
    if x.shape[0] != m:
        raise ValueError(f"x leads with {x.shape[0]} rows; this process "
                         f"holds {m} ranks of the expert axis")
    T = x.shape[1]
    if capacity is None:
        capacity = max(1, (2 * T) // E)
    parts = []
    for i in range(m):
        gate, keep, slot = _plan(router_logits[i], E, capacity)
        my_keep = keep[:, lo + i]
        # The plan in the tokens' dtype, as SwitchMlp casts its dispatch
        # (a no-op in float32).
        xe = (slot.T * my_keep[None, :]).to(x.dtype) @ x[i]       # (C, d)
        ye = expert_fn(tuple(p[i] for p in expert_params), xe)   # (C, d)
        parts.append(((gate * my_keep)[:, None] * slot).to(ye.dtype)
                     @ ye)                                       # (T, d)
    parts = torch.stack(parts)
    y = (C.allreduce(parts, average=False) if transport is None
         else _ExpertSum.apply(parts, transport))
    if with_aux:
        return y, load_balance_loss(router_logits)
    return y
