"""Ulysses-style all-to-all sequence parallelism.

The port of ``bluefog_tpu/parallel/ulysses.py``, the second long-context
strategy beside ``ring_attention``: instead of rotating K/V, transpose the
sharding with two all-to-alls, from sequence-sharded and head-replicated to
head-sharded with the whole sequence, run the attention per head group, and
transpose back.  The sequence axis is ``ring_attention``'s: an ``int``
(rank-major: the shards stacked on the batch dim in this process, where each
all-to-all is a permute of the shard and head dims) or an
``ops.p2p.ProcessRanks`` (``dist.all_to_all_single`` across the
processes).  Requires ``H % n == 0``.  Each move is one autograd node
(``_Move``) whose backward is the other move, its inverse and transpose;
the forward runs under the profiler range ``ulysses::scatter_heads`` or
``ulysses::gather_seq`` and the backward under the same name with
``_backward``, so a step profile (``profile_step``'s ``named_ops``) counts
the moves' copies.
"""

from __future__ import annotations

from functools import partial
from typing import Union

import torch
from torch.autograd.profiler import record_function

from bluefog_tpu_torch.models.transformer import local_attention
from bluefog_tpu_torch.ops.flash_attention import flash_attention
from bluefog_tpu_torch.ops.p2p import ProcessRanks
from bluefog_tpu_torch.parallel.ring_attention import sequence_axis

__all__ = ["ulysses_attention", "ulysses_attention_impl"]


def _scatter_heads(x, n, m, transport):
    """``(m * B, S, H, D)`` (sequence shards ``lo..lo+m-1``) -> ``(m * B,
    n * S, H / n, D)`` (head groups ``lo..lo+m-1``, the whole sequence)."""
    MB, S, H, D = x.shape
    B, g = MB // m, H // n
    # (group j, shard i, B, S, g, D): group j goes to the process owning j.
    y = x.reshape(m, B, S, n, g, D).permute(3, 0, 1, 2, 4, 5)
    P = 1 if transport is None else transport.nprocs
    if P > 1:
        y = transport.all_to_all(y)
    # (source process, my group, its shard, B, S, g, D)
    z = y.reshape(P, m, m, B, S, g, D)
    return z.permute(1, 3, 0, 2, 4, 5, 6).reshape(m * B, n * S, g, D)


def _gather_seq(y, n, m, transport):
    """The inverse of :func:`_scatter_heads`."""
    MB, nS, g, D = y.shape
    B, S = MB // m, nS // n
    P = 1 if transport is None else transport.nprocs
    # (process, my group, its shard, B, S, g, D): shards go to their owner.
    z = y.reshape(m, B, P, n // P, S, g, D).permute(2, 0, 3, 1, 4, 5, 6)
    if P > 1:
        z = transport.all_to_all(z)
    # (group j, shard i, B, S, g, D) -> (shard i, B, S, group j, g, D)
    w = z.reshape(n, m, B, S, g, D).permute(1, 2, 3, 0, 4, 5)
    return w.reshape(m * B, S, n * g, D)


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, move, inverse, x, n, m, transport):
        ctx.name, ctx.inverse, ctx.axis = name, inverse, (n, m, transport)
        with record_function(name):
            return move(x, n, m, transport)

    @staticmethod
    def backward(ctx, grad):
        with record_function(ctx.name + "_backward"):
            dx = ctx.inverse(grad, *ctx.axis)
        return None, None, None, dx, None, None, None


def ulysses_attention(q, k, v, *, axis: Union[int, ProcessRanks],
                      causal: bool = True, inner_attention=None):
    """All-to-all head-parallel attention over the sequence ``axis``;
    ``q``, ``k``, ``v`` and the output ``(m * B, S_local, H, D)`` as in
    ``ring_attention``.

    ``inner_attention(q, k, v, causal=...)`` runs on the gathered-sequence,
    sharded-head layout.  Default: the flash kernels (K1-K3) for CUDA
    tensors, where the gathered sequence is exactly where O(S) memory
    matters, and dense ``local_attention`` on the CPU, as the JAX package
    picks its Pallas kernel on the TPU only."""
    n, _, m, transport = sequence_axis(axis)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"num_heads {H} must be divisible by axis size {n}")
    inner = inner_attention or (flash_attention if q.is_cuda
                                else local_attention)
    qh, kh, vh = (_Move.apply("ulysses::scatter_heads", _scatter_heads,
                              _gather_seq, t, n, m, transport)
                  for t in (q, k, v))
    o = inner(qh, kh, vh, causal=causal)
    return _Move.apply("ulysses::gather_seq", _gather_seq, _scatter_heads, o,
                       n, m, transport)


def ulysses_attention_impl(axis: Union[int, ProcessRanks],
                           inner_attention=None):
    """An ``attn_impl`` for ``models.TransformerLM`` (see
    ``ring_attention_impl``)."""
    return partial(ulysses_attention, axis=axis,
                   inner_attention=inner_attention)
