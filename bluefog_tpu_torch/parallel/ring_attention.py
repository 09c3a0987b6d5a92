"""Ring attention: exact attention over sequence-sharded Q/K/V.

The port of ``bluefog_tpu/parallel/ring_attention.py``.  Each sequence shard
holds a block of Q, K and V; for ``n`` hops it attends its Q block to the K/V
block it holds, merges the partial result into a running ``(output,
logsumexp)`` pair, and passes the K/V block one shard up the ring.  Every
hop's attention is ``ops.flash_attention.flash_attention_lse``: K1 forward,
K2 and K3 backward on the card, with K2 taking the merge's nonzero lse
cotangent; the plain twin on the CPU.  The partials merge by logsumexp
weighting in float32 (``_merge``), as the JAX package's.

With contiguous sharding and ``causal``, a hop is on-diagonal at hop 0
(causal flash), fully visible when the K/V block came from an earlier shard
(non-causal flash), or masked when it came from a later one: a masked hop is
skipped, contributing ``o = 0`` and ``lse = _NEG``, which the merge leaves
out exactly, so the shard's Q gets no gradient from it and that K/V block
none either.

The sequence axis is where the shards live:

- an ``int`` ``n``: **rank-major**, all ``n`` shards in this process,
  stacked on the batch dim (``(n * B, S / n, H, D)``, shard-major; see
  :func:`shard_sequence`).  Under ``causal`` a hop's attending shards
  ``t..`` hold shards ``..n - t``: a slice of K and V, no copy; without it
  the rotation is a roll by one shard.
- an ``ops.p2p.ProcessRanks`` (``basics.process_ranks()``): the shards are
  the world's ranks, each process holding its owned ranks' shards stacked
  the same way, and the rotation crosses processes by point-to-point
  messages; its backward sends the cotangent the other way, the transpose
  of the JAX package's ``ppermute``.  A world of one process holds every
  shard and takes the rank-major form.

Either way the shards that attend in a hop go to the kernels together: at
hop 0 every shard (causal), at hop ``t > 0`` the shards ``i >= t``
(non-causal; without ``causal``, every shard), stacked on the batch dim, so
a layer launches K1 ``n`` times forward, and K2 and K3 ``n`` times each
backward, and no masked block reaches a kernel.
"""

from __future__ import annotations

from functools import partial
from typing import Union

import torch

from bluefog_tpu_torch.ops.flash_attention import flash_attention_lse
from bluefog_tpu_torch.ops.p2p import ProcessRanks
from bluefog_tpu_torch.ops.p2p import shard_axis as sequence_axis

__all__ = ["ring_attention", "ring_attention_impl", "shard_sequence",
           "unshard_sequence", "sequence_axis"]

_NEG = -1e30  # finite "minus infinity": logaddexp/exp stay NaN-free


def shard_sequence(x: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, S, ...)`` -> ``(n * B, S / n, ...)``: the ``n`` contiguous
    sequence shards stacked on the batch dim, shard-major."""
    B, S = x.shape[:2]
    if S % n:
        raise ValueError(f"sequence length {S} does not split into {n} "
                         "shards")
    y = x.reshape((B, n, S // n) + tuple(x.shape[2:]))
    return y.transpose(0, 1).reshape((n * B, S // n) + tuple(x.shape[2:]))


def unshard_sequence(y: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of :func:`shard_sequence`."""
    B = y.shape[0] // n
    z = y.reshape((n, B) + tuple(y.shape[1:]))
    return z.transpose(0, 1).reshape((B, n * y.shape[1]) + tuple(y.shape[2:]))


def _merge(o, lse, o_h, lse_h):
    """Logsumexp-weighted merge of two normalized partial attentions.

    ``o``: (..., S, H, D) f32; ``lse``: (..., S, H) f32.  Rows that saw no
    keys carry lse ~ -1e30 and weight out to ~0."""
    lse_new = torch.logaddexp(lse, lse_h)
    safe = torch.clamp_min(lse_new, _NEG / 2)
    w, w_h = torch.exp(lse - safe), torch.exp(lse_h - safe)
    return o * w[..., None] + o_h * w_h[..., None], lse_new


def _flash(q, k, v, causal: bool):
    """``(o, lse)`` in float32 of shards ``(m, B, S, H, D)`` in one launch,
    the shards stacked on the batch dim."""
    m, B = q.shape[:2]
    flat = lambda t: t.reshape((m * B,) + tuple(t.shape[2:]))  # noqa: E731
    o, lse = flash_attention_lse(flat(q), flat(k), flat(v), causal=causal)
    return (o.float().reshape(q.shape),
            lse.reshape((m, B) + tuple(lse.shape[1:])))


def _kv_hops(k, v, n: int, causal: bool, transport):
    """The K/V each hop's attending shards hold, ``hop(t, start)`` for the
    shards ``start..`` of hop ``t``: shard ``g`` holds shard ``g - t``'s
    (mod ``n``).  Rank-major under ``causal`` the attending shards ``t..``
    hold shards ``..n - t``, a view; otherwise the blocks move one shard a
    hop, by a roll (rank-major) or ``ProcessRanks.ring``, the final
    rotation dead."""
    if transport is None and causal:
        return lambda t, start: (k[start - t:k.shape[0] - t],
                                 v[start - t:v.shape[0] - t])
    if transport is not None:
        hops = transport.ring(k, v, n)
    else:
        hops = [(k, v)]
        for _ in range(n - 1):
            hops.append(tuple(torch.roll(x, 1, 0) for x in hops[-1]))
    return lambda t, start: (hops[t][0][start:], hops[t][1][start:])


def ring_attention(q, k, v, *, axis: Union[int, ProcessRanks],
                   causal: bool = True):
    """Exact attention with K/V rotating around the sequence ``axis``.

    ``q``, ``k``, ``v``: ``(m * B, S_local, H, D)``, the ``m`` shards this
    process holds stacked on the batch dim (all ``n`` for a rank-major
    axis); the global sequence is the shards' concatenation in shard order.
    Returns the shards' outputs in the same layout and dtype."""
    n, lo, m, transport = sequence_axis(axis)
    if q.shape[0] % m:
        raise ValueError(f"leading dim {q.shape[0]} does not stack {m} "
                         "shards")
    shards = lambda t: t.reshape((m, q.shape[0] // m)  # noqa: E731
                                 + tuple(t.shape[1:]))
    q5 = shards(q)
    hop = _kv_hops(shards(k), shards(v), n, causal, transport)
    done = []
    o = lse = None
    first = 0                       # the first shard that still attends
    for t in range(n):
        # Hop t: shard g holds the K/V of shard g - t (mod n); under causal
        # the shards g >= t attend to it, the rest are masked.
        start = min(max(t - lo, 0), m) if causal and t else 0
        if start > first:           # these shards have seen every key
            done.append(o[:start - first])
            o, lse = o[start - first:], lse[start - first:]
            first = start
        if start < m:
            o_h, lse_h = _flash(q5[start:], *hop(t, start),
                                causal=causal and t == 0)
            # Hop 0 merged into the empty accumulator gives itself exactly.
            o, lse = (o_h, lse_h) if o is None else _merge(o, lse, o_h,
                                                           lse_h)
    out = torch.cat(done + [o]) if done else o
    return out.to(q.dtype).reshape(q.shape)


def ring_attention_impl(axis: Union[int, ProcessRanks]):
    """An ``attn_impl`` for ``models.TransformerLM``: the signature of
    ``models.local_attention``, sequence-parallel over ``axis``; the model
    runs on the shards stacked on the batch dim, each with its global
    positions (``TransformerLM(tokens, positions=...)``)."""
    return partial(ring_attention, axis=axis)
