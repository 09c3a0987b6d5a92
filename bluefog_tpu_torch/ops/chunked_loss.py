"""Chunked softmax cross-entropy: an lm-head loss in O(chunk x vocab) memory.

The port of ``bluefog_tpu/ops/chunked_loss.py``.  The next-token loss is
computed without the full ``(B, S, vocab)`` logits: each chunk of sequence
positions is projected in float32, reduced to its per-row logsumexp minus the
correct-token logit, and dropped.  Each chunk runs under
``torch.utils.checkpoint``, so the backward recomputes its logits instead of
keeping them.  The result equals ``F.cross_entropy(h @ W.T, targets)`` up
to float32 summation order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_softmax_cross_entropy"]


def _chunk_loss(h_c, lm_head, t_c):
    logits = F.linear(h_c.float(), lm_head.float())           # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(-1, t_c[..., None])[..., 0]
    return (lse - correct).sum()


def chunked_softmax_cross_entropy(hidden, lm_head, targets, *,
                                  chunk: int = 1024):
    """Mean next-token cross-entropy over ``(B, S)`` without full logits.

    ``hidden``: ``(B, S, E)`` final-layer activations; ``lm_head``: the
    port's ``lm_head.weight``, ``(V, E)``, the transpose of the JAX
    package's ``(E, V)`` kernel; ``targets``: ``(B, S)`` int labels.  The
    chunk is the largest divisor of S that is at most ``chunk``, so an
    awkward S still gets the largest chunk that tiles it."""
    B, S, _ = hidden.shape
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    c = min(chunk, S)
    while S % c:
        c -= 1
    total = hidden.new_zeros((), dtype=torch.float32)
    for h_c, t_c in zip(hidden.split(c, dim=1), targets.split(c, dim=1)):
        total = total + checkpoint(_chunk_loss, h_c, lm_head, t_c.long(),
                                   use_reentrant=False)
    return total / (B * S)
