"""Neighbor collectives over rank-major tensors on one device.

The port's counterpart of the neighbor family in ``bluefog_tpu/ops/
collective.py``.  All ``n`` ranks live on one device, and rank ``i``'s tensor
is row ``i`` of a rank-major tensor of shape ``(n, ...)``.  Each round's
``ppermute(x * send_scale)`` becomes an index gather over the leading dim:
receiver ``d`` takes ``x[src_of[d]] * send_scale[src_of[d]]``, and a rank that
receives nothing this round takes zeros.  The permuted terms are added in the
same balanced order as the JAX package, so float32 results agree bit for bit.
"""

from __future__ import annotations

import torch

from bluefog_tpu_torch.ops.schedule import DynamicSchedule, StaticSchedule

__all__ = ["neighbor_allreduce", "dynamic_neighbor_allreduce"]


def _tree_sum(terms: list) -> torch.Tensor:
    """Balanced pairwise sum, in the JAX package's order."""
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _per_rank(vec, x: torch.Tensor) -> torch.Tensor:
    """(n,) host weights as a tensor of ``x``'s dtype that broadcasts over
    every trailing dim of the rank-major ``x``."""
    t = torch.as_tensor(vec, dtype=x.dtype, device=x.device)
    return t.reshape((-1,) + (1,) * (x.dim() - 1))


def _apply_rounds(x: torch.Tensor, sched: StaticSchedule) -> torch.Tensor:
    """``self_scale[i] * x_i + sum_r recv_r`` with weights applied at the
    sender, as ``bluefog_tpu.ops.collective._apply_rounds``."""
    if x.shape[0] != sched.n:
        raise ValueError(f"rank-major tensor has leading dim {x.shape[0]}, "
                         f"the schedule has {sched.n} ranks")
    terms = [x * _per_rank(sched.self_scale, x)]
    for rnd in sched.rounds:
        scaled = x * _per_rank(rnd.send_scale, x)
        src = torch.as_tensor(rnd.src_of, dtype=torch.long, device=x.device)
        recv = scaled.index_select(0, src.clamp(min=0))
        if bool((rnd.src_of < 0).any()):
            silent = torch.as_tensor(rnd.src_of < 0, device=x.device)
            recv[silent] = 0
        terms.append(recv)
    return _tree_sum(terms)


def neighbor_allreduce(x: torch.Tensor, sched: StaticSchedule) -> torch.Tensor:
    """Weighted neighbor averaging over a static topology:
    ``out_i = W[i,i] * x_i + sum_{j -> i} W[j,i] * x_j``."""
    return _apply_rounds(x, sched)


def dynamic_neighbor_allreduce(x: torch.Tensor, step: int,
                               sched: DynamicSchedule) -> torch.Tensor:
    """Neighbor averaging whose topology changes every step: step ``t``
    runs phase ``t % period``."""
    return _apply_rounds(x, sched.phases[int(step) % sched.period])
