"""Neighbor collectives over rank-major tensors on one device.

The port's counterpart of the neighbor family in ``bluefog_tpu/ops/
collective.py``.  All ``n`` ranks live on one device, and rank ``i``'s tensor
is row ``i`` of a rank-major tensor of shape ``(n, ...)``.  Each round's
``ppermute(x * send_scale)`` becomes an index gather over the leading dim:
receiver ``d`` takes ``x[src_of[d]] * send_scale[src_of[d]]``, and a rank that
receives nothing this round takes zeros.  The permuted terms are added in the
same balanced order as the JAX package, so float32 results agree bit for bit.
The sparse exchange adds its rounds one after another onto the self term,
as the JAX package does, so it agrees bit for bit too.
"""

from __future__ import annotations

import torch

from bluefog_tpu_torch.ops.schedule import DynamicSchedule, StaticSchedule

__all__ = ["allreduce", "neighbor_allreduce", "dynamic_neighbor_allreduce",
           "sparse_neighbor_allreduce", "dynamic_sparse_neighbor_allreduce"]


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


def _check_ranks(x: torch.Tensor, sched: StaticSchedule) -> None:
    if x.shape[0] != sched.n:
        raise ValueError(f"rank-major tensor has leading dim {x.shape[0]}, "
                         f"the schedule has {sched.n} ranks")


def _receive(x: torch.Tensor, rnd) -> torch.Tensor:
    """One round's ``ppermute(x * send_scale)``: receiver ``d`` takes row
    ``src_of[d]`` of the scaled ``x``, a rank without a source zeros."""
    scaled = x * _per_rank(rnd.send_scale, x)
    src = torch.as_tensor(rnd.src_of, dtype=torch.long, device=x.device)
    recv = scaled.index_select(0, src.clamp(min=0))
    if bool((rnd.src_of < 0).any()):
        silent = torch.as_tensor(rnd.src_of < 0, device=x.device)
        recv[silent] = 0
    return recv


def _apply_rounds(x: torch.Tensor, sched: StaticSchedule) -> torch.Tensor:
    """``self_scale[i] * x_i + sum_r recv_r`` with weights applied at the
    sender, as ``bluefog_tpu.ops.collective._apply_rounds``."""
    _check_ranks(x, sched)
    terms = [x * _per_rank(sched.self_scale, x)]
    terms.extend(_receive(x, rnd) for rnd in sched.rounds)
    return _tree_sum(terms)


def allreduce(x: torch.Tensor) -> torch.Tensor:
    """Every rank gets the rank mean (``psum / n`` over the leading dim)."""
    return (x.sum(0, keepdim=True) / x.shape[0]).expand_as(x).clone()


def neighbor_allreduce(x: torch.Tensor, sched: StaticSchedule) -> torch.Tensor:
    """Weighted neighbor averaging over a static topology:
    ``out_i = W[i,i] * x_i + sum_{j -> i} W[j,i] * x_j``."""
    return _apply_rounds(x, sched)


def dynamic_neighbor_allreduce(x: torch.Tensor, step: int,
                               sched: DynamicSchedule) -> torch.Tensor:
    """Neighbor averaging whose topology changes every step: step ``t``
    runs phase ``t % period``."""
    return _apply_rounds(x, sched.phases[int(step) % sched.period])


def sparse_neighbor_allreduce(x: torch.Tensor, sched: StaticSchedule, *,
                              indices: torch.Tensor,
                              return_sent: bool = False):
    """Weighted neighbor averaging of the entries at ``indices`` only: the
    aligned-indices mode of ``bluefog_tpu.ops.collective.
    sparse_neighbor_allreduce``, where every rank sends the same ``(k,)``
    index set (the rotating block of ``compression="sparse:<frac>"``).

    Each rank's payload is ``q_i = scatter(x_i[indices])``, zeros elsewhere,
    and ``out_i = W[i,i] q_i + sum_{j -> i} W[j,i] q_j``, the rounds added
    one after another onto the self term.  ``return_sent=True`` also
    returns ``q``, against which a caller forms the residual ``x - q``."""
    _check_ranks(x, sched)
    n = x.shape[0]
    flat = x.reshape(n, -1)
    pos = indices.to(device=x.device, dtype=torch.long)
    vals = flat.index_select(1, pos)
    q = torch.zeros_like(flat).index_add_(1, pos, vals)
    out = q * _per_rank(sched.self_scale, q)
    for rnd in sched.rounds:
        out.index_add_(1, pos, _receive(vals, rnd))
    out = out.view(x.shape)
    return (out, q.view(x.shape)) if return_sent else out


def dynamic_sparse_neighbor_allreduce(x: torch.Tensor, step: int,
                                      sched: DynamicSchedule, *,
                                      indices: torch.Tensor,
                                      return_sent: bool = False):
    """The sparse exchange over the one-peer walk: step ``t`` runs phase
    ``t % period``."""
    return sparse_neighbor_allreduce(
        x, sched.phases[int(step) % sched.period], indices=indices,
        return_sent=return_sent)
