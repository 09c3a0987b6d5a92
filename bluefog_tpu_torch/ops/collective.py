"""Collectives over rank-major tensors on one device.

The port's counterpart of ``bluefog_tpu/ops/collective.py`` (its dense and
neighbor families).  All ``n`` ranks live on one device, and rank ``i``'s
tensor is row ``i`` of a rank-major tensor of shape ``(n, ...)``.  Each
round's ``ppermute(x * send_scale)`` becomes an index gather over the leading
dim: receiver ``d`` takes ``x[src_of[d]] * send_scale[src_of[d]]``, and a rank
that receives nothing this round takes zeros.  The permuted terms are added
in the same balanced order as the JAX package, so float32 results agree bit
for bit.  The sparse exchange adds its rounds one after another onto the
self term, as the JAX package does, so it agrees bit for bit too.  A
``psum`` over the ranks becomes a sum over the leading dim, replicated to
every row; the machine x local mesh of ``local_allreduce`` is a reshape of
the leading dim into groups of ``local_size`` consecutive ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from bluefog_tpu_torch.ops.schedule import (DynamicSchedule,
                                            PairGossipSchedule,
                                            StaticSchedule)

__all__ = ["allreduce", "local_allreduce", "broadcast", "allgather",
           "neighbor_allgather", "neighbor_allreduce",
           "neighbor_allreduce_matrix", "dynamic_neighbor_allreduce",
           "sparse_neighbor_allreduce", "dynamic_sparse_neighbor_allreduce",
           "pair_gossip"]


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


def _gather_rows(scaled: torch.Tensor, rnd) -> torch.Tensor:
    """Receiver ``d`` takes row ``src_of[d]`` of ``scaled``; a rank without
    a source takes zeros (``ppermute``'s fill)."""
    src = torch.as_tensor(rnd.src_of, dtype=torch.long,
                          device=scaled.device)
    recv = scaled.index_select(0, src.clamp(min=0))
    if bool((rnd.src_of < 0).any()):
        silent = torch.as_tensor(rnd.src_of < 0, device=scaled.device)
        recv[silent] = 0
    return recv


def _receive(x: torch.Tensor, rnd) -> torch.Tensor:
    """One round's ``ppermute(x * send_scale)``: receiver ``d`` takes row
    ``src_of[d]`` of the scaled ``x``, a rank without a source zeros."""
    return _gather_rows(x * _per_rank(rnd.send_scale, x), rnd)


def _apply_rounds(x: torch.Tensor, sched: StaticSchedule) -> torch.Tensor:
    """``self_scale[i] * x_i + sum_r recv_r`` with weights applied at the
    sender, as ``bluefog_tpu.ops.collective._apply_rounds``."""
    _check_ranks(x, sched)
    terms = [x * _per_rank(sched.self_scale, x)]
    terms.extend(_receive(x, rnd) for rnd in sched.rounds)
    return _tree_sum(terms)


def _rank_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (rank) dim, one rank after another in rank
    order, a dtype narrower than float32 accumulated in float32 and
    rounded once: the order and precision of XLA's ``psum`` on the CPU, so
    float32 and bfloat16 sums agree with the JAX package bit for bit."""
    acc = x[0].to(torch.promote_types(x.dtype, torch.float32))
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc.to(x.dtype)


def allreduce(x: torch.Tensor, *, average: bool = True) -> torch.Tensor:
    """Every rank gets the rank sum, or with ``average`` the rank mean
    (``psum / n`` over the leading dim)."""
    s = _rank_sum(x)
    if average:
        s = s / x.shape[0]
    return s.expand_as(x).clone()


def local_allreduce(x: torch.Tensor, local_size: int, *,
                    average: bool = True) -> torch.Tensor:
    """:func:`allreduce` within each machine: the groups of ``local_size``
    consecutive ranks (the JAX package's machine x local mesh)."""
    n = x.shape[0]
    if local_size < 1 or n % local_size:
        raise ValueError(f"world size {n} is not divisible by local_size "
                         f"{local_size}")
    g = x.reshape((n // local_size, local_size) + x.shape[1:])
    s = _rank_sum(g.transpose(0, 1))
    if average:
        s = s / local_size
    return s.unsqueeze(1).expand_as(g).reshape(x.shape).clone()


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every rank gets ``root_rank``'s row."""
    if not 0 <= root_rank < x.shape[0]:
        raise ValueError(f"root_rank {root_rank} is not a rank of "
                         f"{x.shape[0]}")
    return x[root_rank:root_rank + 1].expand_as(x).clone()


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank gets the concatenation of all ranks' tensors along their
    first dim, in rank order: ``(n, d0, ...)`` -> ``(n, n * d0, ...)``."""
    if x.dim() < 2:
        raise ValueError("allgather concatenates along each rank's first "
                         f"dim; got a rank-major tensor of shape "
                         f"{tuple(x.shape)}")
    whole = x.reshape((1, -1) + tuple(x.shape[2:]))
    return whole.expand((x.shape[0],) + whole.shape[1:]).clone()


def neighbor_allreduce(x: torch.Tensor, sched: StaticSchedule) -> torch.Tensor:
    """Weighted neighbor averaging over a static topology:
    ``out_i = W[i,i] * x_i + sum_{j -> i} W[j,i] * x_j``."""
    return _apply_rounds(x, sched)


def neighbor_allreduce_matrix(x: torch.Tensor, w, sched: StaticSchedule
                              ) -> torch.Tensor:
    """Neighbor averaging with a runtime ``(n, n)`` weight matrix ``w``
    over the edges of ``sched``: ``w[s, d]`` scales the ``s -> d`` edge
    and ``w[i, i]`` is the self weight.  The weights are taken in float32
    and then in ``x``'s dtype, as the JAX package's traced matrix."""
    _check_ranks(x, sched)
    n = x.shape[0]
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device).to(x.dtype)
    shape = (-1,) + (1,) * (x.dim() - 1)
    ar = torch.arange(n, device=x.device)
    terms = [x * w[ar, ar].reshape(shape)]
    for rnd in sched.rounds:
        dst = torch.as_tensor(rnd.dst_of, dtype=torch.long, device=x.device)
        scale = torch.where(dst >= 0, w[ar, dst.clamp(min=0)],
                            torch.zeros((), dtype=x.dtype, device=x.device))
        terms.append(_gather_rows(x * scale.reshape(shape), rnd))
    return _tree_sum(terms)


def neighbor_allgather(x: torch.Tensor, sched: StaticSchedule
                       ) -> torch.Tensor:
    """Each rank's in-neighbors' tensors, unweighted: ``(n, max_indegree,
    ...)``, sources in ascending rank order, zeros in the tail slots of a
    rank with fewer in-neighbors."""
    _check_ranks(x, sched)
    n = x.shape[0]
    out = x.new_zeros((n, max(sched.max_indegree, 1)) + tuple(x.shape[1:]))
    ar = torch.arange(n, device=x.device)
    for rnd, slots in zip(sched.rounds, sched.slot_tables):
        slot = torch.as_tensor(slots, dtype=torch.long,
                               device=x.device).clamp(min=0)
        out[ar, slot] = out[ar, slot] + _gather_rows(x, rnd)
    return out


def pair_gossip(x: torch.Tensor, sched: PairGossipSchedule) -> torch.Tensor:
    """Two-rank exchange and average; a rank without a partner keeps its
    own value."""
    _check_ranks(x, sched)
    return x * _per_rank(sched.self_scale, x) + _receive(x, sched.round)


def dynamic_neighbor_allreduce(x: torch.Tensor, step: int,
                               sched: DynamicSchedule) -> torch.Tensor:
    """Neighbor averaging whose topology changes every step: step ``t``
    runs phase ``t % period``."""
    return _apply_rounds(x, sched.phases[int(step) % sched.period])


def sparse_neighbor_allreduce(x: torch.Tensor, sched: StaticSchedule, *,
                              k: Optional[int] = None,
                              indices: Optional[torch.Tensor] = None,
                              valid: Optional[torch.Tensor] = None,
                              aligned: bool = False,
                              return_sent: bool = False):
    """Weighted neighbor averaging of ``k`` entries a rank, as
    ``bluefog_tpu.ops.collective.sparse_neighbor_allreduce``.

    Each rank's payload is ``q_i = scatter_add(vals_i, pos_i)``, zeros
    elsewhere, and ``out_i = W[i,i] q_i + sum_{j -> i} W[j,i] q_j``, the
    rounds added one after another onto the self term.  ``pos_i`` is rank
    ``i``'s ``k`` largest magnitudes, or ``indices``: ``(k,)``, the same on
    every rank (the rotating block of ``compression="sparse:<frac>"``), or
    ``(n, k)``, one set a rank.  Without ``aligned`` each round sends the
    positions beside the values and receivers add at the sender's; with
    it (``indices`` the same on every rank) receivers add at their own.
    ``valid``: an optional ``(k,)`` or ``(n, k)`` mask that zeroes slots.
    A position picked twice adds twice, in ``q`` as at the receivers.
    ``return_sent=True`` also returns ``q``, against which a caller forms
    the residual ``x - q``."""
    _check_ranks(x, sched)
    if aligned and indices is None:
        raise ValueError("aligned=True requires caller-provided indices "
                         "(identical on every rank)")
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if indices is None:
        if k is None:
            raise ValueError("pass k= (top-k selection) or indices=")
        pos = flat.abs().topk(k, dim=1).indices
    else:
        pos = indices.to(device=x.device, dtype=torch.long)
    if pos.dim() == 1 and valid is None:
        # One index set for every rank: a receiver's positions are its own.
        vals = flat.index_select(1, pos)
        q = torch.zeros_like(flat).index_add_(1, pos, vals)
        out = q * _per_rank(sched.self_scale, q)
        for rnd in sched.rounds:
            out.index_add_(1, pos, _receive(vals, rnd))
    else:
        pos = pos.expand(n, -1)
        vals = flat.gather(1, pos)
        if valid is not None:
            vals = vals * valid.to(device=x.device, dtype=x.dtype)
        q = torch.zeros_like(flat).scatter_add_(1, pos, vals)
        out = q * _per_rank(sched.self_scale, q)
        for rnd in sched.rounds:
            rp = pos if aligned else _gather_rows(pos, rnd)
            out.scatter_add_(1, rp, _receive(vals, rnd))
    out = out.view(x.shape)
    return (out, q.view(x.shape)) if return_sent else out


def dynamic_sparse_neighbor_allreduce(x: torch.Tensor, step: int,
                                      sched: DynamicSchedule, *,
                                      indices: torch.Tensor,
                                      valid: Optional[torch.Tensor] = None,
                                      return_sent: bool = False):
    """The aligned sparse exchange over the one-peer walk: step ``t`` runs
    phase ``t % period``."""
    return sparse_neighbor_allreduce(
        x, sched.phases[int(step) % sched.period], indices=indices,
        valid=valid, aligned=True, return_sent=return_sent)
