"""Collectives over rank-major tensors.

The port's counterpart of ``bluefog_tpu/ops/collective.py`` (its dense and
neighbor families).  Rank ``i``'s tensor is row ``i`` of a rank-major tensor
of shape ``(n, ...)``.  In one process every rank lives on one device; with
a transport (``comm``, an ``ops.p2p.ProcessRanks``) each process holds the
rows of the ranks it owns, and the leading dim is their count.

Each round's ``ppermute(x * send_scale)`` becomes an exchange of rows:
receiver ``d`` takes ``x[src_of[d]] * send_scale[src_of[d]]``, scaled at the
sender, and a rank that receives nothing this round takes zeros.  In one
process the exchange is an index gather over the leading dim; across
processes the rows whose source another process owns arrive by
point-to-point messages (``ProcessRanks.exchange``), the rest by the same
local gather.  The terms are added in the same balanced order as the JAX
package either way, so float32 results agree bit for bit.  The sparse
exchange adds its rounds one after another onto the self term, as the JAX
package does, so it agrees bit for bit too.  A ``psum`` over the ranks
becomes a sum over the leading dim in rank order, replicated to every row;
across processes each process sums its owned rows so, in float32, and
``dist.all_reduce`` adds the processes' sums in the library's order: one
row of memory, and the result within float32 rounding of the
single-process one (the same bits on every process).  The machine x local
mesh of ``local_allreduce`` is a reshape of the leading dim into groups of
``local_size`` consecutive ranks; a group that one process owns whole is
summed there, bit for bit the single-process sum.

Every op takes ``async_op``: with it, the op returns an
``ops.p2p.Pending`` whose ``wait()`` gives the result (the
``*_nonblocking`` handles); without it, the result.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from bluefog_tpu_torch.ops.p2p import Pending, ProcessRanks
from bluefog_tpu_torch.ops.schedule import (DynamicSchedule,
                                            PairGossipSchedule,
                                            StaticSchedule, lift_schedule)

__all__ = ["allreduce", "local_allreduce", "broadcast", "allgather",
           "neighbor_allgather", "neighbor_allreduce",
           "neighbor_allreduce_matrix", "dynamic_neighbor_allreduce",
           "sparse_neighbor_allreduce", "dynamic_sparse_neighbor_allreduce",
           "pair_gossip", "hierarchical_neighbor_allreduce",
           "dynamic_hierarchical_neighbor_allreduce", "hierarchical_gossip"]


def _tree_sum(terms: list) -> torch.Tensor:
    """Balanced pairwise sum, in the JAX package's order."""
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _result(p: Pending, async_op: bool):
    return p if async_op else p.wait()


def _owned(vec, comm: Optional[ProcessRanks]):
    """The owned ranks' entries of a host ``(n,)`` per-rank table."""
    return vec if comm is None else vec[comm.lo:comm.hi]


def _per_rank(vec, x: torch.Tensor,
              comm: Optional[ProcessRanks] = None) -> torch.Tensor:
    """(n,) host weights, the owned ranks' part, as a tensor of ``x``'s
    dtype that broadcasts over every trailing dim of the rank-major ``x``."""
    t = torch.as_tensor(_owned(vec, comm), dtype=x.dtype, device=x.device)
    return t.reshape((-1,) + (1,) * (x.dim() - 1))


def _check_ranks(x: torch.Tensor, sched: StaticSchedule,
                 comm: Optional[ProcessRanks] = None) -> None:
    if comm is not None and comm.n != sched.n:
        raise ValueError(f"the schedule has {sched.n} ranks, the world "
                         f"{comm.n}")
    rows = sched.n if comm is None else comm.hi - comm.lo
    if x.shape[0] != rows:
        raise ValueError(f"rank-major tensor has leading dim {x.shape[0]}, "
                         f"expected {rows} (the schedule's {sched.n} ranks"
                         f"{'' if comm is None else ' this process owns'})")


def _gather_rows(rows: torch.Tensor, rnd) -> torch.Tensor:
    """Receiver ``d`` takes row ``src_of[d]`` of ``rows``; a rank without a
    source takes zeros (``ppermute``'s fill)."""
    src = torch.as_tensor(rnd.src_of, dtype=torch.long, device=rows.device)
    recv = rows.index_select(0, src.clamp(min=0))
    if bool((rnd.src_of < 0).any()):
        silent = torch.as_tensor(rnd.src_of < 0, device=rows.device)
        recv[silent] = 0
    return recv


def _exchange(rounds, payloads, comm: Optional[ProcessRanks]) -> Pending:
    """A round's ``ppermute`` of each tensor in ``payloads[r]``: a list, a
    round, of what the owned ranks receive (see ``ProcessRanks.exchange``).
    In one process it is done at once."""
    if comm is None:
        return Pending.done([[_gather_rows(t, rnd) for t in payload]
                             for rnd, payload in zip(rounds, payloads)])
    return comm.exchange(rounds, payloads)


def _apply_rounds(x: torch.Tensor, sched: StaticSchedule,
                  comm: Optional[ProcessRanks] = None) -> Pending:
    """``self_scale[i] * x_i + sum_r recv_r`` with weights applied at the
    sender, as ``bluefog_tpu.ops.collective._apply_rounds``."""
    _check_ranks(x, sched, comm)
    self_term = x * _per_rank(sched.self_scale, x, comm)
    recv = _exchange(sched.rounds,
                     [[x * _per_rank(rnd.send_scale, x, comm)]
                      for rnd in sched.rounds], comm)
    return recv.then(lambda r: _tree_sum([self_term] + [t for t, in r]))


def _rank_sum(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """Sum over the leading (rank) dim, one rank after another in rank
    order, a dtype narrower than float32 accumulated in float32 and
    rounded once (or, without ``rounded``, the float32 accumulator, a
    tensor of its own): the order and precision of XLA's ``psum`` on the
    CPU, so float32 and bfloat16 sums agree with the JAX package bit for
    bit."""
    acc = x[0].to(torch.promote_types(x.dtype, torch.float32),
                  copy=not rounded)
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc.to(x.dtype) if rounded else acc


def allreduce(x: torch.Tensor, *, average: bool = True,
              comm: Optional[ProcessRanks] = None, async_op: bool = False):
    """Every rank gets the rank sum, or with ``average`` the rank mean
    (``psum / n`` over the ranks)."""
    rows = x.shape[0]
    n = rows if comm is None else comm.n
    if comm is None:
        p = Pending.done(_rank_sum(x))
    else:
        p = comm.all_reduce(_rank_sum(x, rounded=False)).then(
            lambda s: s.to(x.dtype))

    def finish(s):
        if average:
            s = s / n
        return s.expand((rows,) + s.shape).clone()
    return _result(p.then(finish), async_op)


def local_allreduce(x: torch.Tensor, local_size: int, *,
                    average: bool = True,
                    comm: Optional[ProcessRanks] = None,
                    async_op: bool = False):
    """:func:`allreduce` within each machine: the groups of ``local_size``
    consecutive ranks (the JAX package's machine x local mesh)."""
    rows = x.shape[0]
    n, lo = (rows, 0) if comm is None else (comm.n, comm.lo)
    if local_size < 1 or n % local_size:
        raise ValueError(f"world size {n} is not divisible by "
                         f"local_size {local_size}")
    if lo % local_size == 0 and rows % local_size == 0:
        # Every group with a rank here is owned whole.
        first = lo // local_size
        g = x.reshape((rows // local_size, local_size) + x.shape[1:])
        p = Pending.done(_rank_sum(g.transpose(0, 1)))
    else:
        # Groups span processes: each adds its part of every group's sum.
        first = 0
        part = x.new_zeros((n // local_size,) + x.shape[1:],
                           dtype=torch.promote_types(x.dtype, torch.float32))
        for grp in range(lo // local_size, (lo + rows - 1) // local_size + 1):
            a = max(grp * local_size, lo) - lo
            b = min((grp + 1) * local_size, lo + rows) - lo
            part[grp] = _rank_sum(x[a:b], rounded=False)
        p = comm.all_reduce(part).then(lambda s: s.to(x.dtype))

    def finish(s):
        if average:
            s = s / local_size
        grp = torch.arange(lo, lo + rows, device=x.device) // local_size
        return s.index_select(0, grp - first)
    return _result(p.then(finish), async_op)


def broadcast(x: torch.Tensor, root_rank: int, *,
              comm: Optional[ProcessRanks] = None, async_op: bool = False):
    """Every rank gets ``root_rank``'s row."""
    if comm is None:
        if not 0 <= root_rank < x.shape[0]:
            raise ValueError(f"root_rank {root_rank} is not a rank of "
                             f"{x.shape[0]}")
        p = Pending.done(x[root_rank])
    else:
        p = comm.broadcast(x, root_rank)
    return _result(p.then(lambda row: row.expand_as(x).clone()), async_op)


def allgather(x: torch.Tensor, *, comm: Optional[ProcessRanks] = None,
              async_op: bool = False):
    """Every rank gets the concatenation of all ranks' tensors along their
    first dim, in rank order: ``(n, d0, ...)`` -> ``(n, n * d0, ...)``."""
    if x.dim() < 2:
        raise ValueError("allgather concatenates along each rank's first "
                         f"dim; got a rank-major tensor of shape "
                         f"{tuple(x.shape)}")
    rows = x.shape[0]

    def finish(whole):
        flat = whole.reshape((1, -1) + tuple(whole.shape[2:]))
        return flat.expand((rows,) + flat.shape[1:]).clone()
    whole = Pending.done(x) if comm is None else comm.all_gather(x)
    return _result(whole.then(finish), async_op)


def neighbor_allreduce(x: torch.Tensor, sched: StaticSchedule, *,
                       comm: Optional[ProcessRanks] = None,
                       async_op: bool = False):
    """Weighted neighbor averaging over a static topology:
    ``out_i = W[i,i] * x_i + sum_{j -> i} W[j,i] * x_j``."""
    return _result(_apply_rounds(x, sched, comm), async_op)


def neighbor_allreduce_matrix(x: torch.Tensor, w, sched: StaticSchedule, *,
                              comm: Optional[ProcessRanks] = None,
                              async_op: bool = False):
    """Neighbor averaging with a runtime ``(n, n)`` weight matrix ``w``
    over the edges of ``sched``: ``w[s, d]`` scales the ``s -> d`` edge
    and ``w[i, i]`` is the self weight.  The weights are taken in float32
    and then in ``x``'s dtype, as the JAX package's traced matrix."""
    _check_ranks(x, sched, comm)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device).to(x.dtype)
    shape = (-1,) + (1,) * (x.dim() - 1)
    lo = 0 if comm is None else comm.lo
    own = torch.arange(lo, lo + x.shape[0], device=x.device)
    self_term = x * w[own, own].reshape(shape)
    sends = []
    for rnd in sched.rounds:
        dst = torch.as_tensor(_owned(rnd.dst_of, comm), dtype=torch.long,
                              device=x.device)
        scale = torch.where(dst >= 0, w[own, dst.clamp(min=0)],
                            torch.zeros((), dtype=x.dtype, device=x.device))
        sends.append([x * scale.reshape(shape)])
    recv = _exchange(sched.rounds, sends, comm)
    return _result(recv.then(
        lambda r: _tree_sum([self_term] + [t for t, in r])), async_op)


def neighbor_allgather(x: torch.Tensor, sched: StaticSchedule, *,
                       comm: Optional[ProcessRanks] = None,
                       async_op: bool = False):
    """Each rank's in-neighbors' tensors, unweighted: ``(n, max_indegree,
    ...)``, sources in ascending rank order, zeros in the tail slots of a
    rank with fewer in-neighbors."""
    _check_ranks(x, sched, comm)
    rows = x.shape[0]
    ar = torch.arange(rows, device=x.device)

    def finish(recv):
        out = x.new_zeros((rows, max(sched.max_indegree, 1))
                          + tuple(x.shape[1:]))
        for (got,), slots in zip(recv, sched.slot_tables):
            slot = torch.as_tensor(_owned(slots, comm), dtype=torch.long,
                                   device=x.device).clamp(min=0)
            out[ar, slot] = out[ar, slot] + got
        return out
    return _result(_exchange(sched.rounds, [[x]] * len(sched.rounds),
                             comm).then(finish), async_op)


def pair_gossip(x: torch.Tensor, sched: PairGossipSchedule, *,
                comm: Optional[ProcessRanks] = None, async_op: bool = False):
    """Two-rank exchange and average; a rank without a partner keeps its
    own value."""
    _check_ranks(x, sched, comm)
    rnd = sched.round
    self_term = x * _per_rank(sched.self_scale, x, comm)
    recv = _exchange([rnd], [[x * _per_rank(rnd.send_scale, x, comm)]], comm)
    return _result(recv.then(lambda r: self_term + r[0][0]), async_op)


def dynamic_neighbor_allreduce(x: torch.Tensor, step: int,
                               sched: DynamicSchedule, *,
                               comm: Optional[ProcessRanks] = None,
                               async_op: bool = False):
    """Neighbor averaging whose topology changes every step: step ``t``
    runs phase ``t % period``."""
    return _result(_apply_rounds(x, sched.phases[int(step) % sched.period],
                                 comm), async_op)


def sparse_neighbor_allreduce(x: torch.Tensor, sched: StaticSchedule, *,
                              k: Optional[int] = None,
                              indices: Optional[torch.Tensor] = None,
                              valid: Optional[torch.Tensor] = None,
                              aligned: bool = False,
                              return_sent: bool = False,
                              comm: Optional[ProcessRanks] = None):
    """Weighted neighbor averaging of ``k`` entries a rank, as
    ``bluefog_tpu.ops.collective.sparse_neighbor_allreduce``.

    Each rank's payload is ``q_i = scatter_add(vals_i, pos_i)``, zeros
    elsewhere, and ``out_i = W[i,i] q_i + sum_{j -> i} W[j,i] q_j``, the
    rounds added one after another onto the self term.  ``pos_i`` is rank
    ``i``'s ``k`` largest magnitudes, or ``indices``: ``(k,)``, the same on
    every rank (the rotating block of ``compression="sparse:<frac>"``), or
    ``(n, k)``, one set a rank (the owned ranks' rows with a transport).
    Each round sends the ``(k,)`` values; without ``aligned`` it sends the
    positions beside them and receivers add at the sender's; with it
    (``indices`` the same on every rank) receivers add at their own.
    ``valid``: an optional ``(k,)`` or ``(n, k)`` mask that zeroes slots.
    A position picked twice adds twice, in ``q`` as at the receivers.
    ``return_sent=True`` also returns ``q``, against which a caller forms
    the residual ``x - q``."""
    _check_ranks(x, sched, comm)
    if aligned and indices is None:
        raise ValueError("aligned=True requires caller-provided indices "
                         "(identical on every rank)")
    rows = x.shape[0]
    flat = x.reshape(rows, -1)
    if indices is None:
        if k is None:
            raise ValueError("pass k= (top-k selection) or indices=")
        pos = flat.abs().topk(k, dim=1).indices
    else:
        pos = indices.to(device=x.device, dtype=torch.long)
    send = [rnd.send_scale for rnd in sched.rounds]
    if pos.dim() == 1 and valid is None:
        # One index set for every rank: a receiver's positions are its own.
        vals = flat.index_select(1, pos)
        q = torch.zeros_like(flat).index_add_(1, pos, vals)
        out = q * _per_rank(sched.self_scale, q, comm)
        recv = _exchange(sched.rounds, [[vals * _per_rank(s, vals, comm)]
                                        for s in send], comm).wait()
        for (rv,) in recv:
            out.index_add_(1, pos, rv)
    else:
        pos = pos.expand(rows, -1)
        vals = flat.gather(1, pos)
        if valid is not None:
            vals = vals * valid.to(device=x.device, dtype=x.dtype)
        q = torch.zeros_like(flat).scatter_add_(1, pos, vals)
        out = q * _per_rank(sched.self_scale, q, comm)
        payloads = [[vals * _per_rank(s, vals, comm)]
                    + ([] if aligned else [pos.contiguous()]) for s in send]
        for got in _exchange(sched.rounds, payloads, comm).wait():
            out.scatter_add_(1, pos if aligned else got[1], got[0])
    out = out.view(x.shape)
    return (out, q.view(x.shape)) if return_sent else out


def dynamic_sparse_neighbor_allreduce(x: torch.Tensor, step: int,
                                      sched: DynamicSchedule, *,
                                      indices: torch.Tensor,
                                      valid: Optional[torch.Tensor] = None,
                                      return_sent: bool = False,
                                      comm: Optional[ProcessRanks] = None):
    """The aligned sparse exchange over the one-peer walk: step ``t`` runs
    phase ``t % period``."""
    return sparse_neighbor_allreduce(
        x, sched.phases[int(step) % sched.period], indices=indices,
        valid=valid, aligned=True, return_sent=return_sent, comm=comm)


# ---------------------------------------------------------------------------
# Hierarchical family (the machine x local mesh)
# ---------------------------------------------------------------------------
# The JAX package's two-axis mesh is a reshape of the rank-major leading dim
# into ``(machines, local_size)``: rank ``m * local_size + l`` is local rank
# ``l`` of machine ``m``.  A collective over one axis is the level's schedule
# lifted to the world's ranks (``schedule.lift_schedule``), so the same
# rounds run in one process and across processes.


def _check_world(x: torch.Tensor, local_size: int,
                 comm: Optional[ProcessRanks]) -> int:
    n = x.shape[0] if comm is None else comm.n
    if local_size < 1 or n % local_size:
        raise ValueError(f"world size {n} is not divisible by local_size "
                         f"{local_size}")
    return n


def _hierarchical(x: torch.Tensor, machine_sched: StaticSchedule,
                  local_size: int, comm: Optional[ProcessRanks],
                  async_op: bool):
    """``bluefog_tpu.ops.collective._hierarchical``: each machine's local
    sum (in rank order, the order of XLA's CPU ``psum_scatter``), the
    machine-level neighbor combine of the sums, then the division by
    ``local_size`` after the combine (the reference's averaging order).
    The JAX package combines a ``1/local_size`` shard a local rank and
    gathers the shards back; the combine is elementwise, so whole rows give
    the same values.  In one process the combine runs on the ``(machines,
    ...)`` sums; across processes every owned rank holds its machine's sum
    (``local_allreduce``) and the machine schedule runs lifted to the
    world's ranks."""
    n = _check_world(x, local_size, comm)
    if machine_sched.n != n // local_size:
        raise ValueError(f"the machine schedule has {machine_sched.n} ranks,"
                         f" the world {n // local_size} machines")
    if comm is None:
        g = x.reshape((n // local_size, local_size) + x.shape[1:])
        combined = _apply_rounds(_rank_sum(g.transpose(0, 1)), machine_sched)
        return _result(combined.then(
            lambda c: (c / local_size).repeat_interleave(local_size, dim=0)),
            async_op)
    sums = local_allreduce(x, local_size, average=False, comm=comm)
    lifted = lift_schedule(machine_sched, n, local_size, "machine")
    return _result(_apply_rounds(sums, lifted, comm).then(
        lambda c: c / local_size), async_op)


def hierarchical_neighbor_allreduce(x: torch.Tensor,
                                    sched: StaticSchedule, local_size: int,
                                    *, comm: Optional[ProcessRanks] = None,
                                    async_op: bool = False):
    """Machine-level neighbor averaging: machines are super-nodes, and the
    weights of ``sched`` (compiled on the machine topology) index
    machines; every rank of machine ``m`` gets ``(sum_j W[j, m] S_j) /
    local_size``, ``S_j`` machine ``j``'s local sum."""
    return _hierarchical(x, sched, local_size, comm, async_op)


def dynamic_hierarchical_neighbor_allreduce(
        x: torch.Tensor, step: int, sched: DynamicSchedule, local_size: int,
        *, comm: Optional[ProcessRanks] = None, async_op: bool = False):
    """Hierarchical averaging with a per-step machine topology: step ``t``
    runs machine phase ``t % period``."""
    return _hierarchical(x, sched.phases[int(step) % sched.period],
                         local_size, comm, async_op)


def hierarchical_gossip(x: torch.Tensor, step: int,
                        inner_sched: StaticSchedule,
                        outer_scheds: Sequence[StaticSchedule],
                        local_size: int, *, outer_every: int = 1,
                        outer_compression: str = "none",
                        outer_frac: Optional[float] = None,
                        comm: Optional[ProcessRanks] = None) -> torch.Tensor:
    """Two-level gossip step (``topology.HierarchicalTopology``'s executor,
    ``bluefog_tpu.ops.collective.hierarchical_gossip``): the dense inner
    combine ``inner_sched`` (over a machine's ``local_size`` ranks) every
    step, then on steps with ``step % outer_every == 0`` the one-peer
    exchange between machines, phase ``outer_scheds[...]`` (over the
    machines).  The outer level's codec:

    - ``bf16``: the bfloat16 cast crosses, and each rank re-adds its own
      rounding ``y - q(y)`` after the mix;
    - ``sparse:<frac>`` (``outer_frac``): a block of ``ceil(frac * size)``
      consecutive coordinates, rotating by the outer step, is mixed
      exactly, the rest is left as it is; the phase is held for a whole
      sweep of blocks."""
    n = _check_world(x, local_size, comm)
    inner = lift_schedule(inner_sched, n, local_size, "local")
    y = _apply_rounds(x, inner, comm).wait()
    k = max(1, int(outer_every))
    if not outer_scheds or int(step) % k:
        return y
    outer_step = int(step) // k
    nphases = len(outer_scheds)
    if isinstance(outer_compression, str) and \
            outer_compression.startswith("sparse"):
        if outer_frac is None:
            raise ValueError("sparse outer compression needs outer_frac")
        size = math.prod(x.shape[1:])
        kk = max(1, math.ceil(outer_frac * size))
        nblocks = max(1, -(-size // kk))
        phase = outer_scheds[(outer_step // nblocks) % nphases]
        if len(phase.rounds) != 1:
            raise ValueError(
                "sparse outer compression expects one-round outer phases "
                f"(a pure machine shift), got {len(phase.rounds)}")
        lifted = lift_schedule(phase, n, local_size, "machine")
        rnd = lifted.rounds[0]
        rot = (torch.arange(kk, device=x.device)
               + (outer_step % nblocks) * kk) % size
        flat = y.reshape(y.shape[0], -1)
        vals = flat.index_select(1, rot)
        (recv,), = _exchange([rnd], [[vals * _per_rank(rnd.send_scale, vals,
                                                       comm)]], comm).wait()
        self_sc = _per_rank(lifted.self_scale, vals, comm)
        # On the block: theta * vals + recv; off the block: untouched.
        return flat.index_add(1, rot, (self_sc - 1.0) * vals + recv
                              ).view(y.shape)
    lifted = lift_schedule(outer_scheds[outer_step % nphases], n, local_size,
                           "machine")
    if outer_compression == "bf16":
        q = y.to(torch.bfloat16)
        mixed = _apply_rounds(q, lifted, comm).wait().to(y.dtype)
        return mixed + (y - q.to(y.dtype))
    return _apply_rounds(y, lifted, comm).wait()
