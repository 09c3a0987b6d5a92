"""The multi-process transport: rank-major rows over ``torch.distributed``.

The port's counterpart of the JAX package's multi-controller mode, where each
process drives its local devices and a collective spans every process.  Each
process owns a contiguous block of the world's ranks, as JAX's
``owned_ranks`` (``bluefog_tpu/basics.py`` L345-351): process ``p`` of ``P``
owns ranks ``p*m .. p*m + m - 1``, and a rank-major tensor there holds those
``m`` rows.  One rank a process is the usual case (one process per card);
the CPU tests also run two.

:class:`ProcessRanks` moves rows between the processes:

- :meth:`ProcessRanks.exchange` is a round of ``ppermute``: receiver ``d``
  takes row ``src_of[d]`` of the senders' payload.  A row whose source this
  process owns is gathered locally; the rows that cross processes go in one
  ``dist.batch_isend_irecv`` a round, never to this process itself.  A
  receiver without a source gets zeros (``ppermute``'s fill).
- :meth:`ProcessRanks.all_reduce`, :meth:`ProcessRanks.all_gather` and
  :meth:`ProcessRanks.broadcast` carry the dense family;
  :meth:`ProcessRanks.ring` (differentiable: the backward runs the
  transposed move) and :meth:`ProcessRanks.all_to_all` are the
  sequence-parallel moves; :meth:`ProcessRanks.rotate` is one hop of a
  lane of rows up or down the ranks (the pipeline's stage handoff).

:func:`shard_axis` reads a parallel axis (sequence, tensor, pipeline or
expert): an ``int`` ``n`` is rank-major, all ``n`` shards in this process;
a :class:`ProcessRanks` spreads them over the world's ranks.

Every move returns a :class:`Pending`: the async works and what finishes the
result once they are done, so the ``*_nonblocking`` calls can hand it out as
a handle and the blocking calls wait on it at once.  A single-process
collective returns a :class:`Pending` that is already done.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Union

import torch
import torch.distributed as dist

__all__ = ["Pending", "ProcessRanks", "shard_axis"]


class Pending:
    """A result in flight: ``wait()`` waits for every one of ``works``
    (``torch.distributed`` works, or other :class:`Pending`) and returns
    ``finish()``, once.  ``keep`` holds the tensors the works still read or
    write (send and receive buffers) until then."""

    def __init__(self, works: Sequence = (), finish: Callable = None,
                 keep: Sequence = ()):
        self._works = list(works)
        self._finish = finish
        self._keep = list(keep)
        self._done = False
        self._value = None

    @classmethod
    def done(cls, value) -> "Pending":
        p = cls()
        p._done, p._value = True, value
        return p

    def is_completed(self) -> bool:
        """True when no work is still in flight (``Work.is_completed``)."""
        return self._done or all(w.is_completed() for w in self._works)

    def wait(self):
        if not self._done:
            for w in self._works:
                w.wait()
            self._value = self._finish()
            self._done = True
            self._works, self._keep, self._finish = [], [], None
        return self._value

    def then(self, fn: Callable) -> "Pending":
        """``fn`` of the result: at once when the result is there, else at
        ``wait()``."""
        if self._done:
            return Pending.done(fn(self._value))
        return Pending([self], lambda: fn(self.wait()))


class ProcessRanks:
    """The ranks of the default ``torch.distributed`` process group: ``n``
    ranks, ``per_process`` of them a process, this process (``process`` of
    ``nprocs``) owning ``lo .. hi - 1``."""

    def __init__(self, per_process: int, process: int, nprocs: int):
        if per_process < 1 or not 0 <= process < nprocs:
            raise ValueError(f"process {process} of {nprocs} with "
                             f"{per_process} ranks a process")
        self.per_process = int(per_process)
        self.process = int(process)
        self.nprocs = int(nprocs)
        self.n = self.per_process * self.nprocs
        self.lo = self.process * self.per_process
        self.hi = self.lo + self.per_process

    def owner(self, rank: int) -> int:
        """The process that owns ``rank``."""
        return int(rank) // self.per_process

    def owns(self, rank: int) -> bool:
        return self.lo <= rank < self.hi

    # -- the neighbor rounds ----------------------------------------------

    def exchange(self, rounds: Sequence, payloads: Sequence[Sequence[
            torch.Tensor]]) -> Pending:
        """One ``ppermute`` a round: ``payloads[r]`` are rank-major ``(m,
        ...)`` tensors that the owned ranks send in ``rounds[r]`` (a
        schedule round: ``src_of``, ``dst_of`` over global ranks); the
        result lists, a round, the tensors the owned ranks receive, each
        receiver the row of its source and zeros without one.  A receiver
        and its sender agree on the order of a pair of processes' rows
        (ascending receiver, then payload), and each round has its tag."""
        lo, hi = self.lo, self.hi
        works, keep, out = [], [], []
        for tag, (rnd, payload) in enumerate(zip(rounds, payloads)):
            sends = [t.contiguous() for t in payload]
            recvs = [torch.zeros_like(t) for t in sends]
            local_d, local_s, ops = [], [], []
            for d in range(lo, hi):
                s = int(rnd.src_of[d])
                if s < 0:
                    continue
                if self.owns(s):
                    local_d.append(d - lo)
                    local_s.append(s - lo)
                else:
                    ops += [dist.P2POp(dist.irecv, r[d - lo], self.owner(s),
                                       tag=tag) for r in recvs]
            for s in sorted(range(lo, hi), key=lambda s: int(rnd.dst_of[s])):
                d = int(rnd.dst_of[s])
                if d >= 0 and not self.owns(d):
                    ops += [dist.P2POp(dist.isend, t[s - lo], self.owner(d),
                                       tag=tag) for t in sends]
            if local_d:
                dst = torch.tensor(local_d, device=sends[0].device)
                src = torch.tensor(local_s, device=sends[0].device)
                for r, t in zip(recvs, sends):
                    r.index_copy_(0, dst, t.index_select(0, src))
            if ops:
                works += dist.batch_isend_irecv(ops)
                keep += sends
            out.append(recvs)
        return Pending(works, lambda: out, keep)

    # -- the dense family ---------------------------------------------------

    def all_gather(self, x: torch.Tensor) -> Pending:
        """Every process gets the world's ``(n, ...)`` rank-major tensor
        from the owned rows ``x`` ``(m, ...)``."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.nprocs)]
        work = dist.all_gather(parts, x, async_op=True)
        return Pending([work], lambda: torch.cat(parts), [x])

    def broadcast(self, x: torch.Tensor, root_rank: int) -> Pending:
        """Rank ``root_rank``'s row of the rank-major tensors ``x`` (the
        owned rows), on every process."""
        if not 0 <= root_rank < self.n:
            raise ValueError(f"root_rank {root_rank} is not a rank of "
                             f"{self.n}")
        if self.owns(root_rank):
            row = x[root_rank - self.lo].contiguous()
        else:
            row = x.new_empty(x.shape[1:])
        work = dist.broadcast(row, self.owner(root_rank), async_op=True)
        return Pending([work], lambda: row)

    def all_reduce(self, x: torch.Tensor) -> Pending:
        """The sum over the processes of each one's ``x``, in
        ``dist.all_reduce``'s order (in place: ``x`` is the caller's own
        buffer)."""
        work = dist.all_reduce(x, async_op=True)
        return Pending([work], lambda: x, [x])

    def all_gather_object(self, obj) -> list:
        """One Python object a process, in process order (blocking)."""
        out = [None] * self.nprocs
        dist.all_gather_object(out, obj)
        return out

    # -- the sequence-parallel moves ---------------------------------------

    def ring(self, k: torch.Tensor, v: torch.Tensor, hops: int) -> list:
        """The K/V blocks of each of ``hops`` ring hops: at hop ``t`` rank
        ``g`` holds rank ``g - t``'s shard of ``k`` and ``v`` (leading dim:
        the owned ranks), moved one rank up the ring a hop (``ppermute``
        with ``i -> i + 1``).  Differentiable: the backward sends the
        cotangents one rank down a hop, adding each hop's on the way, the
        transpose.  One autograd node for every hop, so that every process
        runs the same rounds in the backward, also one whose ranks use the
        blocks of no later hop (a masked hop under causal attention).
        Two processes or more: in one, ``parallel.ring_attention`` moves
        the rank-major blocks itself."""
        flat = _Ring.apply(self, int(hops), k, v)
        return [flat[2 * t:2 * t + 2] for t in range(int(hops))]

    def rotate(self, xs: Sequence[torch.Tensor], up: bool
               ) -> List[torch.Tensor]:
        """Each of ``xs`` (leading dim: the owned ranks) moved one rank up
        the ring (``up``: rank ``g`` gets rank ``g - 1``'s row, ``ppermute``
        with ``i -> i + 1``) or down (rank ``g`` gets rank ``g + 1``'s),
        blocking; a ``torch.roll`` by one of the world's rank-major
        tensor."""
        nxt = (self.process + 1) % self.nprocs
        prev = (self.process - 1) % self.nprocs
        to, frm = (nxt, prev) if up else (prev, nxt)
        ops, outs, recvs = [], [], []
        for x in xs:
            x = x.contiguous()
            edge = x[-1] if up else x[0]
            recv = torch.empty_like(edge)
            ops += [dist.P2POp(dist.isend, edge, to),
                    dist.P2POp(dist.irecv, recv, frm)]
            recvs.append(recv)
            outs.append(x)
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return [torch.cat([r[None], x[:-1]]) if up else
                torch.cat([x[1:], r[None]]) for r, x in zip(recvs, outs)]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``dist.all_to_all_single`` of ``x``'s leading dim in equal parts
        (its own inverse and transpose; ``parallel.ulysses`` makes its
        moves differentiable)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out


def shard_axis(axis: Union[int, ProcessRanks]):
    """``(n, lo, m, transport)`` of a parallel axis: its ``n`` shards, the
    first one this process holds, how many it holds, and the transport
    (None for a rank-major ``int`` axis, and for a :class:`ProcessRanks` of
    one process, which holds every shard)."""
    if isinstance(axis, ProcessRanks):
        if axis.nprocs == 1:
            return axis.n, 0, axis.n, None
        return axis.n, axis.lo, axis.hi - axis.lo, axis
    n = int(axis)
    if n < 1:
        raise ValueError(f"an axis of {n} shards")
    return n, 0, n, None


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ranks: ProcessRanks, hops: int, k, v):
        ctx.ranks = ranks
        out = [k, v]
        for _ in range(hops - 1):
            out += ranks.rotate(out[-2:], up=True)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        acc = list(grads[-2:])
        for t in range(len(grads) // 2 - 2, -1, -1):
            back = ctx.ranks.rotate(acc, up=False)
            acc = [g + b for g, b in zip(grads[2 * t:2 * t + 2], back)]
        return (None, None) + tuple(acc)
