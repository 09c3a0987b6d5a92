"""Topology -> neighbor-exchange schedule compiler.

The port's copy of ``bluefog_tpu/ops/schedule.py``.  A topology compiles
once into a list of rounds plus weight vectors; the edge set is partitioned
by cyclic shift distance ``d = (dst - src) mod n``, and all edges of one
distance form a partial permutation, i.e. one round of point-to-point
exchange.  The decomposition runs in native code (``native/src/schedule.cc``,
``bf_rounds_from_matrix``, built at first use; a failed build raises), with
the numpy ``_rounds_from_matrix_py`` as its oracle.  Every compiled matrix
is then repacked into the least number of rounds (``ops/schedule_opt.py``,
on as the JAX package's default ``BLUEFOG_TPU_SCHEDULE_OPT`` is) and
memoized on its bytes, so the port's schedules are the JAX package's round
for round.

Weights are applied *source-side*: round ``r`` sends ``x * send_scale_r[src]``
and the receiver accumulates unscaled, so receiver-chosen and sender-chosen
weights are one convention.

A compiled schedule is a :class:`CompiledSchedule`: the rounds plus the
stamps of the pass that produced them (``provenance``: ``naive``,
``konig``, ``congestion``, ``synthesized:<sketch>`` or ``sharded``; the
``modeled_cost`` a pass priced them at; the ``sketch`` of a synthesized
schedule), as in the JAX package.  The physical passes (the congestion
repack, the synthesis) run at the context's dispatch
(``basics._physical_repack``), never in the matrix compile cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple

import networkx as nx
import numpy as np

from bluefog_tpu_torch import topology as topo_mod

__all__ = [
    "CommRound",
    "StaticSchedule",
    "CompiledSchedule",
    "DynamicSchedule",
    "PairGossipSchedule",
    "compile_static",
    "compile_dynamic",
    "compile_pair_gossip",
    "uniform_weights",
    "lift_schedule",
    "as_compiled",
    "schedule_provenance",
]


@dataclass(frozen=True, eq=False)
class CommRound:
    """One round of point-to-point exchange.

    ``pairs``      — (src, dst) list of the round.
    ``send_scale`` — (n,) array; src multiplies its payload by
                     ``send_scale[src]`` before sending.  Zero for ranks
                     that do not send this round.
    ``recv_mask``  — (n,) 0/1 array; 1 iff the rank receives this round.
    ``src_of``     — (n,) int array; src rank feeding each dst this round,
                     -1 when silent.
    """
    pairs: Tuple[Tuple[int, int], ...]
    send_scale: np.ndarray
    recv_mask: np.ndarray
    src_of: np.ndarray

    @cached_property
    def dst_of(self) -> np.ndarray:
        """(n,) int array; dst rank each src feeds this round, -1 when
        silent: the inverse of ``src_of``."""
        dst = np.full(len(self.send_scale), -1, dtype=np.int32)
        for s, d in self.pairs:
            dst[s] = d
        return dst


@dataclass(frozen=True, eq=False)
class StaticSchedule:
    """Compiled static topology: ``out = self_scale[i] * x_i + sum_r recv_r``."""
    n: int
    rounds: Tuple[CommRound, ...]
    self_scale: np.ndarray       # (n,)
    indegree: np.ndarray         # (n,) int, self-loop excluded
    outdegree: np.ndarray        # (n,) int, self-loop excluded

    @property
    def max_indegree(self) -> int:
        return int(self.indegree.max(initial=0))

    @cached_property
    def slot_tables(self) -> Tuple[np.ndarray, ...]:
        """Per-round output slot of each receiving rank for ordered concat
        (``neighbor_allgather``): the arriving src's position in the
        receiver's ascending in-neighbor list, -1 when silent."""
        in_nbrs: List[List[int]] = [[] for _ in range(self.n)]
        for rnd in self.rounds:
            for s, d in rnd.pairs:
                in_nbrs[d].append(s)
        for lst in in_nbrs:
            lst.sort()
        tables = []
        for rnd in self.rounds:
            slot = np.full(self.n, -1, dtype=np.int32)
            for dst in range(self.n):
                s = rnd.src_of[dst]
                if s >= 0:
                    slot[dst] = in_nbrs[dst].index(int(s))
            tables.append(slot)
        return tuple(tables)

    def window_plan(self) -> Tuple[Tuple[Tuple[int, float], ...], ...]:
        """The lowering for the one-sided window executor: entry ``s`` is
        the ``(dst, weight)`` list rank ``s`` pushes each step, the round
        structure erased (the window transport has per-peer FIFOs, no
        round barrier); the diagonal stays with the combiner.  The fused
        window step (``ops/fused_step.py``) reads its edges from here."""
        plan: List[List[Tuple[int, float]]] = [[] for _ in range(self.n)]
        for rnd in self.rounds:
            for s, d in rnd.pairs:
                plan[s].append((d, float(rnd.send_scale[s])))
        return tuple(tuple(p) for p in plan)


@dataclass(frozen=True, eq=False)
class CompiledSchedule(StaticSchedule):
    """A :class:`StaticSchedule` with the stamps of the pass that made it:

    ``provenance``   — ``naive`` (shift-distance decomposition), ``konig``
                       (min-round repack), ``congestion`` (link-load
                       repack), ``synthesized:<sketch>``
                       (``ops/synthesis.py``) or ``sharded`` (the merged
                       replica-group schedule of ``ops/sharded.py``).
    ``modeled_cost`` — the ``ops.placement.CostReport`` the producer priced
                       the rounds at (None without an interconnect model).
    ``lowering``     — the executor the rounds target: ``ppermute`` (the
                       collective rounds), ``window`` (the per-peer push
                       plan of :meth:`window_plan`) or ``fused`` (that
                       plan, inside the fused window step).
    ``sketch``       — the sketch a synthesized schedule grew from."""
    provenance: str = "naive"
    modeled_cost: Optional[object] = None
    lowering: str = "ppermute"
    sketch: Optional[str] = None


_UNSET = object()


def as_compiled(sched: StaticSchedule, *, provenance=None, modeled_cost=_UNSET,
                lowering=None, sketch=_UNSET) -> CompiledSchedule:
    """``sched`` as a :class:`CompiledSchedule`, each stamp left
    unspecified inherited from ``sched`` (or the default), so a pass stamps
    only what it owns."""
    prov = provenance if provenance is not None else \
        getattr(sched, "provenance", "naive")
    cost = modeled_cost if modeled_cost is not _UNSET else \
        getattr(sched, "modeled_cost", None)
    low = lowering if lowering is not None else \
        getattr(sched, "lowering", "ppermute")
    sk = sketch if sketch is not _UNSET else getattr(sched, "sketch", None)
    return CompiledSchedule(
        n=sched.n, rounds=sched.rounds, self_scale=sched.self_scale,
        indegree=sched.indegree, outdegree=sched.outdegree,
        provenance=prov, modeled_cost=cost, lowering=low, sketch=sk)


def schedule_provenance(sched) -> str:
    """The provenance of any schedule: its own stamp, a dynamic schedule's
    phases' common one (``mixed`` when they differ), ``naive`` for an
    unstamped one."""
    phases = getattr(sched, "phases", None)
    if phases is not None:
        tags = {schedule_provenance(ph) for ph in phases}
        return tags.pop() if len(tags) == 1 else "mixed"
    return getattr(sched, "provenance", "naive")


@dataclass(frozen=True, eq=False)
class DynamicSchedule:
    """Periodic dynamic topology: step ``t`` runs ``phases[t % len(phases)]``."""
    n: int
    phases: Tuple[StaticSchedule, ...]

    @property
    def period(self) -> int:
        return len(self.phases)

    @property
    def provenance(self) -> str:
        return schedule_provenance(self)


@dataclass(frozen=True, eq=False)
class PairGossipSchedule:
    """Single-round symmetric exchange for ``pair_gossip``."""
    n: int
    round: CommRound
    self_scale: np.ndarray


def _rounds_from_matrix_py(w: np.ndarray) -> Tuple[CommRound, ...]:
    """Partition off-diagonal edges of ``w`` by shift distance into rounds
    (numpy: the oracle of the native :func:`_rounds_from_matrix_native`)."""
    n = w.shape[0]
    by_dist: Dict[int, List[Tuple[int, int]]] = {}
    srcs, dsts = np.nonzero(w)
    for s, d in zip(srcs.tolist(), dsts.tolist()):
        if s == d:
            continue
        by_dist.setdefault((d - s) % n, []).append((s, d))
    rounds = []
    for dist in sorted(by_dist):
        pairs = tuple(sorted(by_dist[dist]))
        send_scale = np.zeros(n)
        recv_mask = np.zeros(n)
        src_of = np.full(n, -1, dtype=np.int32)
        for s, d in pairs:
            send_scale[s] = w[s, d]
            recv_mask[d] = 1.0
            src_of[d] = s
        rounds.append(CommRound(pairs, send_scale, recv_mask, src_of))
    return tuple(rounds)


def _rounds_from_matrix_native(w: np.ndarray) -> Tuple[CommRound, ...]:
    """The shift-distance rounds of ``w`` from the native round compiler
    (``native/src/schedule.cc``), built at first use; bit for bit
    :func:`_rounds_from_matrix_py`."""
    import ctypes

    from bluefog_tpu_torch import native
    lib = native.schedule_lib()
    n = w.shape[0]
    if n < 2:
        return ()
    wq = np.ascontiguousarray(w, dtype=np.float64)
    distances = np.empty(n - 1, dtype=np.int32)
    send_scale = np.empty((n - 1, n), dtype=np.float64)
    recv_mask = np.empty((n - 1, n), dtype=np.float64)
    src_of = np.empty((n - 1, n), dtype=np.int32)
    k = lib.bf_rounds_from_matrix(
        n, wq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        distances.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        send_scale.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        recv_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        src_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    rounds = []
    for r in range(k):
        so = src_of[r]
        dsts = np.nonzero(so >= 0)[0]
        pairs = tuple(sorted((int(so[d]), int(d)) for d in dsts))
        rounds.append(CommRound(pairs, send_scale[r].copy(),
                                recv_mask[r].copy(), so.copy()))
    return tuple(rounds)


def _naive_schedule(w: np.ndarray) -> CompiledSchedule:
    """Matrix -> schedule by the shift-distance decomposition alone."""
    n = w.shape[0]
    off_diag = w.copy()
    np.fill_diagonal(off_diag, 0.0)
    return CompiledSchedule(
        n=n,
        rounds=_rounds_from_matrix_native(w),
        self_scale=np.diag(w).copy(),
        indegree=(off_diag != 0).sum(axis=0).astype(np.int32),
        outdegree=(off_diag != 0).sum(axis=1).astype(np.int32),
        provenance="naive",
    )


def _schedule_from_matrix(w: np.ndarray) -> StaticSchedule:
    """Matrix -> repacked schedule through the compile cache: the one
    funnel of ``compile_static`` and ``compile_dynamic``."""
    from bluefog_tpu_torch.ops.schedule_opt import (
        cached_schedule_from_matrix, optimize_schedule)
    return cached_schedule_from_matrix(
        w, lambda m: optimize_schedule(_naive_schedule(m)))


def uniform_weights(w_adj: np.ndarray) -> np.ndarray:
    """Replace a 0/1-ish adjacency with uniform ``1/(indeg+1)`` averaging
    weights — the default when topology weights are disabled."""
    n = w_adj.shape[0]
    w = np.zeros_like(w_adj, dtype=float)
    mask = (w_adj != 0)
    np.fill_diagonal(mask, False)
    indeg = mask.sum(axis=0)
    for dst in range(n):
        share = 1.0 / (indeg[dst] + 1.0)
        w[mask[:, dst], dst] = share
        w[dst, dst] = share
    return w


def compile_static(topo: nx.DiGraph, *,
                   use_topo_weights: bool = True,
                   self_weight: Optional[float] = None,
                   src_weights: Optional[np.ndarray] = None) -> StaticSchedule:
    """Compile a static topology into a round schedule.

    ``use_topo_weights=False`` applies uniform ``1/(indeg+1)`` weights.
    ``src_weights`` may override the full (n, n) weight matrix;
    ``self_weight`` overrides the diagonal (broadcast to all ranks).
    """
    w = topo_mod.weight_matrix(topo)
    if src_weights is not None:
        w = np.asarray(src_weights, dtype=float)
    elif not use_topo_weights:
        w = uniform_weights(w)
    if self_weight is not None:
        w = w.copy()
        np.fill_diagonal(w, self_weight)
    return _schedule_from_matrix(w)


def _phase_matrix(phase: topo_mod.DynamicPhase, n: int,
                  weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Weight matrix of one dynamic phase: default ``1/(indeg+1)`` averaging."""
    w = np.zeros((n, n))
    if weights is not None:
        for s, d in phase.pairs:
            w[s, d] = weights[s, d]
        np.fill_diagonal(w, np.diag(weights))
        return w
    indeg = np.zeros(n, dtype=np.int64)
    for _s, d in phase.pairs:
        indeg[d] += 1
    for s, d in phase.pairs:
        w[s, d] = 1.0 / (indeg[d] + 1.0)
    for r in range(n):
        w[r, r] = 1.0 / (indeg[r] + 1.0)
    return w


def compile_dynamic(phases: Sequence[topo_mod.DynamicPhase], n: int, *,
                    weights: Optional[np.ndarray] = None) -> DynamicSchedule:
    """Compile a periodic phase table (``topology.dynamic_phase_table`` /
    ``one_peer_exp2_phases``) into per-phase static schedules; step ``t``
    runs phase ``t % period``."""
    compiled = [_schedule_from_matrix(_phase_matrix(ph, n, weights))
                for ph in phases]
    return DynamicSchedule(n=n, phases=tuple(compiled))


def compile_pair_gossip(target_of: Sequence[int], n: int, *,
                        self_weight: float = 0.5,
                        target_weight: float = 0.5) -> PairGossipSchedule:
    """Compile a pairwise exchange: ``target_of[i]`` is rank ``i``'s partner
    (must be mutual, ``target_of[target_of[i]] == i``), or -1 to sit out."""
    pairs = []
    send_scale = np.zeros(n)
    recv_mask = np.zeros(n)
    src_of = np.full(n, -1, dtype=np.int32)
    self_scale = np.ones(n)
    for i, t in enumerate(target_of):
        if t < 0:
            continue
        if target_of[t] != i:
            raise AssertionError(
                f"pair_gossip targets must be mutual ({i}<->{t})")
        pairs.append((i, t))
        send_scale[i] = target_weight
        recv_mask[t] = 1.0
        src_of[t] = i
        self_scale[i] = self_weight
    return PairGossipSchedule(
        n=n,
        round=CommRound(tuple(sorted(pairs)), send_scale, recv_mask, src_of),
        self_scale=self_scale,
    )


def lift_schedule(sched: StaticSchedule, n: int, local_size: int,
                  level: str) -> StaticSchedule:
    """A schedule of one level of the machine x local mesh as the same
    rounds over the world's ``n`` ranks, rank-major (rank ``m * local_size
    + l`` is local rank ``l`` of machine ``m``).

    ``level="machine"``: ``sched`` is over the ``n // local_size``
    machines, and local rank ``l`` of machine ``m`` exchanges with local
    rank ``l`` of ``m``'s peers (a collective over the JAX package's
    machine axis).  ``level="local"``: ``sched`` is over the
    ``local_size`` ranks of a machine and runs inside every machine (its
    local axis).  Round for round and weight for weight the level's
    schedule, so each rank adds its terms in the level's order."""
    L = int(local_size)
    if L < 1 or n % L:
        raise ValueError(f"world size {n} is not divisible by local_size {L}")
    world = np.arange(n)
    if level == "machine":
        idx, base, scale = world // L, world % L, L
    elif level == "local":
        idx, base, scale = world % L, world - world % L, 1
    else:
        raise ValueError(f"level must be 'machine' or 'local', got {level!r}")
    if sched.n != (n // L if level == "machine" else L):
        raise ValueError(f"a {level}-level schedule of {sched.n} ranks does "
                         f"not fit {n} ranks of local_size {L}")

    def rank(level_rank, i):
        return int(level_rank) * scale + int(base[i])

    rounds = []
    for rnd in sched.rounds:
        src = rnd.src_of[idx]
        src_of = np.where(src >= 0, src * scale + base, -1).astype(np.int32)
        pairs = tuple(sorted((rank(s, i), i) for i, s in enumerate(src)
                             if s >= 0))
        rounds.append(CommRound(pairs, rnd.send_scale[idx],
                                rnd.recv_mask[idx], src_of))
    return StaticSchedule(n=n, rounds=tuple(rounds),
                          self_scale=sched.self_scale[idx],
                          indegree=sched.indegree[idx],
                          outdegree=sched.outdegree[idx])
