"""Topology -> neighbor-exchange schedule compiler.

The port's copy of the part of ``bluefog_tpu/ops/schedule.py`` that the
dynamic-topology training step needs.  A topology compiles once into a list
of rounds plus weight vectors; the edge set is partitioned by cyclic shift
distance ``d = (dst - src) mod n``, and all edges of one distance form a
partial permutation, i.e. one round of point-to-point exchange.

Weights are applied *source-side*: round ``r`` sends ``x * send_scale_r[src]``
and the receiver accumulates unscaled, so receiver-chosen and sender-chosen
weights are one convention.

Left out here: the native round decomposition and the min-round repack of
``ops/schedule_opt.py``.  A one-peer phase has one round, so its schedule is
the same either way; a static multi-round topology may order its rounds
differently from the JAX package's repacked schedule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import networkx as nx
import numpy as np

from bluefog_tpu_torch import topology as topo_mod

__all__ = [
    "CommRound",
    "StaticSchedule",
    "DynamicSchedule",
    "compile_static",
    "compile_dynamic",
    "uniform_weights",
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


@dataclass(frozen=True, eq=False)
class StaticSchedule:
    """Compiled static topology: ``out = self_scale[i] * x_i + sum_r recv_r``."""
    n: int
    rounds: Tuple[CommRound, ...]
    self_scale: np.ndarray       # (n,)
    indegree: np.ndarray         # (n,) int, self-loop excluded
    outdegree: np.ndarray        # (n,) int, self-loop excluded


@dataclass(frozen=True, eq=False)
class DynamicSchedule:
    """Periodic dynamic topology: step ``t`` runs ``phases[t % len(phases)]``."""
    n: int
    phases: Tuple[StaticSchedule, ...]

    @property
    def period(self) -> int:
        return len(self.phases)


def _rounds_from_matrix_py(w: np.ndarray) -> Tuple[CommRound, ...]:
    """Partition off-diagonal edges of ``w`` by shift distance into rounds."""
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


def _schedule_from_matrix(w: np.ndarray) -> StaticSchedule:
    n = w.shape[0]
    off_diag = w.copy()
    np.fill_diagonal(off_diag, 0.0)
    return StaticSchedule(
        n=n,
        rounds=_rounds_from_matrix_py(w),
        self_scale=np.diag(w).copy(),
        indegree=(off_diag != 0).sum(axis=0).astype(np.int32),
        outdegree=(off_diag != 0).sum(axis=1).astype(np.int32),
    )


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
