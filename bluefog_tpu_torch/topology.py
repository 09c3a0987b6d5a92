"""Virtual-topology library for decentralized averaging.

The port's own copy of ``bluefog_tpu/topology.py``, kept verbatim below this
paragraph: it is numpy and networkx only, but importing it from the JAX
package would run ``bluefog_tpu/__init__.py`` and pull in jax.  The test
``tests/test_torch_port_schedule.py`` holds the two copies equal.

This module provides the static graph generators, weight-extraction helpers and
dynamic (per-iteration) topology schedules that drive every neighbor-averaging
collective in :mod:`bluefog_tpu`.  It covers the full generator inventory of the
reference framework (see ``bluefog/common/topology_util.py`` in BlueFog:
ExponentialTwoGraph :66, ExponentialGraph :99, SymmetricExponentialGraph :128,
MeshGrid2DGraph :160, StarGraph :214, RingGraph :240, FullyConnectedGraph :284,
dynamic generators :315-554) while adding a TPU-first concept the reference does
not have: a *phase table* (:func:`dynamic_phase_table`,
:class:`bluefog_tpu.ops.schedule.CommSchedule`) — a static, precomputed
description of every per-step communication pattern, so that dynamic topologies
compile once under ``jax.jit`` (``lax.switch`` over phases) instead of being
re-negotiated every step by a coordinator thread.

Conventions
-----------
A topology is a weighted ``networkx.DiGraph`` over ranks ``0..n-1`` whose
adjacency matrix ``W`` is read as ``W[src, dst] = weight``.  Averaging steps
compute ``x_dst <- sum_src W[src, dst] * x_src``; generators produce
doubly-stochastic (or at least column-stochastic from the receiver's point of
view) matrices so consensus preserves the global mean.  A nonzero diagonal
entry is the rank's self-weight.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import networkx as nx
import numpy as np

__all__ = [
    "IsTopologyEquivalent",
    "IsRegularGraph",
    "GetRecvWeights",
    "GetSendWeights",
    "ExponentialTwoGraph",
    "ExponentialGraph",
    "SymmetricExponentialGraph",
    "MeshGrid2DGraph",
    "StarGraph",
    "RingGraph",
    "FullyConnectedGraph",
    "RandomRegularGraph",
    "GetDynamicOnePeerSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "weight_matrix",
    "from_weight_matrix",
    "in_neighbor_ranks",
    "out_neighbor_ranks",
    "DynamicPhase",
    "dynamic_phase_table",
    "one_peer_exp2_phases",
    "HierarchicalTopology",
    "hierarchical_two_level",
]


# ---------------------------------------------------------------------------
# Matrix <-> graph plumbing
# ---------------------------------------------------------------------------

def weight_matrix(topo: nx.DiGraph) -> np.ndarray:
    """Dense ``W[src, dst]`` weight matrix of a topology."""
    return nx.to_numpy_array(topo, nodelist=range(topo.number_of_nodes()))


def from_weight_matrix(w: np.ndarray) -> nx.DiGraph:
    """Build a topology from a dense ``W[src, dst]`` weight matrix."""
    w = np.asarray(w, dtype=float)
    assert w.ndim == 2 and w.shape[0] == w.shape[1], "weight matrix must be square"
    return nx.from_numpy_array(w, create_using=nx.DiGraph)


def _circulant(first_row: np.ndarray) -> nx.DiGraph:
    """Topology whose row ``i`` is ``first_row`` rotated right by ``i``.

    Circulant weight matrices are doubly stochastic whenever ``first_row`` sums
    to one, which is why every shift-structured generator below funnels through
    here.
    """
    n = len(first_row)
    rows = [np.roll(first_row, shift) for shift in range(n)]
    return from_weight_matrix(np.stack(rows))


def in_neighbor_ranks(topo: nx.DiGraph, rank: int) -> List[int]:
    """Ranks with an edge into ``rank`` (excluding the self-loop)."""
    return sorted(r for r in topo.predecessors(rank) if r != rank)


def out_neighbor_ranks(topo: nx.DiGraph, rank: int) -> List[int]:
    """Ranks that ``rank`` has an edge to (excluding the self-loop)."""
    return sorted(r for r in topo.successors(rank) if r != rank)


# ---------------------------------------------------------------------------
# Predicates and weight extraction (API parity: topology_util.py:23-63,306)
# ---------------------------------------------------------------------------

def IsTopologyEquivalent(topo1: Optional[nx.DiGraph],
                         topo2: Optional[nx.DiGraph]) -> bool:
    """True iff two topologies have identical adjacency/weight matrices.

    Deliberately *not* an isomorphism check — rank identity matters for
    communication schedules (matches reference semantics,
    ``topology_util.py:23-37``).
    """
    if topo1 is None or topo2 is None:
        return False
    if topo1.number_of_nodes() != topo2.number_of_nodes():
        return False
    if topo1.number_of_edges() != topo2.number_of_edges():
        return False
    return bool(np.array_equal(weight_matrix(topo1), weight_matrix(topo2)))


def IsRegularGraph(topo: nx.DiGraph) -> bool:
    """True iff every rank has the same total (in+out) degree."""
    degrees = {topo.degree(r) for r in range(topo.number_of_nodes())}
    return len(degrees) == 1


def GetRecvWeights(topo: nx.DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """``(self_weight, {src_rank: weight})`` used when *receiving* updates."""
    w = weight_matrix(topo)
    neighbor_weights = {src: w[src, rank] for src in topo.predecessors(rank)
                        if src != rank}
    self_weight = float(w[rank, rank]) if topo.has_edge(rank, rank) else 0.0
    return self_weight, neighbor_weights


def GetSendWeights(topo: nx.DiGraph, rank: int) -> Tuple[float, Dict[int, float]]:
    """``(self_weight, {dst_rank: weight})`` used when *sending* updates."""
    w = weight_matrix(topo)
    neighbor_weights = {dst: w[rank, dst] for dst in topo.successors(rank)
                        if dst != rank}
    self_weight = float(w[rank, rank]) if topo.has_edge(rank, rank) else 0.0
    return self_weight, neighbor_weights


# ---------------------------------------------------------------------------
# Static generators
# ---------------------------------------------------------------------------

def _power_offsets(size: int, base: int) -> List[int]:
    """Offsets ``{base**k} < size`` (exact integer arithmetic, no float log)."""
    offsets, p = [], 1
    while p < size:
        offsets.append(p)
        p *= base
    return offsets


def ExponentialTwoGraph(size: int) -> nx.DiGraph:
    """Directed circulant where rank ``i`` sends to ``i + 2**k (mod size)``.

    The flagship BlueFog topology (reference ``topology_util.py:66-87``): in-
    and out-degree are ``log2(size)``-ish, spectral gap is good, and every
    round of the dynamic one-peer variant is a single cyclic shift — on TPU a
    single ``lax.ppermute``.
    """
    assert size > 0
    row = np.zeros(size)
    row[0] = 1.0
    for d in _power_offsets(size, 2):
        row[d] = 1.0
    return _circulant(row / row.sum())


def ExponentialGraph(size: int, base: int = 2) -> nx.DiGraph:
    """Circulant with connections at offsets ``base**k`` (reference :99-125)."""
    assert size > 0
    row = np.zeros(size)
    row[0] = 1.0
    for d in _power_offsets(size, base):
        row[d] = 1.0
    return _circulant(row / row.sum())


def SymmetricExponentialGraph(size: int, base: int = 4) -> nx.DiGraph:
    """Circulant with offsets ``base**k`` mirrored around ``size//2``.

    Offset ``d`` participates iff ``min(d, size-d)`` is a power of ``base``
    (reference ``topology_util.py:128-157``).
    """
    assert size > 0
    powers = set(_power_offsets(size, base))
    row = np.zeros(size)
    row[0] = 1.0
    for d in range(1, size):
        folded = d if d <= size // 2 else size - d
        if folded in powers:
            row[d] = 1.0
    return _circulant(row / row.sum())


def MeshGrid2DGraph(size: int, shape: Optional[Tuple[int, int]] = None) -> nx.DiGraph:
    """2-D grid with Metropolis–Hastings weights (reference :160-211).

    Edge weight is ``1 / max(|N_i|, |N_j|)`` with neighborhoods counted
    *including* self; the diagonal absorbs the slack so each row sums to one.
    When ``shape`` is omitted the grid is the most-square factorization, rows
    <= cols; prime sizes degrade to a path.
    """
    assert size > 0
    if shape is None:
        nrow = int(math.isqrt(size))
        while size % nrow != 0:
            nrow -= 1
        shape = (nrow, size // nrow)
    nrow, ncol = shape
    assert nrow * ncol == size, "shape does not match size"

    adj = np.zeros((size, size), dtype=bool)
    for i in range(size):
        r, c = divmod(i, ncol)
        if c + 1 < ncol:
            adj[i, i + 1] = adj[i + 1, i] = True
        if r + 1 < nrow:
            adj[i, i + ncol] = adj[i + ncol, i] = True

    nbhd_size = adj.sum(axis=1) + 1  # |N_i| including self
    w = np.zeros((size, size))
    for i in range(size):
        for j in np.nonzero(adj[i])[0]:
            w[i, j] = 1.0 / max(nbhd_size[i], nbhd_size[j])
        w[i, i] = 1.0 - w[i].sum()
    return from_weight_matrix(w)


def StarGraph(size: int, center_rank: int = 0) -> nx.DiGraph:
    """Bidirectional star through ``center_rank`` (reference :214-237).

    Leaves keep ``1 - 1/size`` self-weight and exchange ``1/size`` with the
    center; the center row is uniform ``1/size``.
    """
    assert size > 0
    w = np.zeros((size, size))
    np.fill_diagonal(w, 1.0 - 1.0 / size)
    w[center_rank, :] = 1.0 / size
    w[:, center_rank] = 1.0 / size
    w[center_rank, center_rank] = 1.0 / size
    return from_weight_matrix(w)


def RingGraph(size: int, connect_style: int = 0) -> nx.DiGraph:
    """Ring topology (reference :240-281).

    ``connect_style``: 0 = bidirectional (1/3 self, 1/3 each side),
    1 = left only (send to ``i-1``), 2 = right only (send to ``i+1``).
    """
    assert size > 0
    assert 0 <= connect_style <= 2, "connect_style must be 0 (bi), 1 (left) or 2 (right)"
    if size == 1:
        return from_weight_matrix(np.ones((1, 1)))
    if size == 2:
        return from_weight_matrix(np.full((2, 2), 0.5))
    row = np.zeros(size)
    if connect_style == 0:
        row[0] = row[1] = row[-1] = 1.0 / 3.0
    elif connect_style == 1:
        row[0] = row[-1] = 0.5
    else:
        row[0] = row[1] = 0.5
    return _circulant(row)


def FullyConnectedGraph(size: int) -> nx.DiGraph:
    """All-to-all with uniform ``1/size`` weights (reference :284-303)."""
    assert size > 0
    return from_weight_matrix(np.full((size, size), 1.0 / size))


def RandomRegularGraph(size: int, degree: int = 4,
                       seed: int = 0) -> nx.DiGraph:
    """Random ``degree``-regular undirected graph as a bidirectional
    topology with uniform ``1/(degree+1)`` weights (doubly stochastic).

    Random-regular graphs are expanders with high probability — near-Exp2
    spectral gap at constant degree — but carry NO shift structure: their
    edges scatter across ~``size`` cyclic distance classes, which makes
    them the stress topology for the schedule optimizer
    (``ops/schedule_opt.py`` repacks them from ~``size`` naive ppermute
    rounds down to exactly ``degree``).  Deterministic in ``seed`` so every
    rank builds the identical graph.
    """
    assert size > 0 and 0 < degree < size, "need 0 < degree < size"
    assert (size * degree) % 2 == 0, "size * degree must be even"
    g = nx.random_regular_graph(degree, size, seed=seed)
    w = np.zeros((size, size))
    share = 1.0 / (degree + 1.0)
    for u, v in g.edges():
        w[u, v] = w[v, u] = share
    np.fill_diagonal(w, share)
    return from_weight_matrix(w)


# ---------------------------------------------------------------------------
# Dynamic (one-peer-per-iteration) schedules
# ---------------------------------------------------------------------------
#
# The reference exposes these as infinite Python iterators consumed rank-by-
# rank (topology_util.py:315-554).  We keep those iterators for API parity but
# derive them from *pure functions of the step index*, which is what the TPU
# path actually consumes: a static table of per-phase global permutations that
# `ops.schedule` turns into `lax.ppermute` source-target pairs selected by
# `lax.switch` — no per-step host negotiation, no recompilation.


@dataclass(frozen=True)
class DynamicPhase:
    """One phase of a periodic dynamic topology.

    ``send_to[i]`` is the rank that ``i`` sends to in this phase (or ``-1`` if
    ``i`` stays silent).  Receives are implied: ``j`` receives from every ``i``
    with ``send_to[i] == j``.
    """
    send_to: Tuple[int, ...]

    @property
    def pairs(self) -> List[Tuple[int, int]]:
        return [(src, dst) for src, dst in enumerate(self.send_to) if dst >= 0]

    def recv_from(self, rank: int) -> List[int]:
        return [src for src, dst in enumerate(self.send_to) if dst == rank]


def _sorted_clockwise_out_neighbors(topo: nx.DiGraph) -> List[List[int]]:
    """Per-rank out-neighbors ordered by clockwise distance, self excluded."""
    n = topo.number_of_nodes()
    table = []
    for r in range(n):
        nbrs = [s for s in topo.successors(r) if s != r]
        nbrs.sort(key=lambda s: (s - r) % n)
        table.append(nbrs)
    return table


def dynamic_phase_table(topo: nx.DiGraph,
                        max_phases: int = 1024) -> List[DynamicPhase]:
    """Static phase table for the one-peer dynamic walk over ``topo``.

    Phase ``p``: rank ``i`` sends to its ``p % outdeg(i)``-th clockwise
    out-neighbor — the same walk as :func:`GetDynamicOnePeerSendRecvRanks`,
    with which it agrees exactly (the table length is the full period
    ``lcm(outdeg(i))``; step ``t`` uses phase ``t % len(table)``).  Raises
    when the period exceeds ``max_phases`` rather than silently truncating —
    a truncated table would diverge from the iterator after one period.
    """
    n = topo.number_of_nodes()
    nbrs = _sorted_clockwise_out_neighbors(topo)
    degs = [max(len(x), 1) for x in nbrs]
    period = 1
    for d in degs:
        period = math.lcm(period, d)
    if period > max_phases:
        raise ValueError(
            f"dynamic phase period lcm(outdegrees)={period} exceeds "
            f"max_phases={max_phases}; use a more regular topology or raise "
            "max_phases explicitly")
    phases = []
    for p in range(period):
        send_to = tuple(nbrs[i][p % degs[i]] if nbrs[i] else -1 for i in range(n))
        phases.append(DynamicPhase(send_to))
    return phases


def one_peer_exp2_phases(size: int) -> List[DynamicPhase]:
    """Phase table for dynamic one-peer Exponential-2: phase ``k`` is the pure
    cyclic shift by ``2**k``.  Each phase is exactly one ``lax.ppermute``."""
    offsets = _power_offsets(size, 2) or [0]
    return [DynamicPhase(tuple((i + d) % size for i in range(size)))
            for d in offsets]


def GetDynamicOnePeerSendRecvRanks(
        topo: nx.DiGraph, self_rank: int) -> Iterator[Tuple[List[int], List[int]]]:
    """Per-step ``([send_rank], recv_ranks)`` for the one-peer dynamic walk.

    API parity with reference ``topology_util.py:315-357``; backed by the same
    phase table the jitted path uses, so eager and compiled schedules agree.
    """
    nbrs = _sorted_clockwise_out_neighbors(topo)
    degs = [max(len(x), 1) for x in nbrs]
    n = topo.number_of_nodes()
    step = 0
    while True:
        # A rank without out-edges sits the round out (phase table emits -1)
        sends = [nbrs[self_rank][step % degs[self_rank]]] if nbrs[self_rank] else []
        recvs = [other for other in range(n)
                 if other != self_rank and nbrs[other]
                 and nbrs[other][step % degs[other]] == self_rank]
        yield sends, recvs
        step += 1


def GetExp2DynamicSendRecvMachineRanks(
        world_size: int, local_size: int, self_rank: int, local_rank: int,
) -> Iterator[Tuple[List[int], List[int]]]:
    """Machine-level dynamic Exp-2 walk for hierarchical averaging.

    Yields ``([send_machine_id], [recv_machine_id])`` per step (reference
    ``topology_util.py:360-396``).  Homogeneous placement required.
    """
    assert self_rank % local_size == local_rank, "homogeneous placement required"
    assert world_size % local_size == 0, "homogeneous placement required"
    assert world_size > local_size, "needs at least two machines"
    machine_id = self_rank // local_size
    num_machines = world_size // local_size
    num_offsets = int(np.log2(num_machines - 1)) + 1 if num_machines > 1 else 1
    step = 0
    while True:
        dist = 2 ** (step % num_offsets)
        yield [(machine_id + dist) % num_machines], [(machine_id - dist) % num_machines]
        step += 1


def _inner_outer_step(num_machines: int, nodes_per_machine: int, self_rank: int,
                      step: int, inner_dist_fn, outer_dist_fn) -> Tuple[int, int]:
    """Shared skeleton of the inner/outer dynamic walks.

    One designated local rank per step talks across machines; all others walk
    inside their machine, skipping over the outgoing rank.
    """
    machine_id, local_id = divmod(self_rank, nodes_per_machine)
    outgoing_local = step % nodes_per_machine

    if local_id == outgoing_local:
        d = outer_dist_fn(step)
        send = ((machine_id + d) % num_machines) * nodes_per_machine + local_id
        recv = ((machine_id - d) % num_machines) * nodes_per_machine + local_id
        return send, recv

    fwd = inner_dist_fn(step)
    if fwd >= (outgoing_local - local_id) % nodes_per_machine:
        fwd += 1
    send = machine_id * nodes_per_machine + (local_id + fwd) % nodes_per_machine
    bwd = inner_dist_fn(step)
    if bwd >= (local_id - outgoing_local) % nodes_per_machine:
        bwd += 1
    recv = machine_id * nodes_per_machine + (local_id - bwd) % nodes_per_machine
    return send, recv


def GetInnerOuterRingDynamicSendRecvRanks(
        world_size: int, local_size: int, self_rank: int,
) -> Iterator[Tuple[List[int], List[int]]]:
    """Inner-ring / outer-ring dynamic walk (reference :399-463).

    Each step one local rank per machine hops to the next machine's same local
    rank; everyone else walks a ring inside the machine that detours around
    the outgoing rank.
    """
    assert world_size % local_size == 0, "homogeneous placement required"
    assert local_size > 2, "needs more than 2 ranks per machine"
    num_machines = world_size // local_size
    step = 0
    while True:
        send, recv = _inner_outer_step(
            num_machines, local_size, self_rank, step,
            inner_dist_fn=lambda _s: 1, outer_dist_fn=lambda _s: 1)
        yield [send], [recv]
        step += 1


def GetInnerOuterExpo2DynamicSendRecvRanks(
        world_size: int, local_size: int, self_rank: int,
) -> Iterator[Tuple[List[int], List[int]]]:
    """Inner-Exp2 / outer-Exp2 dynamic walk — the recommended production
    topology for multi-host training (reference :466-554)."""
    assert world_size % local_size == 0, "homogeneous placement required"
    assert local_size > 2, "needs more than 2 ranks per machine"
    num_machines = world_size // local_size
    outer_n = int(np.log2(num_machines - 1)) + 1 if num_machines > 1 else 1
    inner_n = 1 if local_size == 2 else int(np.log2(local_size - 2)) + 1
    step = 0
    while True:
        send, recv = _inner_outer_step(
            num_machines, local_size, self_rank, step,
            inner_dist_fn=lambda s: 2 ** (s % inner_n),
            outer_dist_fn=lambda s: 2 ** (s % outer_n))
        yield [send], [recv]
        step += 1


# ---------------------------------------------------------------------------
# Hierarchical two-level topology (dense ICI inner x sparse DCN outer)
# ---------------------------------------------------------------------------
#
# TPU pods are two networks in one: cheap dense ICI within a slice, scarce
# DCN links between slices (ops/placement.py models the gap as
# ``dcn_link_cost`` ~ 4x an ICI hop).  The legacy inner/outer dynamic walks
# above approximate the right decomposition but burn one designated rank per
# machine per step on DCN; the HiCCL-style composition below instead runs
# the FULL dense topology inside every slice every step and a one-peer
# dynamic walk *between* slices on its own cadence, with its own
# compression — the two levels priced and executed separately
# (``basics.hierarchical_gossip``).


@dataclass(frozen=True)
class HierarchicalTopology:
    """Two-level gossip topology artifact.

    ``inner``        — dense intra-slice topology over ``slice_size`` local
                       ranks (doubly-stochastic weight matrix; executed
                       over the ICI / LOCAL mesh axis), applied identically
                       inside every slice every step.
    ``outer_phases`` — one-peer dynamic walk over ``n_slices`` slices: each
                       phase is a full slice permutation (cyclic shift);
                       rank ``(m, i)`` exchanges with rank ``(m', i)`` of
                       the peer slice over the DCN level.
    ``outer_every``  — cadence ``k``: the outer level communicates only on
                       steps with ``step % k == 0``; other steps run the
                       inner level alone.
    ``outer_self_weight`` — per-OUTER-STEP self weight ``theta_k`` of the
                       sparse exchange (``x' = theta_k*x + (1-theta_k)*
                       x_peer`` per coordinate).  Built cadence-corrected
                       by :func:`hierarchical_two_level`: the requested
                       cadence-1 weight ``theta`` is raised to
                       ``theta**k`` so one cadence-``k`` exchange carries
                       the outer mixing mass of ``k`` cadence-1 exchanges.

    Every per-step operator — inner-only or inner-then-outer — is doubly
    stochastic (the inner matrix is doubly stochastic per slice and the
    outer is a convex combination of the identity and a permutation), so
    the ``k``-step effective operator is doubly stochastic too: cadence
    changes staleness, never the preserved global mean.
    """
    n: int
    n_slices: int
    slice_size: int
    inner: nx.DiGraph
    outer_phases: Tuple[DynamicPhase, ...]
    outer_every: int = 1
    outer_self_weight: float = 0.5
    inner_kind: str = "exp2"
    outer_kind: str = "exp2"

    # -- step policy --------------------------------------------------------

    @property
    def period(self) -> int:
        """Full schedule period in training steps."""
        return self.outer_every * max(len(self.outer_phases), 1)

    def is_outer_step(self, step: int) -> bool:
        return step % self.outer_every == 0

    def outer_phase_index(self, step: int, sweep_len: int = 1) -> int:
        """Phase of the outer walk at ``step`` (an outer step).

        ``sweep_len > 1`` (sparse outer compression with ``sweep_len``
        rotating index blocks) holds each phase for a full block sweep so
        every coordinate sees every phase — otherwise a block count
        sharing a factor with the phase count would pin some coordinates
        to a single shift distance forever."""
        outer_step = step // self.outer_every
        return (outer_step // max(sweep_len, 1)) % max(
            len(self.outer_phases), 1)

    # -- weight matrices -----------------------------------------------------

    def inner_weight_matrix(self) -> np.ndarray:
        """(slice_size, slice_size) doubly-stochastic inner matrix."""
        return weight_matrix(self.inner)

    def inner_full_matrix(self) -> np.ndarray:
        """(n, n) block-diagonal matrix applying ``inner`` in every slice."""
        return np.kron(np.eye(self.n_slices), self.inner_weight_matrix())

    def outer_slice_matrix(self, phase: int) -> np.ndarray:
        """(n_slices, n_slices) matrix of one outer phase:
        ``theta_k * I + (1 - theta_k) * P_shift`` — doubly stochastic for
        any self weight (convex combination of permutations)."""
        th = self.outer_self_weight
        w = np.eye(self.n_slices) * th
        for src, dst in self.outer_phases[phase].pairs:
            w[src, dst] += 1.0 - th
        return w

    def outer_full_matrix(self, phase: int) -> np.ndarray:
        """(n, n) outer matrix: the slice walk lifted to ranks (rank
        ``(m, i)`` pairs with the SAME local index ``i`` of the peer
        slice)."""
        return np.kron(self.outer_slice_matrix(phase),
                       np.eye(self.slice_size))

    def effective_weight_matrix(self, step: int) -> np.ndarray:
        """(n, n) effective operator of one step in the module-wide
        ``W[src, dst]`` convention: inner first, then (on outer steps) the
        outer exchange — ``x' = W_outer^T (W_inner^T x)``, i.e.
        ``W_eff = W_inner @ W_outer``."""
        w = self.inner_full_matrix()
        if self.outer_phases and self.is_outer_step(step):
            # A single-slice topology has no outer level: every step is
            # the inner operator alone.
            w = w @ self.outer_full_matrix(self.outer_phase_index(step))
        return w

    def product_topology(self, step: int = 0) -> nx.DiGraph:
        """The flat single-level topology equivalent to one hierarchical
        step — the equivalence-test oracle: executing the dense,
        uncompressed, cadence-1 hierarchical mode must match flat
        ``neighbor_allreduce`` over this graph to fp-reassociation
        tolerance."""
        return from_weight_matrix(self.effective_weight_matrix(step))

    def dcn_edges_per_outer_step(self) -> int:
        """Directed inter-slice edges of one outer step (each rank talks
        to exactly one peer rank in another slice)."""
        return self.n if self.n_slices > 1 else 0

    def ici_edges_per_step(self) -> int:
        """Directed intra-slice edges of one step: the inner topology's
        off-diagonal edge count, replicated in every slice — the ONE
        place the wire accounting (telemetry, BENCH json, schedule-dump)
        derives the dense level's per-step rows from."""
        w = self.inner_weight_matrix()
        off = w.copy()
        np.fill_diagonal(off, 0.0)
        return int((off != 0).sum()) * self.n_slices


def _outer_phase_table(n_slices: int, kind: str) -> Tuple[DynamicPhase, ...]:
    if n_slices <= 1:
        return ()
    if kind == "ring":
        return (DynamicPhase(tuple((m + 1) % n_slices
                                   for m in range(n_slices))),)
    if kind == "exp2":
        return tuple(one_peer_exp2_phases(n_slices))
    raise ValueError(
        f"unknown outer walk {kind!r}; expected 'exp2' or 'ring'")


def _inner_graph(slice_size: int, kind: str) -> nx.DiGraph:
    if kind == "exp2":
        return ExponentialTwoGraph(slice_size)
    if kind == "ring":
        return RingGraph(slice_size)
    raise ValueError(
        f"unknown inner topology {kind!r}; expected 'exp2' or 'ring'")


def hierarchical_two_level(n: int, n_slices: int, *,
                           inner: str = "exp2", outer: str = "exp2",
                           outer_every: int = 1,
                           outer_self_weight: float = 0.5,
                           cadence_corrected: bool = True,
                           ) -> HierarchicalTopology:
    """Build the standard two-level topology: dense ``inner`` (exp2/ring)
    inside each of ``n_slices`` equal slices, one-peer dynamic ``outer``
    (exp2 shifts / ring) between slices every ``outer_every`` steps.

    ``outer_self_weight`` is the CADENCE-1 per-exchange self weight
    ``theta`` (default 0.5 — with exp2 shifts and 0.5/0.5 weights a full
    outer sweep of ``log2(n_slices)`` exchanges is an EXACT inter-slice
    average).  With ``cadence_corrected`` (default) the stored per-outer-
    step weight is ``theta ** outer_every``: one cadence-``k`` exchange
    then carries the outer mixing mass of ``k`` cadence-1 exchanges
    (matching self-retention of the non-shared component per ``k``-step
    window), instead of silently diluting the outer level by ``1/k``.
    Any value keeps every operator doubly stochastic, so the ``k``-step
    effective operator still averages — the correction tunes the rate,
    never the preserved mean.
    """
    if n_slices < 1 or n % n_slices:
        raise ValueError(
            f"{n} ranks do not split into {n_slices} equal slices")
    if outer_every < 1:
        raise ValueError(f"outer_every must be >= 1, got {outer_every}")
    if not 0.0 < outer_self_weight < 1.0:
        raise ValueError("outer_self_weight must be in (0, 1), got "
                         f"{outer_self_weight}")
    slice_size = n // n_slices
    theta = (outer_self_weight ** outer_every if cadence_corrected
             else outer_self_weight)
    return HierarchicalTopology(
        n=n, n_slices=n_slices, slice_size=slice_size,
        inner=_inner_graph(slice_size, inner),
        outer_phases=_outer_phase_table(n_slices, outer),
        outer_every=int(outer_every),
        outer_self_weight=float(theta),
        inner_kind=inner, outer_kind=outer)
