"""Physical-topology model, routing cost model and rank-placement optimizer.

The port's copy of ``bluefog_tpu/ops/placement.py``.  The schedule compiler
(``ops/schedule.py`` + ``ops/schedule_opt.py``) is exact about *logical*
cost (which edges exist, how few rounds carry them) but blind to the
physical network: one Exp2 edge between logical neighbors may cross a whole
torus while another round's edges pile onto one link.  TACCL (arxiv
2111.04867) and HiCCL (arxiv 2408.05962) map the communication pattern onto
the interconnect: placement plus contention-aware packing.  The pieces:

  * **Interconnect model** (:class:`TorusModel`): a 2/3-D torus from the
    devices' ``coords`` + ``slice_index`` (TPU devices carry them;
    inter-slice traffic crosses a shared per-slice-pair DCN link, weighted
    ``dcn_link_cost`` hops), or the synthetic
    ``BLUEFOG_TPU_FAKE_TORUS=RxC[xZ]`` torus; CUDA and CPU devices carry no
    geometry, and with no model placement is a no-op.  No model of an
    NVSwitch or InfiniBand GPU node is written here.
  * **Cost model**: every schedule edge is routed dimension-ordered
    (shortest wrap direction per dimension, ties toward +); a schedule
    reports ``max_link_load`` (the busiest link of any round),
    ``hop_bytes`` (total weighted crossings at unit payload) and
    ``serial_link_time`` (the sum of the rounds' bottlenecks).
  * **Placement optimizer** (:func:`optimize_placement`): the logical-rank
    -> device permutation minimizing ``(max_link_load, hop_bytes)`` over
    every phase of the given schedules: a greedy affinity seed and
    simulated annealing from a seeded numpy generator, so every process
    computes the same permutation, the JAX package's bit for bit.  The
    identity is always a candidate and wins ties.

The port's virtual ranks are rows of one tensor, so the permutation moves
no data: ``basics.set_topology`` keeps it, as the JAX package does, to
price the dispatched schedules (``congestion_aware_repack`` and the
synthesis route each edge under it) and for ``placement_info``.
"""

from __future__ import annotations

import hashlib
import math
import threading
import weakref
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.utils.logging import get_logger

__all__ = [
    "TorusModel",
    "MeasuredModel",
    "CostReport",
    "PlacementResult",
    "parse_torus_spec",
    "synthetic_torus",
    "build_model",
    "schedule_rounds",
    "schedule_cost",
    "optimize_placement",
    "set_active",
    "active",
    "predicted_edge_cost",
    "modeled_schedule_hops",
]


# ---------------------------------------------------------------------------
# Interconnect model
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class TorusModel:
    """A wrap-around torus of chips plus optional inter-slice DCN links.

    ``dims``         — per-dimension torus extents (2-D or 3-D).
    ``device_node``  — device index → global node id; several devices may
                       share a node (TPU v2/v3 megacore pairs: 0 hops).
                       Node id = ``slice * prod(dims) + ravel(coords)``.
    ``n_slices``     — number of DCN-connected slices.
    ``dcn_link_cost``— load/hop weight of one DCN crossing relative to one
                       ICI hop (DCN links are the scarce resource; a
                       crossing both costs more hop-bytes and saturates
                       its shared link faster).
    ``wrap``         — per-dimension wraparound flags; empty = every
                       dimension wraps (a full torus).  Sub-pod TPU slices
                       are *meshes* on most axes — modeling wrap links
                       that do not physically exist would let the
                       optimizer route traffic over them and install a
                       placement that is actively wrong on hardware, so
                       :func:`build_model` decides per dimension (see the
                       ``BLUEFOG_TPU_TORUS_WRAP`` policy there).

    Link id space: intra-torus links first (``node * 2*ndims + dim*2 +
    direction``), then one directed DCN link per ordered slice pair.
    """
    name: str
    dims: Tuple[int, ...]
    device_node: Tuple[int, ...]
    n_slices: int = 1
    dcn_link_cost: float = 4.0
    wrap: Tuple[bool, ...] = ()

    @property
    def wrap_dims(self) -> Tuple[bool, ...]:
        return self.wrap if self.wrap else (True,) * len(self.dims)

    # These scalars sit on the routing hot path (millions of calls while
    # building the route table) — plain-int math, cached on the instance
    # (cached_property writes the frozen dataclass's __dict__ directly).
    @cached_property
    def nodes_per_slice(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def n_nodes(self) -> int:
        return self.nodes_per_slice * self.n_slices

    @property
    def first_dcn_link(self) -> int:
        """First DCN link id — the ICI/DCN boundary of the link id space
        (ids below are intra-torus, ids from here on are the per-slice-
        pair DCN links).  The single source of truth consumers splitting
        per-level costs must use, never a re-derived layout formula."""
        return self.n_nodes * 2 * len(self.dims)

    @property
    def n_links(self) -> int:
        return self.first_dcn_link + self.n_slices * self.n_slices

    @cached_property
    def link_weights(self) -> np.ndarray:
        """(n_links,) per-crossing weight: 1.0 ICI, ``dcn_link_cost`` DCN."""
        w = np.ones(self.n_links)
        w[self.first_dcn_link:] = self.dcn_link_cost
        return w

    # -- routing ------------------------------------------------------------

    def _coords(self, node: int) -> Tuple[int, List[int]]:
        sl, flat = divmod(node, self.nodes_per_slice)
        coords = []
        for extent in reversed(self.dims):
            coords.append(flat % extent)
            flat //= extent
        return sl, coords[::-1]

    def _intra_link(self, sl: int, coords: List[int], dim: int,
                    forward: bool) -> int:
        flat = 0
        for c, extent in zip(coords, self.dims):
            flat = flat * extent + c
        node = sl * self.nodes_per_slice + flat
        return node * 2 * len(self.dims) + dim * 2 + (0 if forward else 1)

    def route(self, a: int, b: int) -> np.ndarray:
        """Directed link ids crossed by a packet from node ``a`` to ``b``.

        Dimension-ordered: resolve dim 0 fully, then dim 1, ... taking the
        shorter wrap direction per dimension when the dimension wraps
        (ties go forward, so every rank routes deterministically), the
        direct mesh path otherwise.  Inter-slice packets cross exactly
        the shared ``slice_a → slice_b`` DCN link — intra-slice approach
        hops are deliberately not modeled (the DCN link, not the on-slice
        feed, is the bottleneck resource).
        """
        cache: Dict[Tuple[int, int], np.ndarray] = self.__dict__.setdefault(
            "_route_cache", {})
        hit = cache.get((a, b))
        if hit is not None:
            return hit
        sa, ca = self._coords(a)
        sb, cb = self._coords(b)
        if sa != sb:
            ids = np.asarray([self.first_dcn_link
                              + sa * self.n_slices + sb], np.int64)
            cache[(a, b)] = ids
            return ids
        links: List[int] = []
        cur = list(ca)
        for dim, (extent, wraps) in enumerate(zip(self.dims,
                                                  self.wrap_dims)):
            if wraps:
                fwd = (cb[dim] - cur[dim]) % extent
                if fwd == 0:
                    continue
                steps, forward = (fwd, True) if fwd <= extent - fwd \
                    else (extent - fwd, False)
            else:
                diff = cb[dim] - cur[dim]
                if diff == 0:
                    continue
                steps, forward = abs(diff), diff > 0
            for _ in range(steps):
                links.append(self._intra_link(sa, cur, dim, forward))
                cur[dim] = (cur[dim] + (1 if forward else -1)) % extent
        ids = np.asarray(links, np.int64)
        cache[(a, b)] = ids
        return ids

    def distance(self, a: int, b: int) -> float:
        """Weighted routing distance between two nodes (greedy-seed metric)."""
        if a == b:
            return 0.0
        sa, ca = self._coords(a)
        sb, cb = self._coords(b)
        if sa != sb:
            return self.dcn_link_cost
        return float(sum(
            min((y - x) % e, (x - y) % e) if w else abs(y - x)
            for x, y, e, w in zip(ca, cb, self.dims, self.wrap_dims)))

    # Above this node count the dense (n_nodes² × max-route-length) table
    # the vectorized evaluator gathers from stops being worth its build
    # time/memory; the per-pair route cache path covers the tail.
    _VECTOR_TABLE_MAX_NODES = 256

    @cached_property
    def route_table(self):
        """Dense ``(n_nodes, n_nodes, L)`` int32 route table, padded with
        ``n_links`` (a dummy bin), or ``None`` for very large node sets.
        Built once and cached on the model — it depends only on the
        geometry, never on the placement permutation."""
        n = self.n_nodes
        if n > self._VECTOR_TABLE_MAX_NODES:
            return None
        routes = [[self.route(a, b) for b in range(n)] for a in range(n)]
        width = max((len(r) for row in routes for r in row), default=0)
        tab = np.full((n, n, max(width, 1)), self.n_links, np.int32)
        for a in range(n):
            for b in range(n):
                r = routes[a][b]
                if len(r):
                    tab[a, b, :len(r)] = r
        return tab


@dataclass(frozen=True)
class MeasuredModel(TorusModel):
    """A :class:`TorusModel` whose prices come from *measurement* instead of
    the static ``dcn_link_cost`` constant (the self-tuning control plane,
    ``utils/tuner.py``).

    Two measured layers ride on the inherited geometry:

    ``dcn_link_cost``  — replaced by the measured DCN/ICI relative cost, so
                         every inherited consumer (``link_weights``,
                         ``distance``, the route/evaluator stack,
                         ``optimize_placement``, ``synthesize_schedule``)
                         re-prices automatically through inheritance.
    ``edge_cost``      — sorted ``(src_rank, dst_rank, relative_cost)``
                         tuples per directed *transport* edge.  Rank ids,
                         pre-permutation: the link observatory measures
                         between ranks, not chips, and
                         :func:`predicted_edge_cost` consults this map
                         before falling back to routed distance — closing
                         the divergence loop (once the measured model is
                         active, ``bf_link_divergence_ratio`` prices
                         measurement against measurement and settles).

    ``sketch`` is a content hash of the canonical measured inputs and the
    model's ``name`` is ``measured:<sketch>`` — the placement-search and
    synthesis caches key on ``name``, so re-priced artifacts are cached
    (and attributed in provenance) per measured matrix, never blended with
    the static model's entries.  Built only via :meth:`from_measurements`,
    which sorts and quantizes, so two SPMD ranks fed the same merged
    matrix construct byte-identical models (:meth:`canonical_bytes`)."""
    edge_cost: Tuple[Tuple[int, int, float], ...] = ()
    sketch: str = ""

    @cached_property
    def edge_cost_map(self) -> Dict[Tuple[int, int], float]:
        return {(int(s), int(d)): float(c) for s, d, c in self.edge_cost}

    @staticmethod
    def from_measurements(base: TorusModel,
                          edge_cost: Sequence[Tuple[int, int, float]],
                          dcn_link_cost: Optional[float] = None
                          ) -> "MeasuredModel":
        """Derive a measured model from ``base``'s geometry plus measured
        relative edge costs.  Costs are quantized to 6 decimals and edges
        sorted — the canonical form the sketch hashes, making the result
        independent of measurement arrival order."""
        edges = tuple(sorted((int(s), int(d), round(float(c), 6))
                             for s, d, c in edge_cost))
        dcn = float(base.dcn_link_cost if dcn_link_cost is None
                    else round(float(dcn_link_cost), 6))
        # Geometry + measured prices only — deliberately NOT base.name, so
        # re-measuring from an already-measured model with the same matrix
        # reproduces the same sketch (idempotent re-price).
        canon = "|".join(
            [repr(base.dims), repr(base.device_node),
             str(base.n_slices), dcn.hex(), repr(base.wrap)]
            + [f"{s}>{d}={c.hex()}" for s, d, c in edges])
        sketch = hashlib.sha256(canon.encode()).hexdigest()[:12]
        return MeasuredModel(
            name=f"measured:{sketch}", dims=base.dims,
            device_node=base.device_node, n_slices=base.n_slices,
            dcn_link_cost=dcn, wrap=base.wrap,
            edge_cost=edges, sketch=sketch)

    def canonical_bytes(self) -> bytes:
        """Byte-exact serialization (floats as ``float.hex()``, edges in
        sorted order by construction) — what cross-rank determinism tests
        compare to prove two ranks derived the identical model."""
        parts = [self.name, repr(self.dims), repr(self.device_node),
                 str(self.n_slices), float(self.dcn_link_cost).hex(),
                 repr(self.wrap)]
        parts += [f"{s}>{d}={float(c).hex()}" for s, d, c in self.edge_cost]
        return "|".join(parts).encode()


def parse_torus_spec(spec: str) -> Tuple[int, ...]:
    """Parse ``BLUEFOG_TPU_FAKE_TORUS`` — ``RxC`` or ``XxYxZ`` extents."""
    try:
        dims = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError:
        dims = ()
    if not (1 <= len(dims) <= 3) or any(d < 1 for d in dims) \
            or int(np.prod(dims)) < 2:
        raise ValueError(
            f"BLUEFOG_TPU_FAKE_TORUS={spec!r} is not a valid torus spec; "
            "expected 'RxC' or 'XxYxZ' with positive extents and >= 2 "
            "nodes total (e.g. 4x8)")
    return dims


def synthetic_torus(dims: Sequence[int], n_devices: Optional[int] = None,
                    name: Optional[str] = None,
                    n_slices: int = 1) -> TorusModel:
    """Synthetic torus with device ``i`` on node ``i`` (row-major;
    slice-contiguous when ``n_slices > 1`` — devices ``0..nodes-1`` fill
    slice 0, the next block slice 1, ... with one shared DCN link per
    ordered slice pair, exactly like the real-coords multi-slice model).

    ``n_devices`` may exceed the node count when several devices share a
    chip (must divide evenly: devices ``i`` maps to node
    ``i // (n_devices/nodes)``)."""
    dims = tuple(int(d) for d in dims)
    n_slices = int(n_slices)
    nodes = int(np.prod(dims)) * max(n_slices, 1)
    n_devices = nodes if n_devices is None else int(n_devices)
    if n_devices % nodes:
        raise ValueError(
            f"{n_devices} devices do not divide evenly over a "
            f"{'x'.join(map(str, dims))} torus ({nodes} nodes)")
    per = n_devices // nodes
    base = "fake-torus-" + "x".join(map(str, dims))
    if n_slices > 1:
        base += f"-{n_slices}slices"
    return TorusModel(
        name=name or base,
        dims=dims,
        device_node=tuple(i // per for i in range(n_devices)),
        n_slices=max(n_slices, 1))


def build_model(devices) -> Optional[TorusModel]:
    """Interconnect model for a device list, or None (flat fallback).

    Resolution order: the ``BLUEFOG_TPU_FAKE_TORUS`` spec (synthetic torus
    over exactly ``len(devices)`` nodes — a mismatch logs a warning and
    disables the model rather than silently mis-modeling), then real
    ``device.coords`` / ``slice_index`` (TPU), else None — CPU/GPU devices
    carry no interconnect geometry, and with no model the placement layer
    is a structural no-op.

    Real-coords builds decide per-dimension wraparound from the
    ``BLUEFOG_TPU_TORUS_WRAP`` policy: ``auto`` (default) enables wrap on
    3-D dimensions that are multiples of 4 (the v4/v5p optical-wraparound
    slice rule) and models 2-D (v2/v3 sub-pod) slices as meshes; ``1`` /
    ``0`` force all-wrap / no-wrap for operators who know their slice.
    Modeling a wrap link that does not exist would let the optimizer
    route traffic over it — worse than under-modeling, because the
    installed placement would be actively wrong on hardware.  The
    synthetic fake torus always wraps (it is, by declaration, a torus).
    """
    from bluefog_tpu_torch.utils import config
    spec = config.get().fake_torus
    n = len(devices)
    if spec:
        try:
            dims = parse_torus_spec(spec)
            nodes = 1
            for d in dims:
                nodes *= d
            if nodes != n:
                # Exact match only: synthetic_torus CAN share a node
                # among several devices, but for the env spec a divisor
                # count is far more likely a typo (2x2 for 2x4) than an
                # intent — and a silently mis-modeled geometry drives a
                # real device permutation.
                raise ValueError(
                    f"BLUEFOG_TPU_FAKE_TORUS={spec!r} has {nodes} nodes "
                    f"but the mesh has {n} devices")
            return synthetic_torus(dims, n_devices=n)
        except ValueError as e:
            get_logger().warning(
                "ignoring BLUEFOG_TPU_FAKE_TORUS (%s); physical placement "
                "disabled", e)
            return None
    if n < 2:
        return None
    coords = [getattr(d, "coords", None) for d in devices]
    if any(c is None for c in coords):
        return None
    try:
        coords = [tuple(int(x) for x in c) for c in coords]
    except TypeError:
        return None
    ndims = len(coords[0])
    if not (2 <= ndims <= 3) or any(len(c) != ndims for c in coords):
        return None
    slices = [int(getattr(d, "slice_index", 0) or 0) for d in devices]
    slice_ids = sorted(set(slices))
    slice_pos = {s: i for i, s in enumerate(slice_ids)}
    dims = tuple(max(c[d] for c in coords) + 1 for d in range(ndims))
    # Drop trailing singleton dims (v2/v3 expose (x, y, 0)).
    while len(dims) > 2 and dims[-1] == 1:
        dims = dims[:-1]
        coords = [c[:len(dims)] for c in coords]
    nodes = int(np.prod(dims))
    node_of = []
    for c, s in zip(coords, slices):
        flat = 0
        for x, extent in zip(c, dims):
            flat = flat * extent + x
        node_of.append(slice_pos[s] * nodes + flat)
    policy = (config.get().torus_wrap or "auto").lower()
    if policy in ("1", "true", "always"):
        wrap = (True,) * len(dims)
    elif policy in ("0", "false", "never"):
        wrap = (False,) * len(dims)
    else:  # auto
        if len(dims) >= 3:
            wrap = tuple(d >= 4 and d % 4 == 0 for d in dims)
        else:
            wrap = (False,) * len(dims)
    kind = "torus" if all(wrap) else "mesh"
    name = f"tpu-{kind}-" + "x".join(map(str, dims))
    if len(slice_ids) > 1:
        name += f"-{len(slice_ids)}slices"
    return TorusModel(name=name, dims=dims, device_node=tuple(node_of),
                      n_slices=len(slice_ids), wrap=wrap)


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CostReport:
    """Modeled physical cost of a round sequence at unit payload per edge."""
    max_link_load: float      # max over rounds of the busiest link's load
    hop_bytes: float          # total weighted link crossings
    serial_link_time: float   # sum of per-round bottlenecks (modeled time)
    rounds: int


def schedule_rounds(scheds) -> List[List[Tuple[int, int]]]:
    """Flatten schedules (Static/Dynamic/PairGossip, or a list of them)
    into the per-round (src, dst) edge lists — the contention domains (a
    round's ppermutes fly concurrently; rounds serialize)."""
    if isinstance(scheds, (list, tuple)):
        out: List[List[Tuple[int, int]]] = []
        for s in scheds:
            out.extend(schedule_rounds(s))
        return out
    phases = getattr(scheds, "phases", None)
    if phases is not None:
        return schedule_rounds(list(phases))
    rnd = getattr(scheds, "round", None)
    rounds = scheds.rounds if rnd is None else (rnd,)
    return [list(r.pairs) for r in rounds]


class _Evaluator:
    """Vectorized cost evaluation of one round set under a permutation.

    The annealing loop calls :meth:`cost` thousands of times, so routing
    must not run per edge per call: the model's dense route table (node →
    node → padded link ids, permutation-independent) turns one round's
    evaluation into a single gather + bincount.  Models too large for the
    table fall back to the per-pair route cache."""

    def __init__(self, model: TorusModel, rounds: List[List[Tuple[int, int]]]):
        self.model = model
        self.rounds = [r for r in rounds if r]
        self.lw = model.link_weights
        self.n_links = model.n_links
        self.node = np.asarray(model.device_node, np.int64)
        self._tab = model.route_table
        if self._tab is not None:
            self._srcs = [np.asarray([s for s, _ in r], np.int64)
                          for r in self.rounds]
            self._dsts = [np.asarray([d for _, d in r], np.int64)
                          for r in self.rounds]
        # Lexicographic scalarization for annealing: K exceeds any
        # achievable hop_bytes, so E = mll * K + hop_bytes orders exactly
        # like (mll, hop_bytes).
        total_edges = sum(len(r) for r in rounds)
        max_route_w = (sum(d // 2 if w else d - 1
                           for d, w in zip(model.dims, model.wrap_dims))
                       + model.dcn_link_cost)
        self.K = float(total_edges * max_route_w + 1.0)

    def cost(self, perm: np.ndarray) -> CostReport:
        mll = 0.0
        hop = 0.0
        serial = 0.0
        if self._tab is not None:
            pnode = self.node[perm]
            for srcs, dsts in zip(self._srcs, self._dsts):
                cat = self._tab[pnode[srcs], pnode[dsts]].ravel()
                # minlength/slice drop the padding bin (id == n_links).
                loads = np.bincount(
                    cat, minlength=self.n_links + 1)[:self.n_links] * self.lw
                if not loads.size:
                    continue
                b = float(loads.max())
                if b == 0.0:
                    continue
                mll = max(mll, b)
                serial += b
                hop += float(loads.sum())
            return CostReport(max_link_load=mll, hop_bytes=hop,
                              serial_link_time=serial,
                              rounds=len(self.rounds))
        for pairs in self.rounds:
            ids = [self.model.route(int(self.node[perm[s]]),
                                    int(self.node[perm[d]]))
                   for s, d in pairs]
            cat = np.concatenate(ids) if ids else np.empty(0, np.int64)
            if cat.size == 0:
                continue
            loads = np.bincount(cat, minlength=self.n_links) * self.lw
            b = float(loads.max())
            mll = max(mll, b)
            serial += b
            hop += float(self.lw[cat].sum())
        return CostReport(max_link_load=mll, hop_bytes=hop,
                          serial_link_time=serial, rounds=len(self.rounds))

    def energy(self, perm: np.ndarray) -> float:
        c = self.cost(perm)
        return c.max_link_load * self.K + c.hop_bytes


def schedule_cost(model: TorusModel, scheds,
                  perm: Optional[np.ndarray] = None) -> CostReport:
    """Modeled cost of compiled schedule(s) under a placement (None =
    enumeration order)."""
    rounds = schedule_rounds(scheds)
    ev = _Evaluator(model, rounds)
    n = len(model.device_node)
    if perm is None:
        perm = np.arange(n)
    return ev.cost(np.asarray(perm, np.int64))


# ---------------------------------------------------------------------------
# Placement optimizer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlacementResult:
    perm: np.ndarray           # logical rank -> device index
    is_identity: bool
    identity_cost: CostReport
    optimized_cost: CostReport
    improvement_ratio: float   # identity mll / optimized mll (>= 1.0)
    model_name: str


def _affinity(rounds: List[List[Tuple[int, int]]],
              n: int) -> Dict[int, Dict[int, float]]:
    """Undirected rank-affinity weights: how often two ranks exchange."""
    aff: Dict[int, Dict[int, float]] = {i: {} for i in range(n)}
    for pairs in rounds:
        for s, d in pairs:
            if s == d:
                continue
            aff[s][d] = aff[s].get(d, 0.0) + 1.0
            aff[d][s] = aff[d].get(s, 0.0) + 1.0
    return aff


def _greedy_seed(model: TorusModel, rounds, n: int,
                 block: Optional[int] = None) -> np.ndarray:
    """Affinity-greedy construction: place the most-connected rank first,
    then repeatedly place the rank with the heaviest ties to the placed
    set on the free device minimizing weighted routing distance to its
    placed neighbors.  Deterministic (ties break on lowest index).

    ``block``: restrict rank ``r`` to devices ``d`` with ``d // block ==
    r // block`` (machine-locality constraint — see
    :func:`optimize_placement`)."""
    aff = _affinity(rounds, n)
    node = model.device_node
    placed: Dict[int, int] = {}          # rank -> device
    free = list(range(n))

    def candidates(rank: int) -> List[int]:
        if block is None:
            return list(range(len(free)))
        blk = rank // block
        return [i for i, dev in enumerate(free) if dev // block == blk]

    order_key = lambda r: (-sum(aff[r].values()), r)
    first = min(range(n), key=order_key)
    placed[first] = free.pop(candidates(first)[0])
    while len(placed) < n:
        # Next rank: strongest pull toward the placed set.
        best_r, best_pull = None, (-1.0, 0)
        for r in range(n):
            if r in placed:
                continue
            pull = sum(w for q, w in aff[r].items() if q in placed)
            key = (pull, -r)
            if best_r is None or key > best_pull:
                best_r, best_pull = r, key
        nbrs = [(placed[q], w) for q, w in aff[best_r].items() if q in placed]
        cands = candidates(best_r)
        best_i, best_cost = cands[0], math.inf
        for i in cands:
            dev = free[i]
            c = sum(w * model.distance(node[dev], node[pdev])
                    for pdev, w in nbrs)
            if c < best_cost:
                best_i, best_cost = i, c
        placed[best_r] = free.pop(best_i)
    perm = np.empty(n, np.int64)
    for r, dev in placed.items():
        perm[r] = dev
    return perm


def _anneal(ev: _Evaluator, start: np.ndarray, iters: int,
            rng: np.random.Generator,
            block: Optional[int] = None) -> np.ndarray:
    """Pairwise-swap simulated annealing on the rank→device permutation.
    With ``block`` set, swaps stay within one block so the machine-
    locality constraint of the start permutation is preserved."""
    n = len(start)
    if block is not None and block < 2:
        return start.copy()  # singleton blocks: no legal swap exists
    perm = start.copy()
    cur = ev.energy(perm)
    best, best_e = perm.copy(), cur
    t0 = max(cur * 0.02, 1.0)
    tf = max(t0 * 1e-3, 1e-6)
    for it in range(max(iters, 0)):
        t = t0 * (tf / t0) ** (it / max(iters - 1, 1))
        if block is None:
            i, j = rng.choice(n, size=2, replace=False)
        else:
            base = int(rng.integers(n // block)) * block
            i, j = (base + int(x)
                    for x in rng.choice(block, size=2, replace=False))
        perm[i], perm[j] = perm[j], perm[i]
        e = ev.energy(perm)
        if e <= cur or rng.random() < math.exp(min((cur - e) / t, 0.0)):
            cur = e
            if e < best_e:
                best, best_e = perm.copy(), e
        else:
            perm[i], perm[j] = perm[j], perm[i]
    return best


# Slow-path scale guards: above the dense route table's node cutoff every
# annealing step routes each edge in Python, and the greedy seed is
# O(n² · degree) distance calls — unguarded, the default-on search would
# turn init()/set_topology() on a pod-scale slice into minutes of blocking
# time.  Cap total slow-path edge evaluations and the greedy seed's rank
# count (the clamp is logged; operators who want the full search anyway
# can raise BLUEFOG_TPU_PLACEMENT_ITERS, or skip it with PLACEMENT=0).
_SLOW_EVAL_BUDGET = 1_500_000
_GREEDY_MAX_RANKS = 1024


def optimize_placement(model: TorusModel, scheds, n: int, *,
                       iters: int = 1000, seed: int = 0,
                       block: Optional[int] = None) -> PlacementResult:
    """Best logical-rank → device permutation for the given schedule(s).

    Lexicographic objective ``(max_link_load, hop_bytes)`` over the union
    of every phase's rounds.  Candidates: identity, the greedy affinity
    seed, and the annealed refinement of the better of the two; identity
    wins ties, so an already-optimal (shift-structured) placement is
    returned unchanged and NOTHING is ever made worse than enumeration
    order.  Deterministic in ``seed`` — every SPMD process computes the
    identical permutation from the identical schedule.

    ``block``: machine-locality constraint — the search only considers
    permutations with ``perm[r] // block == r // block``, i.e. each rank
    stays on its enumeration-order machine (devices are enumerated
    process-contiguously, and the hierarchical ``(machine, local)`` mesh
    reshapes consecutive blocks).  The rank-axis search is blind to the
    hierarchical schedules, so without the constraint it could scatter a
    "machine's" ranks across hosts and silently turn every LOCAL_AXIS
    collective into DCN traffic.  A block that does not divide ``n``
    disables the search entirely (identity is returned — never guess at
    a constraint we cannot honor).
    """
    if len(model.device_node) != n:
        raise ValueError(
            f"model covers {len(model.device_node)} devices, need {n}")
    if block is not None and (block < 1 or n % block):
        block = 0  # unhonorable constraint: fall through to identity
    rounds = schedule_rounds(scheds)
    ev = _Evaluator(model, rounds)
    identity = np.arange(n, dtype=np.int64)
    id_cost = ev.cost(identity)
    key = lambda c: (c.max_link_load, c.hop_bytes)

    candidates = [(identity, id_cost)]
    if block != 0:
        if ev._tab is None:
            total_edges = max(sum(len(r) for r in rounds), 1)
            capped = max(_SLOW_EVAL_BUDGET // total_edges, 32)
            if capped < iters:
                get_logger().warning(
                    "placement search on %s (%d nodes, no dense route "
                    "table): annealing capped at %d of %d iterations to "
                    "bound init-time search cost", model.name,
                    model.n_nodes, capped, iters)
                iters = capped
        sa_start = identity
        if n <= _GREEDY_MAX_RANKS:
            greedy = _greedy_seed(model, rounds, n, block)
            g_cost = ev.cost(greedy)
            candidates.append((greedy, g_cost))
            if key(g_cost) < key(id_cost):
                sa_start = greedy
        rng = np.random.default_rng(seed)
        annealed = _anneal(ev, sa_start, iters, rng, block)
        candidates.append((annealed, ev.cost(annealed)))

    best, best_cost = candidates[0]
    for perm, cost in candidates[1:]:
        if key(cost) < key(best_cost):
            best, best_cost = perm, cost
    is_identity = bool((best == identity).all())
    denom = max(best_cost.max_link_load, 1e-12)
    return PlacementResult(
        perm=best, is_identity=is_identity, identity_cost=id_cost,
        optimized_cost=best_cost,
        improvement_ratio=(id_cost.max_link_load / denom
                           if id_cost.max_link_load else 1.0),
        model_name=model.name)


# ---------------------------------------------------------------------------
# Active physical context (set by basics.set_topology, read by wire stats)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: Optional[Tuple[TorusModel, Optional[np.ndarray]]] = None
_active_gen = 0
_hops_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def set_active(model: Optional[TorusModel],
               perm: Optional[np.ndarray]) -> None:
    """Install (or clear, model=None) the process-wide physical context the
    modeled wire-cost telemetry reads.  ``basics`` calls this whenever the
    placement is recomputed; the generation counter invalidates per-
    schedule hop caches."""
    global _active, _active_gen
    with _active_lock:
        _active = None if model is None else (model, perm)
        _active_gen += 1


def active() -> Optional[Tuple[TorusModel, Optional[np.ndarray]]]:
    return _active


def predicted_edge_cost(src: int, dst: int) -> float:
    """The active model's predicted RELATIVE cost for the directed edge
    ``src -> dst`` — what the link observatory prices measured one-way
    delay against (``bf_link_divergence_ratio``).  Uniform 1.0 when no
    model is active (CPU gangs, pre-init): divergence then degrades to
    measured-vs-fastest-link, which is exactly the right alert for a
    modelless run.  Clamped to >= 1.0 — a zero-cost edge (same chip)
    must not make the divergence ratio blow up on wire overhead."""
    with _active_lock:
        act = _active
    if act is None:
        return 1.0
    model, perm = act
    if isinstance(model, MeasuredModel):
        # Measured per-rank edge prices take precedence over routed
        # distance (rank ids, pre-permutation — the observatory measures
        # transport edges, not chips).  Unmeasured edges fall through.
        c = model.edge_cost_map.get((int(src), int(dst)))
        if c is not None:
            return max(float(c), 1.0)
    n = len(model.device_node)
    s, d = int(src), int(dst)
    if not (0 <= s < n and 0 <= d < n):
        return 1.0
    if perm is not None:
        s, d = int(perm[s]), int(perm[d])
    cost = model.distance(int(model.device_node[s]),
                          int(model.device_node[d]))
    return max(float(cost), 1.0)


def modeled_schedule_hops(sched) -> Optional[float]:
    """Modeled weighted hop count of ONE call of a compiled schedule under
    the active physical context, or None when no model is active (or the
    schedule's rank count does not match the modeled device set — e.g.
    machine-level hierarchical schedules).  Unit payload per edge; the
    dispatch layer scales by the per-rank row bytes.  Cached per schedule
    object (schedules are frozen; the cache invalidates on generation).

    The (model, perm, generation) context is snapshotted ONCE — dynamic
    phases all price under the same snapshot, so a concurrent
    ``set_active`` (topology swap on another thread) can never blend two
    models into one reading — and the store re-checks the generation, so
    hops priced against the old model are never cached under the new."""
    with _active_lock:
        act = _active
        gen = _active_gen
    if act is None:
        return None
    model, perm = act
    return _modeled_hops(sched, model, perm, gen)


def _modeled_hops(sched, model: TorusModel, perm: Optional[np.ndarray],
                  gen: int) -> Optional[float]:
    n = getattr(sched, "n", None)
    if n != len(model.device_node):
        return None
    with _active_lock:
        try:
            hit = _hops_cache.get(sched)
        except TypeError:
            hit = None  # non-weakrefable stand-in: uncacheable, not fatal
    if hit is not None and hit[0] == gen:
        return hit[1]
    phases = getattr(sched, "phases", None)
    if phases is not None:  # DynamicSchedule: per-call average over phases
        # Recurse so each phase's value lands in (and reuses) the cache —
        # ONE implementation owns the hop computation below.
        per = [_modeled_hops(ph, model, perm, gen) for ph in phases]
        per = [h for h in per if h is not None]
        hops = sum(per) / len(per) if per else None
    else:
        hops = schedule_cost(model, sched, perm).hop_bytes
    if hops is not None:
        # The DynamicSchedule-level average is cached too: dispatch calls
        # this per op, and re-averaging 16 phases per call (lock + weak
        # lookup each) would blow the ~1µs telemetry budget.
        with _active_lock:
            if gen == _active_gen:
                try:
                    _hops_cache[sched] = (gen, hops)
                except TypeError:
                    pass  # unhashable/unweakrefable stand-ins in tests
    return hops
