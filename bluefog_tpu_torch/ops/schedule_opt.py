"""Minimum-round and congestion-aware repacking of compiled schedules, and
the compile cache.

The port's copy of ``bluefog_tpu/ops/schedule_opt.py``.
``ops/schedule.py`` decomposes a topology's edge set by cyclic shift
distance, which is optimal for shift-structured graphs (ring, Exp2,
fully connected) and wasteful for irregular ones: a random 4-regular
digraph over 32 ranks scatters its edges over ~30 distance classes where
4 rounds suffice.  :func:`optimize_schedule` repacks the rounds by proper
bipartite edge colouring (senders on one side, receivers on the other; a
colour class uses each sender and each receiver at most once, i.e. it is
one round), with Kempe-chain alternating paths, which reach exactly
``max(max_outdegree, max_indegree)`` colours, the least any schedule can
have.

The combine is a sum over edges, so repacking changes which terms a round
carries and with them the order of the sum, not the edges or their
weights.  With the repack the port's schedules are the JAX package's round
for round, and its combines agree bit for bit.

:func:`cached_schedule_from_matrix` memoizes the matrix -> schedule
compilation on the weight matrix's bytes, so a dynamic phase table or a
repeated ``set_topology`` never compiles one matrix twice.  The cache is
purely logical: the physical passes (:func:`congestion_aware_repack`, the
synthesis) read the interconnect model and the placement, so they run at
the context's dispatch, whose schedule cache keys on the placement
generation and the passes' knobs (``basics._sched_path_tag``).

With an interconnect model (``ops/placement.py``),
:func:`congestion_aware_repack` makes the opposite move: edges of one round
that share a saturated link serialize on the wire anyway, so they are split
across rounds (up to ``BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET`` times the
König bound) when the link-load model says an extra round beats
contending.

Both report into the telemetry as the JAX package's do (rounds saved,
congestion moves, the compile cache's hits and misses).  Left out here:
the ``BLUEFOG_TPU_SCHEDULE_OPT`` switch (the port always repacks, as the
JAX package does by default).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from bluefog_tpu_torch.utils import telemetry

__all__ = ["optimize_schedule", "congestion_aware_repack", "min_rounds",
           "cached_schedule_from_matrix", "clear_compile_cache",
           "compile_cache_info"]


def _color_edges(edges: List[Tuple[int, int]], n: int) -> List[int]:
    """Proper edge colouring of the bipartite (senders | receivers) graph:
    one colour per edge, at most ``max(max_outdeg, max_indeg)`` colours.
    Edges are coloured in the caller's order, each with the smallest free
    colour, so the result is deterministic."""
    src_tab: List[Dict[int, int]] = [dict() for _ in range(n)]
    dst_tab: List[Dict[int, int]] = [dict() for _ in range(n)]
    color = [-1] * len(edges)

    def lowest_free(used: Dict[int, int]) -> int:
        c = 0
        while c in used:
            c += 1
        return c

    for ei, (s, d) in enumerate(edges):
        cs = lowest_free(src_tab[s])
        cd = lowest_free(dst_tab[d])
        if cs != cd and cs in dst_tab[d]:
            # cs is free at s but used at d: swap the colours of the
            # maximal (cs, cd)-alternating path that starts at d.  It cannot
            # reach s (it could enter s only on a cs edge) nor revisit a
            # node, so afterwards cs is free at both ends.
            path = []
            node, on_dst_side, want = d, True, cs
            while True:
                tab = dst_tab[node] if on_dst_side else src_tab[node]
                e2 = tab.get(want)
                if e2 is None:
                    break
                path.append(e2)
                s2, d2 = edges[e2]
                node = s2 if on_dst_side else d2
                on_dst_side = not on_dst_side
                want = cd if want == cs else cs
            for e2 in path:
                s2, d2 = edges[e2]
                del src_tab[s2][color[e2]]
                del dst_tab[d2][color[e2]]
            for e2 in path:
                s2, d2 = edges[e2]
                color[e2] = cd if color[e2] == cs else cs
                src_tab[s2][color[e2]] = e2
                dst_tab[d2][color[e2]] = e2
        color[ei] = cs
        src_tab[s][cs] = ei
        dst_tab[d][cs] = ei
    return color


def min_rounds(sched) -> int:
    """König's lower bound of a schedule: ``max(max_outdeg, max_indeg)``."""
    return int(max(sched.outdegree.max(initial=0),
                   sched.indegree.max(initial=0)))


def optimize_schedule(sched):
    """``sched`` repacked into ``min_rounds(sched)`` rounds: the same
    edges, weights, self scales and degrees, stamped ``konig``.  A schedule
    already at the bound (every shift-structured topology) is returned as
    it is."""
    from bluefog_tpu_torch.ops.schedule import CommRound, as_compiled

    target = min_rounds(sched)
    if len(sched.rounds) <= target:
        return sched
    n = sched.n
    edges: List[Tuple[int, int]] = []
    weights: List[float] = []
    for rnd in sched.rounds:
        for s, d in rnd.pairs:
            edges.append((s, d))
            weights.append(float(rnd.send_scale[s]))
    colors = _color_edges(edges, n)
    k = max(colors) + 1 if colors else 0
    if k > target:
        raise AssertionError(
            f"edge coloring used {k} rounds, König bound is {target}")
    groups: List[List[int]] = [[] for _ in range(k)]
    for ei, c in enumerate(colors):
        groups[c].append(ei)
    rounds = []
    for grp in groups:
        pairs = tuple(sorted(edges[ei] for ei in grp))
        send_scale = np.zeros(n)
        recv_mask = np.zeros(n)
        src_of = np.full(n, -1, dtype=np.int32)
        for ei in grp:
            s, d = edges[ei]
            send_scale[s] = weights[ei]
            recv_mask[d] = 1.0
            src_of[d] = s
        rounds.append(CommRound(pairs, send_scale, recv_mask, src_of))
    telemetry.inc("bf_schedule_opt_rounds_saved_total",
                  len(sched.rounds) - k)
    # The cost and sketch described the input's rounds: they do not carry.
    return as_compiled(dataclasses.replace(sched, rounds=tuple(rounds)),
                       provenance="konig", modeled_cost=None, sketch=None)


def _rebuild_rounds(rounds_edges, n):
    """CommRounds from per-round ``(src, dst, weight)`` groups (empty
    groups dropped)."""
    from bluefog_tpu_torch.ops.schedule import CommRound
    out = []
    for grp in rounds_edges:
        if not grp:
            continue
        pairs = tuple(sorted((s, d) for s, d, _ in grp))
        send_scale = np.zeros(n)
        recv_mask = np.zeros(n)
        src_of = np.full(n, -1, dtype=np.int32)
        for s, d, w in grp:
            send_scale[s] = w
            recv_mask[d] = 1.0
            src_of[d] = s
        out.append(CommRound(pairs, send_scale, recv_mask, src_of))
    return tuple(out)


def congestion_aware_repack(sched, model, perm=None, *,
                            budget_factor: float = 2.0,
                            max_moves: int = 256,
                            record: bool = True):
    """``sched`` with the edges of its contended rounds moved apart.

    A round costs its busiest link: edges of one round routed over the same
    link serialize on the wire, so a minimal-round schedule can be slower
    than one with more, less contended rounds.  This pass moves edges off
    saturated links into rounds (existing or new) where they fit as a
    partial permutation, taking a move only when the modeled cost strictly
    improves, lexicographically ``(max per-round bottleneck link load, sum
    of per-round squared link loads, round count)``; the round count stays
    within ``ceil(budget_factor * König)`` (``budget_factor <= 0`` turns the
    pass off).  Edges and weights are untouched: the effective weight
    matrix is the same bits, and only the order of the sum moves.

    ``model``/``perm``: the interconnect model and the logical -> device
    permutation (``ops/placement.py``); a schedule over another rank count
    passes through.  ``record``: count the moves
    (``bf_schedule_congestion_moves_total``; the pricing repacks of the
    placement search pass False)."""
    from bluefog_tpu_torch.ops.schedule import as_compiled

    if model is None or budget_factor <= 0 or len(sched.rounds) <= 0:
        return sched
    n = sched.n
    if len(model.device_node) != n:
        return sched
    node = np.asarray(model.device_node, np.int64)
    if perm is None:
        perm = np.arange(n, dtype=np.int64)
    lw = model.link_weights
    n_links = model.n_links

    # Flatten to (src, dst, weight) with each edge's route.
    edges = []
    for rnd in sched.rounds:
        for s, d in rnd.pairs:
            edges.append((s, d, float(rnd.send_scale[s])))
    routes = [model.route(int(node[perm[s]]), int(node[perm[d]]))
              for s, d, _ in edges]
    groups: List[List[int]] = []
    counts: List[np.ndarray] = []
    ei = 0
    for rnd in sched.rounds:
        grp = list(range(ei, ei + len(rnd.pairs)))
        ei += len(rnd.pairs)
        groups.append(grp)
        c = np.zeros(n_links)
        for e in grp:
            np.add.at(c, routes[e], 1.0)
        counts.append(c)

    def bottleneck(c):
        return float((c * lw).max()) if c.size else 0.0

    def energy(c):
        """Sum of squared weighted link loads: strictly decreases on every
        decongesting move, so the search cannot stall where several rounds
        tie at the global max."""
        return float(((c * lw) ** 2).sum())

    botts = [bottleneck(c) for c in counts]
    ens = [energy(c) for c in counts]
    budget = max(len(groups),
                 int(math.ceil(min_rounds(sched) * budget_factor)))
    srcs_of = [set(edges[e][0] for e in grp) for grp in groups]
    dsts_of = [set(edges[e][1] for e in grp) for grp in groups]

    def total_key():
        return (max(botts, default=0.0), sum(ens), len(groups))

    moves = 0
    for _ in range(max_moves):
        if not groups:
            break
        base = total_key()
        if base[0] <= 0:
            break
        # Every round at the global bottleneck is a source; within each,
        # every edge on a maximally loaded link.
        best = None  # (new_key, e, r_src, r2, is_new)
        for r_star, c_star in enumerate(counts):
            if botts[r_star] < base[0]:
                continue
            loads = c_star * lw
            hot_links = np.nonzero(loads >= botts[r_star])[0]
            candidates = [e for e in groups[r_star]
                          if np.isin(routes[e], hot_links).any()]
            for e in candidates:
                s, d, _w = edges[e]
                targets = [r2 for r2 in range(len(groups))
                           if r2 != r_star and s not in srcs_of[r2]
                           and d not in dsts_of[r2]]
                if len(groups) < budget:
                    targets.append(-1)  # open a new round
                ec = np.zeros(n_links)
                np.add.at(ec, routes[e], 1.0)
                b1_new = bottleneck(c_star - ec)
                e1_new = energy(c_star - ec)
                for r2 in targets:
                    if r2 >= 0:
                        b2_old, e2_old = botts[r2], ens[r2]
                        b2_new = bottleneck(counts[r2] + ec)
                        e2_new = energy(counts[r2] + ec)
                        new_rounds = len(groups)
                    else:
                        b2_old, e2_old = 0.0, 0.0
                        b2_new, e2_new = bottleneck(ec), energy(ec)
                        new_rounds = len(groups) + 1
                    new_en = sum(ens) - ens[r_star] - e2_old \
                        + e1_new + e2_new
                    others = [b for i, b in enumerate(botts)
                              if i not in (r_star, r2)]
                    new_max = max(others + [b1_new, b2_new], default=0.0)
                    new_key = (new_max, new_en, new_rounds)
                    if new_key < base and (best is None
                                           or new_key < best[0]):
                        best = (new_key, e, r_star, r2, r2 < 0)
        if best is None:
            break
        _, e, r_star, r2, is_new = best
        s, d, _w = edges[e]
        groups[r_star].remove(e)
        ec = np.zeros(n_links)
        np.add.at(ec, routes[e], 1.0)
        counts[r_star] = counts[r_star] - ec
        botts[r_star] = bottleneck(counts[r_star])
        ens[r_star] = energy(counts[r_star])
        srcs_of[r_star].discard(s)
        dsts_of[r_star].discard(d)
        if is_new:
            groups.append([e])
            counts.append(ec.copy())
            botts.append(bottleneck(ec))
            ens.append(energy(ec))
            srcs_of.append({s})
            dsts_of.append({d})
        else:
            groups[r2].append(e)
            counts[r2] = counts[r2] + ec
            botts[r2] = bottleneck(counts[r2])
            ens[r2] = energy(counts[r2])
            srcs_of[r2].add(s)
            dsts_of[r2].add(d)
        moves += 1

    if moves == 0:
        return sched
    if record:
        telemetry.inc("bf_schedule_congestion_moves_total", moves)
    rounds = _rebuild_rounds(
        [[edges[e] for e in grp] for grp in groups if grp], n)
    return as_compiled(dataclasses.replace(sched, rounds=rounds),
                       provenance="congestion", modeled_cost=None,
                       sketch=None)


_CACHE_MAX = 256
_cache: "OrderedDict[tuple, object]" = OrderedDict()
_cache_lock = threading.Lock()


def clear_compile_cache() -> None:
    """Drop every cached schedule."""
    with _cache_lock:
        _cache.clear()


def compile_cache_info() -> dict:
    """The cache's occupancy, tallied by the schedules' provenance."""
    with _cache_lock:
        by_prov: Dict[str, int] = {}
        for sched in _cache.values():
            tag = getattr(sched, "provenance", "naive")
            by_prov[tag] = by_prov.get(tag, 0) + 1
        return {"entries": len(_cache), "max": _CACHE_MAX,
                "by_provenance": by_prov}


def cached_schedule_from_matrix(w: np.ndarray, build):
    """``build(w)`` memoized on the weight matrix's bytes (FIFO, at most
    256 entries, so per-step weight matrices cannot grow memory without
    bound).  Schedules are frozen and never written, so sharing is safe."""
    wq = np.ascontiguousarray(w, dtype=np.float64)
    key = (wq.shape, wq.tobytes())
    with _cache_lock:
        if key in _cache:
            telemetry.inc("bf_schedule_compile_cache_hits_total")
            return _cache[key]
    telemetry.inc("bf_schedule_compile_cache_misses_total")
    sched = build(w)
    with _cache_lock:
        if len(_cache) >= _CACHE_MAX:
            _cache.popitem(last=False)
        _cache[key] = sched
    return sched
