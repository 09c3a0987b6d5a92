"""Minimum-round repacking of compiled schedules, and the compile cache.

The port's copy of the numpy core of ``bluefog_tpu/ops/schedule_opt.py``.
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
repeated ``set_topology`` never compiles one matrix twice.  Left out here:
the JAX package's telemetry counters and its ``BLUEFOG_TPU_SCHEDULE_OPT``
switch (the port always repacks, as the JAX package does by default), and
``congestion_aware_repack``, which needs a model of the interconnect.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["optimize_schedule", "min_rounds", "cached_schedule_from_matrix"]


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
    edges, weights, self scales and degrees.  A schedule already at the
    bound (every shift-structured topology) is returned as it is."""
    from bluefog_tpu_torch.ops.schedule import CommRound

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
    return dataclasses.replace(sched, rounds=tuple(rounds))


_CACHE_MAX = 256
_cache: "OrderedDict[tuple, object]" = OrderedDict()
_cache_lock = threading.Lock()


def cached_schedule_from_matrix(w: np.ndarray, build):
    """``build(w)`` memoized on the weight matrix's bytes (FIFO, at most
    256 entries, so per-step weight matrices cannot grow memory without
    bound).  Schedules are frozen and never written, so sharing is safe."""
    wq = np.ascontiguousarray(w, dtype=np.float64)
    key = (wq.shape, wq.tobytes())
    with _cache_lock:
        if key in _cache:
            return _cache[key]
    sched = build(w)
    with _cache_lock:
        if len(_cache) >= _CACHE_MAX:
            _cache.popitem(last=False)
        _cache[key] = sched
    return sched
