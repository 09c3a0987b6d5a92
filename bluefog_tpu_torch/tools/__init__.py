"""Offline host tools over the files a run writes: the port of
``bluefog_tpu/tools/__init__.py``, ``python -m bluefog_tpu_torch.tools``.

Every command reads files in the JAX package's layouts, which the port
writes too, and prints what the JAX command prints, byte for byte:

  python -m bluefog_tpu_torch.tools trace-merge <prefix> [-o merged.json]
      Merge the per-rank timelines ``<prefix><rank>.json``
      (``BLUEFOG_TIMELINE``, ``utils/timeline.py``) into one chrome trace,
      one process lane per rank, the clocks aligned through each rank's
      clock anchor (``bf_clock_anchor``, or the native writer's
      ``<file>.anchor.json``); a truncated file is repaired.

  python -m bluefog_tpu_torch.tools trace-summary <merged.json>
      Per-phase p50/p95/p99 durations from a trace's B/E span pairs.

  python -m bluefog_tpu_torch.tools schedule-dump --topology exp2 --n 64 \
          --torus 8x8 [--slices 2] [--sketch auto] [--rounds] \
          [--hier ...] [--sharded ...] [--lowering fused ...]
      The compiled-schedule pipeline of a topology on a simulated torus:
      one row per stage (naive, Konig repack, congestion repack, sketch
      synthesis) with its rounds and modeled cost, the dispatched
      artifact, and optionally its rounds, the two-level hierarchical
      table, the sharded-gossip table or the fused step's overlap
      preview.  Host math only.

  python -m bluefog_tpu_torch.tools trace-gossip <prefix> [-o out] [--json]
      Merge the flight-recorder dumps ``<prefix>.<rank>.bin``
      (``utils/flightrec.py``) into one chrome trace with a flow arrow
      per sampled wire tag, and print the per-edge one-way-delay table
      (``tools/tracegossip.py``).

  python -m bluefog_tpu_torch.tools bench-trend [dir] [--pattern GLOB]
      The trajectory table of the repo's ``BENCH_r<N>.json`` records,
      with the ``MULTICHIP_r<N>.json`` probe table beside it.

  python -m bluefog_tpu_torch.tools top --endpoints host:port,... | \
          --gang-dir <prefix> [--telemetry-base PORT] [--once]
      Live fleet dashboard (``tools/top.py``): poll every rank's
      ``/metrics`` + ``/healthz`` and render per-rank status, async lag,
      queue depth, straggler score, overlap, tuner and SLO state, the
      merged link matrix, membership and the stalest contribution.

  python -m bluefog_tpu_torch.tools chaos [--np 4] [--device cpu] \
          [--smoke | --delay-smoke | --join-smoke | --kill0-smoke |
           --links-smoke | --tune-smoke]
      The chaos harness (``tools/chaos.py``): a gang under ``bfrun
      --chaos`` that loses a process (or a join, a straggler, a slow
      link), judged on the churn controller's, the async mode's, the link
      observatory's or the tuner's promise.  The gang's rows live on the
      card unless ``--device cpu``.

``python -m bluefog_tpu_torch.tools.metrics_lint`` checks the port's
registered metrics against ``docs/observability.md``.
"""

from __future__ import annotations

import argparse
import glob
import json
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["load_trace_events", "rank_files", "trace_merge",
           "phase_durations", "trace_summary", "schedule_dump",
           "bench_trend", "main"]

_ANCHOR = "bf_clock_anchor"  # timeline.CLOCK_ANCHOR_NAME (no jax import here)


def load_trace_events(path: str) -> Tuple[List[dict], bool]:
    """Parse a chrome-tracing JSON file; returns ``(events, repaired)``.

    Strict parse first; on failure, repair line-by-line — the Python
    timeline writer emits ``[\\n`` then one JSON object per line separated
    by ``,\\n``, so a truncated file (process killed before
    ``stop_timeline``) loses at most its partial tail line."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
        events = data.get("traceEvents", []) if isinstance(data, dict) \
            else data
        return [e for e in events if isinstance(e, dict)], False
    except ValueError:
        pass
    events = []
    body = text.lstrip()
    if body.startswith("["):
        body = body[1:]
    for line in body.splitlines():
        line = line.strip().rstrip(",")
        if not line or line == "]":
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            continue  # the torn tail line of a truncated file
        if isinstance(ev, dict):
            events.append(ev)
    return events, True


def rank_files(prefix: str) -> Dict[int, str]:
    """``{rank: path}`` of the per-rank timelines written under ``prefix``
    (the ``BLUEFOG_TIMELINE`` naming contract: ``<prefix><rank>.json``)."""
    out: Dict[int, str] = {}
    for path in glob.glob(glob.escape(prefix) + "*.json"):
        m = re.fullmatch(re.escape(prefix) + r"(\d+)\.json", path)
        if m:
            out[int(m.group(1))] = path
    return dict(sorted(out.items()))


def _anchor_offset(events: List[dict],
                   path: Optional[str] = None) -> Optional[int]:
    """µs to add to this rank's event timestamps to land on the unix-time
    axis, from its clock-anchor event — or, for the native writer (whose
    wire format cannot carry the anchor in-band), from the
    ``<file>.anchor.json`` sidecar.  None when neither exists
    (pre-anchor files)."""
    for e in events:
        if e.get("name") == _ANCHOR and "args" in e:
            a = e["args"]
            if "unix_us" in a and "monotonic_us" in a:
                return int(a["unix_us"]) - int(a["monotonic_us"])
    if path is not None:
        try:
            with open(path + ".anchor.json") as f:
                a = json.load(f)
            return int(a["unix_us"]) - int(a["monotonic_us"])
        except (OSError, ValueError, KeyError, TypeError):
            pass
    return None


def trace_merge(prefix: str, out_path: Optional[str] = None) -> str:
    """Merge every ``<prefix><rank>.json`` into ``out_path`` (default
    ``<prefix>merged.json``): one process lane per rank, clocks aligned
    via the per-rank anchors.  Returns the output path."""
    files = rank_files(prefix)
    if not files:
        raise FileNotFoundError(
            f"no per-rank timeline files match {prefix}<rank>.json")
    per_rank: Dict[int, List[dict]] = {}
    offsets: Dict[int, Optional[int]] = {}
    repaired_ranks: List[int] = []
    for rank, path in files.items():
        events, repaired = load_trace_events(path)
        per_rank[rank] = events
        offsets[rank] = _anchor_offset(events, path)
        if repaired:
            repaired_ranks.append(rank)
    # Rebase the merged timeline so t=0 is the earliest aligned event
    # (chrome renders absolute-µs traces fine, but small numbers are
    # readable and diffable).
    aligned_starts = [
        min((int(e["ts"]) + off for e in evs if "ts" in e), default=None)
        for r, evs in per_rank.items()
        if (off := offsets[r]) is not None]
    base = min((s for s in aligned_starts if s is not None), default=0)
    merged: List[dict] = []
    for rank, events in per_rank.items():
        merged.append({"name": "process_name", "ph": "M", "pid": rank,
                       "tid": 0, "ts": 0, "args": {"name": f"rank {rank}"}})
        merged.append({"name": "process_sort_index", "ph": "M", "pid": rank,
                       "tid": 0, "ts": 0, "args": {"sort_index": rank}})
        off = offsets[rank]
        if off is not None:
            shift = off - base
        else:
            # No anchor: this rank cannot be wall-aligned; rebase its own
            # first event to t=0 so its lane is at least readable.
            tmin = min((int(e["ts"]) for e in events if "ts" in e),
                       default=0)
            shift = -tmin
        for e in events:
            if e.get("name") == _ANCHOR:
                continue  # consumed; a lane-local M event would just confuse
            ev = dict(e)
            ev["pid"] = rank
            if "ts" in ev:
                ev["ts"] = int(ev["ts"]) + shift
            merged.append(ev)
    if out_path is None:
        out_path = prefix + "merged.json"
    with open(out_path, "w") as f:
        json.dump(merged, f)
    unaligned = sorted(r for r, off in offsets.items() if off is None)
    if unaligned:
        import sys
        print(f"trace-merge: rank(s) {unaligned} carry no clock anchor "
              "(native writer or pre-anchor file); their lanes start at "
              "t=0 instead of wall-aligned", file=sys.stderr)
    if repaired_ranks:
        import sys
        print(f"trace-merge: repaired truncated input for rank(s) "
              f"{repaired_ranks}", file=sys.stderr)
    return out_path


def phase_durations(events: List[dict]) -> Tuple[Dict[str, List[float]],
                                                 int]:
    """``({span name: [duration µs]}, unmatched_begins)`` from B/E pairs
    (per pid/tid/cat/name stack, so nested and concurrent spans pair
    correctly) and complete ``X`` events.

    ``unmatched_begins`` counts B events whose E never arrived — dropped
    under writer-queue overload or lost to file truncation.  Nonzero means
    some durations for those span keys may be unreliable (a later E can
    pair with a stale B and absorb the gap), so the summary must say so
    rather than report an inflated tail silently."""
    stacks: Dict[tuple, List[int]] = {}
    durs: Dict[str, List[float]] = {}
    for e in sorted((e for e in events if "ts" in e),
                    key=lambda e: int(e["ts"])):
        ph = e.get("ph")
        name = e.get("name", "?")
        if ph == "X":
            durs.setdefault(name, []).append(float(e.get("dur", 0)))
            continue
        key = (e.get("pid"), e.get("tid"), e.get("cat"), name)
        if ph == "B":
            stacks.setdefault(key, []).append(int(e["ts"]))
        elif ph == "E":
            st = stacks.get(key)
            if st:
                durs.setdefault(name, []).append(float(int(e["ts"])
                                                       - st.pop()))
    unmatched = sum(len(st) for st in stacks.values())
    return durs, unmatched


def trace_summary(path: str) -> str:
    """Per-phase p50/p95/p99 table (text) from a trace file's spans."""
    import numpy as np
    events, _ = load_trace_events(path)
    durs, unmatched = phase_durations(events)
    if not durs:
        return "trace-summary: no complete spans found"
    rows = []
    for name in sorted(durs, key=lambda n: -sum(durs[n])):
        d = np.asarray(durs[name])
        p50, p95, p99 = np.percentile(d, [50, 95, 99])
        rows.append((name, len(d), d.sum() / 1e3, p50 / 1e3, p95 / 1e3,
                     p99 / 1e3))
    width = max(len(r[0]) for r in rows)
    header = (f"{'phase':<{width}}  {'count':>7}  {'total_ms':>10}  "
              f"{'p50_ms':>9}  {'p95_ms':>9}  {'p99_ms':>9}")
    lines = [header, "-" * len(header)]
    for name, cnt, tot, p50, p95, p99 in rows:
        lines.append(f"{name:<{width}}  {cnt:>7}  {tot:>10.3f}  "
                     f"{p50:>9.3f}  {p95:>9.3f}  {p99:>9.3f}")
    if unmatched:
        lines.append(
            f"WARNING: {unmatched} begin event(s) have no matching end "
            "(dropped under writer overload or truncation) — tail "
            "percentiles for their phases may be inflated")
    return "\n".join(lines)


def schedule_dump(topology: str, n: int, torus: str, *, slices: int = 1,
                  degree: int = 4, seed: int = 0, sketch: str = "auto",
                  budget: float = 2.0, optimize_placement: bool = False,
                  show_rounds: bool = False, hier: bool = False,
                  hier_outer_every: int = 1,
                  hier_compression: str = "none",
                  lowering: str = "ppermute", fusion_buckets: int = 4,
                  payload_mb: float = 64.0, sharded: bool = False,
                  replicated_frac: float = 0.5,
                  num_shards: int = 4) -> str:
    """Text report of the schedule pipeline for one topology x torus.

    The artifact refactor makes this nearly free: every stage returns a
    ``CompiledSchedule`` carrying its own provenance, and the cost model
    prices any of them — the dump just lines them up."""
    import numpy as np

    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.ops import schedule_opt as SO
    from bluefog_tpu_torch.ops import synthesis as SY

    makers = {
        "ring": lambda: topo.RingGraph(n),
        "exp2": lambda: topo.ExponentialTwoGraph(n),
        "star": lambda: topo.StarGraph(n),
        "random-regular": lambda: topo.RandomRegularGraph(n, degree,
                                                          seed=seed),
    }
    if topology not in makers:
        raise SystemExit(
            f"schedule-dump: unknown topology {topology!r}; expected one "
            f"of {', '.join(sorted(makers))}")
    if sketch != "auto" and sketch not in SY.SKETCHES:
        raise SystemExit(
            f"schedule-dump: unknown sketch {sketch!r}; expected one of "
            f"auto, {', '.join(SY.SKETCHES)}")
    dims = PL.parse_torus_spec(torus)
    model = PL.synthetic_torus(dims, n_slices=slices)
    if len(model.device_node) != n:
        raise SystemExit(
            f"schedule-dump: torus {torus} x {slices} slice(s) has "
            f"{len(model.device_node)} nodes but --n is {n}")
    w = topo.weight_matrix(makers[topology]())
    naive = S._naive_schedule(w)
    konig = SO.optimize_schedule(naive)
    perm = None
    placement_note = "identity"
    if optimize_placement:
        res = PL.optimize_placement(model, konig, n, seed=0)
        perm = res.perm
        placement_note = ("identity (optimal)" if res.is_identity
                          else "optimized")
    packed = SO.congestion_aware_repack(konig, model, perm,
                                        budget_factor=budget, record=False)
    chosen, ratio = SY.select_schedule(konig, packed, model, perm,
                                       sketch=sketch, budget_factor=budget)
    stages = [("naive", naive), ("konig", konig), ("congestion", packed)]
    if chosen is not packed:
        stages.append((S.schedule_provenance(chosen), chosen))
    if lowering == "fused":
        # The fused-step consumer re-tags the dispatched artifact, same
        # as ops/fused_step.compile_fused_schedule does before reading
        # window_plan() back off it.
        chosen = S.as_compiled(chosen, lowering="fused")
    lines = [
        f"schedule-dump: {topology} over {n} ranks on {model.name} "
        f"({slices} slice(s)), placement={placement_note}, "
        f"sketch={sketch}, round budget={budget}x Konig",
        "",
        f"{'stage':<28} {'rounds':>6} {'max_link_load':>13} "
        f"{'hop_bytes':>10} {'serial_link_time':>16} {'lowering':>10}",
    ]
    lines.append("-" * len(lines[-1]))
    for name, sched in stages:
        c = PL.schedule_cost(model, sched, perm)
        lines.append(f"{name:<28} {len(sched.rounds):>6} "
                     f"{c.max_link_load:>13.1f} {c.hop_bytes:>10.1f} "
                     f"{c.serial_link_time:>16.1f} "
                     f"{getattr(sched, 'lowering', 'ppermute'):>10}")
    lines += [
        "",
        f"dispatched: provenance={S.schedule_provenance(chosen)} "
        f"sketch={getattr(chosen, 'sketch', None)} "
        f"lowering={getattr(chosen, 'lowering', 'ppermute')} "
        f"synth improvement={ratio:.3f}x"
        + ("" if ratio > 1.0 else " (packed retained — tie or no win)"),
    ]
    if lowering == "fused":
        from bluefog_tpu_torch.ops import fused_step as FS
        total = int(payload_mb * (1 << 20))
        k = max(1, int(fusion_buckets))
        per = [total // k + (1 if i < total % k else 0) for i in range(k)]
        lines += [
            "",
            f"fused lowering preview ({k} bucket(s) over "
            f"{payload_mb:g} MB — whole-step compilation pipelines each "
            "bucket's put against the remaining update compute):",
            f"{'bucket':>6} {'bytes':>12} {'ready_at':>9} {'overlap':>8}",
        ]
        for r in FS.modeled_overlap(per):
            lines.append(f"{r['bucket']:>6} {r['bytes']:>12} "
                         f"{r['ready_at']:>9.2f} {r['overlap']:>8.2f}")
    if show_rounds:
        lines.append("")
        node = np.asarray(model.device_node, np.int64)
        p = np.arange(n) if perm is None else np.asarray(perm, np.int64)
        for i, rnd in enumerate(chosen.rounds):
            loads = np.zeros(model.n_links)
            for s, d in rnd.pairs:
                r = model.route(int(node[p[s]]), int(node[p[d]]))
                np.add.at(loads, r, 1.0)
            b = float((loads * model.link_weights).max()) if rnd.pairs \
                else 0.0
            lines.append(f"round {i:>3}: {len(rnd.pairs):>4} edges, "
                         f"bottleneck {b:.1f}  "
                         f"{list(rnd.pairs)[:8]}"
                         + (" ..." if len(rnd.pairs) > 8 else ""))
    if hier:
        lines.append("")
        lines.extend(_hier_dump_lines(
            model, n, slices, hier_outer_every, hier_compression))
    if sharded:
        lines.append("")
        lines.extend(_sharded_dump_lines(
            model, chosen, n, num_shards, replicated_frac, perm))
    return "\n".join(lines)


def _hier_dump_lines(model, n: int, slices: int, outer_every: int,
                     compression: str) -> List[str]:
    """Two-level schedule/cost table for ``schedule-dump --hier``: one row
    per level (plus one per outer phase) with round count, per-step wire
    rows and the modeled (ICI serial, DCN serial) split — the BENCH-json
    ``detail.hierarchy`` numbers in table form."""
    import numpy as np

    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.ops import schedule_opt as SO
    from bluefog_tpu_torch.utils import config as _config

    if slices < 2:
        raise SystemExit(
            "schedule-dump --hier needs --slices >= 2 (a single slice "
            "has no DCN level to split against)")
    try:
        factor = _config.compression_byte_factor(compression)
    except ValueError as e:
        raise SystemExit(f"schedule-dump --hier: {e}")
    ht = topo.hierarchical_two_level(n, slices,
                                     outer_every=max(outer_every, 1))
    first_dcn = model.first_dcn_link

    def split_serial(sched):
        node = np.asarray(model.device_node, np.int64)
        ici = dcn = 0.0
        for rnd in sched.rounds:
            loads = np.zeros(model.n_links)
            for s, d in rnd.pairs:
                np.add.at(loads, model.route(int(node[s]), int(node[d])),
                          1.0)
            ici += float(loads[:first_dcn].max(initial=0.0))
            dcn += float((loads[first_dcn:] * model.dcn_link_cost)
                         .max(initial=0.0))
        return ici, dcn

    inner_sched = SO.optimize_schedule(
        S._naive_schedule(ht.inner_full_matrix()))
    rows = [("inner (ici, every step)", inner_sched, 1.0, 1.0)]
    for p in range(len(ht.outer_phases)):
        sched = SO.optimize_schedule(
            S._naive_schedule(ht.outer_full_matrix(p)))
        rows.append((f"outer phase {p} (dcn, every {ht.outer_every})",
                     sched, factor, 1.0 / ht.outer_every))
    out = [
        f"hierarchy: {slices} slices of {ht.slice_size}, inner=exp2, "
        f"outer=exp2 one-peer, outer_every={ht.outer_every}, "
        f"outer compression={compression} (byte factor {factor}), "
        f"outer self weight={ht.outer_self_weight}",
        "",
        f"{'level':<28} {'rounds':>6} {'rows/step':>10} "
        f"{'ici_serial':>10} {'dcn_serial':>10}",
    ]
    out.append("-" * len(out[-1]))
    for name, sched, byte_f, cadence_f in rows:
        edges = sum(len(r.pairs) for r in sched.rounds)
        ici, dcn = split_serial(sched)
        out.append(
            f"{name:<28} {len(sched.rounds):>6} "
            f"{edges * byte_f * cadence_f:>10.1f} "
            f"{ici * cadence_f:>10.1f} "
            f"{dcn * byte_f * cadence_f:>10.1f}")
    return out


def _sharded_dump_lines(model, full_sched, n: int, num_shards: int,
                        replicated_frac: float, perm) -> List[str]:
    """Per-replica-group table for ``schedule-dump --sharded``: the
    replicated fraction of the tree rides the full topology while each
    sharded slice gossips inside its replica group only — one row per
    group with its round count, per-step wire rows and modeled serial
    cost, plus the merged in-group artifact all groups dispatch as."""
    from types import SimpleNamespace

    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import sharded as SH

    if n % num_shards:
        raise SystemExit(
            f"schedule-dump --sharded: --num-shards {num_shards} must "
            f"divide --n {n}")
    if not 0.0 <= replicated_frac <= 1.0:
        raise SystemExit("schedule-dump --sharded: --replicated-frac "
                         "must be in [0, 1]")
    groups = SH.default_groups(n, num_shards)
    merged, per_group = SH.compile_group_schedules(n, groups)
    coords = tuple(next(c for c, g in enumerate(groups) if r in g)
                   for r in range(n))
    rep_rows = replicated_frac          # rows per unit payload row
    sh_rows = (1.0 - replicated_frac) / num_shards
    full_edges = sum(len(r.pairs) for r in full_sched.rounds)
    c_full = PL.schedule_cost(model, full_sched, perm)
    out = [
        f"sharded gossip: {num_shards} replica group(s) of "
        f"{n // num_shards}, replicated fraction "
        f"{replicated_frac:.2f} (sharded slices never leave their "
        "group — DCN bytes scale with the replicated fraction only)",
        "",
        f"{'component':<26} {'ranks':<12} {'rounds':>6} "
        f"{'rows/step':>10} {'max_link_load':>13} "
        f"{'serial_link_time':>16}",
    ]
    out.append("-" * len(out[-1]))
    out.append(
        f"{'replicated (full topo)':<26} {'0-' + str(n - 1):<12} "
        f"{len(full_sched.rounds):>6} {full_edges * rep_rows:>10.2f} "
        f"{c_full.max_link_load * rep_rows:>13.2f} "
        f"{c_full.serial_link_time * rep_rows:>16.2f}")
    for gi, (ranks, sub) in enumerate(per_group):
        # Price this group's slice of the merged artifact in isolation:
        # its pairs on the real torus routes, other groups silent.
        gset = set(ranks)
        rounds = [SimpleNamespace(
            pairs=[(s, d) for (s, d) in rnd.pairs if s in gset])
            for rnd in merged.rounds]
        gsched = SimpleNamespace(rounds=rounds)
        cg = PL.schedule_cost(model, gsched, perm)
        edges = sum(len(r.pairs) for r in rounds)
        span = f"{min(ranks)}-{max(ranks)}" if len(ranks) > 1 \
            else str(ranks[0])
        out.append(
            f"{'group %d (in-group)' % gi:<26} {span:<12} "
            f"{len(sub.rounds):>6} {edges * sh_rows:>10.2f} "
            f"{cg.max_link_load * sh_rows:>13.2f} "
            f"{cg.serial_link_time * sh_rows:>16.2f}")
    ici, dcn = SH.edge_level_counts(coords, merged)
    cm = PL.schedule_cost(model, merged, perm)
    out.append(
        f"{'merged in-group artifact':<26} {'0-' + str(n - 1):<12} "
        f"{len(merged.rounds):>6} "
        f"{(ici + dcn) * sh_rows:>10.2f} "
        f"{cm.max_link_load * sh_rows:>13.2f} "
        f"{cm.serial_link_time * sh_rows:>16.2f}")
    _, full_dcn = SH.edge_level_counts(coords, full_sched)
    out += [
        "",
        f"per-step DCN rows: replicated {full_dcn * rep_rows:.2f} "
        f"(= {replicated_frac:.0%} of the all-replicated "
        f"{full_dcn:.0f}), sharded {dcn * sh_rows:.2f} (in-group "
        "schedules cross no group boundary)",
    ]
    return out


def bench_trend(directory: str = ".",
                pattern: str = "BENCH_r*.json") -> str:
    """Perf-trajectory table from the repo's per-round bench records.

    Every growth round leaves a ``BENCH_r<N>.json`` (``{"n", "cmd",
    "rc", "tail", "parsed"}``; ``parsed`` is the bench's one-line JSON
    result, or null when the round had no backend).  This tabulates them
    into the trajectory the individual files cannot show: one row per
    round with the headline metric, and the delta against the previous
    round that reported the SAME metric — so a perf regression shows up
    as a signed percentage, not a diff between two JSON blobs.  Pure
    stdlib over local files; no jax, no network."""
    import os
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, pattern))):
        name = os.path.basename(path)
        m = re.search(r"r(\d+)", name)
        rnd = int(m.group(1)) if m else -1
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = None
        rows.append((rnd, name, doc))
    if not rows:
        # A rounds directory can carry only multichip-probe records
        # (CPU-only rigs never write BENCH_r*.json) — still tabulate.
        multichip = _multichip_trend(directory)
        if multichip:
            return "\n".join(multichip)
        return (f"bench-trend: no files match "
                f"{os.path.join(directory, pattern)}")
    lines = [f"{'round':>5}  {'rc':>3}  {'metric':<44} {'value':>12}  "
             f"{'unit':<8} {'vs_prev':>8}  {'vs_base':>8}"]
    lines.append("-" * len(lines[0]))
    last_value: Dict[str, float] = {}
    for rnd, name, doc in sorted(rows):
        if doc is None:
            lines.append(f"{rnd:>5}  {'?':>3}  "
                         f"{'<unreadable: ' + name + '>':<44}")
            continue
        rc = doc.get("rc")
        parsed = doc.get("parsed")
        if not isinstance(parsed, dict):
            lines.append(f"{rnd:>5}  {rc if rc is not None else '?':>3}  "
                         f"{'(no parsed result)':<44}")
            continue
        metric = str(parsed.get("metric", "?"))
        value = parsed.get("value")
        unit = str(parsed.get("unit", ""))
        base = parsed.get("vs_baseline")
        prev_txt = "-"
        if isinstance(value, (int, float)):
            prev = last_value.get(metric)
            if prev:
                prev_txt = f"{(value / prev - 1.0) * 100:+.1f}%"
            last_value[metric] = float(value)
        val_txt = (f"{value:g}" if isinstance(value, (int, float))
                   else "-")
        base_txt = (f"{base:g}x" if isinstance(base, (int, float))
                    else "-")
        lines.append(f"{rnd:>5}  {rc if rc is not None else '?':>3}  "
                     f"{metric:<44} {val_txt:>12}  {unit:<8} "
                     f"{prev_txt:>8}  {base_txt:>8}")
    multichip = _multichip_trend(directory)
    if multichip:
        lines.append("")
        lines.extend(multichip)
    return "\n".join(lines)


def _multichip_trend(directory: str,
                     pattern: str = "MULTICHIP_r*.json") -> List[str]:
    """The multichip-probe trajectory next to the bench one.  These
    records carry a different shape (``{"n_devices", "rc", "ok",
    "skipped", "tail"}`` — no ``parsed`` metric: the probe reports
    whether a >1-chip gang came up, not a number), so they get their own
    pass/skip table rather than rows forced into the bench columns."""
    import os
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, pattern))):
        name = os.path.basename(path)
        m = re.search(r"r(\d+)", name)
        rnd = int(m.group(1)) if m else -1
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = None
        rows.append((rnd, name, doc))
    if not rows:
        return []
    lines = [f"{'round':>5}  {'rc':>3}  {'devices':>8}  {'result':<10}"]
    lines.append("-" * len(lines[0]))
    for rnd, name, doc in sorted(rows):
        if doc is None:
            lines.append(f"{rnd:>5}  {'?':>3}  {'?':>8}  "
                         f"<unreadable: {name}>")
            continue
        rc = doc.get("rc")
        result = ("skip" if doc.get("skipped")
                  else "ok" if doc.get("ok") else "FAIL")
        nd = doc.get("n_devices")
        lines.append(f"{rnd:>5}  {rc if rc is not None else '?':>3}  "
                     f"{nd if nd is not None else '?':>8}  {result:<10}")
    return lines


def main(argv=None) -> int:
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "chaos":
        # The chaos harness owns a rich flag surface (and a --worker mode
        # bfrun re-enters); delegate before the subparser dispatch.
        from bluefog_tpu_torch.tools.chaos import main as chaos_main
        return chaos_main(argv[1:])
    if argv and argv[0] == "top":
        # Same delegation: the dashboard owns its flag surface.
        from bluefog_tpu_torch.tools.top import main_top
        return main_top(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.tools", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser(
        "trace-merge",
        help="merge per-rank BLUEFOG_TIMELINE files into one aligned trace")
    pm.add_argument("prefix", help="the BLUEFOG_TIMELINE prefix the run "
                                   "used (files are <prefix><rank>.json)")
    pm.add_argument("-o", "--output", default=None,
                    help="output path (default <prefix>merged.json)")
    ps = sub.add_parser(
        "trace-summary",
        help="per-phase p50/p95/p99 table from a (merged) trace")
    ps.add_argument("trace", help="trace JSON file (merged or single-rank)")
    pg = sub.add_parser(
        "trace-gossip",
        help="merge per-rank flight-recorder dumps into one chrome trace "
             "with cross-rank gossip flow arrows + a per-edge one-way-"
             "delay table")
    pg.add_argument("prefix",
                    help="the BLUEFOG_TPU_FLIGHT_RECORDER_PATH prefix the "
                         "run used (dumps are <prefix>.<rank>.bin)")
    pg.add_argument("-o", "--output", default=None,
                    help="output path (default <prefix>.merged.json)")
    pg.add_argument("--json", action="store_true",
                    help="emit stats + the per-edge delay table as one "
                         "machine-readable JSON document on stdout")
    pb = sub.add_parser(
        "bench-trend",
        help="perf-trajectory table from the per-round BENCH_r*.json "
             "records: one row per round with the headline metric and "
             "the delta vs the previous round reporting it")
    pb.add_argument("directory", nargs="?", default=".",
                    help="directory holding the BENCH_r*.json files "
                         "(default: current directory)")
    pb.add_argument("--pattern", default="BENCH_r*.json",
                    help="glob for the bench records "
                         "(default BENCH_r*.json)")
    # Listed for --help only; dispatched above.
    sub.add_parser(
        "chaos", add_help=False,
        help="churn-controller chaos harness: kill a gang rank mid-gossip "
             "under bfrun --chaos and assert survivor-only recovery")
    sub.add_parser(
        "top", add_help=False,
        help="live fleet dashboard: poll every rank's /metrics + /healthz "
             "and render the link matrix, stragglers, SLO state and "
             "membership in one refreshing terminal frame")
    pd = sub.add_parser(
        "schedule-dump",
        help="compiled-schedule pipeline report (provenance, rounds, "
             "modeled cost per stage) for a topology on a simulated torus")
    pd.add_argument("--topology", default="exp2",
                    help="ring / exp2 / star / random-regular (default exp2)")
    pd.add_argument("--n", type=int, default=64,
                    help="rank count (must equal torus nodes x slices)")
    pd.add_argument("--torus", default="8x8",
                    help="per-slice torus spec, e.g. 8x8 (default)")
    pd.add_argument("--slices", type=int, default=1,
                    help="DCN-connected slice count (default 1)")
    pd.add_argument("--degree", type=int, default=4,
                    help="random-regular degree (default 4)")
    pd.add_argument("--seed", type=int, default=0,
                    help="random-regular seed (default 0)")
    pd.add_argument("--sketch", default="auto",
                    help="synthesis sketch (default auto)")
    pd.add_argument("--budget", type=float, default=2.0,
                    help="round budget x Konig (default 2.0)")
    pd.add_argument("--optimize-placement", action="store_true",
                    help="price under the optimized placement permutation "
                         "instead of identity")
    pd.add_argument("--rounds", action="store_true",
                    help="also list the dispatched artifact's rounds with "
                         "per-round bottlenecks")
    pd.add_argument("--hier", action="store_true",
                    help="append the two-level hierarchical-gossip table: "
                         "per-level rounds, per-step wire rows and the "
                         "ICI/DCN serial-time split (needs --slices >= 2)")
    pd.add_argument("--hier-outer-every", type=int, default=1,
                    help="--hier: outer (DCN) cadence (default 1)")
    pd.add_argument("--hier-compression", default="none",
                    help="--hier: outer codec none / bf16 / sparse:<frac> "
                         "(default none)")
    pd.add_argument("--lowering", default="ppermute",
                    choices=["ppermute", "fused"],
                    help="dispatch target to preview: 'fused' re-tags the "
                         "chosen schedule for the whole-step compiler "
                         "(BLUEFOG_TPU_FUSED_STEP) and appends the "
                         "modeled per-bucket put/compute overlap table")
    pd.add_argument("--fusion-buckets", type=int, default=4,
                    help="--lowering fused: bucket count for the overlap "
                         "preview (default 4)")
    pd.add_argument("--payload-mb", type=float, default=64.0,
                    help="--lowering fused: modeled per-step payload in "
                         "MB split across the buckets (default 64)")
    pd.add_argument("--sharded", action="store_true",
                    help="append the sharding-aware gossip table "
                         "(BLUEFOG_TPU_SHARDED_GOSSIP): per-replica-"
                         "group rounds, per-step wire rows and modeled "
                         "serial cost, with the DCN rows scaling by "
                         "--replicated-frac")
    pd.add_argument("--replicated-frac", type=float, default=0.5,
                    help="--sharded: replicated byte fraction of the "
                         "tree (default 0.5)")
    pd.add_argument("--num-shards", type=int, default=4,
                    help="--sharded: replica group count; must divide "
                         "--n (default 4)")
    args = parser.parse_args(argv)
    if args.cmd == "schedule-dump":
        print(schedule_dump(
            args.topology, args.n, args.torus, slices=args.slices,
            degree=args.degree, seed=args.seed, sketch=args.sketch,
            budget=args.budget, optimize_placement=args.optimize_placement,
            show_rounds=args.rounds, hier=args.hier,
            hier_outer_every=args.hier_outer_every,
            hier_compression=args.hier_compression,
            lowering=args.lowering, fusion_buckets=args.fusion_buckets,
            payload_mb=args.payload_mb, sharded=args.sharded,
            replicated_frac=args.replicated_frac,
            num_shards=args.num_shards))
        return 0
    if args.cmd == "bench-trend":
        print(bench_trend(args.directory, args.pattern))
        return 0
    if args.cmd == "trace-gossip":
        from bluefog_tpu_torch.tools.tracegossip import main_trace_gossip
        return main_trace_gossip(args.prefix, args.output,
                                 as_json=args.json)
    if args.cmd == "trace-merge":
        out = trace_merge(args.prefix, args.output)
        events, _ = load_trace_events(out)
        lanes = sorted({e.get("pid") for e in events})
        print(f"trace-merge: wrote {out} ({len(events)} events, "
              f"{len(lanes)} rank lane(s))")
        return 0
    print(trace_summary(args.trace))
    return 0
