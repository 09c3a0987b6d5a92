"""``python -m bluefog_tpu_torch.tools top`` — live fleet dashboard.

The port of ``bluefog_tpu/tools/top.py``: the same polls give the same
frame, byte for byte (its title included), over the port's telemetry
endpoint (``utils/telemetry.py``), link observatory (``utils/linkobs.py``)
and gang directory (``ops/gang.py``).

A curses-free refresh-loop view of a running gang: every interval it
polls each rank's telemetry endpoint (``/metrics`` + ``/healthz``,
served by ``utils/telemetry.start_http_server`` /
``BLUEFOG_TPU_TELEMETRY_PORT``) and renders, in one terminal frame,

  * per-rank health: status, step clock / async lag, deepest tx queue,
    straggler score, measured fused-step overlap (``!``-flagged when
    the measured-vs-modeled divergence crosses the link observatory's
    x3 alert threshold), SLO breaches;
  * the cluster link matrix: per-edge measured one-way delay, jitter and
    measured-vs-modeled divergence (the link observatory's
    ``bf_link_*`` gauges, MAX-merged across ranks exactly as the
    aggregate-snapshot collective merges gauges);
  * membership (epoch, active/suspect ranks) when the churn controller
    is live.

Endpoint discovery, in order of preference:

  --endpoints host:port,host:port,...
      Explicit metrics endpoints, one per process.

  --gang-dir <prefix> [--telemetry-base PORT]
      Read the replicated gang directory
      (``BLUEFOG_TPU_GANG_DIR_PATH`` replicas, ``<prefix>.<proc>.json``)
      for the live processes' HOSTS; each proc's metrics port is
      ``--telemetry-base + proc`` (the ``bfrun --telemetry-port BASE``
      convention: rank r serves on BASE+r).

Plain HTTP + text rendering only — no curses, no live gang membership
of its own; safe to run from a laptop against any reachable
fleet.  ``--once`` (or ``--frames N``) renders and exits, which is also
what the smoke test drives.
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

__all__ = ["parse_prometheus", "scrape", "render_frame", "main_top"]

_CLEAR = "\x1b[2J\x1b[H"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Parse a ``/metrics`` exposition body into the rendered-key form
    the telemetry registry uses (``name{label="v",...}`` -> value)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        if not key:
            continue
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


def scrape(endpoint: str, timeout: float = 2.0) \
        -> Tuple[Optional[Dict[str, float]], Optional[dict]]:
    """One poll of one rank: ``(metrics, health)``, either None on
    error — a dead rank renders as DOWN, it never kills the dashboard."""
    metrics = health = None
    try:
        with urllib.request.urlopen(f"http://{endpoint}/metrics",
                                    timeout=timeout) as r:
            metrics = parse_prometheus(r.read().decode("utf-8", "replace"))
    except (urllib.error.URLError, OSError, ValueError):
        pass
    try:
        with urllib.request.urlopen(f"http://{endpoint}/healthz",
                                    timeout=timeout) as r:
            health = json.loads(r.read().decode("utf-8", "replace"))
    except urllib.error.HTTPError as e:
        # /healthz serves 503 WITH the JSON body when degraded/stalled —
        # that body is the interesting one.
        try:
            health = json.loads(e.read().decode("utf-8", "replace"))
        except ValueError:
            pass
    except (urllib.error.URLError, OSError, ValueError):
        pass
    return metrics, health


def _gauge(metrics: Dict[str, float], name: str) -> Optional[float]:
    vals = [v for k, v in metrics.items()
            if k == name or k.startswith(name + "{")]
    return max(vals) if vals else None


def render_frame(polls: Dict[str, Tuple[Optional[Dict[str, float]],
                                        Optional[dict]]],
                 width: int = 100) -> str:
    """Render one dashboard frame from ``{endpoint: (metrics, health)}``
    polls.  Pure text — the function the smoke test asserts on."""
    from bluefog_tpu_torch.utils import linkobs
    up = {ep: mh for ep, mh in polls.items() if mh[0] is not None}
    lines = [
        f"bluefog_tpu top — {time.strftime('%H:%M:%S')} — "
        f"{len(up)}/{len(polls)} endpoint(s) up",
        "=" * width,
    ]
    # -- membership (any live rank's view; epochs agree by consensus) ------
    member = next((h.get("membership") for _, h in up.values()
                   if h and h.get("membership")), None)
    if member:
        lines.append(
            f"membership: epoch {member.get('epoch')}, "
            f"{len(member.get('active_ranks', []))}/"
            f"{member.get('world_ranks', '?')} ranks active"
            + (f", suspects {member['suspect_ranks']}"
               if member.get("suspect_ranks") else ""))
    # -- per-rank table ----------------------------------------------------
    lines.append(f"{'endpoint':<22} {'status':<9} {'step':>7} "
                 f"{'lag':>5} {'queue':>6} {'straggler':>10} "
                 f"{'ovlp':>7} {'tune':<14} {'slo':<20}")
    lines.append("-" * width)
    for ep in sorted(polls):
        metrics, health = polls[ep]
        if metrics is None:
            lines.append(f"{ep:<22} {'DOWN':<9}")
            continue
        status = (health or {}).get("status", "?")
        a = (health or {}).get("async") or {}
        step = a.get("step", _gauge(metrics, "bf_async_step_lag") and "?")
        lag = a.get("step_lag")
        if lag is None:
            lag = _gauge(metrics, "bf_async_step_lag")
        q = (health or {}).get("win_tx_deepest_queue", {}).get("depth")
        if q is None:
            q = _gauge(metrics, "bf_win_tx_queue_depth")
        sc = (health or {}).get("straggler", {}).get("straggler_score")
        # Measured fused-step overlap (the in-program probes' gauge);
        # flagged, link-observatory style, when measurement and the
        # static model disagree past the x3 alert threshold in either
        # direction — a rank whose puts are NOT hiding where the
        # schedule preview says they should.
        ovlp = _gauge(metrics, "bf_fused_overlap_ratio")
        odiv = _gauge(metrics, "bf_fused_overlap_divergence_ratio")
        ovlp_txt = f"{ovlp:.2f}" if ovlp is not None else "-"
        if odiv is not None and \
                max(odiv, 1.0 / max(odiv, 1e-9)) > linkobs.DIVERGENCE_ALERT:
            ovlp_txt += "!"
        # Self-tuning control plane: "<epoch>:<last knob>", "!"-flagged
        # while a revert-on-regression probation window is open ("-" when
        # the tuner is off: no block, no column content).
        tb = (health or {}).get("tuner") or {}
        if tb:
            # Truncate BEFORE the probation flag: the "!" must survive a
            # long knob name in the 14-char cell.
            tune_txt = \
                f"{tb.get('epoch', 0)}:{tb.get('last_knob') or '-'}"[:13]
            if tb.get("probation"):
                tune_txt += "!"
        else:
            te = _gauge(metrics, "bf_tune_epoch")
            tune_txt = f"{te:g}" if te is not None else "-"
        slo = ((health or {}).get("links") or {}).get("slo", {})
        slo_txt = ("BREACH " + ",".join(slo["breached"])
                   if slo.get("breached")
                   else ("ok" if slo.get("rules") else "-"))
        lines.append(
            f"{ep:<22} {status:<9} "
            f"{step if step is not None else '-':>7} "
            f"{f'{lag:g}' if lag is not None else '-':>5} "
            f"{f'{q:g}' if q is not None else '-':>6} "
            f"{f'{sc:.2f}' if sc is not None else '-':>10} "
            f"{ovlp_txt:>7} "
            f"{tune_txt[:14]:<14} "
            f"{slo_txt[:20]:<20}")
    # -- link matrix (gauge-MAX merge: each edge lives on its receiver) ----
    merged = linkobs.merge_link_snapshots(
        [m for m, _ in up.values() if m])
    report = linkobs.report_from_snapshot(merged)
    lines.append("")
    if report.get("edges"):
        lines.append(
            f"link matrix ({len(report['edges'])} edge(s)) — "
            f"max divergence x"
            f"{report.get('max_divergence_ratio', 1.0):.2f}:")
        lines.append(f"  {'edge':<12} {'delay_us':>10} {'jitter_us':>10} "
                     f"{'divergence':>11}")
        hot = report.get("hot_edge")
        for r in report["edges"]:
            mark = " <- HOT" if hot and (r["src"], r["dst"]) == \
                (hot["src"], hot["dst"]) else ""
            edge = "{} -> {}".format(r["src"], r["dst"])
            lines.append(
                f"  {edge:<12} "
                f"{r.get('delay_us', 0.0):>10.1f} "
                f"{r.get('jitter_us', 0.0):>10.1f} "
                f"{r.get('divergence_ratio', 1.0):>11.3f}{mark}")
    else:
        lines.append("link matrix: no bf_link_* series yet "
                     "(BLUEFOG_TPU_LINK_OBS off, or no traced traffic)")
    # -- worst contribution age across the fleet ---------------------------
    ages = [(ep, s, a.get("stalest_sec"))
            for ep, (_, h) in up.items()
            for s, a in ((h or {}).get("contribution_age") or {}).items()
            if a.get("stalest_sec") is not None]
    if ages:
        ep, s, sec = max(ages, key=lambda t: t[2])
        lines.append(f"stalest contribution: src {s} at {ep} "
                     f"({sec:.3f}s)")
    lines.append("=" * width)
    return "\n".join(lines)


def _discover_endpoints(args) -> List[str]:
    if args.endpoints:
        return [e.strip() for e in args.endpoints.split(",") if e.strip()]
    if args.gang_dir:
        from bluefog_tpu_torch.ops.gang import GangDirectory
        d = GangDirectory.load_any(args.gang_dir)
        eps = []
        for proc in (d.active or sorted(d.endpoints)):
            ep = d.endpoints.get(proc)
            if ep is None:
                continue
            host = ep.rsplit(":", 1)[0]
            eps.append(f"{host}:{args.telemetry_base + int(proc)}")
        if eps:
            return eps
        raise SystemExit("top: gang directory has no live endpoints")
    raise SystemExit(
        "top: need --endpoints host:port,... or --gang-dir <prefix> "
        "(with --telemetry-base matching bfrun --telemetry-port)")


def main_top(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.tools top",
        description="live fleet dashboard over /metrics + /healthz")
    p.add_argument("--endpoints", default=None,
                   help="comma-separated metrics endpoints (host:port)")
    p.add_argument("--gang-dir", default=None,
                   help="gang-directory replica prefix "
                        "(BLUEFOG_TPU_GANG_DIR_PATH) for host discovery")
    p.add_argument("--telemetry-base", type=int, default=9100,
                   help="metrics port base with --gang-dir: proc p serves "
                        "on base+p (bfrun --telemetry-port convention; "
                        "default 9100)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds (default 2)")
    p.add_argument("--frames", type=int, default=0,
                   help="render N frames then exit (0 = until Ctrl-C)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (= --frames 1)")
    p.add_argument("--plain", action="store_true",
                   help="never clear the screen between frames (logs, CI)")
    args = p.parse_args(argv)
    endpoints = _discover_endpoints(args)
    frames = 1 if args.once else args.frames
    n = 0
    try:
        while True:
            polls = {ep: scrape(ep) for ep in endpoints}
            frame = render_frame(polls)
            if not args.plain and frames != 1:
                print(_CLEAR, end="")
            print(frame, flush=True)
            n += 1
            if frames and n >= frames:
                return 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main_top())
