"""Link observatory: online per-edge delay and bandwidth sensing, and SLO
alerts.

The port of ``bluefog_tpu/utils/linkobs.py``, the same estimators, rules
and reports.  Every schedule, placement and stripe count is priced off the
static torus model (``dcn_link_cost``), while the wire trace tags
(``BLUEFOG_TPU_TRACE_SAMPLE``) measure each edge's real one-way delay.
This module is the online sensing layer: it rides the window store's
commit of a traced message (``ops/window.py``, native and Python drains
alike) and the transport's per-(peer, stripe) tx byte counters
(``ops/transport.py``) to keep, per directed edge:

* one-way delay: an EWMA in µs plus the histogram
  ``bf_link_delay_seconds{src,dst}`` for p50/p99;
* jitter: the RFC-3550 EWMA of consecutive transit-time deltas
  (``bf_link_jitter_us{src,dst}``);
* goodput: bytes/s over windows of at least 0.5 s a (peer, stripe)
  (``bf_link_goodput_bytes{peer,stripe}``);
* retry and error rates: per-second EWMAs diffed from the transport's
  counters (``bf_link_retry_rate{peer}``, ``bf_link_error_rate{peer}``);
* divergence: measured delay against the active placement model's
  predicted cost of the edge (``bf_link_divergence_ratio{src,dst}``), both
  normalized by their own fastest live edge, so a healthy fleet reads
  about 1.0 and one slow link stands out (no model: uniform prediction).

:func:`link_report` assembles the cluster's link matrix over the
aggregate-snapshot collective (``telemetry.aggregate_snapshot``: gauges
merge by MAX, and each edge's gauges live only on its receiver, so the
merge is the matrix).

**SLO engine.**  ``BLUEFOG_TPU_SLO=<metric><op><value>[;<rule>...]`` (e.g.
``link_delay_us>50000;step_lag>128``) declares rules evaluated at step
boundaries (:func:`on_step`, driven by ``window.set_async_step``).  A
rule's first False-to-True transition bumps ``bf_slo_breaches_total{rule}``,
degrades ``/healthz`` (the ``links`` block of ``telemetry.health()``) and
dumps the flight recorder once (its own 30 s limiter).  A rule may name
``link_delay_us``, ``link_jitter_us``, ``link_divergence``,
``goodput_bytes``, ``retry_rate``, ``error_rate``, ``step_lag``,
``queue_depth``, or any literal ``bf_*`` gauge (max over its label sets).

Everything is gated on ``BLUEFOG_TPU_LINK_OBS`` (default on; ``=0`` is
bitwise inert: no registry mutation, every note site one cached config
check).  The ``clear_*`` entry points run even when it is off.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.utils import config, telemetry

__all__ = [
    "enabled", "note_commit", "note_delay", "note_tx", "on_step",
    "parse_slo_rules", "slo_state", "health_summary", "local_report",
    "link_report", "report_from_snapshot", "merge_link_snapshots",
    "clear_edges", "clear_peer", "clear_all", "reset",
    "DIVERGENCE_ALERT",
]

# A link whose normalized measured delay exceeds its normalized predicted
# cost by this factor is "diverged": the static model no longer describes
# it.  Surfaced in ``/healthz``; the SLO grammar can tighten it.
DIVERGENCE_ALERT = 3.0

_EWMA_ALPHA = 0.2          # delay/jitter smoothing (≈ last ~10 samples)
_GOODPUT_WINDOW_S = 0.5    # min window before a goodput rate is published
_GOODPUT_ALPHA = 0.5


class _EdgeStat:
    __slots__ = ("delay_us", "jitter_us", "divergence", "samples",
                 "last_us")

    def __init__(self) -> None:
        self.delay_us = 0.0
        self.jitter_us = 0.0
        self.divergence = 1.0
        self.samples = 0
        self.last_us = 0


class _TxStat:
    __slots__ = ("win_start", "win_bytes", "goodput")

    def __init__(self, now: float) -> None:
        self.win_start = now
        self.win_bytes = 0.0
        self.goodput = 0.0


_lock = threading.Lock()
_edges: Dict[Tuple[int, int], _EdgeStat] = {}
_tx: Dict[Tuple[str, int], _TxStat] = {}
# SLO engine state: parsed rules cached by spec string (config.reload may
# swap the spec), latched breach set, counter bases for rate EWMAs.
_rules_spec: Optional[str] = None
_rules: List["SloRule"] = []
_breached: Dict[str, float] = {}     # rule raw -> value at breach
_rate_base: Dict[Tuple[str, str], float] = {}
_rate_last = [0.0]
_rates: Dict[Tuple[str, str], float] = {}   # (kind, peer) -> per-sec EWMA


def enabled() -> bool:
    """True iff the observatory is armed (``BLUEFOG_TPU_LINK_OBS``)."""
    return config.get().link_obs


# -- ingestion ---------------------------------------------------------------

def note_commit(src: int, dst: int, tag) -> None:
    """Feed one committed trace tag (wire format ``TRACE_TRAILER``:
    src, seq, origin monotonic µs, origin unix µs, origin step).  Called
    from the window commit path for every sampled data message; must be
    O(edges-at-this-rank) and allocation-light."""
    if not enabled() or src < 0 or dst < 0:
        return
    now_us = time.time_ns() // 1000
    note_delay(src, dst, float(max(0, now_us - int(tag[3]))),
               _now_us=now_us)


def note_delay(src: int, dst: int, delay_us: float, *,
               _now_us: Optional[int] = None) -> None:
    """Feed one measured one-way delay sample for edge ``src -> dst``.
    Public so offline samples (a loopback rig that bypasses the window
    commit path) can drive the same estimator."""
    if not enabled() or src < 0 or dst < 0:
        return
    now_us = time.time_ns() // 1000 if _now_us is None else _now_us
    delay_us = max(0.0, float(delay_us))
    with _lock:
        e = _edges.get((src, dst))
        if e is None:
            e = _edges[(src, dst)] = _EdgeStat()
            e.delay_us = delay_us
        else:
            # RFC-3550 jitter: EWMA of consecutive transit-time deltas —
            # immune to the sender's own cadence, unlike inter-arrival.
            d = abs(delay_us - e.delay_us)
            e.jitter_us += _EWMA_ALPHA * (d - e.jitter_us)
            e.delay_us += _EWMA_ALPHA * (delay_us - e.delay_us)
        e.samples += 1
        e.last_us = now_us
        rows = _refresh_divergence_locked()
    _publish_divergence(rows)
    telemetry.set_gauge("bf_link_delay_us", e.delay_us, src=src, dst=dst)
    telemetry.set_gauge("bf_link_jitter_us", e.jitter_us, src=src,
                        dst=dst)
    telemetry.observe("bf_link_delay_seconds", delay_us / 1e6, src=src,
                      dst=dst)


def note_tx(peer: str, stripe: int, nbytes: float) -> None:
    """Feed transmitted payload bytes for (peer, stripe) — the native tx
    stats pump's per-stripe byte diffs, or the Python sender's per-batch
    totals.  Publishes a goodput rate once per ≥0.5 s window."""
    if not enabled() or nbytes <= 0:
        return
    now = time.monotonic()
    rate = None
    with _lock:
        t = _tx.get((peer, stripe))
        if t is None:
            t = _tx[(peer, stripe)] = _TxStat(now)
        t.win_bytes += float(nbytes)
        dt = now - t.win_start
        if dt >= _GOODPUT_WINDOW_S:
            r = t.win_bytes / dt
            t.goodput = r if t.goodput == 0.0 else \
                t.goodput + _GOODPUT_ALPHA * (r - t.goodput)
            t.win_start = now
            t.win_bytes = 0.0
            rate = t.goodput
    if rate is not None:
        telemetry.set_gauge("bf_link_goodput_bytes", rate, peer=peer,
                            stripe=stripe)


def _predicted_edge_cost(src: int, dst: int) -> float:
    # Lazy: utils must not import ops at module load (layering), and a
    # run with no active placement model prices every edge uniformly.
    try:
        from bluefog_tpu_torch.ops import placement
        return float(placement.predicted_edge_cost(src, dst))
    except Exception:  # noqa: BLE001 — sensing never breaks the hot path
        return 1.0


def _refresh_divergence_locked() -> List[Tuple[int, int, float]]:
    """Recompute every edge's divergence ratio.  Both the measured and
    the predicted side are normalized by their own FASTEST live edge, so
    units cancel: an edge that is k× slower than the best link while the
    model prices it only j× dearer reads k/j.  A healthy fleet reads
    ≈1.0; one slow link stands out even against few in-neighbors (a
    median baseline would dilute toward the slow edge itself when a rank
    has only two).  EWMAs, not raw samples, so the min is stable.
    Returns the (src, dst, ratio) list so gauge publication can happen
    outside the lock."""
    live = [(k, e) for k, e in _edges.items() if e.samples > 0]
    if not live:
        return []
    meas = [e.delay_us for _, e in live]
    pred = [_predicted_edge_cost(*k) for k, _ in live]
    mbase = min(meas) or 1.0
    pbase = min(pred) or 1.0
    out = []
    for (k, e), m, p in zip(live, meas, pred):
        e.divergence = (max(m, 1e-9) / mbase) / (max(p, 1e-9) / pbase)
        out.append((k[0], k[1], e.divergence))
    return out


def _publish_divergence(rows) -> None:
    for src, dst, ratio in rows:
        telemetry.set_gauge("bf_link_divergence_ratio", ratio, src=src,
                            dst=dst)


# -- step-boundary evaluation ------------------------------------------------

def on_step(step: int) -> None:
    """Step-boundary tick: refresh divergence gauges, fold the transport
    retry/error counters into per-second rate EWMAs, and evaluate the
    SLO rules.  Driven by ``W.set_async_step``; calling it twice a step
    is harmless (rate windows are wall-clock, breaches are latched)."""
    if not enabled():
        return
    with _lock:
        rows = _refresh_divergence_locked()
    _publish_divergence(rows)
    _update_rates()
    _eval_slo()


# Literal gauge name per rate kind (keyed so metrics-lint can see them).
_RATE_GAUGES = {"retry": "bf_link_retry_rate",
                "error": "bf_link_error_rate"}


def _update_rates() -> None:
    """Per-peer retry/error rates: diff the transport counters against
    the last tick, divide by wall time, EWMA, publish."""
    now = time.monotonic()
    with _lock:
        last = _rate_last[0]
        if last and now - last < 0.2:
            return
        _rate_last[0] = now
    counters, _ = telemetry._raw_series()
    deltas: Dict[Tuple[str, str], float] = {}
    for key, val in counters.items():
        name = key[0]
        if name == "bf_win_tx_retries_total":
            kind = "retry"
        elif name == "bf_win_tx_errors_total":
            kind = "error"
        else:
            continue
        peer = dict(key[1]).get("peer", "")
        deltas[(kind, peer)] = deltas.get((kind, peer), 0.0) + val
    dt = max(1e-3, now - last) if last else None
    with _lock:
        for k, total in deltas.items():
            d = max(0.0, total - _rate_base.get(k, 0.0))
            _rate_base[k] = total
            if dt is None:
                continue    # first tick: establish the base only
            r = d / dt
            prev = _rates.get(k, 0.0)
            _rates[k] = prev + _EWMA_ALPHA * (r - prev)
        out = dict(_rates)
    for (kind, peer), r in out.items():
        telemetry.set_gauge(_RATE_GAUGES[kind], r, peer=peer)


# -- SLO engine --------------------------------------------------------------

class SloRule:
    __slots__ = ("raw", "metric", "op", "threshold")

    def __init__(self, raw: str, metric: str, op: str,
                 threshold: float) -> None:
        self.raw = raw
        self.metric = metric
        self.op = op
        self.threshold = threshold

    def check(self, value: float) -> bool:
        if self.op == ">":
            return value > self.threshold
        if self.op == "<":
            return value < self.threshold
        if self.op == ">=":
            return value >= self.threshold
        return value <= self.threshold


_RULE_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(>=|<=|>|<)\s*"
                      r"([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*$")

_SLO_METRICS = ("link_delay_us", "link_jitter_us", "link_divergence",
                "goodput_bytes", "retry_rate", "error_rate", "step_lag",
                "queue_depth")


def parse_slo_rules(spec: Optional[str]) -> List[SloRule]:
    """Parse ``metric<op>value`` rules, ``;``-separated.  Fails loudly:
    a malformed SLO must stop the run at config time, not silently
    never alert."""
    rules: List[SloRule] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        m = _RULE_RE.match(part)
        if m is None:
            raise ValueError(
                f"BLUEFOG_TPU_SLO: cannot parse rule {part!r} — expected "
                f"<metric><op><value> with op one of > < >= <= "
                f"(e.g. link_delay_us>50000)")
        metric, op, val = m.group(1), m.group(2), float(m.group(3))
        if metric not in _SLO_METRICS and not metric.startswith("bf_"):
            raise ValueError(
                f"BLUEFOG_TPU_SLO: unknown metric {metric!r} — one of "
                f"{', '.join(_SLO_METRICS)} or a literal bf_* gauge name")
        rules.append(SloRule(part, metric, op, val))
    return rules


def _active_rules() -> List[SloRule]:
    global _rules_spec, _rules
    spec = config.get().slo
    with _lock:
        if spec != _rules_spec:
            _rules_spec = spec
            _rules = parse_slo_rules(spec)
        return list(_rules)


def _gauge_max(name: str) -> Optional[float]:
    _, gauges = telemetry._raw_series()
    vals = [v for k, v in gauges.items() if k[0] == name]
    return max(vals) if vals else None


def _metric_value(metric: str) -> Optional[float]:
    """Resolve an SLO metric to its current worst-case value at this
    rank (None when there is no signal yet — a rule never breaches on
    absence)."""
    with _lock:
        if metric == "link_delay_us":
            vals = [e.delay_us for e in _edges.values() if e.samples]
            return max(vals) if vals else None
        if metric == "link_jitter_us":
            vals = [e.jitter_us for e in _edges.values() if e.samples]
            return max(vals) if vals else None
        if metric == "link_divergence":
            vals = [e.divergence for e in _edges.values() if e.samples]
            return max(vals) if vals else None
        if metric == "goodput_bytes":
            vals = [t.goodput for t in _tx.values() if t.goodput > 0]
            return min(vals) if vals else None
        if metric == "retry_rate":
            vals = [v for (k, _), v in _rates.items() if k == "retry"]
            return max(vals) if vals else None
        if metric == "error_rate":
            vals = [v for (k, _), v in _rates.items() if k == "error"]
            return max(vals) if vals else None
    if metric == "step_lag":
        return _gauge_max("bf_async_step_lag")
    if metric == "queue_depth":
        return _gauge_max("bf_win_tx_queue_depth")
    return _gauge_max(metric)


def _eval_slo() -> None:
    rules = _active_rules()
    if not rules:
        return
    for rule in rules:
        value = _metric_value(rule.metric)
        breached = value is not None and rule.check(value)
        with _lock:
            was = rule.raw in _breached
            if breached and not was:
                _breached[rule.raw] = float(value)
            elif not breached and was:
                del _breached[rule.raw]
        if breached and not was:
            from bluefog_tpu_torch.utils import flightrec
            from bluefog_tpu_torch.utils.logging import get_logger
            telemetry.inc("bf_slo_breaches_total", rule=rule.raw)
            get_logger().warning(
                "SLO breach: %s (measured %.6g) — /healthz degraded, "
                "flight recorder dump requested", rule.raw, value)
            # flightrec's own 30 s limiter makes this "one dump per
            # breach storm": every alert ships a postmortem, a flapping
            # rule cannot spend the run rewriting the black box.
            flightrec.dump_on_error(f"SLO breach: {rule.raw}")
        elif was and not breached:
            from bluefog_tpu_torch.utils.logging import get_logger
            get_logger().warning("SLO recovered: %s", rule.raw)


def slo_state() -> dict:
    """The SLO engine's current view: configured rules, latched breaches
    (rule -> value at breach)."""
    rules = _active_rules() if enabled() else []
    with _lock:
        return {"rules": [r.raw for r in rules],
                "breached": dict(_breached)}


# -- reporting ---------------------------------------------------------------

def _edge_label(src: int, dst: int) -> str:
    return f"{src}->{dst}"


def health_summary() -> Optional[dict]:
    """The ``links`` block for ``/healthz``: worst edge,
    max divergence, SLO state.  None when the observatory is off or has
    nothing to say (no edges observed AND no rules configured)."""
    if not enabled():
        return None
    slo = slo_state()
    with _lock:
        live = [(k, e) for k, e in _edges.items() if e.samples]
    if not live and not slo["rules"]:
        return None
    body: dict = {"edges": len(live),
                  "slo": {"rules": slo["rules"],
                          "breached": sorted(slo["breached"])}}
    if live:
        worst_k, worst = max(live, key=lambda kv: kv[1].delay_us)
        body["worst_edge"] = _edge_label(*worst_k)
        body["worst_delay_us"] = round(worst.delay_us, 1)
        body["max_divergence_ratio"] = round(
            max(e.divergence for _, e in live), 3)
    return body


def local_report() -> dict:
    """This rank's link table (its INBOUND edges — the receiver owns the
    delay measurement) plus tx goodput and SLO state, JSON-friendly."""
    edges = []
    with _lock:
        items = sorted(_edges.items())
        tx_items = sorted(_tx.items())
    for (src, dst), e in items:
        if not e.samples:
            continue
        row = {"src": src, "dst": dst,
               "delay_ewma_us": round(e.delay_us, 1),
               "jitter_us": round(e.jitter_us, 1),
               "divergence_ratio": round(e.divergence, 3),
               "samples": e.samples}
        pcts = telemetry.histogram_percentiles(
            "bf_link_delay_seconds", (50.0, 99.0), src=src, dst=dst)
        if pcts:
            row["p50_us"] = round(pcts[50.0] * 1e6, 1)
            row["p99_us"] = round(pcts[99.0] * 1e6, 1)
        edges.append(row)
    goodput = [{"peer": p, "stripe": s,
                "goodput_bytes_s": round(t.goodput, 1)}
               for (p, s), t in tx_items if t.goodput > 0]
    return {"edges": edges, "goodput": goodput, "slo": slo_state()}


_SERIES_RE = re.compile(r'^(bf_link_[a-z_]+)\{(.*)\}$')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def report_from_snapshot(snap: Dict[str, float]) -> dict:
    """Assemble a link matrix from rendered telemetry series (local or
    aggregate).  Pure: snapshots shipped by other means merge with the
    function ``link_report`` uses on a live gang."""
    edges: Dict[Tuple[int, int], dict] = {}
    goodput = []
    for key, val in snap.items():
        m = _SERIES_RE.match(key)
        if m is None:
            continue
        name = m.group(1)
        labels = dict(_LABEL_RE.findall(m.group(2)))
        if name == "bf_link_goodput_bytes":
            goodput.append({"peer": labels.get("peer", "?"),
                            "stripe": labels.get("stripe", "?"),
                            "goodput_bytes_s": val})
            continue
        try:
            edge = (int(labels["src"]), int(labels["dst"]))
        except (KeyError, ValueError):
            continue
        row = edges.setdefault(edge, {"src": edge[0], "dst": edge[1]})
        if name == "bf_link_delay_us":
            row["delay_us"] = val
        elif name == "bf_link_jitter_us":
            row["jitter_us"] = val
        elif name == "bf_link_divergence_ratio":
            row["divergence_ratio"] = val
    rows = [edges[k] for k in sorted(edges)]
    report: dict = {"edges": rows, "goodput": goodput}
    delayed = [r for r in rows if "delay_us" in r]
    if delayed:
        hot = max(delayed, key=lambda r: r["delay_us"])
        report["hot_edge"] = {"src": hot["src"], "dst": hot["dst"],
                              "delay_us": hot["delay_us"]}
        report["max_divergence_ratio"] = max(
            (r.get("divergence_ratio", 1.0) for r in rows), default=1.0)
    return report


def merge_link_snapshots(snaps: List[Dict[str, float]]) -> Dict[str, float]:
    """Gauge-MAX merge of several ranks' ``bf_link_*`` series — what the
    aggregate-snapshot collective does for gauges, usable where no
    collective is available."""
    merged: Dict[str, float] = {}
    for snap in snaps:
        for key, val in snap.items():
            if not key.startswith("bf_link_"):
                continue
            merged[key] = max(merged.get(key, float("-inf")), val)
    return merged


def link_report(aggregate: bool = True) -> dict:
    """The cluster-wide link matrix: every edge's measured delay/jitter/
    divergence plus the hot edge.  ``aggregate=True`` rides the
    aggregate-snapshot COLLECTIVE (all ranks must call it together, like
    any collective); ``aggregate=False`` reads only this rank's inbound
    edges."""
    snap = telemetry.aggregate_snapshot() if aggregate \
        else telemetry.snapshot()
    return report_from_snapshot(snap)


# -- hygiene (runs even when disabled — same contract as telemetry.clear_*) --

def _clear_edge_gauges(keys) -> None:
    for src, dst in keys:
        telemetry.clear_gauge("bf_link_delay_us", src=src, dst=dst)
        telemetry.clear_gauge("bf_link_jitter_us", src=src, dst=dst)
        telemetry.clear_gauge("bf_link_divergence_ratio", src=src,
                              dst=dst)


def clear_edges(ranks) -> None:
    """Drop every edge touching ``ranks`` (a dead peer's link gauges
    must not linger as live delay claims)."""
    dead = set(int(r) for r in ranks)
    if not dead:
        return
    with _lock:
        gone = [k for k in _edges if k[0] in dead or k[1] in dead]
        for k in gone:
            del _edges[k]
    _clear_edge_gauges(gone)


def clear_peer(peer: str) -> None:
    """Drop a transport peer's goodput/rate series (rides
    ``drop_peer``'s per-stripe gauge hygiene)."""
    with _lock:
        gone = [k for k in _tx if k[0] == peer]
        for k in gone:
            del _tx[k]
        rgone = [k for k in _rates if k[1] == peer]
        for k in rgone:
            _rates.pop(k, None)
            _rate_base.pop(k, None)
    for _, stripe in gone:
        telemetry.clear_gauge("bf_link_goodput_bytes", peer=peer,
                              stripe=stripe)
    for kind, _ in rgone:
        telemetry.clear_gauge(_RATE_GAUGES[kind], peer=peer)


def clear_all() -> None:
    """Transport shutdown: retire every link series this process
    published."""
    with _lock:
        edge_keys = list(_edges)
        tx_keys = list(_tx)
        rate_keys = list(_rates)
        _edges.clear()
        _tx.clear()
        _rates.clear()
        _rate_base.clear()
        _breached.clear()
        _rate_last[0] = 0.0
    _clear_edge_gauges(edge_keys)
    for peer, stripe in tx_keys:
        telemetry.clear_gauge("bf_link_goodput_bytes", peer=peer,
                              stripe=stripe)
    for kind, peer in rate_keys:
        telemetry.clear_gauge(_RATE_GAUGES[kind], peer=peer)


def reset() -> None:
    """Test hygiene: clear_all plus the parsed-rule cache."""
    global _rules_spec, _rules
    clear_all()
    with _lock:
        _rules_spec = None
        _rules = []
