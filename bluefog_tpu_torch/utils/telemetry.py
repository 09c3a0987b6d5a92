"""Runtime telemetry: process-local counters, gauges and histograms, and
the ``/metrics`` + ``/healthz`` endpoint.

The port of ``bluefog_tpu/utils/telemetry.py``, with its series names,
labels, bucket ladder and Prometheus text.  Every comm entry point of the
port reports here:

  * ``basics.py``: per-op calls, element bytes, schedule rounds, edges and
    estimated wire bytes (:func:`record_comm_traffic`), the dispatch-cache
    counters, the dispatch and sync histograms, the placement and synthesis
    gauges and the hierarchical level bytes.
  * ``ops/window.py`` / ``ops/transport.py``: window op counts, payload
    bytes a peer process, in-flight handles, drain bursts, RPC latency,
    mutex waits, the peer probe.
  * ``ops/schedule_opt.py``: rounds saved, congestion moves, compile-cache
    hits and misses; ``ops/synthesis.py``: the synthesis ratio;
    ``ops/sharded.py``: the level bytes of sharded gossip.
  * ``utils/stall.py``: stall warnings; ``utils/profiler.py``: the step and
    phase histograms and the straggler gauges.
  * the optimizer families: the step-time histogram and the
    consensus-distance gauge.

Telemetry is on by default, so nothing here may synchronise the device:
every value comes from shapes, schedules and host integers, and the
consensus gauge reduces on the device before ``n`` floats cross.  With
``BLUEFOG_TPU_TELEMETRY=0`` every mutator returns before it touches
anything: no registry mutation, no key rendering.

The registry is process-local.  :func:`aggregate_snapshot` merges every
process's view over the port's own ``allgather`` of fixed-width JSON rows.

Endpoint: ``BLUEFOG_TPU_TELEMETRY_PORT`` (or :func:`start_http_server`)
serves ``/metrics`` (Prometheus text) and ``/healthz`` (JSON: the stall
watchdog's overdue waits, the peer probe, the straggler report, the async
window mode) on a daemon thread, bound to loopback unless
``BLUEFOG_TPU_TELEMETRY_HOST`` says otherwise.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.utils import config

__all__ = [
    "enabled",
    "inc",
    "set_gauge",
    "observe",
    "observe_bucket_counts",
    "start_timer",
    "observe_since",
    "histogram_percentiles",
    "snapshot",
    "telemetry_snapshot",
    "aggregate_snapshot",
    "record_comm_traffic",
    "render_prometheus",
    "reset",
    "start_http_server",
    "stop_http_server",
    "server_port",
    "maybe_start_endpoint",
    "emit_timeline_counters",
    "health",
]

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


class _Registry:
    """Process-local metric store: one lock, three dicts."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: Dict[_Key, float] = {}
        self.gauges: Dict[_Key, float] = {}
        # Histograms: key -> [per-bucket counts (len(_HIST_BUCKETS) + 1,
        # last = overflow), running sum].  Buckets are FIXED and log-spaced
        # (below) so cross-rank merge is elementwise addition — no
        # per-series boundary negotiation.
        self.hists: Dict[_Key, list] = {}


_registry = _Registry()


def enabled() -> bool:
    """True when the registry records (``BLUEFOG_TPU_TELEMETRY``, default
    on — counters are dict increments on already-python paths; the
    endpoint stays opt-in separately)."""
    return config.get().telemetry


def _key(name: str, labels: dict) -> _Key:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def inc(name: str, value: float = 1.0, **labels) -> None:
    """Add ``value`` to a monotonic counter (no-op when disabled)."""
    if not config.get().telemetry:
        return
    key = _key(name, labels)
    with _registry.lock:
        _registry.counters[key] = _registry.counters.get(key, 0.0) + value


def set_gauge(name: str, value: float, **labels) -> None:
    """Record the last value of a gauge (no-op when disabled)."""
    if not config.get().telemetry:
        return
    key = _key(name, labels)
    with _registry.lock:
        _registry.gauges[key] = float(value)


def clear_counter(name: str, **labels) -> None:
    """Drop one counter series — the same churn-hygiene escape hatch as
    :func:`clear_gauge`, for per-peer counters whose label names a rank
    that no longer exists (a dead rank's series is not "still counting",
    it is an orphan claim about a peer the gang evicted).  Runs even when
    telemetry is disabled, like :func:`clear_gauge` — a stale key must go
    regardless."""
    key = _key(name, labels)
    with _registry.lock:
        _registry.counters.pop(key, None)


def clear_gauge(name: str, **labels) -> None:
    """Drop a gauge series, if present — for gauges describing a subsystem
    that has been deactivated, where a stale last value would misreport
    (e.g. the placement gauges after ``BLUEFOG_TPU_PLACEMENT=0``).
    Runs even when telemetry is disabled: the registry renders
    unconditionally, so a stale key must go regardless."""
    key = _key(name, labels)
    with _registry.lock:
        _registry.gauges.pop(key, None)


# Log-spaced latency bucket boundaries, 1 µs .. 50 s (observations are
# SECONDS).  Fixed for every histogram series: one shared boundary table
# keeps observe() at a single bisect (≤ ~1µs) and makes the cross-rank
# merge a blind elementwise add.  The 1-2.5-5 ladder gives ~3 buckets per
# decade — enough resolution to separate p50 from p99 without label bloat.
_HIST_BUCKETS: Tuple[float, ...] = tuple(
    float(f"{m}e{e}")  # decimal literals: no float noise in the le labels
    for e in range(-6, 2) for m in ("1", "2.5", "5"))


def observe(name: str, value_seconds: float, **labels) -> None:
    """Record one observation into a fixed-bucket latency histogram
    (no-op when disabled — no registry mutation, nothing rendered).

    Renders at snapshot/scrape time as the Prometheus histogram triple:
    cumulative ``<name>_bucket{le=...}`` series, ``<name>_sum`` and
    ``<name>_count``.  Merged across ranks by :func:`aggregate_snapshot`
    (bucket counts and sums ADD, like counters)."""
    if not config.get().telemetry:
        return
    import bisect
    key = _key(name, labels)
    i = bisect.bisect_left(_HIST_BUCKETS, value_seconds)
    with _registry.lock:
        h = _registry.hists.get(key)
        if h is None:
            h = _registry.hists[key] = [[0] * (len(_HIST_BUCKETS) + 1), 0.0]
        h[0][i] += 1
        h[1] += value_seconds


def observe_bucket_counts(name, counts, total_sum: float, **labels) -> None:
    """Merge pre-bucketed observations into a histogram series (no-op when
    disabled).  ``counts`` are per-bucket counts against the shared
    boundary table (``len(_HIST_BUCKETS) + 1`` entries, the last the
    overflow): the native transport (``winsvc.cc``) keeps the same ladder,
    so its cumulative histograms merge in by elementwise addition."""
    if not config.get().telemetry:
        return
    n = len(_HIST_BUCKETS) + 1
    if len(counts) != n:
        raise ValueError(
            f"observe_bucket_counts({name!r}): {len(counts)} buckets do not "
            f"match the shared boundary table ({n})")
    if not any(counts):
        return
    key = _key(name, labels)
    with _registry.lock:
        h = _registry.hists.get(key)
        if h is None:
            h = _registry.hists[key] = [[0] * n, 0.0]
        for i, c in enumerate(counts):
            h[0][i] += int(c)
        h[1] += float(total_sum)


def start_timer() -> Optional[float]:
    """``perf_counter()`` when the registry records, else None — the one
    guard-then-time idiom every latency-histogram site uses (pair with
    :func:`observe_since`)."""
    if not config.get().telemetry:
        return None
    import time
    return time.perf_counter()


def observe_since(t0: Optional[float], name: str,
                  **labels) -> Optional[float]:
    """Record elapsed seconds since a :func:`start_timer` stamp into the
    named histogram; no-op (returns None) when the stamp is None —
    telemetry was off at start, so nothing is recorded even if it was
    toggled since.  Returns the elapsed seconds otherwise."""
    if t0 is None:
        return None
    import time
    dt = time.perf_counter() - t0
    observe(name, dt, **labels)
    return dt


def histogram_bucket_counts(name: str, **labels) -> Optional[List[float]]:
    """The raw cumulative bucket counts of a recorded histogram (None with
    no observations): two snapshots' difference is exactly what was
    observed in between (the tuner's revert-on-regression medians)."""
    key = _key(name, labels)
    with _registry.lock:
        h = _registry.hists.get(key)
        return None if h is None else list(h[0])


def histogram_percentiles(name: str, qs=(50.0, 95.0, 99.0),
                          **labels) -> Optional[Dict[float, float]]:
    """Approximate percentiles of a recorded histogram (``{q: seconds}``),
    linearly interpolated within the containing bucket.  Quantiles landing
    in the overflow bucket report the largest finite boundary (the
    histogram cannot resolve beyond it).  None when the series has no
    observations."""
    key = _key(name, labels)
    with _registry.lock:
        h = _registry.hists.get(key)
        if h is None:
            return None
        counts = list(h[0])
    total = sum(counts)
    if total == 0:
        return None
    out: Dict[float, float] = {}
    for q in qs:
        target = total * q / 100.0
        cum = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                if i >= len(_HIST_BUCKETS):      # overflow bucket
                    out[q] = _HIST_BUCKETS[-1]
                else:
                    lo = _HIST_BUCKETS[i - 1] if i else 0.0
                    hi = _HIST_BUCKETS[i]
                    frac = (target - (cum - c)) / c
                    out[q] = lo + (hi - lo) * frac
                break
    return out


def reset() -> None:
    """Drop every series (tests; a production registry is append-only)."""
    with _registry.lock:
        _registry.counters.clear()
        _registry.gauges.clear()
        _registry.hists.clear()


def _render_key(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def _fmt_le(b: float) -> str:
    """Bucket-boundary rendering for the ``le`` label (Prometheus spells
    the overflow bucket ``+Inf``)."""
    return "+Inf" if b == float("inf") else _fmt_value(b)


def _flatten_hist(out: Dict[str, float], key: _Key, counts, total_sum) -> None:
    """Append one histogram's ``_bucket``/``_sum``/``_count`` series (the
    Prometheus triple, cumulative buckets) to a flat snapshot dict."""
    name, labels = key
    cum = 0
    for b, c in zip(tuple(_HIST_BUCKETS) + (float("inf"),), counts):
        cum += c
        le_key = (name + "_bucket",
                  tuple(sorted(labels + (("le", _fmt_le(b)),))))
        out[_render_key(le_key)] = float(cum)
    out[_render_key((name + "_sum", labels))] = float(total_sum)
    out[_render_key((name + "_count", labels))] = float(cum)


def snapshot() -> Dict[str, float]:
    """Flat ``{rendered_series: value}`` dict of the process-local registry
    (counters and gauges together; counter names end in ``_total``;
    histograms render as their ``_bucket``/``_sum``/``_count`` triple)."""
    with _registry.lock:
        out = {_render_key(k): v for k, v in _registry.counters.items()}
        out.update({_render_key(k): v for k, v in _registry.gauges.items()})
        hists = {k: (list(h[0]), h[1]) for k, h in _registry.hists.items()}
    for k, (counts, s) in sorted(hists.items()):
        _flatten_hist(out, k, counts, s)
    emit_timeline_counters()
    return out


def _raw_series() -> Tuple[Dict[_Key, float], Dict[_Key, float]]:
    with _registry.lock:
        return dict(_registry.counters), dict(_registry.gauges)


def _raw_hists() -> Dict[_Key, tuple]:
    with _registry.lock:
        return {k: (list(h[0]), h[1]) for k, h in _registry.hists.items()}


# ---------------------------------------------------------------------------
# Cross-rank aggregation (rides the collective path, like metric_average)
# ---------------------------------------------------------------------------

def _merge_records(records: List[dict]) -> Dict[str, float]:
    """Merge per-process registry records (the aggregate wire rows) into
    one flat snapshot: counters summed, gauges maxed, histogram bucket
    counts and sums added elementwise.  Pure — unit-testable without a
    gang."""
    agg_c: Dict[_Key, float] = {}
    agg_g: Dict[_Key, float] = {}
    agg_h: Dict[_Key, list] = {}
    for rec in records:
        for name, labels, v in rec.get("c", []):
            k = (name, tuple((a, b) for a, b in labels))
            agg_c[k] = agg_c.get(k, 0.0) + v
        for name, labels, v in rec.get("g", []):
            k = (name, tuple((a, b) for a, b in labels))
            agg_g[k] = max(agg_g.get(k, float("-inf")), v)
        for name, labels, counts, s in rec.get("h", []):
            k = (name, tuple((a, b) for a, b in labels))
            h = agg_h.setdefault(k, [[0] * len(counts), 0.0])
            for i, c in enumerate(counts):
                h[0][i] += c
            h[1] += s
    out = {_render_key(k): v for k, v in agg_c.items()}
    out.update({_render_key(k): v for k, v in agg_g.items()})
    for k, h in sorted(agg_h.items()):
        _flatten_hist(out, k, h[0], h[1])
    return out


def aggregate_snapshot() -> Dict[str, float]:
    """Cluster-wide snapshot: counters summed, gauges maxed and histograms
    bucket-merged across every process's registry.

    Collective across processes: every process must call it together.  It
    rides the port's ``allgather`` (one fixed-width JSON row a rank,
    processes deduplicated by their id).  In one process (all ranks in one
    registry) it is the local snapshot."""
    from bluefog_tpu_torch import basics
    if not basics.initialized():
        return snapshot()
    comm = basics.process_ranks()
    if comm is None or comm.nprocs == 1:
        return snapshot()
    import numpy as np
    import torch
    counters, gauges = _raw_series()
    hists = _raw_hists()
    blob = json.dumps({
        "proc": comm.process,
        "c": [[k[0], list(k[1]), v] for k, v in counters.items()],
        "g": [[k[0], list(k[1]), v] for k, v in gauges.items()],
        "h": [[k[0], list(k[1]), h[0], h[1]] for k, h in hists.items()],
    }).encode()
    n = basics.size()
    m = len(basics.owned_ranks())
    dev = basics.device()
    # Agree on the row width first: registries differ per process, so the
    # payload gather must fit the largest blob.
    lens = torch.full((m, 1), float(len(blob)), dtype=torch.float32,
                      device=dev)
    width = int(basics.allgather(lens)[0].max().item())
    rows = np.zeros((m, width), np.uint8)
    rows[:, :len(blob)] = np.frombuffer(blob, np.uint8)
    # Every rank's row of the output is all ranks' blobs back to back.
    gathered = basics.allgather(torch.from_numpy(rows).to(dev))[0]
    gathered = gathered.cpu().numpy().reshape(n, width)
    records = []
    seen_procs = set()
    for r in range(n):
        raw = bytes(gathered[r]).rstrip(b"\0")
        if not raw:
            continue
        rec = json.loads(raw.decode())
        if rec["proc"] in seen_procs:  # one registry a process, not a rank
            continue
        seen_procs.add(rec["proc"])
        records.append(rec)
    return _merge_records(records)


def telemetry_snapshot(aggregate: bool = False) -> Dict[str, float]:
    """The ``bf.telemetry_snapshot()`` surface: the process-local registry
    as a flat dict, or (``aggregate=True``) the cluster-wide merge via the
    collective path (collective in multi-process runs — see
    :func:`aggregate_snapshot`)."""
    return aggregate_snapshot() if aggregate else snapshot()


# ---------------------------------------------------------------------------
# Prometheus text exporter
# ---------------------------------------------------------------------------

def _fmt_value(v: float) -> str:
    """Prometheus value rendering, total: NaN/±Inf spellings per the text
    exposition format (a diverging run CAN land nan in a gauge — the
    scrape must keep working)."""
    import math
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return str(int(v)) if v == int(v) else repr(v)


def render_prometheus() -> str:
    """The process-local registry in Prometheus text exposition format
    (``# TYPE`` per family; ``*_total`` series are counters; histograms
    render as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``)."""
    counters, gauges = _raw_series()
    lines: List[str] = []
    for store, mtype in ((counters, "counter"), (gauges, "gauge")):
        families: Dict[str, list] = {}
        for key, v in sorted(store.items()):
            families.setdefault(key[0], []).append((key, v))
        for name, series in families.items():
            lines.append(f"# TYPE {name} {mtype}")
            for key, v in series:
                lines.append(f"{_render_key(key)} {_fmt_value(v)}")
    hfamilies: Dict[str, list] = {}
    for key, h in sorted(_raw_hists().items()):
        hfamilies.setdefault(key[0], []).append((key, h))
    for name, series in hfamilies.items():
        lines.append(f"# TYPE {name} histogram")
        for key, (counts, s) in series:
            flat: Dict[str, float] = {}
            _flatten_hist(flat, key, counts, s)
            for rendered, v in flat.items():
                lines.append(f"{rendered} {_fmt_value(v)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Health (stall monitor + peer probe)
# ---------------------------------------------------------------------------

def health() -> dict:
    """Liveness summary for ``/healthz``: the stall watchdog's overdue
    waits, the window transport's unreachable-peer probe, the latest
    cross-rank straggler report, the transport's coalescing, queue depths
    and decode pool, the async window mode's block, the link observatory's
    ``links`` block (a latched SLO breach degrades the status) and the
    tuner's.  The JAX package's ``membership`` and ``gang_directory``
    blocks come with item 20; until then they are absent, as they are
    there when those subsystems are off."""
    from bluefog_tpu_torch.utils import stall
    overdue = stall._monitor.overdue_ops()
    body = {
        "status": "ok",
        "overdue_ops": [{"op": name, "waited_sec": round(sec, 1)}
                        for name, sec in overdue],
        "stall_threshold_sec": config.get().stall_warning_sec,
    }
    from bluefog_tpu_torch.utils import profiler
    straggler = profiler.last_straggler_report()
    if straggler is not None:
        if profiler.attribution_degraded():
            # A fused step ran without probe attribution: the phase
            # histograms carry an opaque fused-step bucket.
            straggler["attribution"] = (
                "degraded: fused steps unattributed (no in-program "
                "probes); phase histograms carry an opaque fused-step "
                "bucket")
        body["straggler"] = straggler
    # Transport coalescing: sub-messages a native send (1.0: nothing
    # coalesces) and the deepest per-peer backlog after a drain.
    with _registry.lock:
        ratio = _registry.gauges.get(_key("bf_win_tx_coalesce_ratio", {}))
        depths = [(dict(k[1]), v) for k, v in _registry.gauges.items()
                  if k[0] == "bf_win_tx_queue_depth"]
        decode_busy = _registry.gauges.get(
            _key("bf_win_rx_decode_pool_busy", {}))
    if ratio is not None:
        body["win_tx_coalesce_ratio"] = round(ratio, 2)
    if depths:
        labels, depth = max(depths, key=lambda kv: kv[1])
        deepest = {"peer": labels.get("peer", "?"), "depth": depth}
        if "stripe" in labels:
            deepest["stripe"] = labels["stripe"]
        body["win_tx_deepest_queue"] = deepest
    if decode_busy is not None:
        # The native drain's decode workers busy at the last pump: pinned
        # at the pool's size, inbound decode is this host's bottleneck.
        body["win_rx_decode_pool_busy"] = decode_busy
    # The age of each in-neighbor's gossip when it folded (wire trace
    # tags); absent when tracing is off.
    with _registry.lock:
        ages: Dict[str, dict] = {}
        for k, v in _registry.gauges.items():
            if k[0] == "bf_win_contribution_freshest_age_seconds" and k[1]:
                ages.setdefault(k[1][0][1], {})["freshest_sec"] = round(v, 4)
            elif k[0] == "bf_win_contribution_stalest_age_seconds" and k[1]:
                ages.setdefault(k[1][0][1], {})["stalest_sec"] = round(v, 4)
    if ages:
        body["contribution_age"] = ages
    # The async window mode: step clock, step lag, the staleness policy and
    # the per-source tallies; absent when the mode is not armed.
    try:
        from bluefog_tpu_torch.ops import window as _window
        async_block = _window.async_info()
    except Exception:  # noqa: BLE001 — health must render regardless
        async_block = None
    if async_block is not None:
        with _registry.lock:
            rej = {k[1][0][1]: v for k, v in _registry.counters.items()
                   if k[0] == "bf_win_stale_rejected_total" and k[1]}
            dwn = {k[1][0][1]: v for k, v in _registry.counters.items()
                   if k[0] == "bf_win_stale_downweighted_total" and k[1]}
        if rej:
            async_block["stale_rejected"] = rej
        if dwn:
            async_block["stale_downweighted"] = dwn
        body["async"] = async_block
    # The link observatory: worst edge, max divergence, the SLO engine's
    # state; absent with BLUEFOG_TPU_LINK_OBS=0 or nothing observed.
    try:
        from bluefog_tpu_torch.utils import linkobs
        links = linkobs.health_summary()
    except Exception:  # noqa: BLE001 — health must render regardless
        links = None
    if links is not None:
        body["links"] = links
        if links.get("slo", {}).get("breached"):
            body["status"] = "degraded"
    # The tuner's epoch, knobs and probation; absent unless
    # BLUEFOG_TPU_TUNE=1.
    try:
        from bluefog_tpu_torch.utils import tuner
        tune = tuner.health_summary()
    except Exception:  # noqa: BLE001 — health must render regardless
        tune = None
    if tune is not None:
        body["tuner"] = tune
    probe = stall._peer_probe
    if probe is not None:
        try:
            missing = probe()
        except Exception:  # noqa: BLE001 — a probe crash is itself a signal
            missing = None
        if missing is None:
            body["unreachable_peer_ranks"] = None
            body["status"] = "degraded"
        else:
            body["unreachable_peer_ranks"] = missing
            if missing:
                body["status"] = "degraded"
    if overdue:
        body["status"] = "stalled"
    return body


# ---------------------------------------------------------------------------
# Timeline integration (chrome-tracing counter events)
# ---------------------------------------------------------------------------

def emit_timeline_counters() -> None:
    """Write every counter/gauge as a chrome-tracing counter event
    (``"ph": "C"``) through the live timeline writer, so the series render
    as stacked counter tracks alongside the op spans.  No-op without an
    active timeline (and on the native writer, whose wire format carries
    no ``args`` payload)."""
    from bluefog_tpu_torch.utils import timeline
    if not timeline.counter_events_supported():
        return
    counters, gauges = _raw_series()
    for key, v in list(counters.items()) + list(gauges.items()):
        timeline.counter_event(_render_key(key), v)


# ---------------------------------------------------------------------------
# HTTP endpoint (/metrics + /healthz)
# ---------------------------------------------------------------------------

_server = None
_server_lock = threading.Lock()


def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    emit_timeline_counters()
                    self._reply(200, render_prometheus().encode(),
                                "text/plain; version=0.0.4")
                elif path == "/healthz":
                    body = health()
                    code = 200 if body["status"] == "ok" else 503
                    self._reply(code, json.dumps(body).encode(),
                                "application/json")
                else:
                    self._reply(404, b"not found\n", "text/plain")
            except BrokenPipeError:
                pass  # scraper went away mid-reply
            except Exception as e:  # noqa: BLE001 — a bad series must not
                try:                # kill the handler thread silently
                    self._reply(500, f"error: {e}\n".encode(), "text/plain")
                except OSError:
                    pass

        def log_message(self, *args):  # scrapes must not spam stderr
            pass

    return Handler


def start_http_server(port: int = 0, host: Optional[str] = None) -> int:
    """Start the /metrics + /healthz endpoint on a daemon thread; returns
    the bound port (``port=0`` picks an ephemeral one).  Idempotent — a
    second call returns the live server's port.

    Binds LOOPBACK by default (same convention as the cluster REPL's ctrl
    socket: never expose a new service on every interface silently) —
    off-host Prometheus scraping opts in via
    ``BLUEFOG_TPU_TELEMETRY_HOST=0.0.0.0`` (or a specific interface)."""
    global _server
    import os
    from http.server import ThreadingHTTPServer
    if host is None:
        host = os.environ.get("BLUEFOG_TPU_TELEMETRY_HOST", "127.0.0.1")
    with _server_lock:
        if _server is not None:
            return _server.server_address[1]
        srv = ThreadingHTTPServer((host, int(port)), _make_handler())
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever, daemon=True,
                             name="bf-telemetry-http")
        t.start()
        _server = srv
        return srv.server_address[1]


def stop_http_server() -> None:
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()


def server_port() -> Optional[int]:
    with _server_lock:
        return None if _server is None else _server.server_address[1]


def maybe_start_endpoint() -> Optional[int]:
    """Start the endpoint iff ``BLUEFOG_TPU_TELEMETRY_PORT`` is set (called
    from ``bf.init``); returns the bound port or None.  A failed bind is
    logged, never fatal — observability must not take the job down."""
    port = config.get().telemetry_port
    if port is None:
        return None
    try:
        bound = start_http_server(port)
    except OSError as e:
        from bluefog_tpu_torch.utils.logging import get_logger
        get_logger().warning(
            "telemetry endpoint could not bind port %s (%s); /metrics "
            "disabled for this process", port, e)
        return None
    from bluefog_tpu_torch.utils.logging import get_logger
    get_logger().info("telemetry endpoint serving /metrics and /healthz "
                      "on port %d", bound)
    return bound


# ---------------------------------------------------------------------------
# Shared comm accounting
# ---------------------------------------------------------------------------

def record_comm_traffic(op: str, nbytes: float, *, size: int,
                        sched_stats=None, calls: float = 1.0) -> None:
    """The one accounting formula for collective traffic: calls, element
    bytes, and — given ``sched_stats = (rounds, edges[, hops[, prov]])``
    from ``collective.schedule_wire_stats`` — rounds/edges/estimated wire bytes
    (one ``nbytes / size`` per-rank row per directed edge).  When the
    stats carry a modeled hop count (a physical interconnect model is
    active — ``ops/placement``), ``bf_schedule_hop_bytes_total`` records
    the PHYSICAL wire cost: per-rank row bytes times weighted link
    crossings, i.e. what the traffic actually costs the torus/DCN, not
    just the logical edge count.  Used by the dispatch layer
    (``basics._record_dispatch``) per call and by ``bench.py`` to account
    a whole jitted run at once, so the two can never drift apart."""
    if not config.get().telemetry:
        return
    inc("bf_comm_calls_total", calls, op=op)
    inc("bf_comm_bytes_total", float(nbytes) * calls, op=op)
    if sched_stats is not None:
        rounds, edges = sched_stats[0], sched_stats[1]
        hops = sched_stats[2] if len(sched_stats) > 2 else None
        prov = sched_stats[3] if len(sched_stats) > 3 else None
        inc("bf_comm_rounds_total", rounds * calls, op=op)
        inc("bf_comm_edges_total", edges * calls, op=op)
        set_gauge("bf_comm_peers", edges, op=op)
        inc("bf_comm_wire_bytes_total",
            float(nbytes) / max(size, 1) * edges * calls, op=op)
        if hops is not None:
            inc("bf_schedule_hop_bytes_total",
                float(nbytes) / max(size, 1) * hops * calls, op=op)
        if prov is not None:
            # Which schedule-pipeline output served the call: counters
            # never go stale across a provenance change the way a labeled
            # gauge would, and the per-op split shows exactly which ops
            # ride synthesized schedules.
            inc("bf_comm_schedule_provenance_total", calls, op=op,
                provenance=prov)


# ---------------------------------------------------------------------------
# Consensus-distance gauge (gossip health)
# ---------------------------------------------------------------------------

def record_consensus_distance(mean_dist: float, max_dist: float) -> None:
    """Record one consensus-distance sample: mean/max over this process's
    ranks of ``||x_r - neighborhood_mean_r||_2``.  Called by the optimizer
    families every ``BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY`` steps."""
    set_gauge("bf_consensus_distance", mean_dist)
    set_gauge("bf_consensus_distance_max", max_dist)
    inc("bf_consensus_samples_total")


def consensus_every(*, costs_communication: bool = False) -> int:
    """Sampling period K for the consensus-distance gauge (0 = off, and
    always off when telemetry is disabled).

    ``costs_communication=True`` marks samplers that pay for the gauge
    with an EXTRA collective (the collective optimizer family runs one
    more full-parameter combine plus a host sync per sample): those stay
    off unless ``BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY`` was explicitly
    set, so default telemetry never changes a training loop's
    communication volume.  Free samplers (the window family reads the
    combine it already performed) use the default period."""
    cfg = config.get()
    if not cfg.telemetry:
        return 0
    if costs_communication and not cfg.telemetry_consensus_set:
        return 0
    return cfg.telemetry_consensus_every
