"""Probes: native timestamps at the seams of the fused window step.

The port of ``bluefog_tpu/utils/probes.py``.  The fused step
(``ops/fused_step.py``) captures the window step into one program, which
is fast and opaque: host clocks see one interval, so ``bf.step_profile()``
would book all of it as grad-compute.  This module puts a clock inside the
program.

The ring is ``native/src/xlacall.cc``'s (``bf_probe_*``): one note is a
relaxed atomic claim and a 16-byte store of ``(probe_id, steady-clock ns,
seq)``, with no GIL and no allocation.  On a card the program's seams
(grad-ready, each bucket's put chain before and after, step end) are
stream host functions (``csrc/hostfn.cu``) that call ``bf_probe_note`` when
the stream reaches them; the host notes its own seams (drain start and
commit, finish) into the same ring over ctypes.  Host functions, not CUDA
events: an event's time is on the device's clock and can be read only as
an interval from another event, while a host function's note is on
``std::chrono::steady_clock``, the clock of ``time.monotonic_ns()`` and of
the timeline (all CLOCK_MONOTONIC), so one :func:`reconcile` drain orders
the program's seams and the host's on one clock.  A host function's time
is when the stream reached it, which is when the work before it had
finished: its seams are the device's, up to the callback latency.  On the
CPU the same seams are noted from Python in the program's order.

:func:`reconcile` maps the events into the existing surfaces:

  * phase attribution for an active ``StepProfiler``
    (``bf_step_phase_seconds``: optimizer-update = the program's interval
    less the put-issue windows; gossip-communicate = the put-issue windows
    and the host drain; host-sync = the status wait past the program's
    end; the rest stays grad-compute);
  * a measured ``bf_fused_overlap_ratio``: bucket ``i``'s put issue is a
    window, its center ``mid_i = (t_pre_i + t_post_i) / 2``, and
    ``overlap_i = clamp((t_end - mid_i) / (t_end - t_grad), 0, 1)``, the
    share of the program still ahead while the put was in flight; its
    ratio to the model (``fused_step.modeled_overlap``) is the
    ``bf_fused_overlap_divergence_ratio`` gauge (the x3 line of the link
    observatory);
  * ``bf_fused_bucket_issue_seconds{bucket}``, each bucket's put chain's
    dwell in the program, and ``bf_fused_step_overlap_seconds{bucket}``;
  * per-bucket lanes in the chrome timeline (cat ``fused-probe``), on the
    monotonic microsecond clock of every other event.

``BLUEFOG_TPU_PROBE`` (default on): ``=0`` records no probe and leaves the
program without probe nodes; the profiler then labels the remainder
``fused-step`` and ``/healthz`` reports it.  Registry mutation is
telemetry-gated, as every other metric source.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "GRAD_READY", "STEP_END", "DRAIN_START", "DRAIN_COMMIT", "FINISH_DONE",
    "BUCKET_PRE", "BUCKET_POST",
    "available", "enabled", "arm", "note", "drain", "reconcile",
    "last_summary", "recent_summaries", "probe_name",
]

# ---------------------------------------------------------------------------
# Probe IDs (the ring stores ids, not names — these are the vocabulary)
# ---------------------------------------------------------------------------

GRAD_READY = 1     # program entry: gradients materialized, update math begins
STEP_END = 2       # program tail: last bucket's put chain issued

# Host-side seams, noted through the C ABI into the same ring:
DRAIN_START = 10   # win_update drain begins (host, after statuses land)
DRAIN_COMMIT = 11  # drain handed combine buffers to the finish program
FINISH_DONE = 12   # rebuilt/merged params returned to the caller

BUCKET_PRE = 100   # + bucket index: bucket flat ready, put chain about to run
BUCKET_POST = 200  # + bucket index: bucket's put chain issued

_RING_CAPACITY = 8192


def probe_name(pid: int) -> str:
    """Human name for a probe id (timeline lanes, trace tooling)."""
    fixed = {GRAD_READY: "grad-ready", STEP_END: "step-end",
             DRAIN_START: "drain-start", DRAIN_COMMIT: "drain-commit",
             FINISH_DONE: "finish-done"}
    if pid in fixed:
        return fixed[pid]
    if BUCKET_PRE <= pid < BUCKET_POST:
        return f"bucket{pid - BUCKET_PRE}-pre"
    if BUCKET_POST <= pid < BUCKET_POST + 100:
        return f"bucket{pid - BUCKET_POST}-post"
    return f"probe{pid}"


# ---------------------------------------------------------------------------
# Ring access (arming, host notes, drain)
# ---------------------------------------------------------------------------

_arm_lock = threading.Lock()
_armed = False
_last: Optional[dict] = None
_history: "collections.deque" = collections.deque(maxlen=256)
_lane_names_emitted: set = set()


def available() -> bool:
    """The probe ring is there: it lives in the service's library, built
    from the sources (a failed build raises, so this is True wherever the
    library loads)."""
    from bluefog_tpu_torch import native
    return native.lib() is not None


def enabled() -> bool:
    """Probes are configured on and the ring is there."""
    from bluefog_tpu_torch.utils import config
    return config.get().probe and available()


def arm(capacity: int = _RING_CAPACITY) -> bool:
    """Enable the native event ring (idempotent; first capacity wins
    in-process — the ring is shared by every fused optimizer)."""
    global _armed
    if not available():
        return False
    with _arm_lock:
        from bluefog_tpu_torch import native
        native.lib().bf_probe_enable(int(capacity))
        _armed = True
    return True


def note(probe_id: int) -> None:
    """Host-side probe: same ring, same clock as the in-program calls."""
    if not _armed and not arm():
        return
    from bluefog_tpu_torch import native
    lib = native.lib()
    if lib is not None:
        lib.bf_probe_note(int(probe_id))


def total() -> int:
    """Events ever claimed (including any overwritten by ring wrap)."""
    from bluefog_tpu_torch import native
    lib = native.lib()
    if lib is None:
        return 0
    return int(lib.bf_probe_total())


def drain(cap: int = _RING_CAPACITY) -> List[tuple]:
    """Drain events noted since the previous drain, oldest first, as
    ``(t_ns, probe_id, seq)`` tuples.  Empty when the ring is off."""
    from bluefog_tpu_torch import native
    lib = native.lib()
    if lib is None:
        return []
    buf = (native.ProbeEvent * cap)()
    n = int(lib.bf_probe_drain(buf, cap))
    if n <= 0:
        return []
    return [(int(buf[i].t_ns), int(buf[i].probe_id), int(buf[i].seq))
            for i in range(n)]


def _reset_for_tests() -> None:
    global _armed, _last
    from bluefog_tpu_torch import native
    lib = native.loaded()
    if lib is not None:
        lib.bf_probe_reset()
    with _arm_lock:
        _armed = False
    _last = None
    _history.clear()
    _lane_names_emitted.clear()


# ---------------------------------------------------------------------------
# Reconcile: events -> metrics, profiler phases, timeline lanes
# ---------------------------------------------------------------------------

def last_summary() -> Optional[dict]:
    """The most recent :func:`reconcile` result (bench + tools read this)."""
    s = _last
    return None if s is None else dict(s)


def recent_summaries(n: Optional[int] = None) -> List[dict]:
    """The last ``n`` (default: all retained, newest last) reconcile
    summaries — the bench derives per-bucket p50/p99 issue latencies and
    the measured-overlap median from these instead of one step's noise."""
    rows = list(_history)
    if n is not None:
        rows = rows[-int(n):]
    return [dict(r) for r in rows]


def _emit_lanes(events: List[tuple], issues: Dict[int, tuple]) -> None:
    """Per-bucket timeline lanes: X spans on the shared monotonic clock.

    Lane tids sit at 1000+bucket so they group visually under the rank's
    process lane without colliding with real thread ids; the fused-step
    umbrella span rides tid 999 and the host drain tid 998."""
    from bluefog_tpu_torch.utils import timeline
    if not timeline.timeline_enabled():
        return
    ts = {pid: t for (t, pid, _s) in events}

    def span(name, tid, t0_ns, t1_ns):
        if t0_ns is None or t1_ns is None or t1_ns < t0_ns:
            return
        timeline.probe_span(name, t0_ns // 1000, (t1_ns - t0_ns) // 1000,
                            tid)
        if tid not in _lane_names_emitted and \
                timeline.counter_events_supported():
            # Name the synthetic lane (Python writer only — the native
            # wire format carries no args payload for M events).
            timeline.thread_name(tid, f"fused {name.split(' ')[0]}")
            _lane_names_emitted.add(tid)

    span("fused-step", 999, ts.get(GRAD_READY), ts.get(STEP_END))
    span("drain", 998, ts.get(DRAIN_START), ts.get(DRAIN_COMMIT))
    for bi, (t_pre, t_post) in sorted(issues.items()):
        span(f"bucket{bi} put-issue", 1000 + bi, t_pre, t_post)


def reconcile(num_buckets: int, *, modeled_mean: Optional[float] = None,
              t_statuses_ns: Optional[int] = None) -> Optional[dict]:
    """Drain the ring and fold one fused step's events into the existing
    observability surfaces.  Called by ``FusedStep.step()`` after the
    finish program returns; a no-op (returns None) when the step's
    in-program probes did not fire (probe path disarmed mid-flight).

    Returns the summary dict it also stores for :func:`last_summary`:
    ``measured_overlap``, ``modeled_overlap``, ``divergence``,
    ``bucket_issue_seconds`` and the raw seam timestamps."""
    global _last
    events = drain()
    if not events:
        return None
    ts: Dict[int, int] = {}
    for t_ns, pid, _seq in events:
        ts[pid] = t_ns  # newest wins: one step's worth per drain
    t_grad = ts.get(GRAD_READY)
    t_end = ts.get(STEP_END)
    if t_grad is None or t_end is None or t_end <= t_grad:
        return None

    from bluefog_tpu_torch.utils import profiler, telemetry
    telemetry.inc("bf_probe_events_total", float(len(events)))

    issues: Dict[int, tuple] = {}
    for bi in range(num_buckets):
        t_pre = ts.get(BUCKET_PRE + bi)
        t_post = ts.get(BUCKET_POST + bi)
        if t_pre is not None and t_post is not None and t_post >= t_pre:
            issues[bi] = (t_pre, t_post)

    # Measured overlap, same normalization as modeled_overlap(): the
    # fraction of the program still ahead when each bucket's put was in
    # flight, taking the issue WINDOW's center as the model's issue
    # instant (see module docstring).
    program_ns = t_end - t_grad
    overlaps = []
    issue_sum = 0.0
    for bi, (t_pre, t_post) in sorted(issues.items()):
        issue_s = (t_post - t_pre) / 1e9
        issue_sum += issue_s
        telemetry.observe("bf_fused_bucket_issue_seconds", issue_s,
                          bucket=str(bi))
        telemetry.observe("bf_fused_step_overlap_seconds",
                          max(0.0, (t_end - t_post) / 1e9), bucket=str(bi))
        mid = (t_pre + t_post) / 2
        overlaps.append(min(1.0, max(0.0, (t_end - mid) / program_ns)))
    measured = sum(overlaps) / len(overlaps) if overlaps else 0.0
    telemetry.set_gauge("bf_fused_overlap_ratio", measured)

    divergence = None
    if modeled_mean is not None and modeled_mean > 0:
        divergence = measured / modeled_mean
        telemetry.set_gauge("bf_fused_overlap_divergence_ratio", divergence)

    # Real phase attribution for the active StepProfiler: the program's
    # wall time splits into update math (the non-put remainder of the
    # in-program interval), the put-issue windows + the host drain
    # (communication), and the status wait past program end (host-sync);
    # whatever the profiler's remainder logic keeps is true grad-compute.
    prof = profiler.active()
    attributed = prof is not None
    if prof is not None:
        opt_s = max(0.0, program_ns / 1e9 - issue_sum)
        comm_s = issue_sum
        t_ds, t_dc = ts.get(DRAIN_START), ts.get(DRAIN_COMMIT)
        if t_ds is not None and t_dc is not None and t_dc > t_ds:
            comm_s += (t_dc - t_ds) / 1e9
        prof.attribute("optimizer-update", opt_s)
        if comm_s > 0:
            prof.attribute("gossip-communicate", comm_s)
        if t_statuses_ns is not None and t_statuses_ns > t_end:
            prof.attribute("host-sync", (t_statuses_ns - t_end) / 1e9)

    _emit_lanes(events, issues)

    _last = {
        "measured_overlap": round(measured, 6),
        "modeled_overlap": (round(modeled_mean, 6)
                            if modeled_mean is not None else None),
        "divergence": (round(divergence, 3)
                       if divergence is not None else None),
        "bucket_issue_seconds": {
            bi: round((tp - t0) / 1e9, 9)
            for bi, (t0, tp) in sorted(issues.items())},
        "program_seconds": round(program_ns / 1e9, 9),
        "attributed": attributed,
        "events": len(events),
        "t_grad_ready_ns": t_grad,
        "t_step_end_ns": t_end,
        "wall_ns": time.monotonic_ns(),
    }
    _history.append(_last)
    return dict(_last)
