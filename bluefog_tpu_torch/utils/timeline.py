"""Timeline: named-activity tracing to chrome://tracing JSON and
``torch.profiler``.

The port of ``bluefog_tpu/utils/timeline.py`` (the reference's C++
Timeline, ``common/timeline.{h,cc}``: one JSON file a rank, enabled by
``BLUEFOG_TIMELINE=<prefix>``).  Events are written by the native writer
(``native/src/timeline.cc``: a lock-free ring and a writer thread, built at
first use with the window service), or by a Python writer thread when
``BLUEFOG_TPU_PYTHON_TIMELINE=1`` asks for it.  A failed native build
raises, as the port's other native builds do.

Where the JAX package enters ``jax.profiler.TraceAnnotation`` so a span
shows in a TPU trace, the port enters ``torch.profiler.record_function``
(and, on a machine with CUDA, an NVTX range), so the span shows in the
``torch.profiler`` trace ``profile_step.profile`` takes.  Both cost time on
every call, so they are entered only while a timeline, a step profiler or a
``torch.profiler`` is live; :func:`op_span` also wraps the framework's own
comm spans this way, which the JAX package does not annotate.

The clock is ``time.monotonic_ns()``: the anchor event (the Python
writer) or the ``<file>.anchor.json`` sidecar (the native writer) pairs it
with wall time, so ``bluefog_tpu.tools.trace_merge`` aligns the ranks'
files.
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import threading
import time
from contextlib import contextmanager
from typing import Dict

__all__ = [
    "timeline_enabled",
    "timeline_start_activity",
    "timeline_end_activity",
    "timeline_context",
    "start_timeline",
    "stop_timeline",
    "flush",
    "counter_event",
    "counter_events_supported",
    "probe_span",
    "thread_name",
    "op_span",
    "set_op_span_hook",
    "CLOCK_ANCHOR_NAME",
]

_TRACE_EVENT_SENTINEL = None


class _TimelineWriter:
    """Python writer: events go through a queue to a writer thread, so the
    training thread never blocks on file IO."""

    def __init__(self, path: str):
        self.path = path
        self.q: "queue.Queue" = queue.Queue(maxsize=1 << 16)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bf-timeline")
        self._thread.start()

    def _run(self):
        with open(self.path, "w") as f:
            f.write("[\n")
            first = True
            while True:
                ev = self.q.get()
                if ev is _TRACE_EVENT_SENTINEL:
                    break
                if not first:
                    f.write(",\n")
                f.write(json.dumps(ev))
                first = False
                f.flush()
            f.write("\n]\n")

    def emit(self, ev: dict):
        try:
            self.q.put_nowait(ev)
        except queue.Full:
            pass  # drop rather than stall training

    def close(self):
        self.q.put(_TRACE_EVENT_SENTINEL)
        self._thread.join(timeout=5)


class _NativeTimelineWriter:
    """Native writer (``native/src/timeline.cc``): a multi-producer ring
    and a writer thread in C++; no Python allocation an event."""

    def __init__(self, path: str):
        from bluefog_tpu_torch import native
        self.path = path
        self._lib = native.lib()
        self._h = self._lib.bf_timeline_open(path.encode(), os.getpid())
        if not self._h:
            raise OSError(f"cannot open timeline file {path!r}")

    def emit(self, ev: dict):
        self._lib.bf_timeline_event(
            self._h, ev["name"].encode(), ev["cat"].encode(),
            ev["ph"].encode(), ev["ts"], ev.get("dur", 0), ev["tid"])

    def close(self):
        if self._h:
            self._lib.bf_timeline_close(self._h)
            self._h = None


def _make_writer(path: str):
    if os.environ.get("BLUEFOG_TPU_PYTHON_TIMELINE") == "1":
        return _TimelineWriter(path)
    return _NativeTimelineWriter(path)


_writer = None
_active: Dict[str, object] = {}
_lock = threading.Lock()


def _process_index() -> int:
    """This process's index for file naming: ``BFTPU_PROCESS_ID`` (bfrun),
    else ``RANK`` (torchrun), else the process group's rank, else 0."""
    for var in ("BFTPU_PROCESS_ID", "RANK"):
        env = os.environ.get(var)
        if env is not None:
            return int(env)
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001 — naming must work before init too
        pass
    return 0


def _maybe_autostart():
    if _writer is None:
        prefix = os.environ.get("BLUEFOG_TIMELINE")
        if prefix:
            # One file a process, <prefix><process>.json (the reference's
            # operations.cc:450-459).
            start_timeline(f"{prefix}{_process_index()}.json")


def timeline_enabled() -> bool:
    _maybe_autostart()
    return _writer is not None


# The clock-anchor metadata event, emitted once at timeline start: it pairs
# this process's monotonic event clock with wall time for trace-merge.
CLOCK_ANCHOR_NAME = "bf_clock_anchor"

_atexit_installed = False


def _emit_clock_anchor() -> None:
    w = _writer
    if w is None:
        return
    mono_us = time.monotonic_ns() // 1000
    args = {"monotonic_us": mono_us, "unix_us": time.time_ns() // 1000,
            "rank": _process_index()}
    if hasattr(w, "q"):
        w.emit({"name": CLOCK_ANCHOR_NAME, "ph": "M", "ts": mono_us,
                "pid": os.getpid(), "tid": 0, "args": args})
        return
    # The native format carries no args payload: the anchor rides a
    # sidecar file that trace-merge reads.
    try:
        with open(w.path + ".anchor.json", "w") as f:
            json.dump(args, f)
    except OSError:
        pass  # tracing must never take the job down; merge will warn


def start_timeline(path: str) -> bool:
    """Begin writing a chrome-tracing file (the reference's
    ``bf.timeline_start``); False when one is already open."""
    global _writer, _atexit_installed
    with _lock:
        if _writer is not None:
            return False
        _writer = _make_writer(path)
        if not _atexit_installed:
            # A process that never stops its timeline still closes the
            # JSON array at exit: a truncated file fails strict parsers.
            atexit.register(stop_timeline)
            _atexit_installed = True
    _emit_clock_anchor()
    return True


def stop_timeline() -> bool:
    global _writer
    with _lock:
        if _writer is None:
            return False
        _writer.close()
        _writer = None
    return True


def flush() -> None:
    """Give queued events a moment to reach the file (``bf.suspend`` calls
    it, so a paused session can open the trace).  The Python writer
    flushes an event at a time once its queue drains; the native writer
    flushes on its own tick."""
    w = _writer
    if w is None:
        return
    q = getattr(w, "q", None)
    if q is not None:
        deadline = time.monotonic() + 2.0
        while not q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)


# -- profiler ranges -----------------------------------------------------------

_nvtx = None  # torch.cuda.nvtx where CUDA is present, else False


def _nvtx_module():
    global _nvtx
    if _nvtx is None:
        import torch
        _nvtx = torch.cuda.nvtx if torch.cuda.is_available() else False
    return _nvtx


class _Range:
    """A ``torch.profiler.record_function`` range, with an NVTX range on a
    machine with CUDA; the port's ``jax.profiler.TraceAnnotation``."""

    __slots__ = ("_rf", "_nvtx")

    def __init__(self, name: str):
        import torch
        self._rf = torch.profiler.record_function(name)
        self._rf.__enter__()
        self._nvtx = _nvtx_module()
        if self._nvtx:
            self._nvtx.range_push(name)

    def __exit__(self, *exc):
        if self._nvtx:
            self._nvtx.range_pop()
        self._rf.__exit__(None, None, None)


def _torch_profiling() -> bool:
    import torch
    return torch.autograd._profiler_enabled()


def timeline_start_activity(tensor_name: str,
                            activity_name: str = "USER") -> bool:
    """Open a named activity span (the reference's ``basics.py:415-451``).
    False when no timeline is open."""
    _maybe_autostart()
    if _writer is None:
        return False
    key = f"{tensor_name}:{activity_name}"
    rng = _Range(key)
    with _lock:
        prior = _active.pop(key, None)
        _active[key] = rng
    if prior is not None:
        # A span of the same key was still open (a retry loop, a double
        # start): close it so the range stack stays balanced.
        prior.__exit__(None, None, None)
    _writer.emit({"name": activity_name, "cat": tensor_name, "ph": "B",
                  "ts": time.monotonic_ns() // 1000, "pid": os.getpid(),
                  "tid": threading.get_ident()})
    return True


def timeline_end_activity(tensor_name: str,
                          activity_name: str = "USER") -> bool:
    if _writer is None:
        return False
    key = f"{tensor_name}:{activity_name}"
    with _lock:
        rng = _active.pop(key, None)
    if rng is not None:
        rng.__exit__(None, None, None)
    _writer.emit({"name": activity_name, "cat": tensor_name, "ph": "E",
                  "ts": time.monotonic_ns() // 1000, "pid": os.getpid(),
                  "tid": threading.get_ident()})
    return True


@contextmanager
def timeline_context(tensor_name: str, activity_name: str = "USER"):
    """``with bf.timeline_context("grad_sync"):`` span recorder."""
    timeline_start_activity(tensor_name, activity_name)
    try:
        yield
    finally:
        timeline_end_activity(tensor_name, activity_name)


def probe_span(name: str, ts_us: int, dur_us: int, tid: int,
               cat: str = "fused-probe") -> None:
    """One complete ("X") span on a synthetic lane, on the same monotonic
    microsecond clock as every other event (both writers carry ``dur``)."""
    w = _writer
    if w is None:
        return
    w.emit({"name": name, "cat": cat, "ph": "X", "ts": int(ts_us),
            "dur": max(0, int(dur_us)), "pid": os.getpid(), "tid": int(tid)})


def thread_name(tid: int, name: str) -> None:
    """Label a synthetic lane with a ``thread_name`` metadata event (the
    Python writer only: the native format has no args payload)."""
    w = _writer
    if w is None or not hasattr(w, "q"):
        return
    w.emit({"name": "thread_name", "ph": "M", "ts": 0, "pid": os.getpid(),
            "tid": int(tid), "args": {"name": name}})


def counter_events_supported() -> bool:
    """True when a writer that carries counter events is live (the Python
    writer; the native format has no ``args`` payload)."""
    return _writer is not None and hasattr(_writer, "q")


def counter_event(name: str, value: float, cat: str = "telemetry") -> None:
    """One chrome-tracing counter event (``"ph": "C"``): the series renders
    as a counter track beside the op spans."""
    w = _writer
    if w is None or not hasattr(w, "q"):
        return
    w.emit({"name": name, "cat": cat, "ph": "C",
            "ts": time.monotonic_ns() // 1000, "pid": os.getpid(),
            "tid": 0, "args": {"value": float(value)}})


# Installed by utils.profiler while a step profiler is active: called as
# ``hook(op_name, phase, seconds)`` for every completed TOP-LEVEL op span
# (the window family nests per-edge spans inside the op's own span, and
# reporting both would count the same wall time twice).
_span_hook = None
_span_depth = threading.local()


def set_op_span_hook(hook) -> None:
    """Register (or clear, with ``None``) the op-span duration observer."""
    global _span_hook
    _span_hook = hook


@contextmanager
def op_span(op_name: str, phase: str):
    """The framework's op-phase span (ENQUEUE/COMMUNICATE/UPDATE), the
    reference's per-phase ActivityStart/End hooks.  Two module checks and
    one profiler-state read when no timeline, step profiler or
    ``torch.profiler`` is live."""
    hook = _span_hook
    if hook is None and _writer is None \
            and not os.environ.get("BLUEFOG_TIMELINE") \
            and not _torch_profiling():
        yield
        return
    _maybe_autostart()
    w = _writer
    counted = hook is not None
    if counted:
        _span_depth.d = getattr(_span_depth, "d", 0) + 1
        t0 = time.perf_counter()
    rng = _Range(f"{op_name}:{phase}")
    base = {"name": phase, "cat": op_name, "pid": os.getpid(),
            "tid": threading.get_ident()}
    if w is not None:
        w.emit({**base, "ph": "B", "ts": time.monotonic_ns() // 1000})
    try:
        yield
    finally:
        if w is not None:
            w.emit({**base, "ph": "E", "ts": time.monotonic_ns() // 1000})
        rng.__exit__(None, None, None)
        if counted:
            _span_depth.d -= 1
            if _span_depth.d == 0 and _span_hook is not None:
                _span_hook(op_name, phase, time.perf_counter() - t0)
