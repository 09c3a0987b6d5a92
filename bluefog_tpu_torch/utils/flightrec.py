"""Transport flight recorder: the gossip stack's black box.

The port of ``bluefog_tpu/utils/flightrec.py``, the Python face of the
``bf_rec_*`` ring in the port's copy of ``native/src/winsvc.cc``: a
process-wide fixed-size ring of transport events (enqueue, flush, sendmsg,
drain, decode, fold, commit) keyed by window or peer name, stripe, source,
destination and trace sequence.  The native hot paths record directly; the
Python transport path and the window store's commit sites record through
:func:`note`.  Off (the default) nothing is allocated and every record site
is one bool check.

Armed with ``BLUEFOG_TPU_FLIGHT_RECORDER=1`` (ring size
``BLUEFOG_TPU_FLIGHT_RECORDER_EVENTS``, default 65536 events).  The ring
is dumped to ``<BLUEFOG_TPU_FLIGHT_RECORDER_PATH>.<rank>.bin`` on a fatal
transport error or by ``bf.flight_recorder_dump()``.  Each dump opens with
a clock anchor pairing CLOCK_MONOTONIC with wall time.

Dump layout (little-endian), the JAX package's byte for byte:
  u32 magic 0xBFF11EC0 | u32 version (=1) | i32 rank | i32 reserved |
  i64 unix_us | i64 monotonic_us | i64 count | count x 48-byte event
with each event exactly the ``bf_rec_event_t`` struct
(``native/src/bluefog_native.h``).
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from bluefog_tpu_torch import native
from bluefog_tpu_torch.utils import config
from bluefog_tpu_torch.utils.logging import get_logger

__all__ = ["ETYPE_NAMES", "EVENT_DTYPE", "enabled", "enable", "maybe_enable",
           "note", "snapshot", "dump", "dump_on_error", "load", "reset",
           "ENQUEUE", "FLUSH", "SENDMSG", "DRAIN", "DECODE", "FOLD",
           "COMMIT"]

# Event types — mirrors of the BF_REC_* constants in bluefog_native.h.
ENQUEUE, FLUSH, SENDMSG, DRAIN, DECODE, FOLD, COMMIT = range(1, 8)
ETYPE_NAMES = {ENQUEUE: "enqueue", FLUSH: "flush", SENDMSG: "sendmsg",
               DRAIN: "drain", DECODE: "decode", FOLD: "fold",
               COMMIT: "commit"}

MAGIC = 0xBFF11EC0
VERSION = 1
HEADER = struct.Struct("<IIiiqqq")  # magic, ver, rank, rsvd, unix, mono, n

# numpy twin of bf_rec_event_t (48 bytes; a test pins it to the ctypes
# mirror, so a struct drift fails loudly instead of misparsing).
EVENT_DTYPE = np.dtype([
    ("t_us", "<i8"), ("src", "<i4"), ("dst", "<i4"), ("seq", "<u4"),
    ("len", "<u4"), ("etype", "u1"), ("op", "u1"), ("stripe", "u1"),
    ("flags", "u1"), ("name", "S20")])

_on = False            # cached arming state: note() must stay ~free when off
_lock = threading.Lock()
_last_auto_dump = [0.0]


def enable(capacity: Optional[int] = None) -> bool:
    """Arm the native ring (idempotent), building the service first when
    needed (a failed build raises)."""
    global _on
    cap = config.get().flight_recorder_events if capacity is None \
        else capacity
    native.lib().bf_rec_enable(int(cap))
    _on = True
    return True


def maybe_enable() -> bool:
    """Arm iff ``BLUEFOG_TPU_FLIGHT_RECORDER=1`` (the transport's start
    calls it); off, the default, touches nothing."""
    if not config.get().flight_recorder:
        return False
    return enable()


def enabled() -> bool:
    return _on


def note(etype: int, *, op: int = 0, stripe: int = 0, src: int = -1,
         dst: int = -1, seq: int = 0, length: int = 0,
         name: str = "") -> None:
    """Record one event from Python (the fallback transport's sender and
    the window-store commit sites).  ~1 µs over ctypes — these sites run
    per frame / per commit run, not per message."""
    if not _on:
        return
    native.lib().bf_rec_note(int(etype), int(op), int(stripe), int(src),
                             int(dst), int(seq) & 0xFFFFFFFF, int(length),
                             name.encode()[:19])


def snapshot() -> np.ndarray:
    """The ring's live contents, oldest-first, as an EVENT_DTYPE array
    (empty when the recorder is off or nothing was recorded)."""
    if not _on:
        return np.empty(0, EVENT_DTYPE)
    lib = native.lib()
    n = int(lib.bf_rec_snapshot(None, 0))
    if n <= 0:
        return np.empty(0, EVENT_DTYPE)
    buf = (native.RecEvent * n)()
    got = int(lib.bf_rec_snapshot(buf, n))
    return np.frombuffer(buf, dtype=EVENT_DTYPE, count=max(0, got)).copy()


def reset() -> None:
    """Empty the ring (a no-op before the service is loaded)."""
    lib = native.loaded()
    if lib is not None:
        lib.bf_rec_reset()


def _my_rank() -> int:
    try:
        from bluefog_tpu_torch import basics
        if basics.initialized():
            return int(basics.rank())
    except Exception:  # noqa: BLE001 — dumps must work pre-init too
        pass
    try:
        return int(os.environ.get("BFTPU_PROCESS_ID", "0"))
    except ValueError:
        return 0


def dump(path: Optional[str] = None, reason: str = "") -> Optional[str]:
    """Write the ring to ``<prefix>.<rank>.bin`` (or ``path``) with the
    clock anchor the trace-gossip merge aligns ranks by.  Returns the
    path, or None when the recorder is off.  Never raises — the black
    box must not turn a transport failure into a second failure."""
    if not _on:
        return None
    try:
        events = snapshot()
        rank = _my_rank()
        if path is None:
            path = f"{config.get().flight_recorder_path}.{rank}.bin"
        # One anchor sample for the whole file: monotonic and unix read
        # back to back, the pairing of the timeline clock anchors.
        mono_us = time.monotonic_ns() // 1000
        unix_us = time.time_ns() // 1000
        with _lock:
            with open(path, "wb") as f:
                f.write(HEADER.pack(MAGIC, VERSION, rank, 0, unix_us,
                                    mono_us, len(events)))
                f.write(events.tobytes())
        get_logger().warning(
            "flight recorder: dumped %d event(s) to %s%s", len(events),
            path, f" ({reason})" if reason else "")
        return path
    except Exception:  # noqa: BLE001 — see docstring
        get_logger().exception(
            "flight recorder dump failed")
        return None


def dump_on_error(reason: str) -> None:
    """Auto-dump on a fatal transport error, rate-limited (one dump per
    30 s per process): a retry storm must not spend its time rewriting
    the same black box file."""
    if not _on:
        return
    now = time.monotonic()
    with _lock:
        if now - _last_auto_dump[0] < 30.0:
            return
        _last_auto_dump[0] = now
    dump(reason=reason)


def load(path: str) -> Tuple[Dict, np.ndarray]:
    """Read one dump back: ``(header, events)`` with ``header`` carrying
    rank and the unix/monotonic anchor pair."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < HEADER.size:
        raise ValueError(f"{path}: truncated flight-recorder header")
    magic, version, rank, _rsvd, unix_us, mono_us, count = \
        HEADER.unpack_from(raw, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a flight-recorder dump "
                         f"(magic {magic:#x})")
    if version != VERSION:
        raise ValueError(f"{path}: dump version {version} != {VERSION}")
    body = raw[HEADER.size:]
    have = len(body) // EVENT_DTYPE.itemsize
    events = np.frombuffer(body, EVENT_DTYPE,
                           count=min(count, have))
    return ({"rank": rank, "unix_us": unix_us, "mono_us": mono_us,
             "count": int(count)}, events)
