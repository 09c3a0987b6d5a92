"""The window transport: one-sided gossip between processes over TCP.

The port of ``bluefog_tpu/ops/transport.py``.  Each process of a
multi-process run starts one :class:`WindowTransport`; ``win_put``,
``win_accumulate`` and ``win_get`` on a rank that another process owns
travel through it, and the owner's drain thread applies them to its window
store (``ops/window.py``).  The wire is the JAX package's, bit for bit: the
op codes and flags below, the single-message frame and the ``OP_BATCH``
container of ``native/src/winsvc.cc`` (a copy of the JAX package's), the
bf16 and sparse payload codecs.  A JAX process and a port process can
exchange window traffic.

Coalescing (``BLUEFOG_TPU_WIN_COALESCE``, default on): :meth:`send`
enqueues onto a bounded queue a peer, serviced by one sender worker a
(peer, stripe); the worker ships its queue as one ``OP_BATCH`` frame on a
byte threshold, a short linger, an urgent op (fence, mutex and get
traffic) or an explicit :meth:`WindowTransport.flush`.  Every message to a
peer rides that peer's queue in order, so per-peer FIFO, which fences and
the distributed mutex rely on, holds: a ``FENCE_REQ`` enqueued after puts
is decoded after them.  ``BLUEFOG_TPU_WIN_COALESCE=0`` sends each message
as its own frame.

The hot loop (``BLUEFOG_TPU_WIN_NATIVE``, default on) runs in C++: the
per-peer queues and workers (``bf_wintx_*``), the batch encode, and the
drain's decode, codecs and same-slot fold (``bf_winsvc_drain``), which
hands the window store one folded commit set a run.  The Python classes
here are the ``=0`` path and the oracle the native path is held to (same
frames, the same folded bits).  Unlike the JAX package, a missing native
library is not a reason to fall back: it is built from the sources at
first use (``bluefog_tpu_torch/native``), and a failed build raises.

Striping (``BLUEFOG_TPU_WIN_STRIPES``): each peer is driven by N sockets
and workers, frames sharded by (window, row), so each stripe is its own
FIFO; fences and mutex releases fan out over every stripe
(``ops/window.py`` counts the copies).  ``auto`` is 1.  The native drain
has a decode pool (``BLUEFOG_TPU_WIN_DECODE_THREADS``) that decodes
frames of different connections in parallel and emits them in arrival
order.

Wire trace tags (``BLUEFOG_TPU_TRACE_SAMPLE``): one data message in N
carries ``OP_TRACE_FLAG`` and a 32-byte trailer (:data:`TRACE_TRAILER`:
the source rank, a sequence number, the origin's monotonic and wall
clocks and its training step, :func:`set_trace_origin_step`), built by
:func:`make_trace_tag`, which ``ops/window.py`` appends after the codec, so
both hot paths ship it as payload; the receiver strips it and the async
mode's staleness policy reads the step.  Unset, the wire is the same bits.

The native send (``BLUEFOG_TPU_WIN_NATIVE=1``) is one call a message into
``bf_wintx_send``: through the ``_bf_fastcall`` METH_FASTCALL module where it
builds (``native.fastcall``), else through ``ctypes``, as in the JAX package;
:attr:`WindowTransport.send_path` says which (``"python"`` on the Python
path).

Telemetry and the flight recorder are the JAX package's: message and byte
counters a peer and op, RPC latency, batch sizes and the coalescing ratio,
queue depths, the drain's bursts, retries and errors (``utils/telemetry``;
on the native path pumped from the C++ counters at flush boundaries and
burst ends, as the JAX package does); the recorder's ENQUEUE, FLUSH and
SENDMSG events on the Python path (the native path records its own) and a
dump on a fatal send error (``utils/flightrec``).  The link observatory
(``utils/linkobs``) reads each stripe's sent bytes as goodput, from the
native pump's diffs or the Python sender's batches; the tuner
(``utils/tuner``) may override ``auto`` stripes and, through
:meth:`WindowTransport.set_linger_ms`, the linger.

Chaos faults (``utils/chaos.py``): :meth:`WindowTransport.set_partition`
drops every outbound frame to the named peers, and
:meth:`WindowTransport.set_send_delay` sleeps before each DATA enqueue (a
slow link, which the link observatory measures as one-way delay), in the
native sender's enqueue (``bf_wintx_send``, which a put plan's run and
:meth:`WindowTransport.send` both reach) or in ``send`` on the Python
sender; the
control ops, ``OP_MEMBER`` heartbeats and ``OP_GANG`` directory traffic
among them, are never delayed, and they are urgent: an enqueue cuts the
linger, so they ship at once, behind whatever the peer's FIFO already
holds.

The control lane (the port's own; the frames stay the JAX package's): an
``OP_MEMBER`` heartbeat ships as a frame of its own on its stripe's FIFO,
and the receiver's reader hands it to a queue of its own, consumed by a
thread of its own, instead of the drain's, so that no heartbeat waits for
the drain to decode and fold the rows read before it (a 0.94 GB row held
a heartbeat 0.4-0.9 s on the H100's host).  Each such frame's read and
hand-over times are kept, a source rank at a time (``member_rx``).
"""

from __future__ import annotations

import ctypes
import os
import random
import struct
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch import native
from bluefog_tpu_torch.ops import xlaffi
from bluefog_tpu_torch.utils import config, flightrec, linkobs, telemetry
from bluefog_tpu_torch.utils.logging import get_logger

# Wire op codes, word for word the JAX package's (``bluefog_tpu/ops/
# transport.py`` L78-127).
OP_PUT = 1
OP_ACCUMULATE = 2
OP_GET_REQ = 3
OP_GET_REPLY = 4
OP_FENCE_REQ = 5
OP_FENCE_ACK = 6
OP_MUTEX_ACQ = 7
OP_MUTEX_GRANT = 8
OP_MUTEX_REL = 9
# Container frame: the payload is a version-flagged stream of sub-messages.
OP_BATCH = 10
# Membership and gang control planes (item 20).
OP_MEMBER = 11
OP_GANG = 12
# Flag bits ORed into the op byte: a bf16-compressed f32 row, a sparse
# ``u32 k | i32 idx[k] | f32 val[k]`` row, a 32-byte trace trailer.
OP_BF16_FLAG = 0x40
OP_SPARSE_FLAG = 0x20
OP_TRACE_FLAG = 0x10
OP_FLAG_MASK = OP_BF16_FLAG | OP_SPARSE_FLAG | OP_TRACE_FLAG

__all__ = ["WindowTransport", "OP_PUT", "OP_ACCUMULATE", "OP_GET_REQ",
           "OP_GET_REPLY", "OP_FENCE_REQ", "OP_FENCE_ACK", "OP_MUTEX_ACQ",
           "OP_MUTEX_GRANT", "OP_MUTEX_REL", "OP_BATCH", "OP_MEMBER",
           "OP_GANG", "OP_BF16_FLAG", "OP_SPARSE_FLAG", "OP_TRACE_FLAG",
           "OP_FLAG_MASK", "TRACE_TRAILER", "make_trace_tag", "trace_strip",
           "set_trace_origin_step", "trace_origin_step", "sparse_encode",
           "sparse_decode", "stripe_for", "resolve_stripes",
           "resolve_stripes_static"]

_log = get_logger()
# The Python drain's poll period on an empty inbound queue (the native
# drain blocks inside its call instead).
_POLL_SEC = 0.002

# Ops on a waiter's critical path: they flush the peer's queue at once and,
# enqueued after any pending data, certify it once answered.
_URGENT_OPS = frozenset((OP_GET_REQ, OP_GET_REPLY, OP_FENCE_REQ,
                         OP_FENCE_ACK, OP_MUTEX_ACQ, OP_MUTEX_GRANT,
                         OP_MUTEX_REL, OP_MEMBER, OP_GANG))


def _ships_alone(op: int) -> bool:
    """A heartbeat (``OP_MEMBER``) ships as a frame of its own, so that
    the receiver's reader hands it to the control lane (never inside an
    ``OP_BATCH`` with data); the native sender groups its frames alike."""
    return (op & ~OP_FLAG_MASK) == OP_MEMBER


_OP_NAMES = {OP_PUT: "put", OP_ACCUMULATE: "accumulate",
             OP_GET_REQ: "get_req", OP_GET_REPLY: "get_reply",
             OP_FENCE_REQ: "fence_req", OP_FENCE_ACK: "fence_ack",
             OP_MUTEX_ACQ: "mutex_acq", OP_MUTEX_GRANT: "mutex_grant",
             OP_MUTEX_REL: "mutex_rel", OP_BATCH: "batch",
             OP_MEMBER: "member", OP_GANG: "gang"}


def _op_label(op: int) -> str:
    """The telemetry label of a wire op code (flags stripped)."""
    return _OP_NAMES.get(op & ~OP_FLAG_MASK, str(op))

# src_rank, seq, origin monotonic us, origin unix us, origin step (-1: the
# sender had no step clock).
TRACE_TRAILER = struct.Struct("<iIqqq")

_trace_lock = threading.Lock()
_trace_count = 0
_trace_seq = 0
# The sender's training step (the async step clock), stamped into each
# trailer so that a receiver counts a contribution's age in steps.
_origin_step = -1


def set_trace_origin_step(step: int) -> None:
    """Publish the sender's origin-step clock to both encoders: this
    module's :func:`make_trace_tag` and, when the native service is loaded,
    its own (``bf_trace_set_step``)."""
    global _origin_step
    _origin_step = int(step)
    handle = native.loaded()
    if handle is not None:
        handle.bf_trace_set_step(int(step))


def trace_origin_step() -> int:
    return _origin_step


def make_trace_tag(src: int) -> Optional[bytes]:
    """The packed trailer when this outgoing data message is the 1-in-N
    tagged one, else None.  With ``BLUEFOG_TPU_TRACE_SAMPLE`` unset this is
    one config check: no counter moves and nothing is allocated (the wire
    stays bitwise the untagged one)."""
    period = config.get().trace_sample
    if period <= 0:
        return None
    global _trace_count, _trace_seq
    with _trace_lock:
        count = _trace_count
        _trace_count += 1
        if count % period:
            return None
        _trace_seq += 1
        seq = _trace_seq
    return TRACE_TRAILER.pack(src, seq, time.monotonic_ns() // 1000,
                              time.time_ns() // 1000, _origin_step)


def trace_strip(payload):
    """Split a trace-flagged payload into ``(body, tag)``; raises
    ValueError when it is too short to carry the trailer."""
    n = len(payload)
    if n < TRACE_TRAILER.size:
        raise ValueError(
            f"trace-flagged payload of {n} bytes cannot carry the "
            f"{TRACE_TRAILER.size}-byte trailer")
    tag = TRACE_TRAILER.unpack_from(payload, n - TRACE_TRAILER.size)
    return payload[:n - TRACE_TRAILER.size], tag


# ---------------------------------------------------------------------------
# Striping
# ---------------------------------------------------------------------------

_DATA_OPS = frozenset((OP_PUT, OP_ACCUMULATE, OP_GET_REPLY))
_crc_cache: Dict[str, int] = {}


def stripe_for(name: str, src: int, op: int, n_stripes: int) -> int:
    """The stripe of one wire message: data ops shard by (window, row =
    src rank), everything else rides stripe 0 (crc32, so every process
    routes an edge onto the same FIFO)."""
    if n_stripes <= 1 or (op & ~OP_FLAG_MASK) not in _DATA_OPS:
        return 0
    crc = _crc_cache.get(name)
    if crc is None:
        crc = _crc_cache[name] = zlib.crc32(name.encode())
    return (crc + (src if src > 0 else 0)) % n_stripes


def resolve_stripes() -> int:
    """``BLUEFOG_TPU_WIN_STRIPES``, or for ``auto`` the static oracle
    (:func:`resolve_stripes_static`) under the tuner's measured override;
    with ``BLUEFOG_TPU_TUNE=0`` the override table is empty and the static
    value passes through, bitwise."""
    cfg = config.get()
    if cfg.win_stripes >= 1:
        return cfg.win_stripes
    static = resolve_stripes_static()
    from bluefog_tpu_torch.utils import tuner
    return max(1, min(8, tuner.override_int("stripes", static)))


def resolve_stripes_static() -> int:
    """The ``auto`` oracle: the placement model's ``dcn_link_cost`` (a DCN
    crossing modeled k hops gets ~k streams, at most 8); without a model
    (hosts whose devices carry no geometry) 1, the single-stream wire."""
    try:
        from bluefog_tpu_torch import basics
        model = basics._ctx._placement_state[0]
    except Exception:  # noqa: BLE001 — a transport before the context
        model = None
    if model is None:
        return 1
    return max(1, min(8, int(round(float(model.dcn_link_cost)))))


def _resolve_decode_threads() -> int:
    """The drain's decode pool: the knob, or ``auto`` = one core left for
    the drain thread, at least 1, at most 4."""
    cfg = config.get()
    if cfg.win_decode_threads >= 0:
        return cfg.win_decode_threads
    return max(1, min(4, (os.cpu_count() or 2) - 1))


# ---------------------------------------------------------------------------
# sparse:<frac> payload codec (OP_SPARSE_FLAG)
# ---------------------------------------------------------------------------
# Little-endian u32 k | k x i32 flat index | k x f32 value.

_SPARSE_HDR = struct.Struct("<I")


def sparse_encode(values: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """One sparse payload of the selected entries of a flat f32 row."""
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    val = np.ascontiguousarray(values, dtype=np.float32)
    if idx.shape != val.shape or idx.ndim != 1:
        raise ValueError("sparse_encode expects matching 1-D index/value "
                         f"arrays, got {idx.shape} / {val.shape}")
    blob = _SPARSE_HDR.pack(len(idx)) + idx.tobytes() + val.tobytes()
    return np.frombuffer(blob, np.uint8)


def sparse_decode(payload) -> Tuple[np.ndarray, np.ndarray]:
    """``(indices, values)`` of one sparse payload, the f32 bits
    untouched."""
    buf = payload if isinstance(payload, (bytes, bytearray, memoryview)) \
        else memoryview(np.ascontiguousarray(payload, np.uint8)).cast("B")
    (k,) = _SPARSE_HDR.unpack_from(buf, 0)
    want = _SPARSE_HDR.size + k * 8
    if len(buf) != want:
        raise ValueError(
            f"sparse payload of {len(buf)} bytes does not match header "
            f"k={k} (expected {want})")
    off = _SPARSE_HDR.size
    idx = np.frombuffer(buf, np.int32, count=k, offset=off)
    val = np.frombuffer(buf, np.float32, count=k, offset=off + k * 4)
    return idx, val


# ---------------------------------------------------------------------------
# OP_BATCH framing
# ---------------------------------------------------------------------------
#   u8 version (=1) | u32 count | count x sub-message
#   sub-message := u8 op | i32 src | i32 dst | f64 weight | f64 p_weight |
#                  u16 name_len | name | u64 payload_len | payload

BATCH_VERSION = 1
_BATCH_HDR = struct.Struct("<BI")
_SUB_HDR = struct.Struct("<BiiddH")
_SUB_PLEN = struct.Struct("<Q")

# One message: (op, name, src, dst, weight, p_weight, payload), the payload
# bytes on the send side and a zero-copy memoryview on the drain side.
Msg = Tuple[int, str, int, int, float, float, "bytes | memoryview"]


def _encode_batch(msgs: Sequence[Msg]) -> bytes:
    """Serialize sub-messages into one OP_BATCH payload."""
    parts: List[bytes] = [_BATCH_HDR.pack(BATCH_VERSION, len(msgs))]
    for (op, name, src, dst, weight, p_weight, payload) in msgs:
        nb = name.encode()
        parts.append(_SUB_HDR.pack(op, src, dst, weight, p_weight, len(nb)))
        parts.append(nb)
        parts.append(_SUB_PLEN.pack(len(payload)))
        parts.append(payload)
    return b"".join(parts)


def _decode_batch(buf) -> List[Msg]:
    """Decode one OP_BATCH payload; the sub-message payloads are zero-copy
    slices of ``buf``, valid while the caller keeps it."""
    ver, count = _BATCH_HDR.unpack_from(buf, 0)
    if ver != BATCH_VERSION:
        raise ValueError(
            f"window batch frame version {ver} != {BATCH_VERSION}: the peer "
            "runs an incompatible transport")
    off = _BATCH_HDR.size
    out: List[Msg] = []
    for _ in range(count):
        op, src, dst, weight, p_weight, nlen = _SUB_HDR.unpack_from(buf, off)
        off += _SUB_HDR.size
        name = bytes(buf[off:off + nlen]).decode()
        off += nlen
        (plen,) = _SUB_PLEN.unpack_from(buf, off)
        off += _SUB_PLEN.size
        out.append((op, name, src, dst, weight, p_weight,
                    buf[off:off + plen]))
        off += plen
    if off != len(buf):
        raise ValueError(
            f"window batch frame: {len(buf) - off} trailing bytes after "
            f"{count} sub-messages")
    return out


def _as_bytes_view(tensor) -> np.ndarray:
    """A payload (numpy array or bytes-like) as a flat uint8 view."""
    if isinstance(tensor, (bytes, bytearray, memoryview)):
        return np.frombuffer(tensor, np.uint8)
    return np.ascontiguousarray(tensor).view(np.uint8).reshape(-1)


# ---------------------------------------------------------------------------
# Outbound: per-peer sender workers (the BLUEFOG_TPU_WIN_NATIVE=0 path)
# ---------------------------------------------------------------------------

class _PeerSender:
    """One bounded queue and one worker thread a (peer, stripe): parallel
    across peers and stripes, FIFO within one.  The worker flushes on a
    byte threshold, an urgent op, an explicit flush() or the linger."""

    def __init__(self, transport: "WindowTransport", host: str, port: int,
                 stripe: int = 0):
        self._t = transport
        self.host, self.port = host, port
        self.stripe = stripe
        self.peer = f"{host}:{port}"
        self.cond = threading.Condition()
        self.q: deque = deque()
        self.bytes_pending = 0
        self.flush_now = False
        self.closing = False
        self.error: Optional[Exception] = None
        # Failed batch sends to this peer: ops snapshot the sum over their
        # peers (error_token) and flush(since=token) raises for each op
        # that overlapped a failure, even after another flusher took the
        # stored error.
        self.err_count = 0
        # Messages ever enqueued / whose batch send completed (or failed):
        # flush() waits for its own snapshot of seq_enq.
        self.seq_enq = 0
        self.seq_done = 0
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"bf-win-tx-{self.peer}#{stripe}")
        self.thread.start()

    def enqueue(self, msg: Msg, urgent: bool) -> None:
        with self.cond:
            if self.error is not None:
                err, self.error = self.error, None
                raise err
            # Backpressure: a full queue blocks the producer; gossip is
            # paced, never dropped.
            while (len(self.q) >= self._t._tx_queue_max
                   and not self.closing and self.error is None):
                self.cond.wait(0.05)
            if self.error is not None:
                err, self.error = self.error, None
                raise err
            if self.closing:
                raise ConnectionError(
                    f"win transport to {self.peer} is stopping; message "
                    "not sent")
            self.q.append(msg)
            self.seq_enq += 1
            self.bytes_pending += len(msg[6])
            if urgent or self.bytes_pending >= self._t._flush_bytes:
                self.flush_now = True
            if flightrec.enabled():
                # Noted before the worker is woken: its FLUSH and SENDMSG
                # of this message come after, in the ring too.
                op = msg[0]
                seq = 0
                if op & OP_TRACE_FLAG and len(msg[6]) >= TRACE_TRAILER.size:
                    seq = TRACE_TRAILER.unpack_from(
                        msg[6], len(msg[6]) - TRACE_TRAILER.size)[1]
                flightrec.note(flightrec.ENQUEUE, op=op, stripe=self.stripe,
                               src=msg[2], dst=msg[3], seq=seq,
                               length=len(msg[6]), name=msg[1])
            self.cond.notify_all()

    def flush(self, timeout: float) -> None:
        """Block until everything enqueued before this call was handed to
        the native send (or raise)."""
        with self.cond:
            target = self.seq_enq
            if self.q:
                self.flush_now = True
            self.cond.notify_all()
            ok = self.cond.wait_for(
                lambda: self.error is not None or self.seq_done >= target
                or self.closing,
                timeout=timeout)
            if self.error is not None:
                err, self.error = self.error, None
                raise err
            if self.seq_done >= target:
                return
            if self.closing:
                # stop() raced this flush: the worker drains its queue
                # before it exits; give it stop()'s grace.
                self.cond.wait_for(
                    lambda: self.error is not None
                    or self.seq_done >= target,
                    timeout=min(5.0, timeout))
                if self.error is not None:
                    err, self.error = self.error, None
                    raise err
                if self.seq_done >= target:
                    return
                raise ConnectionError(
                    f"win transport to {self.peer} stopped with "
                    f"{target - self.seq_done} message(s) unsent")
            if not ok:
                raise ConnectionError(
                    f"win transport flush to {self.peer} timed out after "
                    f"{timeout:.0f}s ({len(self.q)} messages still queued)")

    def stop(self) -> None:
        with self.cond:
            self.closing = True
            self.cond.notify_all()
        self.thread.join(timeout=5)

    def _run(self) -> None:
        linger = self._t._linger
        while True:
            with self.cond:
                while not self.q and not self.closing:
                    self.cond.wait()
                if not self.q:
                    return
                if not self.flush_now and linger > 0:
                    self.cond.wait_for(
                        lambda: self.flush_now or self.closing,
                        timeout=linger)
                # Up to the byte threshold: a backlog does not become one
                # huge frame.
                batch: List[Msg] = []
                nbytes = 0
                while self.q and (not batch
                                  or nbytes < self._t._flush_bytes):
                    if batch and (_ships_alone(self.q[0][0])
                                  or _ships_alone(batch[-1][0])):
                        break
                    m = self.q.popleft()
                    batch.append(m)
                    nbytes += len(m[6])
                self.bytes_pending -= nbytes
                self.flush_now = bool(self.q)
                self.cond.notify_all()
            try:
                self._t._send_frames(self.host, self.port, batch,
                                     self.stripe)
            except Exception as e:  # noqa: BLE001 — surfaced to flushers
                _log.warning("window transport: batch of %d message(s) to "
                             "%s dropped: %s", len(batch), self.peer, e)
                flightrec.dump_on_error(f"batch send to {self.peer} dropped")
                with self.cond:
                    self.error = e
                    self.err_count += 1
            finally:
                with self.cond:
                    self.seq_done += len(batch)
                    if telemetry.enabled():
                        # The backlog left after the drain: 0 when the
                        # sender keeps up.
                        telemetry.set_gauge("bf_win_tx_queue_depth",
                                            len(self.q), peer=self.peer,
                                            stripe=str(self.stripe))
                    self.cond.notify_all()


# The native path's cumulative counters (a ``WinTxStats`` / ``WinRxStats``
# field each) and the series each one's growth is counted into; the
# metrics lint reads the names from these tables.
_NATIVE_TX_COUNTERS = {"frames": "bf_win_native_tx_frames_total",
                       "batches": "bf_win_tx_batches_total",
                       "batched_msgs": "bf_win_tx_batched_msgs_total"}
_NATIVE_RX_COUNTERS = {"folded_msgs": "bf_win_native_rx_folded_msgs_total",
                       "commits": "bf_win_native_rx_commits_total"}


class WindowTransport:
    """One TCP endpoint a process for window gossip.

    ``apply(op, name, src, dst, weight, p_weight, payload)`` runs on the
    drain thread for every inbound message, ``payload`` a zero-copy view
    valid only for the call.  ``apply_batch(msgs)`` takes one decoded
    OP_BATCH frame (the Python drain); ``apply_items(items)`` takes the
    native drain's ordered items, ``(0, msg)`` raw and ``(1, commit)``
    folded entries ``(name, replace, src, dst, p_mass, puts, accs, values,
    wire_bytes, trace)`` with ``values`` a zero-copy f32 view valid only
    for the call.  Windows opt into the native fold with
    :meth:`register_window`.

    ``alloc(nbytes)`` makes the drain's receive buffers (a flat uint8
    numpy array): the window store passes pinned host memory on CUDA, so
    that a commit's host-to-card copy reads pinned memory.

    ``tx_bytes`` counts the payload bytes handed to :meth:`send` (what
    crosses the socket, less the framing); ``send_path`` is the native
    send's binding, ``"fastcall"`` or ``"ctypes"``, or ``"python"``."""

    def __init__(self, apply: Callable, *, apply_batch: Callable = None,
                 apply_items: Callable = None, port: int = 0,
                 alloc: Optional[Callable[[int], np.ndarray]] = None):
        cfg = config.get()
        self._lib = native.lib()
        flightrec.maybe_enable()
        self._svc = self._lib.bf_winsvc_start(port, cfg.win_max_pending)
        if not self._svc:
            raise OSError(f"cannot start window service on port {port}")
        # The native encoder's sampling period (the Python sender tags
        # through make_trace_tag); both off by default.
        self._lib.bf_trace_configure(int(cfg.trace_sample))
        self._apply = apply
        self._apply_batch = apply_batch
        self._apply_items = apply_items
        self._alloc = alloc or (lambda n: np.empty(n, np.uint8))
        self.coalesce = bool(cfg.win_coalesce)
        self._linger = max(0.0, cfg.win_coalesce_linger_ms) / 1e3
        self._flush_bytes = max(1, cfg.win_coalesce_bytes)
        self._tx_queue_max = max(1, cfg.win_tx_queue)
        self._retries = max(0, cfg.win_retries)
        self._retry_backoff = max(0.0, cfg.win_retry_backoff_ms) / 1e3
        self.n_stripes = resolve_stripes()
        self._partitioned: frozenset = frozenset()
        # The chaos link-delay fault (set_send_delay) on the Python sender:
        # seconds slept before each DATA enqueue; 0.0 outside chaos, one
        # float check a send (the native sender keeps its own).
        self._send_delay = 0.0
        self._senders: Dict[Tuple[str, int, int], _PeerSender] = {}
        self._senders_lock = threading.Lock()
        self._bytes_lock = threading.Lock()
        self.tx_bytes = 0
        self._tx_frames = self._tx_msgs = 0  # the coalescing ratio's
        # The native stats pumps' last snapshots, and the peers sent to.
        self._stats_lock = threading.Lock()
        self._tx_pump_last = 0.0
        self._tx_last = native.WinTxStats()
        self._rx_last = native.WinRxStats()
        self._peer_addrs: set = set()
        self._peer_last: Dict[Tuple[str, int], tuple] = {}
        self._stripe_last: Dict[Tuple[str, int, int], int] = {}
        self.native_path = self.coalesce and bool(cfg.win_native)
        self._tx = None
        self._fc_send = None
        self.send_path = "python"
        self.decode_threads = 0
        if self.native_path:
            fc = native.fastcall()
            self._fc_send = fc.wintx_send if fc is not None else None
            self.send_path = "ctypes" if fc is None else "fastcall"
            self._tx = self._lib.bf_wintx_start(
                self._flush_bytes, int(self._linger * 1e6),
                self._tx_queue_max, self._retries, self._retry_backoff,
                self.n_stripes)
            if not self._tx:
                raise RuntimeError("bf_wintx_start failed")
            self._hostb: Dict[str, bytes] = {}
            self._nameb: Dict[str, bytes] = {}
            self._items_cap = 512
            self._items = (native.WinItem * self._items_cap)()
            self._raw_buf = self._alloc(1 << 20)
            self._val_buf = self._alloc(1 << 20).view(np.float32)
            self.decode_threads = int(self._lib.bf_winsvc_set_decode(
                self._svc, _resolve_decode_threads()))
            telemetry.set_gauge("bf_win_native_active", 1)
        # Each source rank's newest OP_MEMBER frames as (read, popped), on
        # the host's monotonic clock: the reader's stamp when the frame's
        # last byte was read, and the moment the control lane took it
        # (churn_liveness reads them).
        self.member_rx: Dict[int, deque] = {}
        self._stop = threading.Event()
        self._buf = None if self.native_path else self._alloc(1 << 20)
        self._drainer = threading.Thread(target=self._drain, daemon=True,
                                         name="bf-win-transport")
        self._drainer.start()
        # The control lane: the readers hand OP_MEMBER frames to this
        # thread, not to the drain, so a heartbeat never waits behind the
        # decode and fold of the data frames read before it.
        self._ctrl_buf = np.empty(1 << 16, np.uint8)
        self._ctrl = threading.Thread(target=self._drain_control,
                                      daemon=True, name="bf-win-control")
        self._ctrl.start()

    @property
    def port(self) -> int:
        return int(self._lib.bf_winsvc_port(self._svc))

    # -- native window registry (drain-side folding) -----------------------
    def register_window(self, name: str, elems: int) -> None:
        """Opt a flat f32 window of ``elems`` elements into the native
        drain fold (a no-op on the Python path)."""
        if self.native_path and elems > 0 and len(name.encode()) < 128:
            self._lib.bf_winsvc_win_set(self._svc, name.encode(), elems)

    def unregister_window(self, name: str) -> None:
        if self.native_path:
            self._lib.bf_winsvc_win_set(self._svc, name.encode(), -1)

    # -- outbound ----------------------------------------------------------
    def send(self, host: str, port: int, op: int, name: str, src: int,
             dst: int, weight: float, tensor, p_weight: float = 0.0,
             stripe: Optional[int] = None) -> None:
        """Send one message; ``tensor`` is its payload, a numpy array or a
        bytes-like (copied before this returns, on every path)."""
        if stripe is None:
            stripe = stripe_for(name, src, op, self.n_stripes)
        if self._send_delay and self._tx is None \
                and (op & ~OP_FLAG_MASK) in _DATA_OPS:
            # DATA ops only: heartbeats, fences, mutex and gang traffic are
            # never delayed (a slow data link, not a dead control plane).
            time.sleep(self._send_delay)
        payload = _as_bytes_view(tensor)
        with self._bytes_lock:
            self.tx_bytes += payload.size
        if self._tx is not None:
            # The native path's counters are pumped from the C++ ones.
            hb = self._hostb.get(host)
            if hb is None:
                hb = self._hostb[host] = host.encode()
            self._peer_addrs.add((host, port))
            nb = self._nameb.get(name)
            if nb is None:
                nb = self._nameb[name] = name.encode()
            urgent = 1 if (op & ~OP_FLAG_MASK) in _URGENT_OPS else 0
            # bf_wintx_send copies the payload into the peer's arena before
            # it returns, so the payload need live only for the call.
            if self._fc_send is not None:
                # One METH_FASTCALL call, the payload through the buffer
                # protocol (no copy: a contiguous uint8 array).
                rc = self._fc_send(self._tx, hb, port, op, nb, src, dst,
                                   float(weight), float(p_weight), payload,
                                   urgent, stripe)
            else:
                rc = self._lib.bf_wintx_send(
                    self._tx, hb, port, op, nb, src, dst, float(weight),
                    float(p_weight), payload.ctypes.data, payload.size,
                    urgent, stripe)
            if rc == 0:
                return
            if rc == -4:
                raise ValueError(
                    "window transport: window name exceeds the receiver's "
                    f"128-byte name field (127 usable bytes): {name!r}")
            if telemetry.enabled():
                telemetry.inc("bf_win_tx_errors_total", peer=f"{host}:{port}")
            flightrec.dump_on_error(
                f"native send to {host}:{port} failed (code {rc})")
            raise ConnectionError(
                f"win transport send to {host}:{port} failed "
                f"(native code {rc})")
        if len(name.encode()) >= 128:
            raise ValueError(
                f"window transport: name exceeds 127 bytes: {name!r}")
        if telemetry.enabled():
            telemetry.inc("bf_win_tx_msgs_total", op=_op_label(op))
            telemetry.inc("bf_win_tx_bytes_total", float(payload.size),
                          peer=f"{host}:{port}")
        if not self.coalesce:
            t0 = telemetry.start_timer()
            self._native_send(host, port, op, name, src, dst, weight,
                              p_weight, payload)
            if t0 is not None:
                telemetry.observe_since(t0, "bf_win_rpc_seconds",
                                        op=_op_label(op))
            return
        # The queue owns a copy: the caller may reuse its array at once.
        xlaffi.count_host_copy(payload.size, "enqueue")
        msg: Msg = (op, name, src, dst, float(weight), float(p_weight),
                    payload.tobytes())
        self._sender(host, port, stripe).enqueue(
            msg, urgent=(op & ~OP_FLAG_MASK) in _URGENT_OPS)

    def count_tx(self, nbytes: float) -> None:
        """Add payload bytes that a put plan enqueued on the native sender
        itself (not through :meth:`send`) to :attr:`tx_bytes`."""
        with self._bytes_lock:
            self.tx_bytes += int(nbytes)

    def kick(self) -> None:
        """Wake every sender with a pending queue, without waiting (ship
        now instead of after the linger)."""
        if self._tx is not None:
            self._lib.bf_wintx_kick(self._tx)
            return
        with self._senders_lock:
            senders = list(self._senders.values())
        for s in senders:
            with s.cond:
                if s.q:
                    s.flush_now = True
                    s.cond.notify_all()

    def set_partition(self, addrs) -> None:
        """Declare ``(host, port)`` peers unreachable: sends to them fail
        at once, with no retries; ``None`` heals."""
        self._partitioned = frozenset(addrs or ())
        if self._tx is not None:
            csv = ",".join(f"{h}:{p}" for h, p in sorted(self._partitioned))
            self._lib.bf_wintx_set_partition(self._tx, csv.encode())

    def set_send_delay(self, seconds: float) -> None:
        """Chaos link-delay fault: sleep ``seconds`` before every DATA
        enqueue (control ops never), so that the link observatory measures
        it as per-edge one-way delay; 0.0 heals the fault.  The native
        sender sleeps in its enqueue, after the message's trace tag was
        stamped, which a put plan's run reaches as :meth:`send` does."""
        seconds = max(0.0, float(seconds))
        if self._tx is not None:
            self._lib.bf_wintx_set_send_delay(self._tx,
                                              int(round(seconds * 1e6)))
        self._send_delay = seconds

    def set_linger_ms(self, ms: float) -> None:
        """Adapt the coalesce linger at run time (the tuner's
        ``coalesce_linger_ms``): live on the Python senders, which read it
        at every wait; the native sender keeps the linger it started with,
        and a new transport takes the new value."""
        self._linger = max(0.0, float(ms)) / 1e3

    def drop_peer(self, host: str, port: int) -> None:
        """Retire every stripe of a peer's sender: its queued messages are
        discarded, a producer blocked on it fails, and a later send to the
        address makes fresh senders."""
        peer = f"{host}:{port}"
        # A dead peer's goodput and rate gauges are no claims about a live
        # wire.
        linkobs.clear_peer(peer)
        if self._tx is not None:
            dropped = int(self._lib.bf_wintx_drop_peer(self._tx,
                                                       host.encode(), port))
            # The pumps forget the peer: its counters restart at 0 when a
            # later send makes fresh senders.
            with self._stats_lock:
                self._peer_addrs.discard((host, port))
                self._peer_last.pop((host, port), None)
                for k in [k for k in self._stripe_last
                          if k[:2] == (host, port)]:
                    self._stripe_last.pop(k, None)
            for k in range(self.n_stripes):
                telemetry.clear_gauge("bf_win_tx_queue_depth", peer=peer,
                                      stripe=str(k))
            if dropped and telemetry.enabled():
                telemetry.inc("bf_win_tx_dropped_msgs_total", float(dropped),
                              peer=peer)
            return
        with self._senders_lock:
            senders = [self._senders.pop(k)
                       for k in [k for k in self._senders
                                 if k[:2] == (host, port)]]
        dropped = 0
        for s in senders:
            with s.cond:
                n = len(s.q)
                dropped += n
                s.q.clear()
                s.bytes_pending = 0
                s.seq_done = s.seq_enq
                if n:
                    s.error = ConnectionError(
                        f"win transport peer {s.peer} retired with {n} "
                        "queued message(s) discarded")
                    s.err_count += 1
                s.closing = True
                s.cond.notify_all()
            telemetry.clear_gauge("bf_win_tx_queue_depth", peer=s.peer,
                                  stripe=str(s.stripe))
        if dropped and telemetry.enabled():
            telemetry.inc("bf_win_tx_dropped_msgs_total", float(dropped),
                          peer=peer)

    def error_token(self, addrs=None) -> int:
        """Snapshot for ``flush(since=...)``, over the same ``addrs``:
        failed batches to those peers since then make the flush raise."""
        if self._tx is not None:
            if addrs is None:
                return int(self._lib.bf_wintx_err_count(self._tx, None, 0))
            return sum(int(self._lib.bf_wintx_err_count(
                self._tx, h.encode(), p)) for h, p in addrs)
        return sum(s.err_count for s in self._select_senders(addrs))

    def _select_senders(self, addrs) -> List[_PeerSender]:
        with self._senders_lock:
            if addrs is None:
                return list(self._senders.values())
            want = set(addrs)
            return [s for k, s in self._senders.items() if k[:2] in want]

    def flush(self, timeout: float = 300.0, addrs=None,
              since: Optional[int] = None) -> None:
        """Hand every queued message (to ``addrs``, default every peer) to
        TCP, and raise any send error; ``since`` is an
        :meth:`error_token` over the same ``addrs``."""
        if self._tx is not None:
            self._flush_native(timeout, addrs, since)
            return
        senders = self._select_senders(addrs)
        errors = []
        for s in senders:
            try:
                s.flush(timeout)
            except Exception as e:  # noqa: BLE001 — every peer must drain
                errors.append(e)
        if errors:
            raise errors[0]
        if since is not None and \
                sum(s.err_count for s in senders) > since:
            raise ConnectionError(
                "win transport: a batched send containing this op's "
                "message(s) failed on a sender worker")

    def _flush_native(self, timeout: float, addrs, since) -> None:
        errors = []
        targets = [(None, 0)] if addrs is None else \
            [(h.encode(), p) for h, p in addrs]
        for h, p in targets:
            rc = int(self._lib.bf_wintx_flush(self._tx, h, p,
                                              float(timeout)))
            if rc:
                errors.append(rc)
        self._pump_native_tx_stats()
        if errors:
            flightrec.dump_on_error(f"native flush failed (code {errors[0]})")
            rc = errors[0]
            if rc == -6:
                raise ConnectionError(
                    f"win transport flush timed out after {timeout:.0f}s "
                    "(messages still queued on the native sender)")
            if rc == -5:
                raise ConnectionError(
                    "win transport stopped with message(s) unsent")
            if rc == -8:
                raise ConnectionError(
                    "win transport peer retired with queued message(s) "
                    "discarded")
            raise ConnectionError(
                "win transport: a batched send containing this op's "
                f"message(s) failed on a native sender worker (code {rc})")
        if since is not None and self.error_token(addrs) > since:
            raise ConnectionError(
                "win transport: a batched send containing this op's "
                "message(s) failed on a sender worker")

    def _pump_native_tx_stats(self, tx=None, force: bool = False) -> None:
        """Diff the native sender's cumulative counters into the telemetry
        (the series the Python path keeps a message, and the
        ``bf_win_native_*`` ones), at most every 50 ms unless ``force``:
        every window op flushes at its boundary."""
        tx = self._tx if tx is None else tx
        if tx is None or not telemetry.enabled():
            return
        now = time.monotonic()
        if not force and now - self._tx_pump_last < 0.05:
            return
        self._tx_pump_last = now
        with self._stats_lock:
            cur = native.WinTxStats()
            self._lib.bf_wintx_stats(tx, None, 0, ctypes.byref(cur))
            last, self._tx_last = self._tx_last, cur
            for i in range(16):
                d = cur.by_op[i] - last.by_op[i]
                if d > 0:
                    telemetry.inc("bf_win_tx_msgs_total", float(d),
                                  op=_op_label(i))
            for field, name in _NATIVE_TX_COUNTERS.items():
                d = getattr(cur, field) - getattr(last, field)
                if d > 0:
                    telemetry.inc(name, float(d))
            if cur.frames > 0:
                telemetry.set_gauge("bf_win_tx_coalesce_ratio",
                                    cur.batch_size_sum / cur.frames)
            telemetry.observe_bucket_counts(
                "bf_win_tx_batch_size",
                [cur.batch_size_hist[i] - last.batch_size_hist[i]
                 for i in range(25)],
                cur.batch_size_sum - last.batch_size_sum)
            telemetry.observe_bucket_counts(
                "bf_win_rpc_seconds",
                [cur.send_sec_hist[i] - last.send_sec_hist[i]
                 for i in range(25)],
                cur.send_sec_sum - last.send_sec_sum, op="native")
            # A peer's bytes, errors and retries, and each stripe's bytes
            # and queue depth.  The diffs are clamped at 0: a dropped and
            # re-made peer restarts its counters.
            for (h, p) in list(self._peer_addrs):
                ps = native.WinTxStats()
                self._lib.bf_wintx_stats(tx, h.encode(), p, ctypes.byref(ps))
                peer = f"{h}:{p}"
                lb, le, lr = self._peer_last.get((h, p), (0, 0, 0))
                for name, d in (("bf_win_tx_bytes_total", ps.bytes - lb),
                                ("bf_win_tx_errors_total", ps.errors - le),
                                ("bf_win_tx_retries_total",
                                 ps.retries - lr)):
                    if d > 0:
                        telemetry.inc(name, float(d), peer=peer)
                self._peer_last[(h, p)] = (ps.bytes, ps.errors, ps.retries)
                for k in range(self.n_stripes):
                    ss = native.WinTxStats()
                    self._lib.bf_wintx_stripe_stats(tx, h.encode(), p, k,
                                                    ctypes.byref(ss))
                    d = ss.bytes - self._stripe_last.get((h, p, k), 0)
                    if d > 0:
                        telemetry.inc("bf_win_tx_stripe_bytes_total",
                                      float(d), peer=peer, stripe=str(k))
                        # The same diff is the observatory's goodput.
                        linkobs.note_tx(peer, k, float(d))
                    telemetry.set_gauge("bf_win_tx_queue_depth",
                                        float(ss.queue_len), peer=peer,
                                        stripe=str(k))
                    self._stripe_last[(h, p, k)] = ss.bytes

    def _pump_native_rx_stats(self) -> None:
        """Diff the native drain's cumulative counters into the telemetry
        (the series the Python drain keeps a frame and a message)."""
        if not telemetry.enabled():
            return
        cur = native.WinRxStats()
        self._lib.bf_winsvc_rx_stats(self._svc, ctypes.byref(cur))
        last, self._rx_last = self._rx_last, cur
        d = cur.batch_frames - last.batch_frames
        if d > 0:
            telemetry.inc("bf_win_rx_batches_total", float(d))
            telemetry.inc("bf_win_native_rx_frames_total", float(d))
        d = cur.bytes - last.bytes
        if d > 0:
            telemetry.inc("bf_win_rx_bytes_total", float(d))
        for i in range(16):
            d = cur.by_op[i] - last.by_op[i]
            if d > 0:
                telemetry.inc("bf_win_rx_msgs_total", float(d),
                              op=_op_label(i))
        for field, name in _NATIVE_RX_COUNTERS.items():
            d = getattr(cur, field) - getattr(last, field)
            if d > 0:
                telemetry.inc(name, float(d))
        if self.decode_threads > 0:
            # Busy decode workers now: pinned at the pool's size, inbound
            # decode is the bottleneck.
            telemetry.set_gauge("bf_win_rx_decode_pool_busy",
                                float(cur.decode_busy))
        telemetry.observe_bucket_counts(
            "bf_win_rx_batch_size",
            [cur.batch_size_hist[i] - last.batch_size_hist[i]
             for i in range(25)],
            cur.batch_size_sum - last.batch_size_sum)

    def _sender(self, host: str, port: int, stripe: int = 0) -> _PeerSender:
        key = (host, port, stripe)
        with self._senders_lock:
            s = self._senders.get(key)
            if s is None:
                s = self._senders[key] = _PeerSender(self, host, port,
                                                     stripe)
            return s

    def _send_frames(self, host: str, port: int, batch: List[Msg],
                     stripe: int = 0) -> None:
        """Ship a drained queue as one OP_BATCH frame, or as the plain
        frame when one message coalesced (the per-message wire)."""
        peer = f"{host}:{port}"
        nbytes = sum(len(m[6]) for m in batch)
        if telemetry.enabled():
            telemetry.inc("bf_win_tx_stripe_bytes_total", float(nbytes),
                          peer=peer, stripe=str(stripe))
        linkobs.note_tx(peer, stripe, float(nbytes))
        frame_op = batch[0][0] if len(batch) == 1 else OP_BATCH
        if flightrec.enabled():
            flightrec.note(flightrec.FLUSH, op=frame_op, stripe=stripe,
                           src=-1, dst=port, seq=len(batch), length=nbytes,
                           name=peer)
        t0 = telemetry.start_timer()
        if len(batch) == 1:
            op, name, src, dst, weight, p_weight, payload = batch[0]
            blob = np.frombuffer(payload, np.uint8)
            self._native_send(host, port, op, name, src, dst, weight,
                              p_weight, blob)
        else:
            blob = np.frombuffer(_encode_batch(batch), np.uint8)
            self._native_send(host, port, OP_BATCH, "", -1, -1, 0.0, 0.0,
                              blob)
        if t0 is not None:
            telemetry.observe_since(t0, "bf_win_rpc_seconds",
                                    op=_op_label(frame_op))
        if flightrec.enabled():
            # src carries the native recorder's rc: this runs on success.
            flightrec.note(flightrec.SENDMSG, op=frame_op, stripe=stripe,
                           src=0, dst=port, seq=len(batch), length=blob.size,
                           name=peer)
        with self._bytes_lock:  # several sender threads update the ratio
            self._tx_frames += 1
            self._tx_msgs += len(batch)
            ratio = self._tx_msgs / self._tx_frames
        if telemetry.enabled():
            telemetry.observe("bf_win_tx_batch_size", float(len(batch)))
            if len(batch) > 1:
                telemetry.inc("bf_win_tx_batches_total")
                telemetry.inc("bf_win_tx_batched_msgs_total",
                              float(len(batch)))
            telemetry.set_gauge("bf_win_tx_coalesce_ratio", ratio)

    def _native_send(self, host: str, port: int, op: int, name: str,
                     src: int, dst: int, weight: float, p_weight: float,
                     payload: np.ndarray) -> None:
        """One frame through ``bf_winsvc_send``, with up to
        ``BLUEFOG_TPU_WIN_RETRIES`` jittered exponential-backoff retries
        of a transient failure."""
        if (host, port) in self._partitioned:
            raise ConnectionError(
                f"win transport send to {host}:{port} dropped (partition)")
        args = (host.encode(), port, op, name.encode(), src, dst,
                float(weight), float(p_weight),
                payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                payload.size)
        rc = self._lib.bf_winsvc_send(*args)
        attempt = 0
        # -1 (address resolution) and -4 (name too long) are deterministic.
        while rc not in (0, -1, -4) and attempt < self._retries:
            telemetry.inc("bf_win_tx_retries_total", peer=f"{host}:{port}")
            time.sleep(self._retry_backoff * (2 ** attempt)
                       * (0.5 + random.random()))
            attempt += 1
            rc = self._lib.bf_winsvc_send(*args)
        if rc == -4:
            raise ValueError(
                "window transport: window name exceeds the receiver's "
                f"128-byte name field (127 usable bytes): {name!r}")
        if rc != 0:
            if telemetry.enabled():
                telemetry.inc("bf_win_tx_errors_total", peer=f"{host}:{port}")
            flightrec.dump_on_error(
                f"send to {host}:{port} failed (code {rc})")
            raise ConnectionError(
                f"win transport send to {host}:{port} failed (code {rc})")

    # -- inbound -----------------------------------------------------------
    def _drain(self):
        if self.native_path:
            return self._drain_native()
        return self._drain_python()

    def _drain_native(self):
        """``bf_winsvc_drain`` pops queued frames and returns ordered items,
        decode, codecs and same-slot folds done in C++; it blocks inside
        the call (without the GIL) while the queue is empty."""
        lib, svc = self._lib, self._svc
        burst, burst_t0, burst_t_end = 0, 0.0, 0.0
        while not self._stop.is_set():
            t_call = time.perf_counter()
            n = lib.bf_winsvc_drain(
                svc, self._items, self._items_cap,
                self._raw_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._raw_buf.size,
                self._val_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._val_buf.size, 64, 50)
            # A burst (items drained back to back, the inbound depth's
            # proxy) ends when the call had to wait for data or found none.
            if burst and (n == 0 or (n > 0 and
                                     time.perf_counter() - t_call > 0.002)):
                telemetry.set_gauge("bf_win_rx_queue_depth", burst)
                telemetry.observe("bf_win_drain_burst_seconds",
                                  burst_t_end - burst_t0)
                burst = 0
                self._pump_native_rx_stats()
            if n == -1:    # the next frame's raw payloads exceed the buffer
                self._raw_buf = self._alloc(
                    max(self._raw_buf.size * 2, 1 << 24))
                continue
            if n == -2:    # its folded values exceed the buffer
                self._val_buf = self._alloc(
                    4 * max(self._val_buf.size * 2, 1 << 22)).view(
                        np.float32)
                continue
            if n == -3:    # more runs than item slots
                self._items_cap *= 2
                self._items = (native.WinItem * self._items_cap)()
                continue
            if n > 0:
                if not burst:
                    burst_t0 = time.perf_counter()
                burst += int(n)
                self._apply_native_items(int(n))
                burst_t_end = time.perf_counter()

    def _raw_item_msg(self, it, raw_mv) -> Msg:
        return (int(it.op), it.name.decode(), int(it.src), int(it.dst),
                float(it.weight), float(it.p_weight),
                raw_mv[it.off:it.off + it.len])

    def _fallback_batch_frame(self, payload) -> Optional[List[Msg]]:
        """Python-decode a frame the native drain handed back whole (a bad
        version, an oversized name); None when it is undecodable (logged)."""
        try:
            return _decode_batch(payload)
        except Exception:  # noqa: BLE001 — the drain must survive
            _log.exception("window transport batch decode failed")
            return None

    def _apply_native_items(self, n: int) -> None:
        """Hand one native drain result, in order, to ``apply_items``; a
        consumer without it gets each decoded frame through
        ``apply_batch`` (singletons through ``apply``)."""
        raw_mv = memoryview(self._raw_buf)
        if self._apply_items is None:
            return self._apply_native_frames(n, raw_mv)
        items = []
        for i in range(n):
            it = self._items[i]
            if it.kind:
                vals = np.frombuffer(self._val_buf, np.float32,
                                     count=it.len, offset=it.off * 4)
                trace = (int(it.trace_src), int(it.trace_seq),
                         int(it.trace_mono_us), int(it.trace_unix_us),
                         int(it.trace_step)) if it.trace_seq else None
                items.append((1, (it.name.decode(), bool(it.replace),
                                  int(it.src), int(it.dst),
                                  float(it.p_weight), int(it.puts),
                                  int(it.accs), vals, int(it.wire_bytes),
                                  trace)))
            elif int(it.op) == OP_BATCH:
                sub = self._fallback_batch_frame(
                    raw_mv[it.off:it.off + it.len])
                items.extend((0, m) for m in sub or ())
            else:
                items.append((0, self._raw_item_msg(it, raw_mv)))
        try:
            self._apply_items(items)
        except Exception:  # noqa: BLE001 — the drain thread must survive
            _log.exception("window transport apply failed")

    def _apply_native_frames(self, n: int, raw_mv) -> None:
        """The consumer without ``apply_items``: raw items regrouped by
        their frame tag, one ``apply_batch`` call a decoded frame (no
        window is registered, so no commit can occur)."""
        i = 0
        while i < n:
            it = self._items[i]
            group = None
            if it.kind:
                _log.warning("window transport: folded commit for %r "
                             "dropped (no apply_items)", it.name.decode())
                i += 1
                continue
            if int(it.op) == OP_BATCH:
                group = self._fallback_batch_frame(
                    raw_mv[it.off:it.off + it.len])
                i += 1
                if group is None:
                    continue
            elif it.frame:
                group, f = [], it.frame
                while (i < n and self._items[i].kind == 0
                       and self._items[i].frame == f):
                    group.append(self._raw_item_msg(self._items[i], raw_mv))
                    i += 1
            else:
                msg = self._raw_item_msg(it, raw_mv)
                i += 1
            try:
                if group is None:
                    self._apply(*msg)
                elif self._apply_batch is not None:
                    self._apply_batch(group)
                else:
                    for m in group:
                        self._apply(*m)
            except Exception:  # noqa: BLE001 — the drain must survive
                _log.exception("window transport apply failed")

    def _drain_python(self):
        msg = native.WinMsg()
        burst, burst_t0 = 0, 0.0  # messages drained back to back
        while not self._stop.is_set():
            got = self._lib.bf_winsvc_recv(
                self._svc, ctypes.byref(msg),
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._buf.size)
            if got == -1:  # payload larger than the buffer
                self._buf = self._alloc(max(self._buf.size * 2, 1 << 24))
                continue
            if got == 0:
                if burst:
                    # The burst's length is the inbound depth's proxy, its
                    # time the drain's service time.
                    telemetry.set_gauge("bf_win_rx_queue_depth", burst)
                    telemetry.observe("bf_win_drain_burst_seconds",
                                      time.perf_counter() - burst_t0)
                    burst = 0
                self._stop.wait(_POLL_SEC)
                continue
            if not burst:
                burst_t0 = time.perf_counter()
            burst += 1
            payload = memoryview(self._buf)[:msg.payload_len]
            op = int(msg.op)
            try:
                if op == OP_BATCH:
                    msgs = _decode_batch(payload)
                    if telemetry.enabled():
                        telemetry.inc("bf_win_rx_batches_total")
                        telemetry.inc("bf_win_rx_bytes_total",
                                      float(len(payload)))
                        telemetry.observe("bf_win_rx_batch_size",
                                          float(len(msgs)))
                        for m in msgs:
                            telemetry.inc("bf_win_rx_msgs_total",
                                          op=_op_label(m[0]))
                    if self._apply_batch is not None:
                        self._apply_batch(msgs)
                    else:
                        for m in msgs:
                            self._apply(*m)
                else:
                    if telemetry.enabled():
                        telemetry.inc("bf_win_rx_msgs_total",
                                      op=_op_label(op))
                        telemetry.inc("bf_win_rx_bytes_total",
                                      float(msg.payload_len))
                    self._apply(op, msg.name.decode(), int(msg.src),
                                int(msg.dst), float(msg.weight),
                                float(msg.p_weight), payload)
            except Exception:  # noqa: BLE001 — the drain must survive
                _log.exception("window transport apply failed")

    def _drain_control(self):
        """The control lane's consumer: each ``OP_MEMBER`` frame, in
        arrival order, to ``apply`` (the membership controller takes only
        its own lock)."""
        msg = native.WinMsg()
        while not self._stop.is_set():
            got = self._lib.bf_winsvc_ctrl_recv(
                self._svc, ctypes.byref(msg),
                self._ctrl_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._ctrl_buf.size, 50)
            if got == -1:  # payload larger than the buffer
                self._ctrl_buf = np.empty(self._ctrl_buf.size * 2, np.uint8)
                continue
            if got == 0:
                continue
            op = int(msg.op)
            src = int(msg.src)
            q = self.member_rx.get(src)
            if q is None:
                q = self.member_rx.setdefault(src, deque(maxlen=4096))
            q.append((msg.rx_mono_us / 1e6, time.monotonic()))
            if telemetry.enabled():
                telemetry.inc("bf_win_rx_msgs_total", op=_op_label(op))
                telemetry.inc("bf_win_rx_bytes_total",
                              float(msg.payload_len))
            try:
                self._apply(op, msg.name.decode(), src,
                            int(msg.dst), float(msg.weight),
                            float(msg.p_weight),
                            memoryview(self._ctrl_buf)[:msg.payload_len])
            except Exception:  # noqa: BLE001 — the lane must survive
                _log.exception("window transport control apply failed")

    def stop(self):
        """Stop the senders (each drains its queue first), the drain and
        control threads and the service."""
        tx, self._tx = self._tx, None
        if tx is not None:
            try:
                self._pump_native_tx_stats(tx, force=True)
            except Exception:  # noqa: BLE001 — telemetry must not block stop
                pass
            self._lib.bf_wintx_stop(tx)
        with self._senders_lock:
            senders = list(self._senders.values())
            self._senders.clear()
        for s in senders:
            s.stop()
        self._stop.set()
        self._drainer.join(timeout=5)
        self._ctrl.join(timeout=5)
        if self._svc:
            if self.native_path:
                try:
                    self._pump_native_rx_stats()
                except Exception:  # noqa: BLE001
                    pass
            self._lib.bf_winsvc_stop(self._svc)
            self._svc = None
