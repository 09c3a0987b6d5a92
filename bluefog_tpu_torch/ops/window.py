"""One-sided window ops: the async gossip family, in one process or across
processes.

The port of ``bluefog_tpu/ops/window.py``.  A window holds, for every rank
this process owns, its exposed memory (``main``) and one staging buffer
per in-neighbor edge, with per-rank mutexes, per-edge version counters and
the associated-P scalars of push-sum.  ``win_put`` overwrites each
destination's buffer-for-me with ``w * t``, ``win_accumulate`` adds into
it, ``win_get`` pulls ``w * main[src]``; ``win_update`` combines self
memory with the staging buffers, and ``win_update_then_collect`` sums them
with weight 1 and empties them (push-sum's collect).  The nonblocking ops
run on a worker pool and return an integer handle for :func:`win_wait`.

**Across processes** (``basics.init_distributed``), each process is the
authority for the ranks it owns, as in the JAX package: the window keeps
main and staging for the owned ranks and their in-edges only (the
owned-rows layout, O(owned + in-degree) rows a process), and an edge whose
target another process owns travels over the window transport
(``ops/transport.py``, its native service in ``native/src/winsvc.cc``) as
the raw row and its weight; the owner's drain thread scales and applies it
with the same versions, mutexes and associated P.  :func:`win_fence` acks
every peer's sends and ends in ``basics.barrier()``.  A window created
from a tensor of the owned rows (``(len(owned_ranks()), ...)``) takes and
returns owned rows (``layout="owned"``); one created from a rank-major
tensor takes rank-major tensors and returns zeros in the rows of other
processes' ranks.

**The device.**  ``main`` and the staging buffers stay on ``bf.device()``:
a local put is a device copy, ``win_update`` a device weighted sum.  A
remote edge's row is copied from the card into a pinned host buffer (one
a window, row and codec, reused), handed to the transport, which copies
it into its send arena before it returns; an inbound row is decoded and
scaled on the host by the drain (in C++ on the native path) and copied to
the card into staging, in the drain's call, from a pinned receive buffer.
The receiver multiplies the raw row by the weight in float32, as the JAX
package's numpy does and as torch multiplies a float32 tensor by a Python
scalar, so a fenced put lands the same bits as in one process.

**One stream.**  Every window op, including the jobs of the pool threads,
the drain thread's commits and the service pool's replies, is enqueued on
one CUDA stream, the device's default stream (:func:`_stream`, which also
makes the thread's current device the window's).  Under the locks,
enqueue order is then execution order, which is what the store's locking
argues about.  The host bookkeeping is updated when a job *runs*, not
when the device finishes.  A caller may have another stream current: an
op (a job at its dispatch) first makes the default stream wait for the
caller's stream, so it reads what the caller wrote; an op that returns
rows, and :func:`win_wait`, :func:`win_fence` and :func:`win_flush`, make
the caller's stream wait for the default stream.

A nonblocking op reads its payload when its job runs: the caller must not
change the tensor before :func:`win_wait` (MPI's rule for a nonblocking
put).  Across processes :func:`win_wait` of a put means the local send is
done (the payload handed to TCP), not that the row arrived; remote
visibility is ordered by :func:`win_fence`, as with ``MPI_Put``.

**The async mode** (``BLUEFOG_TPU_ASYNC=1``, armed by the window
optimizers through :func:`configure_async`): the optimizers drop the
per-step fence, and every committed accumulate passes the bounded-staleness
policy.  A contribution's age is the receiver's step clock
(:func:`set_async_step`) less the origin step in its wire trace tag
(``BLUEFOG_TPU_TRACE_SAMPLE``), or its wall-clock age over the receiver's
step period when the tag has no step; an untagged one inherits its edge's
last estimate.  Past ``BLUEFOG_TPU_ASYNC_STALENESS_STEPS`` it is rejected or
downweighted (``BLUEFOG_TPU_ASYNC_STALENESS_POLICY``), the mass held back
kept in the window's stale-residual store until
:func:`win_fold_stale_residuals` folds it into staging after a fence, so
push-sum's mass is conserved.  Off, nothing changes: every data path is
bit for bit the lockstep one.  The arithmetic is the JAX package's, in
float32 on the window's device: the policy's decisions, the staging, the
store and P are the same bits.

Every op reports into ``utils/telemetry`` as the JAX package's does (op
counts, bytes a peer process, in-flight handles, mutex waits, the stale
counters, the contribution ages), in ``op_span`` spans for the timeline and
the step profiler; ``win_wait`` and the remote mutex grants run under the
stall watchdog, whose peer probe the transport installs.

**The put-plan path** (``BLUEFOG_TPU_WIN_XLA``, default on;
``ops/xlaffi.py``): a float32 put whose remote edges all ride the native
sender runs them as one native plan over one staging copy of the owned
rows (pinned, on a card) instead of a staged row and a send an edge; the
frames are the same bytes, and ``=0`` keeps the host-staged path as the
oracle.  The fused window step (``ops/fused_step.py``) captures the same
plan into its program and finishes each bucket with
:func:`_fused_host_finish`.  Every traced commit feeds the link
observatory (``utils/linkobs.py``), and :func:`set_async_step` ticks it
and the tuner.

**Elasticity** (``BLUEFOG_TPU_CHURN``, ``BLUEFOG_TPU_ELASTIC_JOIN``): the
membership heartbeats (``OP_MEMBER``) and the gang's directory and join
traffic (``OP_GANG``) go to ``ops/membership.py`` and ``ops/gang.py``
before the rank-directory check, as in the JAX package (a joiner gets its
grant on a transport with no directory yet); with the subsystems off they
are dropped there.  The churn supervisor (``run/supervisor.py``) rebuilds
the windows after a committed change with :func:`owned_snapshot` and
:func:`rebuild_from_snapshot`: the owned rows are stacked on the window's
device, never through the host, and the new window, under the survivor
topology, starts from them with zeroed staging and the push-sum scalars
restored.  ``BLUEFOG_TPU_WIN_COMPRESSION`` acts on cross-process edges
only.
"""

from __future__ import annotations

import contextlib
import math
import os
import socket
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional

import numpy as np
import torch

from bluefog_tpu_torch.ops.transport import (
    OP_ACCUMULATE, OP_BF16_FLAG, OP_FENCE_ACK, OP_FENCE_REQ, OP_FLAG_MASK,
    OP_GANG, OP_GET_REPLY, OP_GET_REQ, OP_MEMBER, OP_MUTEX_ACQ,
    OP_MUTEX_GRANT, OP_MUTEX_REL, OP_PUT, OP_SPARSE_FLAG, OP_TRACE_FLAG,
    make_trace_tag, set_trace_origin_step, sparse_decode, sparse_encode,
    trace_strip)
from bluefog_tpu_torch.ops import xlaffi
from bluefog_tpu_torch.utils import (config, flightrec, linkobs, stall,
                                     telemetry)
from bluefog_tpu_torch.utils.logging import get_logger
from bluefog_tpu_torch.utils.timeline import op_span

__all__ = [
    "win_create", "win_free", "win_put", "win_put_nonblocking",
    "win_get", "win_get_nonblocking", "win_accumulate",
    "win_accumulate_nonblocking", "win_update", "win_update_then_collect",
    "win_wait", "win_poll", "win_mutex", "win_fence", "win_flush",
    "get_win_version", "win_state_dict", "win_load_state_dict",
    "get_current_created_window_names", "win_associated_p",
    "turn_on_win_ops_with_associated_p", "turn_off_win_ops_with_associated_p",
    "configure_async", "async_armed", "set_async_step", "async_step_lag",
    "async_info", "win_fold_stale_residuals", "clear_async_staleness",
    "clear_contribution_age", "owned_snapshot", "rebuild_from_snapshot",
    "churn_tolerates",
]

_log = get_logger()


def _timeout() -> float:
    """``BLUEFOG_TPU_WIN_TIMEOUT``: how long an op waits for a peer."""
    return config.get().win_timeout


class _Window:
    """State of one named window in the owned-rows layout: ``main``,
    ``p_main``, ``main_versions`` and ``mutexes`` keyed by owned rank,
    ``staging``, ``p_staging`` and ``versions`` by ``(dst, src)`` edge with
    an owned ``dst``.  One process owns every rank.

    ``layout`` is the caller's array convention: ``"rank"`` windows take
    and return rank-major ``(n, ...)`` tensors, ``"owned"`` windows (across
    processes) ``(len(owned), ...)`` ones, row ``i`` rank ``owned[i]``."""

    def __init__(self, name: str, tensor: torch.Tensor,
                 in_nbrs: List[List[int]], out_nbrs: List[List[int]],
                 zero_init: bool, owned: List[int], layout: str):
        n = len(in_nbrs)
        self.name = name
        self.n = n
        self.shape = tuple(tensor.shape[1:])
        self.dtype = tensor.dtype
        self.device = tensor.device
        self.in_nbrs = in_nbrs
        self.out_nbrs = out_nbrs
        self.owned = list(owned)
        self.layout = layout
        # rank -> row of the caller's tensors
        self.row_of = ({r: r for r in range(n)} if layout == "rank"
                       else {r: i for i, r in enumerate(self.owned)})
        # main[r]: rank r's exposed memory (win_get's source, win_update's
        # self term), from a rank-major tensor or one of the owned rows (a
        # rebuild keeps a rank-layout window's layout, rebuild_from_snapshot).
        src_row = ({r: r for r in range(n)} if tensor.shape[0] == n
                   else {r: i for i, r in enumerate(self.owned)})
        self.main: Dict[int, torch.Tensor] = {
            r: tensor[src_row[r]].clone() for r in self.owned}
        # staging[(dst, src)]: what src pushed toward dst (or dst pulled
        # from src); seeded with the neighbor's initial value.
        self.staging: Dict[tuple, torch.Tensor] = {}
        for dst in self.owned:
            for src in in_nbrs[dst]:
                if zero_init:
                    self.staging[(dst, src)] = torch.zeros_like(tensor[0])
                elif layout == "rank":
                    self.staging[(dst, src)] = tensor[src].clone()
                else:
                    raise ValueError(
                        "owned-layout windows require zero_init=True (the "
                        "creation tensor carries no neighbor rows to seed "
                        "staging with)")
        # versions[(dst, src)]: puts into the slot since the last update.
        self.versions: Dict[tuple, int] = {k: 0 for k in self.staging}
        # Self-publishes to main[r] (win_put's self_weight): a publish that
        # lands mid-combine serializes AFTER the update, and the swap must
        # not clobber it with the pre-publish combine result.
        self.main_versions: Dict[int, int] = {r: 0 for r in self.owned}
        self.mutexes: Dict[int, threading.RLock] = {
            r: threading.RLock() for r in self.owned}
        self.lock = threading.RLock()      # the store-structure lock
        # Whole win_update calls, one at a time (snapshot -> combine -> swap
        # of two updates must not interleave); puts and the drain take only
        # `lock`, so they stay concurrent with the combine.
        self.update_lock = threading.Lock()
        # associated-P scalars (push-sum weights); self starts at 1.0
        self.p_main: Dict[int, float] = {r: 1.0 for r in self.owned}
        self.p_staging: Dict[tuple, float] = {k: 0.0 for k in self.staging}
        # Pinned host rows of remote sends, one a (src, codec, purpose),
        # reused; each purpose has its lock (puts, GET replies).
        self.pinned: Dict[tuple, torch.Tensor] = {}
        self.put_stage_lock = threading.Lock()
        self.reply_stage_lock = threading.Lock()
        # The async mode's stale-residual store, by edge: the mass the
        # staleness policy held back, until win_fold_stale_residuals.
        self.stale_residual: Dict[tuple, torch.Tensor] = {}
        self.p_stale_residual: Dict[tuple, float] = {}


class _Distrib:
    """Multi-process window state: the transport and the rank directory.

    ``rank_owner[r]`` is the process that owns rank ``r``;
    ``proc_addr[p]`` is process ``p``'s ``(host, port)`` endpoint."""

    def __init__(self, transport, rank_owner: Dict[int, int],
                 proc_addr: Dict[int, tuple], my_proc: int):
        self.transport = transport
        self.rank_owner = rank_owner
        self.proc_addr = proc_addr
        self.my_proc = my_proc
        self.my_rank = min(r for r, p in rank_owner.items() if p == my_proc)
        self.cv = threading.Condition()
        self.pending_gets: Dict[tuple, int] = {}   # (name, dst, src) -> n
        self.fence_acks = 0
        # Striped fan-out: FENCE_REQ and MUTEX_REL ride every stripe of a
        # peer, with the copy count in the wire `weight` and a sender serial
        # in `p_weight`; the receiver acts on the last copy of the newest
        # serial.  Keys: requesting rank (fence) / (name, rank, requester)
        # (release); values: (serial, copies seen).
        self.fence_req_seen: Dict[int, tuple] = {}
        self.rel_seen: Dict[tuple, tuple] = {}
        # Fences each process has sent us (counted on the last copy) and
        # fences of ours: under churn the fence's barrier is the peers'
        # own FENCE_REQs, not a collective over the process group.
        self.fence_reqs_in: Dict[int, int] = {}
        self.fences_out = 0
        self.fanout_serial = 0
        # The remote mutex: one outstanding ACQ a (name, rank) a process.
        self.grant_events: Dict[tuple, threading.Event] = {}
        self.remote_holds: Dict[tuple, threading.Event] = {}
        self.mutex_serial: Dict[tuple, threading.Lock] = {}
        # Inbound messages for windows not created here yet (SPMD skew).
        self.parked: Dict[str, list] = {}


class _WindowStore:
    def __init__(self):
        self.windows: Dict[str, _Window] = {}
        self.lock = threading.RLock()
        self.pool = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix="bf-win")
        # Inbound service work (GET replies, fence acks) runs on its own
        # executor: user ops on `pool` block waiting for peers' replies,
        # and serving replies from a saturated `pool` would deadlock both
        # sides until the timeout.
        self.svc_pool = ThreadPoolExecutor(max_workers=4,
                                           thread_name_prefix="bf-win-svc")
        self.handles: Dict[int, Future] = {}
        self.next_handle = 0
        self.associated_p_enabled = False
        self.distrib: Optional[_Distrib] = None
        # Messages that arrived between the listener going live and the
        # directory being installed.
        self.preinit_msgs: list = []

    def get(self, name: str) -> _Window:
        with self.lock:
            if name not in self.windows:
                raise KeyError(f"window {name!r} does not exist")
            return self.windows[name]

    def submit(self, fn, device: torch.device,
               payload: Optional[torch.Tensor] = None) -> int:
        """Run ``fn`` on the pool; the job returns ``device``, for the
        waiter's stream order.  Called on the caller's thread, it orders
        the default stream after the caller's (see :func:`_stream`).
        Refused while ``suspend()`` is in force."""
        from bluefog_tpu_torch import basics
        basics._require_active()
        _default_waits_for_caller(device, payload)

        def job():
            with _stream(device):
                fn()
            return device
        with self.lock:
            h = self.next_handle
            self.next_handle += 1
            self.handles[h] = self.pool.submit(job)
            telemetry.set_gauge("bf_win_inflight_handles", len(self.handles))
            return h


_store = _WindowStore()


class _Stats:
    """Seconds and bytes of the cross-process path, summed over threads:
    card-to-host staging of remote rows (the host-staged path's a row, the
    put-plan path's one copy a put: ``plan_stage_*``), their sends and
    flushes until
    they were handed to TCP (the wire), the waits for a remote mutex's
    grant, and the drain's host-to-card copies of what arrived.  Read by
    the benchmark and ``chip_smoke.py``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.stage_s = self.wire_s = self.commit_s = self.mutex_s = 0.0
        self.plan_stage_s = 0.0
        self.stage_bytes = self.commit_bytes = self.plan_stage_bytes = 0

    def add(self, **kv) -> None:
        with self.lock:
            for k, v in kv.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> dict:
        with self.lock:
            d = _store.distrib
            return {"stage_s": self.stage_s, "stage_bytes": self.stage_bytes,
                    "plan_stage_s": self.plan_stage_s,
                    "plan_stage_bytes": self.plan_stage_bytes,
                    "wire_s": self.wire_s, "mutex_s": self.mutex_s,
                    "commit_s": self.commit_s,
                    "commit_bytes": self.commit_bytes,
                    "tx_bytes": d.transport.tx_bytes if d else 0}


stats = _Stats()


def _side_stream(device: torch.device):
    """The calling thread's current stream on ``device`` when it is not
    the default stream (None on the CPU and on the default stream)."""
    if device.type != "cuda":
        return None
    current = torch.cuda.current_stream(device)
    return None if current == torch.cuda.default_stream(device) else current


def _default_waits_for_caller(device: torch.device,
                              payload: Optional[torch.Tensor] = None):
    """The default stream waits for the caller's stream; ``payload``,
    which the default stream will read, is not reused by the caching
    allocator before that read."""
    side = _side_stream(device)
    if side is None:
        return
    default = torch.cuda.default_stream(device)
    default.wait_stream(side)
    if payload is not None:
        payload.record_stream(default)


def _caller_waits(device: torch.device) -> None:
    """The caller's stream waits for the window ops enqueued so far."""
    side = _side_stream(device)
    if side is not None:
        side.wait_stream(torch.cuda.default_stream(device))


@contextlib.contextmanager
def _stream(device: torch.device):
    """Run the enclosed window ops on ``device``'s default stream, with
    ``device`` current (a no-op on the CPU), ordered after the work the
    calling thread has enqueued on its current stream, which waits for
    them in turn."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        _default_waits_for_caller(device)
        with torch.cuda.stream(torch.cuda.default_stream(device)):
            yield
        _caller_waits(device)


def _any_window_exists() -> bool:
    return bool(_store.windows)


def _drain_handles(timeout: float = 60.0) -> bool:
    """Wait for every outstanding nonblocking op; False if one is still
    running at ``timeout`` (errors are left for its ``win_wait``)."""
    with _store.lock:
        futures = list(_store.handles.values())
    deadline = time.monotonic() + timeout
    drained = True
    for f in futures:
        try:
            _caller_waits(f.result(
                timeout=max(0.0, deadline - time.monotonic())))
        except FutureTimeout:
            drained = False
        except Exception:  # noqa: BLE001 — the owning win_wait raises it
            pass
    return drained


def _free_all_windows() -> None:
    d = _store.distrib
    with _store.lock:
        for f in _store.handles.values():
            f.cancel()
        _store.handles.clear()
        if d is not None:
            for name in _store.windows:
                d.transport.unregister_window(name)
        _store.windows.clear()
    _drop_ef_residuals()


# ---------------------------------------------------------------------------
# The async mode: the step clock and the bounded-staleness policy
# ---------------------------------------------------------------------------

class _AsyncGossip:
    """The process's async-mode state.  ``armed`` is the one check every
    commit makes: off (the default) every data path is the lockstep one.
    ``step`` and its EWMA ``step_period`` are this process's step clock;
    ``peer_step`` the newest origin step seen from each source (from the
    trace tags), ``edge_age`` the last age estimated on each edge, which an
    untagged message on that edge inherits."""

    def __init__(self):
        self.lock = threading.Lock()
        self.armed = False
        self.staleness_steps = 0
        self.policy = ("reject", 0.0)
        self.step = 0
        self.step_period = 0.0
        self._last_step_mono = None
        self.peer_step: Dict[int, int] = {}
        self.edge_age: Dict[tuple, float] = {}


_async = _AsyncGossip()


def _set_native_fold(armed: bool) -> None:
    """The native drain folds accumulates into a put-headed entry only
    outside the async mode, as :func:`_apply_data_run` does, so the policy
    sees the same entries on both paths."""
    from bluefog_tpu_torch import native
    handle = native.loaded()
    if handle is not None:
        handle.bf_winsvc_set_fold_across_put(0 if armed else 1)


def configure_async(enabled: Optional[bool] = None) -> bool:
    """Arm (or disarm) the async mode from the config (``enabled``
    overrides ``BLUEFOG_TPU_ASYNC``); returns whether it is armed.
    Disarming clears every estimate, so that a re-arm starts afresh."""
    cfg = config.get()
    on = cfg.async_mode if enabled is None else bool(enabled)
    with _async.lock:
        _async.staleness_steps = int(cfg.async_staleness_steps)
        _async.policy = config.parse_staleness_policy(
            cfg.async_staleness_policy)
        _async.armed = on
        if not on:
            _async.peer_step.clear()
            _async.edge_age.clear()
            _async._last_step_mono = None
            _async.step_period = 0.0
    _set_native_fold(on)
    return on


def async_armed() -> bool:
    return _async.armed


def set_async_step(step: int) -> None:
    """Publish this process's training step: ages count against it, and
    the trace tags carry it as their origin step.  It is a step boundary
    of the link observatory (divergence, rates, SLO rules); the tuner
    ticks in the churn supervisor's ``step`` (or ``tuner.tick``), as in
    the JAX package."""
    now = time.monotonic()
    with _async.lock:
        prev, _async._last_step_mono = _async._last_step_mono, now
        _async.step = int(step)
        if prev is not None and now > prev:
            dt = now - prev
            _async.step_period = dt if _async.step_period == 0.0 \
                else 0.9 * _async.step_period + 0.1 * dt
    set_trace_origin_step(step)
    linkobs.on_step(step)


def async_step_lag() -> int:
    """The newest peer step seen less this process's step (positive: this
    process is behind); 0 before any tagged message arrived."""
    with _async.lock:
        if not _async.peer_step:
            return 0
        return max(_async.peer_step.values()) - _async.step


def async_info() -> Optional[dict]:
    """The async mode's state (None when it is not armed)."""
    with _async.lock:
        if not _async.armed:
            return None
        cfg = config.get()
        freshest = max(_async.peer_step.values(), default=None)
        return {
            "step": _async.step,
            "staleness_steps": _async.staleness_steps,
            "policy": cfg.async_staleness_policy,
            "collect_every": cfg.async_collect_every,
            "step_lag": (freshest - _async.step)
            if freshest is not None else 0,
            "step_period_sec": round(_async.step_period, 6),
            "peer_steps": dict(_async.peer_step),
        }


def _staleness_factor(name: str, key: tuple, tag) -> tuple:
    """The policy's decision for one arriving accumulate on edge ``key``
    (``win.lock`` held): ``(keep, action)``, ``keep`` the share that
    enters staging and ``action`` None (fresh: the caller takes the
    lockstep arithmetic), ``"reject"`` (keep 0.0) or ``"downweight"``.

    The age in steps: exact from a tag's origin step; from a tag without
    one, its wall-clock age over this process's step period; an untagged
    message inherits its edge's last estimate (fresh before the first)."""
    if not _async.armed:
        return 1.0, None
    src = key[1]
    with _async.lock:
        bound = _async.staleness_steps
        kind, alpha = _async.policy
        if tag is not None:
            o_step = tag[4] if len(tag) > 4 else -1
            if o_step >= 0:
                age = float(max(0, _async.step - o_step))
                if o_step > _async.peer_step.get(src, -(1 << 62)):
                    _async.peer_step[src] = int(o_step)
            else:
                age_sec = max(0.0, (time.time_ns() // 1000 - tag[3]) / 1e6)
                period = _async.step_period
                age = age_sec / period if period > 0 else 0.0
            _async.edge_age[(name,) + key] = age
        else:
            age = _async.edge_age.get((name,) + key, 0.0)
    if bound <= 0 or age <= bound:
        return 1.0, None
    if kind == "downweight":
        return alpha, "downweight"
    return 0.0, "reject"


_age_lock = threading.Lock()
_age_minmax: Dict[int, list] = {}


def _note_contribution(name: str, src: int, tag, dst: int = -1) -> None:
    """One tagged contribution reached its staging slot: the flight
    recorder's COMMIT event (the end of the tag's chain), the link
    observatory's delay sample of the edge ``src -> dst``, and its age,
    the receiver's wall clock less the tag's origin (exact on one host),
    into ``bf_win_contribution_age_seconds`` and the freshest and stalest
    gauges of its source."""
    if flightrec.enabled():
        flightrec.note(flightrec.COMMIT, src=tag[0], dst=src, seq=tag[1],
                       name=name)
    linkobs.note_commit(src, dst, tag)
    if not telemetry.enabled():
        return
    age = max(0.0, (time.time_ns() // 1000 - tag[3]) / 1e6)
    telemetry.observe("bf_win_contribution_age_seconds", age, src=str(src))
    with _age_lock:
        mm = _age_minmax.get(src)
        if mm is None:
            mm = _age_minmax[src] = [age, age]
        else:
            mm[0] = min(mm[0], age)
            mm[1] = max(mm[1], age)
        lo, hi = mm
    telemetry.set_gauge("bf_win_contribution_freshest_age_seconds", lo,
                        src=str(src))
    telemetry.set_gauge("bf_win_contribution_stalest_age_seconds", hi,
                        src=str(src))


def clear_contribution_age(ranks=None) -> None:
    """Drop the contribution-age gauges of the sources ``ranks`` (None:
    every one): a dead peer's last ages must not linger as live series.
    The histograms stay (counters, not claims about a live edge)."""
    with _age_lock:
        targets = list(_age_minmax) if ranks is None else \
            [r for r in ranks if r in _age_minmax]
        for r in targets:
            _age_minmax.pop(r, None)
    for r in targets:
        telemetry.clear_gauge("bf_win_contribution_freshest_age_seconds",
                              src=str(r))
        telemetry.clear_gauge("bf_win_contribution_stalest_age_seconds",
                              src=str(r))


def _note_stale(actions) -> None:
    """The staleness policy's applied decisions, ``[(src, action)]``
    (counted outside ``win.lock``: counters are not state)."""
    if not telemetry.enabled():
        return
    for src, action in actions:
        telemetry.inc("bf_win_stale_rejected_total" if action == "reject"
                      else "bf_win_stale_downweighted_total", src=str(src))


def _divert_stale(win: _Window, key: tuple, contrib: torch.Tensor,
                  p_mass: float, keep: float) -> None:
    """Move the share of one stale contribution that was not admitted into
    the window's stale-residual store (``win.lock`` held).  ``contrib``
    may view a receive buffer: the store keeps its own tensors."""
    frac = 1.0 - keep
    add = contrib.clone() if keep == 0.0 else contrib * frac
    res = win.stale_residual.get(key)
    if res is None:
        win.stale_residual[key] = add
    else:
        res += add
    if _store.associated_p_enabled:
        win.p_stale_residual[key] = \
            win.p_stale_residual.get(key, 0.0) + frac * p_mass


def win_fold_stale_residuals(name: Optional[str] = None) -> int:
    """Fold every stale-diverted contribution back into its staging slot
    (one window, or every window); returns the edges folded.  After a
    fence nothing is in flight, so staging plus the residuals is exactly
    the mass the senders shipped: the collect that follows is exact.
    Residuals of edges the window no longer has are dropped."""
    with _store.lock:
        names = [name] if name is not None else list(_store.windows)
    folded = 0
    for nm in names:
        try:
            win = _store.get(nm)
        except KeyError:
            continue
        with _stream(win.device), win.lock:
            for key, res in list(win.stale_residual.items()):
                if key in win.staging:
                    win.staging[key] += res
                    win.versions[key] += 1
                    if _store.associated_p_enabled:
                        win.p_staging[key] += \
                            win.p_stale_residual.get(key, 0.0)
                    folded += 1
            win.stale_residual.clear()
            win.p_stale_residual.clear()
    return folded


def clear_async_staleness(ranks=None) -> None:
    """Forget the async estimates of the sources ``ranks`` (None: every
    one): a peer gone from the world must not keep its last origin step in
    the step lag, nor its stale counters."""
    with _async.lock:
        if ranks is None:
            targets = sorted(set(_async.peer_step)
                             | {k[2] for k in _async.edge_age})
        else:
            targets = [int(r) for r in ranks]
        for r in targets:
            _async.peer_step.pop(r, None)
        for k in [k for k in _async.edge_age if k[2] in targets]:
            _async.edge_age.pop(k, None)
    for r in targets:
        telemetry.clear_counter("bf_win_stale_rejected_total", src=str(r))
        telemetry.clear_counter("bf_win_stale_downweighted_total",
                                src=str(r))


# ---------------------------------------------------------------------------
# Multi-process plumbing: rank ownership and the transport
# ---------------------------------------------------------------------------

def _owns(rank: int) -> bool:
    d = _store.distrib
    return d is None or d.rank_owner[rank] == d.my_proc


def _owned_ranks(n: int) -> List[int]:
    d = _store.distrib
    if d is None:
        return list(range(n))
    return [r for r in range(n) if d.rank_owner[r] == d.my_proc]


def _local_host_addr() -> str:
    """This process's address for the window transport: ``BFTPU_WIN_HOST``,
    else the interface that routes to the rendezvous host (a UDP connect
    sends no packet), else the host name's address."""
    override = os.environ.get("BFTPU_WIN_HOST")
    if override:
        return override
    coord = os.environ.get("BFTPU_COORDINATOR")
    target = None
    if coord and ":" in coord:
        host, port = coord.rsplit(":", 1)
        target = (host, int(port))
    elif os.environ.get("MASTER_ADDR"):
        target = (os.environ["MASTER_ADDR"],
                  int(os.environ.get("MASTER_PORT", "29500")))
    if target is not None:
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect(target)
                return s.getsockname()[0]
        except OSError:
            pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


# The endpoint exchange's key namespace: c10d store keys are set once, and
# a re-init must not read the previous incarnation's.  Every process calls
# init_transport as often (an SPMD call), so the counters agree.
_exchange_generation = 0


def _exchange_endpoints(me: str, comm) -> List[str]:
    """Every process's ``host:port`` endpoint, in process order, over the
    c10d store of the default process group (the JAX package uses its
    coordinator's key-value store the same way)."""
    global _exchange_generation
    from torch.distributed import distributed_c10d
    gen = _exchange_generation
    _exchange_generation += 1
    store = distributed_c10d._get_default_store()
    store.set(f"bf/win_addr/{gen}/{comm.process}", me)
    out = []
    for p in range(comm.nprocs):
        out.append(store.get(f"bf/win_addr/{gen}/{p}").decode())
    return out


def _pinned_alloc(device: torch.device):
    """The transport's receive-buffer allocator: pinned host memory when
    the windows live on a card, so a commit's copy to it reads pinned
    memory."""
    if device.type != "cuda":
        return None

    def alloc(nbytes: int) -> np.ndarray:
        with torch.cuda.device(device):
            return torch.empty(nbytes, dtype=torch.uint8,
                               pin_memory=True).numpy()
    return alloc


def make_transport(port: int = 0, device: Optional[torch.device] = None):
    """A window transport wired to this store's apply callbacks, with no
    rank directory yet: inbound data messages wait in ``preinit_msgs``
    until :func:`install_distrib`."""
    from bluefog_tpu_torch.ops.transport import WindowTransport
    return WindowTransport(_apply_inbound, apply_batch=_apply_inbound_batch,
                           apply_items=_apply_inbound_items, port=port,
                           alloc=_pinned_alloc(device or torch.device("cpu")))


def install_distrib(transport, rank_owner: Dict[int, int],
                    proc_addr: Dict[int, tuple], my_proc: int) -> None:
    """Install the rank directory over a live transport and replay the
    messages that raced ahead of it, under one lock hold (the drain thread
    waits on that lock in its pre-init check)."""
    with _store.lock:
        _store.distrib = _Distrib(transport, dict(rank_owner),
                                  dict(proc_addr), my_proc)
        pending, _store.preinit_msgs = _store.preinit_msgs, []
        for msg in pending:
            _apply_inbound(*msg)
    # Stall warnings can now name the unreachable peers' ranks.
    stall.set_peer_probe(_probe_missing_ranks)
    # The async mode (BLUEFOG_TPU_ASYNC) arms with the transport, as in
    # the JAX package: raw window gossip (no optimizer) ages and folds
    # contributions too; with the knob off the flag stays False.
    configure_async()


def _probe_missing_ranks(timeout: float = 1.0) -> List[int]:
    """The ranks whose owner's transport endpoint refuses a TCP connection
    (the stall watchdog's and ``/healthz``'s liveness source; the JAX
    package's L494).  The peers are probed concurrently."""
    d = _store.distrib
    if d is None:
        return []

    def reachable(addr) -> bool:
        try:
            socket.create_connection(addr, timeout=timeout).close()
            return True
        except OSError:
            return False

    peers = [(p, addr) for p, addr in sorted(d.proc_addr.items())
             if p != d.my_proc]
    if not peers:
        return []
    with ThreadPoolExecutor(max_workers=min(16, len(peers)),
                            thread_name_prefix="bf-stall-probe") as pool:
        alive = list(pool.map(lambda pa: reachable(pa[1]), peers))
    missing: List[int] = []
    for (p, _), ok in zip(peers, alive):
        if not ok:
            missing.extend(r for r, owner in d.rank_owner.items()
                           if owner == p)
    telemetry.inc("bf_win_peer_probes_total")
    telemetry.set_gauge("bf_win_unreachable_peers", len(missing))
    return sorted(missing)


def init_transport() -> bool:
    """Start the window transport and exchange the rank directory: called
    by ``basics.init_distributed`` when the world spans processes.  False
    (and nothing started) in one process."""
    from bluefog_tpu_torch import basics
    if _store.distrib is not None:
        return True
    comm = basics.process_ranks()
    if comm is None or comm.nprocs == 1:
        return False
    transport = make_transport(config.get().win_port, basics.device())
    _set_native_fold(_async.armed)
    try:
        addrs = _exchange_endpoints(
            f"{_local_host_addr()}:{transport.port}", comm)
    except BaseException:
        transport.stop()
        raise
    proc_addr = {}
    for p, addr in enumerate(addrs):
        host, _, port = addr.rpartition(":")
        proc_addr[p] = (host, int(port))
    rank_owner = {r: comm.owner(r) for r in range(comm.n)}
    install_distrib(transport, rank_owner, proc_addr, comm.process)
    return True


def _shutdown_transport() -> None:
    d = _store.distrib
    _store.distrib = None
    if d is not None:
        stall.set_peer_probe(None)
        # The cached put plans route onto this transport's native sender:
        # they die before it does.
        xlaffi.invalidate()
        d.transport.stop()
        # No transport, no edges: the gang service rode it, and the
        # per-edge ages and async estimates describe peers gone with it.
        from bluefog_tpu_torch.ops import gang
        gang.install(None)
        clear_contribution_age()
        clear_async_staleness()
        linkobs.clear_all()


# ---------------------------------------------------------------------------
# Payloads on the wire
# ---------------------------------------------------------------------------

# Sender-side error-feedback residuals of the sparse:<frac> codec, keyed by
# (window, src, dst) edge, on the window's device: the un-sent complement
# of every sparsified row is folded into the next send on that edge, so the
# time-summed wire traffic carries the full mass.
_ef_residuals: Dict[tuple, torch.Tensor] = {}
_ef_lock = threading.Lock()


def _drop_ef_residuals(name: Optional[str] = None) -> None:
    """Forget sender residuals (every window's, or one freed window's),
    the put plans' native ones and the plans with them."""
    xlaffi.invalidate(name)
    with _ef_lock:
        if name is None:
            _ef_residuals.clear()
        else:
            for k in [k for k in _ef_residuals if k[0] == name]:
                _ef_residuals.pop(k, None)


def _sparse_payload(name: str, src: int, dst: int, row: torch.Tensor,
                    frac: float) -> np.ndarray:
    """Top-|magnitude| sparsification of one edge's row with error
    feedback: the previous residual is added, the top ``ceil(frac *
    size)`` entries ship (their float32 bits exact), the complement is the
    new residual."""
    flat = row.reshape(-1)
    key = (name, src, dst)
    # A stream that switched from the put-plan path to this one would
    # strand mass in the native residual store: take it (copy and erase)
    # and fold it in; residuals add, so the merge is exact.
    nat = xlaffi.take_native_residual(name, src, dst, flat.numel())
    with _ef_lock:
        res = _ef_residuals.get(key)
        v = flat + res if res is not None and res.shape == flat.shape \
            else flat.clone()
        if nat is not None:
            v += torch.from_numpy(nat).to(v.device)
        k = max(1, int(math.ceil(frac * v.numel())))
        if k >= v.numel():
            idx = torch.arange(v.numel(), device=v.device)
        else:
            idx = torch.topk(v.abs(), k, sorted=False).indices.sort().values
        vals = v[idx]
        v[idx] = 0.0
        _ef_residuals[key] = v
    return sparse_encode(vals.cpu().numpy(), idx.cpu().numpy())


def _stage(win: _Window, key: tuple, row: torch.Tensor) -> np.ndarray:
    """``row`` (contiguous, on the window's device) as host bytes the
    transport copies from: on a card, copied into the pinned buffer of
    ``key`` (kept for reuse; the caller holds that purpose's lock), the
    copy complete on return; on the CPU, the row's own memory."""
    if row.device.type != "cuda":
        return row.contiguous().view(torch.uint8).reshape(-1).numpy()
    t0 = time.perf_counter()
    buf = win.pinned.get(key)
    if buf is None or buf.shape != row.shape or buf.dtype != row.dtype:
        buf = win.pinned[key] = torch.empty(row.shape, dtype=row.dtype,
                                            pin_memory=True)
    buf.copy_(row, non_blocking=True)
    torch.cuda.current_stream(row.device).synchronize()
    nbytes = row.numel() * row.element_size()
    stats.add(stage_s=time.perf_counter() - t0, stage_bytes=nbytes)
    xlaffi.count_host_copy(nbytes, "stage")
    return buf.view(torch.uint8).reshape(-1).numpy()


def _encode_row(win: _Window, op: int, src: int, dst: int,
                row: torch.Tensor, purpose: str, cache: dict):
    """``(op with codec flags, host payload)`` of one remote edge's row
    under ``BLUEFOG_TPU_WIN_COMPRESSION``, as the JAX package's
    ``_send_to_proc`` encodes it: ``sparse:<frac>`` for float32
    accumulates (error feedback a (window, src, dst) edge), ``bf16`` for
    every float32 row, else the raw row.  Dense and bf16 rows are staged
    once a src an op (``cache``)."""
    comp = config.get().win_compression
    f32 = row.dtype == torch.float32 and row.numel() > 0
    if f32 and comp.startswith("sparse") and op == OP_ACCUMULATE:
        # The fraction under the tuner's override (empty with
        # BLUEFOG_TPU_TUNE=0: the configured value, bitwise).
        from bluefog_tpu_torch.utils import tuner
        return op | OP_SPARSE_FLAG, _sparse_payload(
            win.name, src, dst, row, tuner.override_float(
                "sparse_frac", config.parse_sparse_frac(comp)))
    if f32 and comp == "bf16":
        if ("bf16", src) not in cache:
            cache[("bf16", src)] = _stage(
                win, (src, "bf16", purpose), row.to(torch.bfloat16))
        return op | OP_BF16_FLAG, cache[("bf16", src)]
    if ("raw", src) not in cache:
        cache[("raw", src)] = _stage(win, (src, "raw", purpose),
                                     row.contiguous())
    return op, cache[("raw", src)]


def _send_to_proc(proc: int, op: int, name: str, src: int, dst: int,
                  weight: float, p_weight: float = 0.0, payload=None,
                  stripe: Optional[int] = None) -> None:
    d = _store.distrib
    host, port = d.proc_addr[proc]
    if payload is None:
        payload = np.empty(0, np.uint8)
    if payload.size and (op & ~OP_FLAG_MASK) in (OP_PUT, OP_ACCUMULATE):
        # The sampled data message carries its trace trailer inside the
        # payload, after any codec (BLUEFOG_TPU_TRACE_SAMPLE; unset, this
        # is one config check).
        tag = make_trace_tag(src)
        if tag is not None:
            # One copy of the row (the JAX package's bytes concatenation
            # makes two); the same bytes on the wire.
            payload = np.concatenate([payload.reshape(-1).view(np.uint8),
                                      np.frombuffer(tag, np.uint8)])
            op |= OP_TRACE_FLAG
    if telemetry.enabled():
        telemetry.inc("bf_win_proc_tx_bytes_total", float(payload.nbytes),
                      proc=proc)
        # Window traffic between processes is the dcn level of the
        # two-level wire accounting.
        telemetry.inc("bf_comm_level_bytes_total", float(payload.nbytes),
                      level="dcn")
    d.transport.send(host, port, op, name, src, dst, weight, payload,
                     p_weight, stripe=stripe)


def _send_to_rank_owner(rank: int, op: int, name: str, src: int, dst: int,
                        weight: float, p_weight: float = 0.0, payload=None,
                        stripe: Optional[int] = None) -> None:
    _send_to_proc(_store.distrib.rank_owner[rank], op, name, src, dst,
                  weight, p_weight, payload, stripe=stripe)


def _fanout_weight(n_stripes: int) -> float:
    """Wire ``weight`` of a FENCE_REQ / MUTEX_REL copy: the copy count,
    exactly 0.0 single-stream (the pre-stripe wire)."""
    return float(n_stripes) if n_stripes > 1 else 0.0


def _fanout_serial(d: _Distrib, n_stripes: int) -> float:
    """Wire ``p_weight`` of a fan-out's copies: a per-process serial, so a
    partially delivered earlier fan-out never completes a later one;
    exactly 0.0 single-stream."""
    if n_stripes <= 1:
        return 0.0
    with d.cv:
        d.fanout_serial += 1
        return float(d.fanout_serial)


def _fanout_count(seen: dict, key, serial: float):
    """Advance one fan-out counter for an arriving copy (under ``d.cv``):
    the copies seen for ``serial``, or None for a stale copy of an older
    fan-out."""
    cur = seen.get(key)
    if cur is not None and cur[0] > serial:
        return None
    count = cur[1] + 1 if cur is not None and cur[0] == serial else 1
    seen[key] = (serial, count)
    return count


def _flush_transport(procs=None, since=None, timeout=None) -> None:
    """Hand the queued sends to TCP (to the processes ``procs``, default
    every peer) and raise their errors here; ``since`` is the transport's
    error token from before the op's sends.  A no-op in one process."""
    d = _store.distrib
    if d is None:
        return
    addrs = None if procs is None else {d.proc_addr[p] for p in procs}
    if addrs is not None and not addrs:
        return
    d.transport.flush(timeout=_timeout() if timeout is None else timeout,
                      addrs=addrs, since=since)


def _wait_on_peers(wait, procs, tok, what: str,
                   timeout: Optional[float] = None) -> bool:
    """``wait(seconds) -> bool`` until it holds or ``timeout`` (default
    ``BLUEFOG_TPU_WIN_TIMEOUT``) passes.  Under churn (a membership
    controller installed) the wait runs in slices, and a peer process of
    ``procs`` that left the committed view, or whose sends failed since
    the error token ``tok``, ends it with ``ConnectionError``: a dead
    peer's grant, reply or ack never comes, and the controller's own
    heartbeats to it are what fail first."""
    timeout = _timeout() if timeout is None else timeout
    from bluefog_tpu_torch.ops import membership
    ctrl = membership.current()
    if ctrl is None:
        return wait(timeout)
    d = _store.distrib
    addrs = {d.proc_addr[p] for p in procs if p in d.proc_addr}
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        if wait(max(0.0, min(0.05, left))):
            return True
        gone = sorted(p for p in procs if p not in ctrl.active)
        if gone or (tok is not None and addrs
                    and d.transport.error_token(addrs) > tok):
            raise ConnectionError(
                f"{what}: peer process(es) {gone or sorted(procs)} failed "
                "or left the gang")
        if left <= 0:
            return False


def _payload_row(win: _Window, payload, compressed: bool = False,
                 sparse: bool = False) -> torch.Tensor:
    """Decode one wire payload (bytes, or a view into the transport's
    receive buffer valid only for the apply call) to a window-shaped host
    row; the result may view the payload."""
    numel = int(np.prod(win.shape, dtype=np.int64))
    itemsize = torch.empty((), dtype=win.dtype).element_size()
    expected = numel * itemsize
    if sparse:
        idx, vals = sparse_decode(payload)
        row = torch.zeros(numel, dtype=win.dtype)
        if idx.size:
            if int(idx.max(initial=0)) >= numel or \
                    int(idx.min(initial=0)) < 0:
                raise ValueError(
                    f"window {win.name!r}: sparse payload indexes outside "
                    f"the {numel}-element row")
            row[torch.from_numpy(idx.astype(np.int64))] = \
                torch.from_numpy(vals.copy()).to(win.dtype)
        return row.reshape(win.shape)
    raw = np.frombuffer(payload, np.uint8)
    if compressed:
        if len(raw) * 2 != expected:
            raise ValueError(
                f"window {win.name!r}: bf16-flagged payload of {len(raw)} "
                f"bytes does not match half a {expected}-byte row")
        # bf16 -> float32 is exact: the bf16 bits are the high half.
        wide = raw.view(np.uint16).astype(np.uint32) << 16
        return torch.from_numpy(wide.view(np.float32)).to(
            win.dtype).reshape(win.shape)
    if len(raw) != expected:
        raise ValueError(
            f"window {win.name!r}: payload of {len(raw)} bytes does not "
            f"match the {expected}-byte row (shape {win.shape}, dtype "
            f"{win.dtype})")
    if not raw.flags.writeable:
        raw = raw.copy()
    return torch.from_numpy(raw).view(win.dtype).reshape(win.shape)


def _to_device(win: _Window, row: torch.Tensor) -> torch.Tensor:
    """A host row on the window's device, the copy complete on return (the
    row may view a receive buffer that the next drain reuses)."""
    if win.device.type != "cuda":
        return row
    t0 = time.perf_counter()
    out = row.to(win.device)
    stats.add(commit_s=time.perf_counter() - t0,
              commit_bytes=row.numel() * row.element_size())
    return out


# ---------------------------------------------------------------------------
# Inbound: the drain thread's apply
# ---------------------------------------------------------------------------

def _reply_get(name: str, src: int, dst: int, weight: float) -> None:
    """Answer a GET_REQ: ship ``main[src]`` (owned here) to ``dst``'s
    owner, which scales it by ``weight``."""
    try:
        win = _store.get(name)
    except KeyError:
        return  # freed concurrently; the requester's timeout reports it
    with win.reply_stage_lock, _stream(win.device):
        with win.lock:
            row = win.main[src].clone()
            p_w = weight * float(win.p_main[src])
        op, payload = _encode_row(win, OP_GET_REPLY, src, dst, row, "reply",
                                  {})
        _send_to_rank_owner(dst, op, name, src, dst, weight, p_w, payload)


@contextlib.contextmanager
def _remote_mutex(name: str, rank: int, my_rank: int):
    """Writer-side distributed mutex on a rank another process owns: ACQ,
    wait for the GRANT, the critical section, REL.  The REL travels the
    same FIFO as the puts sent inside, so the owner applies them before it
    releases.  Yields the seconds the grant took."""
    d = _store.distrib
    with d.cv:
        serial = d.mutex_serial.setdefault((name, rank), threading.Lock())
    with serial:
        granted = threading.Event()
        with d.cv:
            d.grant_events[(name, rank)] = granted
        try:
            proc = d.rank_owner[rank]
            tok = d.transport.error_token({d.proc_addr[proc]})
            t0 = time.perf_counter()
            _send_to_rank_owner(rank, OP_MUTEX_ACQ, name, my_rank, rank, 0.0)
            _flush_transport({proc}, since=tok)
            with stall.watch(f"win_mutex({name!r}) grant of rank {rank}"):
                got = _wait_on_peers(granted.wait, {proc}, tok,
                                     f"win_mutex({name!r}) grant")
            if not got:
                raise ConnectionError(
                    f"win_mutex({name!r}): rank {rank}'s owner did not grant "
                    f"within {_timeout():.0f}s")
            waited = time.perf_counter() - t0
            stats.add(mutex_s=waited)
            telemetry.inc("bf_win_mutex_acquisitions_total", kind="remote")
            telemetry.inc("bf_win_mutex_wait_seconds_total", waited,
                          kind="remote")
            yield waited
        finally:
            try:
                proc = d.rank_owner[rank]
                tok = d.transport.error_token({d.proc_addr[proc]})
                n_str = d.transport.n_stripes
                w = _fanout_weight(n_str)
                serial_no = _fanout_serial(d, n_str)
                for k in range(n_str):
                    _send_to_rank_owner(rank, OP_MUTEX_REL, name, my_rank,
                                        rank, w, p_weight=serial_no,
                                        stripe=k)
                _flush_transport({proc}, since=tok)
            except ConnectionError as e:
                # Under churn a dead owner's release goes nowhere, and
                # nothing waits for it.
                if not churn_tolerates(e):
                    raise
            finally:
                with d.cv:
                    d.grant_events.pop((name, rank), None)


def _requester_removed(requester: int) -> bool:
    """Under churn: is the requester's process out of the committed view
    (dead, or voted out alive)?  Its release would never come, and a
    grant to it would hold the mutex for the whole release timeout,
    stalling every later requester (``_release_remote_holds`` frees only
    the holds taken before the commit)."""
    from bluefog_tpu_torch.ops import membership
    ctrl = membership.current()
    d = _store.distrib
    if ctrl is None or d is None:
        return False
    proc = d.rank_owner.get(requester)
    return proc is not None and proc not in ctrl.view().active_procs


def _hold_mutex_for_remote(name: str, rank: int, requester: int) -> None:
    """Hold rank's (owned) mutex for a remote requester until its
    MUTEX_REL arrives; on its own daemon thread.  A requester out of the
    gang's committed view gets no grant."""
    d = _store.distrib
    try:
        win = _store.get(name)
    except KeyError:
        return
    release = threading.Event()
    key = (name, rank, requester)
    try:
        with win.mutexes[rank]:
            if _requester_removed(requester):
                return
            # Registered only once the mutex is ours: a predecessor's late
            # release copies must not set this event.
            with d.cv:
                d.remote_holds[key] = release
            proc = d.rank_owner[requester]
            tok = d.transport.error_token({d.proc_addr[proc]})
            _send_to_rank_owner(requester, OP_MUTEX_GRANT, name, requester,
                                rank, 0.0)
            _flush_transport({proc}, since=tok)
            release.wait(timeout=_timeout())
    finally:
        with d.cv:
            if d.remote_holds.get(key) is release:
                d.remote_holds.pop(key, None)


def _apply_inbound(op: int, name: str, src: int, dst: int, weight: float,
                   p_weight: float, payload) -> None:
    """Apply one inbound message to the owned window state (the drain
    thread).  It never blocks on a peer: replies and mutex holds go to the
    service pool and their own threads.  ``payload`` may view the
    transport's receive buffer, valid for this call only."""
    base = op & ~OP_FLAG_MASK
    if base == OP_MEMBER:
        # The churn controller's heartbeats: consumed at once, never
        # parked (dropped with no controller installed; the sender
        # heartbeats again on its own cadence).
        from bluefog_tpu_torch.ops import membership
        membership.handle_wire(payload)
        return
    if base == OP_GANG:
        # Gang join and directory traffic: before the directory check, as
        # a joiner's grant lands on a transport with no directory yet.
        from bluefog_tpu_torch.ops import gang
        gang.handle_wire(payload)
        return
    orig_op = op
    compressed = bool(op & OP_BF16_FLAG)
    sparse = bool(op & OP_SPARSE_FLAG)
    traced = bool(op & OP_TRACE_FLAG)
    op = base
    d = _store.distrib
    if d is None:
        with _store.lock:
            if _store.distrib is None:
                # No directory yet (a peer finished its init first): keep
                # the bytes; install_distrib replays in arrival order.
                _store.preinit_msgs.append(
                    (orig_op, name, src, dst, weight, p_weight,
                     bytes(payload)))
                return
            d = _store.distrib
    if op == OP_FENCE_REQ:
        # Striped: answer only the last copy of the newest serial.
        total = int(weight) if weight >= 2.0 else 1
        if total > 1:
            with d.cv:
                seen = _fanout_count(d.fence_req_seen, src, p_weight)
                if seen is None or seen < total:
                    return
                d.fence_req_seen.pop(src, None)
        with d.cv:
            proc = d.rank_owner.get(src)
            d.fence_reqs_in[proc] = d.fence_reqs_in.get(proc, 0) + 1
            d.cv.notify_all()
        _store.svc_pool.submit(_send_to_rank_owner, src, OP_FENCE_ACK, "",
                               src, dst, 0.0)
        return
    if op == OP_FENCE_ACK:
        with d.cv:
            d.fence_acks += 1
            d.cv.notify_all()
        return
    if op == OP_MUTEX_GRANT:
        with d.cv:
            ev = d.grant_events.get((name, dst))
        if ev is not None:
            ev.set()
        return
    if op == OP_MUTEX_REL:
        total = int(weight) if weight >= 2.0 else 1
        with d.cv:
            if total > 1:
                key = (name, dst, src)
                seen = _fanout_count(d.rel_seen, key, p_weight)
                if seen is None or seen < total:
                    return
                d.rel_seen.pop(key, None)
            ev = d.remote_holds.get((name, dst, src))
        if ev is not None:
            ev.set()
        return
    with _store.lock:
        win = _store.windows.get(name)
        if win is None:
            # SPMD skew: the peer wrote this window before our win_create
            # ran; win_create replays in arrival order.
            d.parked.setdefault(name, []).append(
                (orig_op, name, src, dst, weight, p_weight, bytes(payload)))
            return
    if op in (OP_PUT, OP_ACCUMULATE, OP_GET_REPLY):
        # Applied, not parked: inbound bytes a peer process (a parked
        # message's replay is not counted twice).
        if telemetry.enabled():
            telemetry.inc("bf_win_proc_rx_bytes_total", float(len(payload)),
                          proc=d.rank_owner.get(src, -1))
        tag = None
        stale = None
        if traced:
            payload, tag = trace_strip(payload)
        row = _payload_row(win, payload, compressed, sparse=sparse)
        with _stream(win.device), \
                op_span(f"win_apply.{name}.{src}->{dst}", "COMMUNICATE"):
            scaled = _to_device(win, row) * weight  # a float32 multiply
            with win.lock:
                key = (dst, src)
                if key in win.staging:
                    stale = None
                    if op == OP_ACCUMULATE:
                        keep, stale = _staleness_factor(name, key, tag)
                        if stale is None:
                            win.staging[key] += scaled
                        else:
                            # The admitted share in, the rest held in the
                            # stale-residual store: no mass is dropped.
                            if keep:
                                win.staging[key] += scaled * keep
                            _divert_stale(win, key, scaled, p_weight, keep)
                    else:
                        win.staging[key] = scaled
                    if stale != "reject":
                        win.versions[key] += 1
                    if _store.associated_p_enabled:
                        if op != OP_ACCUMULATE:
                            win.p_staging[key] = p_weight
                        elif stale is None:
                            win.p_staging[key] += p_weight
                        elif keep:
                            win.p_staging[key] += keep * p_weight
        if stale is not None:
            _note_stale([(src, stale)])
        if tag is not None:
            _note_contribution(name, src, tag, dst)
        if op == OP_GET_REPLY:
            with d.cv:
                key = (name, dst, src)
                d.pending_gets[key] = d.pending_gets.get(key, 0) - 1
                d.cv.notify_all()
    elif op == OP_GET_REQ:
        _store.svc_pool.submit(_reply_get, name, src, dst, weight)
    elif op == OP_MUTEX_ACQ:
        threading.Thread(target=_hold_mutex_for_remote,
                         args=(name, dst, src), daemon=True,
                         name=f"bf-win-hold-{dst}").start()


def _apply_inbound_batch(msgs) -> None:
    """One decoded OP_BATCH frame (the Python drain), in arrival order:
    runs of puts and accumulates into one window take
    :func:`_apply_data_run`; a bad message or run loses only itself."""
    i, n = 0, len(msgs)
    while i < n:
        if (msgs[i][0] & ~OP_FLAG_MASK) not in (OP_PUT, OP_ACCUMULATE):
            try:
                _apply_inbound(*msgs[i])
            except Exception:  # noqa: BLE001 — isolate per message
                _log.exception("window transport apply failed (batched "
                               "control msg)")
            i += 1
            continue
        name = msgs[i][1]
        j = i + 1
        while (j < n and msgs[j][1] == name
               and (msgs[j][0] & ~OP_FLAG_MASK) in (OP_PUT, OP_ACCUMULATE)):
            j += 1
        try:
            _apply_data_run(name, msgs[i:j])
        except Exception:  # noqa: BLE001 — isolate per run
            _log.exception("window transport apply failed (batched data "
                           "run)")
        i = j


def _apply_inbound_items(items) -> None:
    """The native drain's ordered items: ``(0, msg)`` raw messages and
    ``(1, commit)`` folded entries, a window's run committed under one
    lock hold; a bad run or message loses only itself."""
    i, n = 0, len(items)
    while i < n:
        kind, payload = items[i]
        if kind == 0:
            try:
                _apply_inbound(*payload)
            except Exception:  # noqa: BLE001 — isolate per message
                _log.exception("window transport apply failed (native raw "
                               "msg)")
            i += 1
            continue
        name = payload[0]
        j = i + 1
        while j < n and items[j][0] == 1 and items[j][1][0] == name:
            j += 1
        try:
            _commit_native_run(name, [it[1] for it in items[i:j]])
        except Exception:  # noqa: BLE001 — isolate per run
            _log.exception("window transport apply failed (native commit "
                           "run)")
        i = j


def _commit_native_run(name: str, entries) -> None:
    """Commit one window's run of natively folded entries under one
    ``win.lock`` hold.  An entry is ``(name, replace, src, dst, p_mass,
    puts, accs, values, wire_bytes, trace)`` with ``values`` a float32 view
    into the drain's buffer, valid only for this call: a replace copies it
    into staging, an accumulate adds it, each copy to the card complete
    before the call returns.  The C++ fold reproduces the Python batched
    apply's decode, scale and fold order, so the state is the same bits."""
    d = _store.distrib
    with _store.lock:
        win = _store.windows.get(name) if d is not None else None
    if win is None or d is None:
        # Pre-init or SPMD-skew parking: each folded entry as one
        # equivalent message (a put of the folded row at weight 1).
        for (nm, replace, src, dst, p_mass, _puts, _accs, vals, _wb,
             _tr) in entries:
            _apply_inbound(OP_PUT if replace else OP_ACCUMULATE, nm, src,
                           dst, 1.0, p_mass, np.asarray(vals).tobytes())
        return
    if telemetry.enabled():
        for (_nm, _r, src, _d, _pm, _p, _a, _v, wire_bytes, _t) in entries:
            telemetry.inc("bf_win_proc_rx_bytes_total", float(wire_bytes),
                          proc=d.rank_owner.get(src, -1))
    expected = int(np.prod(win.shape, dtype=np.int64))
    noted, stale_noted = [], []
    with _stream(win.device), win.lock, \
            op_span(f"win_apply_batch.{name}", "COMMUNICATE"):
        for (_nm, replace, src, dst, p_mass, puts, accs, vals, _wb,
             trace) in entries:
            key = (dst, src)
            if key not in win.staging:
                continue
            if trace is not None:
                noted.append((src, dst, trace))
            if vals.size != expected or win.dtype != torch.float32:
                _log.warning("window %r: folded entry of %d elements does "
                             "not match the %d-element row; dropped", name,
                             vals.size, expected)
                continue
            row = _to_device(win, torch.from_numpy(vals).view(win.shape))
            if replace:
                # On the CPU the row still views the drain's buffer.
                win.staging[key] = row if win.device.type == "cuda" \
                    else row.clone()
                win.versions[key] += puts + accs
                if _store.associated_p_enabled:
                    win.p_staging[key] = p_mass
                continue
            keep, action = _staleness_factor(name, key, trace)
            if action is None:
                win.staging[key] += row
                win.versions[key] += puts + accs
                if _store.associated_p_enabled:
                    win.p_staging[key] += p_mass
                continue
            stale_noted.append((src, action))
            if keep:
                win.staging[key] += row * keep
                win.versions[key] += puts + accs
                if _store.associated_p_enabled:
                    win.p_staging[key] += keep * p_mass
            _divert_stale(win, key, row, p_mass, keep)
    _note_stale(stale_noted)
    for src, dst, trace in noted:
        _note_contribution(name, src, trace, dst)


def _apply_data_run(name: str, group) -> None:
    """A run of puts and accumulates into one window (the Python drain):
    decode and scale outside the lock, fold consecutive contributions to
    one slot (a put then accumulates is ``A + B`` with every version tick
    kept), commit the run under one lock hold."""
    d = _store.distrib
    with _store.lock:
        win = _store.windows.get(name) if _store.distrib is not None else None
    if d is None or win is None:
        for m in group:
            _apply_inbound(*m)
        return
    if telemetry.enabled():
        for m in group:
            telemetry.inc("bf_win_proc_rx_bytes_total", float(len(m[6])),
                          proc=d.rank_owner.get(m[2], -1))
    # [replace, (dst, src), scaled row, p mass, ticks, trace tag or None]
    entries = []
    noted, stale_noted = [], []
    with _stream(win.device), \
            op_span(f"win_apply_batch.{name}", "COMMUNICATE"):
        for (op, _n, src, dst, weight, p_weight, payload) in group:
            try:
                tag = None
                if op & OP_TRACE_FLAG:
                    payload, tag = trace_strip(payload)
                row = _payload_row(win, payload, bool(op & OP_BF16_FLAG),
                                   sparse=bool(op & OP_SPARSE_FLAG))
            except ValueError:
                _log.exception("window transport apply failed (batched row "
                               "decode)")
                continue
            scaled = _to_device(win, row) * weight  # fresh: no view kept
            key = (dst, src)
            accumulate = (op & ~OP_FLAG_MASK) == OP_ACCUMULATE
            # The async mode folds no accumulate into a put-headed entry:
            # puts pass no policy, and the fold would carry the
            # accumulate's mass past it.  The latest tag governs a run.
            if accumulate and entries and entries[-1][1] == key \
                    and (not _async.armed or not entries[-1][0]):
                entries[-1][2] += scaled
                entries[-1][3] += p_weight
                entries[-1][4] += 1
                if tag is not None:
                    entries[-1][5] = tag
            else:
                entries.append([not accumulate, key, scaled, p_weight, 1,
                                tag])
        with win.lock:
            for replace, key, scaled, p_mass, ticks, tag in entries:
                if key not in win.staging:
                    continue
                if tag is not None:
                    noted.append((key[1], key[0], tag))
                if replace:
                    win.staging[key] = scaled
                    win.versions[key] += ticks
                    if _store.associated_p_enabled:
                        win.p_staging[key] = p_mass
                    continue
                keep, action = _staleness_factor(name, key, tag)
                if action is None:
                    win.staging[key] += scaled
                    win.versions[key] += ticks
                    if _store.associated_p_enabled:
                        win.p_staging[key] += p_mass
                    continue
                stale_noted.append((key[1], action))
                if keep:
                    win.staging[key] += scaled * keep
                    win.versions[key] += ticks
                    if _store.associated_p_enabled:
                        win.p_staging[key] += keep * p_mass
                _divert_stale(win, key, scaled, p_mass, keep)
    _note_stale(stale_noted)
    for src, dst, tag in noted:
        _note_contribution(name, src, tag, dst)


# ---------------------------------------------------------------------------
# Topology, weights, devices
# ---------------------------------------------------------------------------

def _neighbors_from_topology():
    from bluefog_tpu_torch import basics
    from bluefog_tpu_torch import topology as topology_util
    topo = basics.load_topology()
    n = basics.size()
    return (n, [topology_util.in_neighbor_ranks(topo, r) for r in range(n)],
            [topology_util.out_neighbor_ranks(topo, r) for r in range(n)])


def _resolve_edge_weights(weights, nbrs_of, default: float, *,
                          peer_is_src: bool = False,
                          ranks=None) -> Dict[tuple, float]:
    """Normalize dst/src weight arguments to ``{(rank, peer): w}``.

    ``weights`` may be None (every edge gets ``default``), a full (n, n)
    matrix in the ``W[src, dst]`` convention, a dict ``{(rank, peer): w}``,
    or a dict ``{peer: w}`` applied to every rank.  ``peer_is_src`` marks
    in-neighbor callers (win_get / win_update), where ``rank`` is the
    destination and the matrix lookup is ``W[peer, rank]``."""
    out: Dict[tuple, float] = {}
    n = len(nbrs_of)
    rs = range(n) if ranks is None else ranks
    if weights is None:
        for r in rs:
            for peer in nbrs_of[r]:
                out[(r, peer)] = default
    elif isinstance(weights, dict):
        if weights and isinstance(next(iter(weights)), tuple):
            return {k: float(v) for k, v in weights.items()}
        for r in rs:
            for peer in nbrs_of[r]:
                if peer in weights:
                    out[(r, peer)] = float(weights[peer])
    else:
        w = np.asarray(weights, dtype=float)
        if w.shape != (n, n):
            raise ValueError(f"weight matrix must be ({n}, {n}), got "
                             f"{w.shape}")
        for r in rs:
            for peer in nbrs_of[r]:
                out[(r, peer)] = float(w[peer, r] if peer_is_src
                                       else w[r, peer])
    return out


def _index(dev: torch.device) -> tuple:
    """``dev`` with its index made explicit (``cuda`` is the current
    card)."""
    if dev.type == "cuda" and dev.index is None:
        return dev.type, torch.cuda.current_device()
    return dev.type, dev.index


def _device_tensor(tensor, what: str) -> torch.Tensor:
    """``tensor``, detached (windows hold values, outside autograd), as a
    tensor on ``bf.device()``; one elsewhere is refused, never copied over
    (no quiet staging through the host)."""
    from bluefog_tpu_torch import basics
    t = torch.as_tensor(tensor).detach()
    dev = basics.device()
    if _index(t.device) != _index(dev):
        raise ValueError(f"{what}: the tensor is on {t.device}, the windows "
                         f"live on {dev}; move it there first")
    return t


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------

def win_create(tensor, name: str, zero_init: bool = False) -> bool:
    """Create a named window on ``bf.device()`` from a rank-major ``(size,
    ...)`` tensor or, across processes, from the owned rows
    (``(len(owned_ranks()), ...)``, the owned layout, which requires
    ``zero_init``): one staging buffer per in-edge of an owned rank, under
    the current topology, which is frozen while windows exist.  Across
    processes an SPMD call (every process creates the window); gossip that
    raced ahead of it is replayed in arrival order.  Returns False if the
    name is taken."""
    from bluefog_tpu_torch import basics
    comm = basics.process_ranks()
    if comm is not None and comm.nprocs > 1 and _store.distrib is None:
        raise RuntimeError(
            "window ops across processes need the window transport, which "
            "bf.init_distributed() starts: without it each process would "
            "gossip with a private copy")
    n, in_nbrs, out_nbrs = _neighbors_from_topology()
    t = _device_tensor(tensor, f"win_create({name!r})")
    owned = _owned_ranks(n)
    rows = t.shape[0] if t.dim() else None
    if rows == n:
        layout = "rank"
    elif _store.distrib is not None and rows == len(owned):
        layout = "owned"
    else:
        raise ValueError(
            f"win_create({name!r}): leading dim {rows} is neither the world "
            f"size ({n}, rank-major) nor this process's owned-rank count "
            f"({len(owned)}, owned layout)")
    d = _store.distrib
    with _store.lock:
        if name in _store.windows:
            return False
        with _stream(t.device):
            win = _store.windows[name] = _Window(
                name, t, in_nbrs, out_nbrs, zero_init, owned, layout)
            if d is not None:
                for msg in d.parked.pop(name, []):
                    try:
                        _apply_inbound(*msg)
                    except Exception:  # noqa: BLE001 — isolate per message
                        # A straggler of an earlier window of this name
                        # (freed while its gossip was in flight).
                        _log.exception("window %r: a parked message could "
                                       "not be applied; dropped", name)
    if d is not None and win.dtype == torch.float32:
        # The native drain folds float32 rows; other dtypes arrive raw.
        d.transport.register_window(name, int(np.prod(win.shape,
                                                       dtype=np.int64)))
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Free one window (all with ``name=None``); False if there is none of
    that name.  Its sparse residuals go with it."""
    d = _store.distrib
    try:
        with _store.lock:
            if name is None:
                names = list(_store.windows)
            elif name in _store.windows:
                names = [name]
            else:
                return False
            for nm in names:
                if d is not None:
                    d.transport.unregister_window(nm)
                del _store.windows[nm]
        return True
    finally:
        _drop_ef_residuals(name)


def get_current_created_window_names() -> List[str]:
    with _store.lock:
        return sorted(_store.windows)


def owned_snapshot(name: str) -> Dict[str, object]:
    """What a rebuild after a membership change starts from: the owned
    ranks' rows of the window's memory stacked into one tensor on the
    window's device (no row crosses to the host), the push-sum scalars and
    the layout.  Taken between whole updates (``update_lock``)."""
    win = _store.get(name)
    with win.update_lock, win.lock, _stream(win.device):
        rows = (torch.stack([win.main[r] for r in win.owned]) if win.owned
                else torch.empty((0,) + win.shape, dtype=win.dtype,
                                 device=win.device))
        return {"rows": rows, "owned": list(win.owned),
                "p_main": dict(win.p_main), "layout": win.layout}


def rebuild_from_snapshot(name: str, snap: Dict[str, object]) -> None:
    """Create window ``name`` anew under the current topology from an
    :func:`owned_snapshot`: its memory the snapshot's rows (the same
    bits), its staging zeroed (gossip of the old epoch, and of a dead
    peer, is dropped), its push-sum scalars restored and its layout kept.
    An SPMD call across the survivors (each rebuilds its own windows)."""
    n, in_nbrs, out_nbrs = _neighbors_from_topology()
    rows = snap["rows"]
    owned = _owned_ranks(n)
    if list(snap["owned"]) != owned:
        raise ValueError(
            f"rebuild_from_snapshot({name!r}): the snapshot holds ranks "
            f"{snap['owned']}, this process owns {owned}")
    d = _store.distrib
    with _store.lock:
        if name in _store.windows:
            raise ValueError(f"rebuild_from_snapshot: window {name!r} "
                             "exists; free it first")
        with _stream(rows.device):
            win = _store.windows[name] = _Window(
                name, rows, in_nbrs, out_nbrs, True, owned,
                snap["layout"])
            for r, p in snap["p_main"].items():
                if r in win.p_main:
                    win.p_main[r] = p
            if d is not None:
                for msg in d.parked.pop(name, []):
                    try:
                        _apply_inbound(*msg)
                    except Exception:  # noqa: BLE001 — isolate per message
                        _log.exception("window %r: a parked message could "
                                       "not be applied; dropped", name)
    if d is not None and win.dtype == torch.float32:
        d.transport.register_window(name, int(np.prod(win.shape,
                                                       dtype=np.int64)))


def _release_remote_holds(ranks) -> None:
    """Release the owned mutexes held for the requesters ``ranks`` (their
    process died holding them: no MUTEX_REL will come)."""
    d = _store.distrib
    if d is None:
        return
    dead = {int(r) for r in ranks}
    with d.cv:
        for (_name, _rank, requester), ev in list(d.remote_holds.items()):
            if requester in dead:
                ev.set()


def churn_tolerates(err: BaseException) -> bool:
    """True when ``err`` is a send failure the churn controller owns: a
    ``ConnectionError`` while a live membership controller is installed.
    A peer that died before the gang voted it out fails its sends; the
    window optimizers count such a failure and combine what arrived, and
    the committed change retires the peer (``run/supervisor.py``)."""
    if not isinstance(err, ConnectionError):
        return False
    from bluefog_tpu_torch.ops import membership
    ctrl = membership.current()
    if ctrl is None or ctrl.evicted:
        return False
    _log.warning("churn: a send failed before the gang voted its peer out "
                 "(%s); combining what has arrived", err)
    return True


# ---------------------------------------------------------------------------
# One-sided ops
# ---------------------------------------------------------------------------

def _validate_edges(edges: Dict[tuple, float], nbrs_of: List[List[int]],
                    *, peer_is_src: bool, op: str) -> None:
    """Reject edges absent from the window's topology (a caller bug, as
    the reference's MPI graph communicator errors)."""
    for (r, peer) in edges:
        if peer not in nbrs_of[r]:
            kind = "in-neighbor" if peer_is_src else "out-neighbor"
            raise ValueError(
                f"{op}: rank {peer} is not an {kind} of rank {r} in the "
                "window's topology")


def _expected_rows(win: _Window) -> int:
    return win.n if win.layout == "rank" else len(win.owned)


def _validate_payload(win: _Window, t: torch.Tensor, op: str) -> None:
    want = _expected_rows(win)
    if t.dim() == 0 or t.shape[0] != want:
        kind = ("rank-major (world size)" if win.layout == "rank"
                else "owned-rows (this process's owned-rank count)")
        raise ValueError(
            f"{op}({win.name!r}): leading dim "
            f"{t.shape[0] if t.dim() else None} != {want} — this window "
            f"uses the {kind} layout")


def _validate_self_weight(win: _Window, self_weight) -> None:
    """At dispatch, before the job: a bad vector fails at the call site."""
    if self_weight is None:
        return
    sw = np.asarray(self_weight, dtype=float)
    if sw.ndim and sw.shape != (win.n,):
        raise ValueError(
            f"self_weight vector must have shape ({win.n},) — one entry "
            f"per global rank — got {sw.shape}")


def _do_put(name: str, tensor: torch.Tensor, edges: Dict[tuple, float],
            require_mutex: bool, accumulate: bool, self_weight=None) -> None:
    try:
        win = _store.get(name)
    except KeyError:
        return  # window freed after dispatch: the put becomes a no-op
    d = _store.distrib
    remote_procs = ({d.rank_owner[dst] for (src, dst) in edges
                     if _owns(src) and not _owns(dst)}
                    if d is not None else set())
    # An error token scoped to the peers this op addresses, taken before
    # any enqueue: failures on other peers never fail this op.
    tok = (d.transport.error_token({d.proc_addr[p] for p in remote_procs})
           if remote_procs else None)
    op = OP_ACCUMULATE if accumulate else OP_PUT
    kind = "win_accumulate" if accumulate else "win_put"
    # The put-plan path (BLUEFOG_TPU_WIN_XLA): every remote edge in one
    # native plan run over one staging copy of the owned rows; the
    # host-staged loop below is its oracle (=0) and takes what a plan
    # cannot serve, with the same frames.
    plan = None
    if remote_procs and xlaffi.keep_device_ok(tensor, win):
        remote_edges = tuple(
            ((src, dst), w) for (src, dst), w in edges.items()
            if _owns(src) and not _owns(dst))
        plan = xlaffi.prepare_put(d, win, name, op, remote_edges,
                                  per_edge=require_mutex,
                                  compact=tensor.device.type == "cuda")
    # Under churn a failed edge (a peer not yet voted out) does not stop
    # the others nor the self-publish: push-sum's mass is split once,
    # whatever reached the dead peer is lost with it, and the first error
    # is raised at the end.
    from bluefog_tpu_torch.ops import membership
    errors = [] if membership.current() is not None else None
    if plan is not None:
        t0 = time.perf_counter()
        with _collect_errors(errors):
            _plan_put(win, name, tensor, edges, plan, accumulate,
                      require_mutex, kind, errors)
            _flush_transport(remote_procs, since=tok)
        stats.add(wire_s=time.perf_counter() - t0)
    else:
        with (win.put_stage_lock if remote_procs
              else contextlib.nullcontext()):
            staged: dict = {}
            wire_s = 0.0
            for (src, dst), w in edges.items():
                if not _owns(src):
                    continue  # src's owner performs this edge
                # A span an edge: the timeline shows each transfer.
                with op_span(f"{kind}.{name}.{src}->{dst}", "COMMUNICATE"):
                    if _owns(dst):
                        _do_put_edge(win, tensor, win.row_of[src], src, dst,
                                     w, accumulate, require_mutex)
                    else:
                        with _collect_errors(errors):
                            wire_s += _send_put_edge(
                                win, name, tensor[win.row_of[src]], src, dst,
                                w, op, require_mutex, staged)
            # Op boundary: every remote edge is handed to TCP (its errors
            # raised on this op's future) before the op completes.
            if remote_procs:
                t0 = time.perf_counter()
                with _collect_errors(errors):
                    _flush_transport(remote_procs, since=tok)
                stats.add(wire_s=wire_s + time.perf_counter() - t0)
    if self_weight is not None:
        _publish_self(win, tensor, self_weight)
    if errors:
        raise errors[0]


@contextlib.contextmanager
def _collect_errors(errors):
    """Raise as usual with ``errors`` None; else keep a ConnectionError in
    the list and go on (the churn path of :func:`_do_put`)."""
    if errors is None:
        yield
        return
    try:
        yield
    except ConnectionError as e:
        errors.append(e)


def _plan_put(win: _Window, name: str, tensor: torch.Tensor,
              edges: Dict[tuple, float], plan, accumulate: bool,
              require_mutex: bool, kind: str, errors=None) -> None:
    """One put through its plan: the local edges keep the store write,
    the remote edges run the plan on one staging copy (``xlaffi.
    stage_rows``), each inside its edge's mutex with ``require_mutex``
    (a plan an edge then).  The sparse residuals the host-staged path left
    move to the native store first."""
    for (src, dst), w in edges.items():
        if _owns(src) and _owns(dst):
            with op_span(f"{kind}.{name}.{src}->{dst}", "COMMUNICATE"):
                _do_put_edge(win, tensor, win.row_of[src], src, dst, w,
                             accumulate, require_mutex)
    d = _store.distrib
    tx = d.transport._tx
    if not tx:
        raise ConnectionError(f"{kind}({name!r}): window transport is "
                              "stopping")
    xlaffi.migrate_residuals(plan, _ef_residuals, _ef_lock)
    xlaffi.sync_trace_period()
    with plan.stage_lock:
        buf = xlaffi.stage_rows(plan, tensor, win)
        ptr, total = buf.data_ptr(), buf.numel()
        with plan.dispatch_lock, \
                op_span(f"{kind}.{name}.plan", "COMMUNICATE"):
            xlaffi.refresh_p(plan, win, _store.associated_p_enabled)
            for pid, grp in plan.groups:
                if require_mutex:
                    (src, dst), _w = grp[0]
                    with _collect_errors(errors), \
                            _remote_mutex(name, dst, src):
                        _run_plan_group(win, name, plan, pid, grp, tx, ptr,
                                        total)
                else:
                    _run_plan_group(win, name, plan, pid, grp, tx, ptr,
                                    total)
    d.transport.count_tx(plan.total_bytes)
    xlaffi.record_dispatch(plan)


def _run_plan_group(win: _Window, name: str, plan, pid: int, grp, tx: int,
                    ptr: int, total: int) -> None:
    """Run one plan group, rebuilding it once if the native plan vanished
    between the cache fetch and the run (nothing was sent then)."""
    try:
        xlaffi.run_group(pid, tx, ptr, total)
    except xlaffi.PlanVanished:
        fresh = xlaffi.prepare_put(_store.distrib, win, name, plan.op,
                                   tuple(grp), per_edge=False,
                                   compact=plan.compact)
        if fresh is None:
            raise
        xlaffi.refresh_p(fresh, win, _store.associated_p_enabled)
        xlaffi.run_group(fresh.groups[0][0], tx, ptr, total)


def _send_put_edge(win: _Window, name: str, row: torch.Tensor, src: int,
                   dst: int, w: float, op: int, require_mutex: bool,
                   staged: dict) -> float:
    """A remote edge: the raw row (in the window's dtype) and its weight go
    to ``dst``'s owner, whose drain scales and applies it;
    ``require_mutex`` takes the distributed mutex around the send.
    Returns the seconds of the send and, with the mutex, of its release's
    flush (the grant's wait left out)."""
    with win.lock:
        p_w = w * float(win.p_main[src]) \
            if _store.associated_p_enabled else 0.0
    wire_op, payload = _encode_row(win, op, src, dst, row.to(win.dtype),
                                   "put", staged)
    t0 = time.perf_counter()
    # With the mutex, the release's flush hands this row to TCP.
    with (_remote_mutex(name, dst, src) if require_mutex
          else contextlib.nullcontext(0.0)) as waited:
        _send_to_rank_owner(dst, wire_op, name, src, dst, w, p_w, payload)
    return time.perf_counter() - t0 - waited


def _do_put_edge(win: _Window, tensor: torch.Tensor, row: int, src: int,
                 dst: int, w: float, accumulate: bool,
                 require_mutex: bool) -> None:
    """One local (src, dst) edge of a put or accumulate: ``w *
    tensor[row]`` in the window's dtype (a float32 multiply by ``w`` for a
    float32 payload, as numpy's)."""
    payload = (tensor[row] * w).to(win.dtype)
    mutex = win.mutexes[dst] if require_mutex else None
    if mutex:
        mutex.acquire()
    try:
        with win.lock:
            if (dst, src) not in win.staging:
                return  # window freed concurrently
            if accumulate:
                win.staging[(dst, src)] += payload
            else:
                win.staging[(dst, src)] = payload
            win.versions[dst, src] += 1
            if _store.associated_p_enabled:
                if accumulate:
                    win.p_staging[(dst, src)] += w * win.p_main[src]
                else:
                    win.p_staging[(dst, src)] = w * win.p_main[src]
    finally:
        if mutex:
            mutex.release()


def _publish_self(win: _Window, tensor: torch.Tensor, self_weight) -> None:
    """Self-scaling after the edge sends, so that the sends carry the
    pre-scaled P mass (column-stochastic conservation: self_weight plus
    the dst weights is 1 on p_old).  Owned rows only.  The JAX package
    multiplies the row by a float64 weight, which numpy does in float64
    before the cast to the window's dtype; so does this, except for a
    weight of 1.0, which is exact either way."""
    sw = np.asarray(self_weight, dtype=float)
    with win.lock:
        sw_vec = sw if sw.ndim else np.full(win.n, float(sw))
        for r in win.owned:
            s = float(sw_vec[r])
            row = tensor[win.row_of[r]]
            if s == 1.0:
                win.main[r] = row.to(win.dtype, copy=True)
            else:
                wide = torch.promote_types(row.dtype, torch.float64)
                win.main[r] = (row.to(wide) * s).to(win.dtype)
            win.main_versions[r] += 1
            if _store.associated_p_enabled:
                win.p_main[r] *= s


def _fused_host_finish(name: str, payload: torch.Tensor,
                       edges: Dict[tuple, float], *, accumulate: bool,
                       self_weight=None, require_mutex: bool = False,
                       remote_procs=None, since=None,
                       flush: bool = True) -> None:
    """The host half of one fused-program put (``ops/fused_step.py``): the
    program ran the remote edges' plan; what :func:`_do_put` does around
    that run stays here, in its order, so the window state a fused step
    leaves is the eager one's: the local edges' staging writes, the scoped
    flush (every remote edge handed to TCP before the put counts as done)
    and the self-publish.  ``flush=False`` leaves the flush to a caller
    that issues one for every bucket (a wire boundary, not a state
    change)."""
    try:
        win = _store.get(name)
    except KeyError:
        return  # window freed after dispatch
    kind = "win_accumulate" if accumulate else "win_put"
    with _stream(win.device):
        for (src, dst), w in edges.items():
            if _owns(src) and _owns(dst):
                with op_span(f"{kind}.{name}.{src}->{dst}", "COMMUNICATE"):
                    _do_put_edge(win, payload, win.row_of[src], src, dst, w,
                                 accumulate, require_mutex)
        if remote_procs and flush:
            _flush_transport(remote_procs, since=since)
        if self_weight is not None:
            _publish_self(win, payload, self_weight)


def _put_nonblocking(tensor, name: str, self_weight, dst_weights,
                     require_mutex: bool, accumulate: bool) -> int:
    op = "win_accumulate" if accumulate else "win_put"
    win = _store.get(name)  # raise early on an unknown window
    t = _device_tensor(tensor, f"{op}({name!r})")
    _validate_payload(win, t, op)
    _validate_self_weight(win, self_weight)
    edges = _resolve_edge_weights(dst_weights, win.out_nbrs, 1.0,
                                  ranks=win.owned)
    _validate_edges(edges, win.out_nbrs, peer_is_src=False, op=op)
    _count_win_op("accumulate" if accumulate else "put",
                  t.numel() * t.element_size(), edges)

    def work():
        with op_span(f"{op}.{name}", "COMMUNICATE"):
            _do_put(name, t, edges, require_mutex, accumulate=accumulate,
                    self_weight=self_weight)
    return _store.submit(work, win.device, payload=t)


def _count_win_op(op: str, nbytes: float, edges) -> None:
    """One one-sided op's counters at dispatch: calls, the topology edges
    it touches, and the bytes it moves (puts and accumulates: the caller's
    payload; gets: a window row a pulled edge; updates: the combined owned
    rows)."""
    if not telemetry.enabled():
        return
    telemetry.inc("bf_win_ops_total", op=op)
    telemetry.inc("bf_win_edges_total", float(len(edges)), op=op)
    telemetry.inc("bf_win_bytes_total", float(nbytes), op=op)


def _row_nbytes(win: _Window) -> int:
    return int(np.prod(win.shape, dtype=np.int64)) * \
        torch.empty((), dtype=win.dtype).element_size()


def win_put_nonblocking(tensor, name: str, *, self_weight=None,
                        dst_weights=None, require_mutex: bool = False) -> int:
    """Scaled overwrite of each destination's buffer-for-me (async).

    ``dst_weights``: None (every out-edge, weight 1), a ``{(src, dst): w}``
    or ``{dst: w}`` dict, or an ``(n, n)`` matrix ``W[src, dst]``.
    ``self_weight`` — a scalar or a per-rank ``(n,)`` vector — rescales
    each owned rank's exposed memory to ``self_weight * tensor`` after the
    sends.  With associated-P on, pass ``dst_weights`` and ``self_weight``
    that sum to 1 per source (push-sum)."""
    return _put_nonblocking(tensor, name, self_weight, dst_weights,
                            require_mutex, accumulate=False)


def win_put(tensor, name: str, *, self_weight=None, dst_weights=None,
            require_mutex: bool = False) -> bool:
    win_wait(win_put_nonblocking(tensor, name, self_weight=self_weight,
                                 dst_weights=dst_weights,
                                 require_mutex=require_mutex))
    return True


def win_accumulate_nonblocking(tensor, name: str, *, self_weight=None,
                               dst_weights=None,
                               require_mutex: bool = False) -> int:
    """Scaled add into each destination's buffer-for-me (async); the
    arguments as in :func:`win_put_nonblocking`."""
    return _put_nonblocking(tensor, name, self_weight, dst_weights,
                            require_mutex, accumulate=True)


def win_accumulate(tensor, name: str, *, self_weight=None,
                   dst_weights=None, require_mutex: bool = False) -> bool:
    win_wait(win_accumulate_nonblocking(
        tensor, name, self_weight=self_weight, dst_weights=dst_weights,
        require_mutex=require_mutex))
    return True


def _do_get(name: str, edges: Dict[tuple, float], require_mutex: bool) -> None:
    try:
        win = _store.get(name)
    except KeyError:
        return  # window freed after dispatch: the get becomes a no-op
    d = _store.distrib
    remote = []
    for (dst, src), w in edges.items():
        if not _owns(dst):
            continue  # dst's owner performs this edge
        if not _owns(src):
            remote.append((dst, src, w))
            continue
        mutex = win.mutexes[src] if require_mutex else None
        with op_span(f"win_get.{name}.{src}->{dst}", "COMMUNICATE"):
            if mutex:
                mutex.acquire()
            try:
                with win.lock:
                    if (dst, src) not in win.staging:
                        continue
                    win.staging[(dst, src)] = win.main[src] * w
                    win.versions[dst, src] += 1
                    if _store.associated_p_enabled:
                        win.p_staging[(dst, src)] = w * win.p_main[src]
            finally:
                if mutex:
                    mutex.release()
    if not remote:
        return
    # One-sided pull: request each remote row, then wait for the replies.
    req_procs = {d.rank_owner[src] for (_, src, _) in remote}
    tok = d.transport.error_token({d.proc_addr[p] for p in req_procs})
    with d.cv:
        for (dst, src, w) in remote:
            key = (name, dst, src)
            d.pending_gets[key] = d.pending_gets.get(key, 0) + 1
    for (dst, src, w) in remote:
        _send_to_rank_owner(src, OP_GET_REQ, name, src, dst, w)
    _flush_transport(req_procs, since=tok)
    keys = [(name, dst, src) for (dst, src, _) in remote]

    def replied(t):
        with d.cv:
            return d.cv.wait_for(
                lambda: all(d.pending_gets.get(k, 0) <= 0 for k in keys),
                timeout=t)
    try:
        ok = _wait_on_peers(replied, req_procs, tok, f"win_get({name!r})")
    finally:
        with d.cv:
            for k in keys:
                d.pending_gets.pop(k, None)
    if not ok:
        raise ConnectionError(
            f"win_get({name!r}): no reply from remote rank(s) "
            f"{sorted({s for (_, s, _) in remote})} within "
            f"{_timeout():.0f}s")


def win_get_nonblocking(name: str, *, src_weights=None,
                        require_mutex: bool = False) -> int:
    """Pull ``w * main[src]`` from each in-neighbor into my staging
    (async); ``src_weights`` in the forms of ``dst_weights``, keyed
    ``(dst, src)`` (a matrix still reads ``W[src, dst]``)."""
    win = _store.get(name)
    edges = _resolve_edge_weights(src_weights, win.in_nbrs, 1.0,
                                  peer_is_src=True, ranks=win.owned)
    _validate_edges(edges, win.in_nbrs, peer_is_src=True, op="win_get")
    _count_win_op("get", len(edges) * _row_nbytes(win), edges)

    def work():
        with op_span(f"win_get.{name}", "COMMUNICATE"):
            _do_get(name, edges, require_mutex)
    return _store.submit(work, win.device)


def win_get(name: str, *, src_weights=None,
            require_mutex: bool = False) -> bool:
    win_wait(win_get_nonblocking(name, src_weights=src_weights,
                                 require_mutex=require_mutex))
    return True


# ---------------------------------------------------------------------------
# Update (sync + weighted combine)
# ---------------------------------------------------------------------------

def _default_update_weights(win: _Window):
    """The topology's combine weights, owned edges only: its edge weights
    when the topology is weighted, else uniform ``1/(indeg+1)``."""
    from bluefog_tpu_torch import basics
    from bluefog_tpu_torch import topology as topology_util
    if basics.is_topo_weighted():
        wmat = topology_util.weight_matrix(basics.load_topology())
        self_w = np.diag(wmat)
        nbr_w = {(dst, src): wmat[src, dst]
                 for dst in win.owned for src in win.in_nbrs[dst]}
    else:
        self_w = np.array([1.0 / (len(win.in_nbrs[r]) + 1)
                           for r in range(win.n)])
        nbr_w = {(dst, src): 1.0 / (len(win.in_nbrs[dst]) + 1)
                 for dst in win.owned for src in win.in_nbrs[dst]}
    return self_w, nbr_w


def _caller_rows(win: _Window, rows: List[torch.Tensor]) -> torch.Tensor:
    """The owned ranks' rows in the window's layout: stacked (owned), or
    rank-major with zeros in the rows of other processes' ranks."""
    if win.layout == "owned" or len(win.owned) == win.n:
        return torch.stack(rows)
    out = torch.zeros((win.n,) + win.shape, dtype=win.dtype,
                      device=win.device)
    for r, row in zip(win.owned, rows):
        out[r] = row
    return out


def win_update(name: str, *, self_weight=None, neighbor_weights=None,
               reset_weights: bool = False,
               require_mutex: bool = False) -> torch.Tensor:
    """Combine self memory with the in-neighbor staging buffers, in place:
    ``out_i = sw_i * main_i + sum_src w[i, src] * staging[i, src]``, in
    ``in_nbrs`` order (``acc = sw * main``, then ``acc += w * staging``
    an edge at a time, as the JAX package's numpy, so float32 results
    agree bit for bit).  Writes the result to self memory and returns it
    in the window's layout (rank-major: zeros in the rows of ranks another
    process owns, which their owners combine).  ``reset_weights`` empties
    the consumed staging buffers.  An edge left out of an explicit partial
    ``neighbor_weights`` is not consumed: its staging, P and version
    counter stay pending.

    Locking: ``win.lock`` is held to snapshot the inputs, to swap the
    results back and, without ``reset_weights``, for one edge's multiply
    at a time (the drain thread is never held behind the whole combine).
    With ``reset_weights`` the staging buffers are moved out at the
    snapshot (fresh zeros swap in): a put landing mid-combine goes into
    the fresh buffer and waits for the next update.  A self-publish
    landing mid-combine (``main_versions`` moved) serializes after the
    update: its main stands, and its P factor applies on top of the
    combined P."""
    win = _store.get(name)
    return _caller_rows(win, _update_rows(
        name, self_weight=self_weight, neighbor_weights=neighbor_weights,
        reset_weights=reset_weights, require_mutex=require_mutex))


def _update_rows(name: str, *, self_weight=None, neighbor_weights=None,
                 reset_weights: bool = False,
                 require_mutex: bool = False) -> List[torch.Tensor]:
    """:func:`win_update`'s rows, one an owned rank in ``win.owned``
    order: the window's new memory itself, not copies, so that a caller
    that copies them out (the window optimizers) allocates no rank-major
    tensor.  Read them, never write them."""
    win = _store.get(name)
    _count_win_op("update", len(win.owned) * _row_nbytes(win), {})
    owned = win.owned
    if (self_weight is None) != (neighbor_weights is None):
        raise ValueError(
            "self_weight and neighbor_weights have to be presented at "
            "the same time (matches reference torch/mpi_ops.py:1050)")
    if self_weight is None:
        self_w, nbr_w = _default_update_weights(win)
    else:
        self_w = np.full(win.n, float(self_weight)) \
            if np.ndim(self_weight) == 0 else np.asarray(self_weight, float)
        nbr_w = _resolve_edge_weights(neighbor_weights, win.in_nbrs, 1.0,
                                      peer_is_src=True, ranks=owned)
    acquired = []
    if require_mutex:
        for r in owned:
            win.mutexes[r].acquire()
            acquired.append(win.mutexes[r])
    win.update_lock.acquire()
    acquired.append(win.update_lock)
    try:
        with _stream(win.device), op_span(f"win_update.{name}", "UPDATE"):
            return _combine(win, self_w, nbr_w, reset_weights)
    finally:
        for m in acquired:
            m.release()


def _combine(win: _Window, self_w: np.ndarray, nbr_w: Dict[tuple, float],
             reset_weights: bool) -> List[torch.Tensor]:
    """win_update's snapshot, combine and swap (under its locks)."""
    owned = win.owned
    stag: Dict[tuple, torch.Tensor] = {}
    p_stag: Dict[tuple, float] = {}
    # -- snapshot (under lock; moves for reset, nothing to copy otherwise)
    with win.lock:
        p_out = {r: win.p_main[r] for r in owned}
        p_snap = dict(p_out)
        # acc = sw * main (a float32 multiply by the rounded weight, as
        # numpy's): the scaled copy is the snapshot of main.
        out = {r: win.main[r] * float(self_w[r]) for r in owned}
        for dst in owned:
            for src in win.in_nbrs[dst]:
                k = (dst, src)
                if k not in win.staging or nbr_w.get(k) is None:
                    continue
                if reset_weights:
                    stag[k] = win.staging[k]
                    win.staging[k] = torch.zeros_like(stag[k])
                    p_stag[k] = win.p_staging[k]
                    win.p_staging[k] = 0.0
                    win.versions[dst, src] = 0
        ver = dict(win.versions)
        mver = dict(win.main_versions)
    # -- combine (a lock held for one edge at most; one scratch buffer)
    tmp = None
    for dst in owned:
        acc = out[dst]
        p_acc = p_out[dst] * self_w[dst]
        for src in win.in_nbrs[dst]:
            k = (dst, src)
            w = nbr_w.get(k)
            if w is None:
                continue
            w = float(w)
            if reset_weights:
                if k not in stag:
                    continue
                tmp = torch.mul(stag[k], w, out=tmp)
            else:
                with win.lock:
                    if k not in win.staging:
                        continue
                    tmp = torch.mul(win.staging[k], w, out=tmp)
                    p_stag[k] = win.p_staging[k]
                    # This update consumed everything in the slot as of
                    # now: puts that landed since the snapshot count too.
                    ver[dst, src] = win.versions[dst, src]
            acc.add_(tmp)
            p_acc += w * p_stag.get(k, 0.0)
        p_out[dst] = p_acc
    # -- swap (under lock; owned ranks only: their owners run the rest)
    with win.lock:
        for dst in owned:
            if win.main_versions[dst] == mver[dst]:
                win.main[dst] = out[dst]
                if _store.associated_p_enabled:
                    win.p_main[dst] = p_out[dst]
            elif _store.associated_p_enabled:
                # A publish (main *= sw, p_main *= sw) landed mid-combine
                # and serializes after: its main stands, and P is the
                # combined mass times the publishes' factor.
                factor = (win.p_main[dst] / p_snap[dst]
                          if p_snap[dst] != 0.0 else 1.0)
                win.p_main[dst] = p_out[dst] * factor
            if not reset_weights:
                # Consumed in place: the counters drop to the puts that
                # landed mid-combine (they serialize after this update).
                for src in win.in_nbrs[dst]:
                    k = (dst, src)
                    if k not in win.staging or nbr_w.get(k) is None:
                        continue
                    win.versions[dst, src] = max(0, win.versions[dst, src]
                                                 - ver[dst, src])
    return [out[r] for r in owned]


def win_update_then_collect(name: str, *,
                            require_mutex: bool = True) -> torch.Tensor:
    """Sum self memory with every received contribution and empty the
    staging buffers: push-sum's collect (``torch/mpi_ops.py:1206-1260``)."""
    win = _store.get(name)
    return _caller_rows(win, _collect_rows(name, require_mutex=require_mutex))


def _collect_rows(name: str, *,
                  require_mutex: bool = True) -> List[torch.Tensor]:
    """:func:`win_update_then_collect`'s rows (see :func:`_update_rows`)."""
    win = _store.get(name)
    # Counted with the inner update, as in the JAX package.
    _count_win_op("update_then_collect", len(win.owned) * _row_nbytes(win),
                  {})
    all_edges = {(dst, src): 1.0
                 for dst in win.owned for src in win.in_nbrs[dst]}
    return _update_rows(name, self_weight=1.0, neighbor_weights=all_edges,
                        reset_weights=True, require_mutex=require_mutex)


# ---------------------------------------------------------------------------
# Handles, mutex, fence, versions, associated-P, state
# ---------------------------------------------------------------------------

def win_wait(handle: int) -> bool:
    """Wait for a nonblocking op; False if its window was freed while it
    ran.  Its error, if any, is raised here."""
    with _store.lock:
        fut = _store.handles.pop(handle, None)
        telemetry.set_gauge("bf_win_inflight_handles", len(_store.handles))
    if fut is None:
        return True
    t0 = telemetry.start_timer()
    try:
        with stall.watch(f"win_wait(handle={handle})"):
            device = fut.result()
        _caller_waits(device)
    except KeyError:
        return False
    finally:
        # The host-side latency of one nonblocking op: its wait on the
        # pool and its own sends and replies.
        telemetry.observe_since(t0, "bf_win_wait_seconds")
    return True


def win_poll(handle: int) -> bool:
    with _store.lock:
        fut = _store.handles.get(handle)
    return fut is None or fut.done()


@contextlib.contextmanager
def win_mutex(name: str, *, for_self: bool = False,
              ranks: Optional[List[int]] = None):
    """Hold the mutexes of ``ranks`` (default: ``rank()``'s out-neighbors,
    and with ``for_self`` itself), in ascending rank order everywhere so
    that no lock cycle forms; ``require_mutex`` writers to them wait.  A
    rank another process owns is locked through the transport (ACQ,
    GRANT, REL): its owner holds the rank's lock until our release
    lands."""
    from bluefog_tpu_torch import basics
    from bluefog_tpu_torch import topology as topology_util
    basics._require_active()
    win = _store.get(name)
    me = basics.rank()
    if ranks is None:
        ranks = topology_util.out_neighbor_ranks(basics.load_topology(), me)
        if for_self:
            ranks = list(ranks) + [me]
    with contextlib.ExitStack() as stack:
        for r in sorted(set(ranks)):
            if _owns(r):
                t0 = time.perf_counter()
                win.mutexes[r].acquire()
                telemetry.inc("bf_win_mutex_acquisitions_total", kind="local")
                telemetry.inc("bf_win_mutex_wait_seconds_total",
                              time.perf_counter() - t0, kind="local")
                stack.callback(win.mutexes[r].release)
            else:
                stack.enter_context(_remote_mutex(name, r, me))
        yield


def win_fence(name: Optional[str] = None) -> None:
    """Epoch fence over the one-sided family: on return every window op
    this process dispatched has run (the first error among them is
    raised), every message any process sent before its fence has been
    applied at its target, and every process has reached the fence.  Our
    FENCE_REQ trails our puts on each peer's FIFO (every stripe's), so the
    peer's ack certifies them; the fence ends in ``basics.barrier()``.
    Under churn (a membership controller installed) the fence addresses
    the processes of the committed view only, and its barrier is their
    FENCE_REQs of this fence (each trails that peer's puts to us): no
    collective over a process group that may hold a dead member."""
    from bluefog_tpu_torch import basics
    basics._require_active()
    with _store.lock:
        outstanding = list(_store.handles.items())
    errors = []
    for _, fut in outstanding:
        try:
            _caller_waits(fut.result(timeout=_timeout()))
        except KeyError:
            pass  # window freed while the op ran (win_wait's reading)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)
    with _store.lock:
        for h, _ in outstanding:
            _store.handles.pop(h, None)
    if errors:
        raise errors[0]
    d = _store.distrib
    from bluefog_tpu_torch.ops import membership
    ctrl = membership.current() if d is not None else None
    if d is not None:
        members = None if ctrl is None else set(ctrl.active)
        peers = [p for p in d.proc_addr if p != d.my_proc
                 and (members is None or p in members)]
        with d.cv:
            d.fence_acks = 0
            d.fences_out += 1
            generation = d.fences_out
        # Under churn the error token and the flush cover the members
        # only (a dead peer's retired senders are no part of the fence).
        scope = None if ctrl is None else set(peers)
        tok = d.transport.error_token(
            None if scope is None else {d.proc_addr[p] for p in scope})
        n_str = d.transport.n_stripes
        w = _fanout_weight(n_str)
        serial = _fanout_serial(d, n_str)
        for p in peers:
            for k in range(n_str):
                _send_to_proc(p, OP_FENCE_REQ, name or "", d.my_rank, -1,
                              w, p_weight=serial, stripe=k)
        _flush_transport(scope, since=tok)

        def acked(t):
            with d.cv:
                return d.cv.wait_for(lambda: d.fence_acks >= len(peers),
                                     timeout=t)
        ok = _wait_on_peers(acked, peers, tok, "win_fence")
        if not ok:
            raise ConnectionError(
                f"win_fence: missing acks ({d.fence_acks}/{len(peers)}) "
                f"after {_timeout():.0f}s")
        if ctrl is not None:
            def reached(t):
                with d.cv:
                    return d.cv.wait_for(
                        lambda: all(d.fence_reqs_in.get(p, 0) >= generation
                                    for p in peers), timeout=t)
            ok = _wait_on_peers(reached, peers, tok, "win_fence")
            if not ok:
                raise ConnectionError(
                    f"win_fence: peers {peers} did not reach fence "
                    f"{generation} within {_timeout():.0f}s")
            dev = basics.device()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return
    basics.barrier()


def win_flush(wait: bool = True, timeout: Optional[float] = None) -> None:
    """Push queued window work out now.  With ``wait``, the outstanding
    ops are drained (their errors stay for ``win_wait``) and, across
    processes, every per-peer send queue is handed to TCP (its errors
    raised here); without it, the senders are only woken (pacing, not a
    barrier).  ``timeout`` defaults to ``BLUEFOG_TPU_WIN_TIMEOUT``."""
    d = _store.distrib
    if not wait:
        if d is not None:
            d.transport.kick()
        return
    _drain_handles(_timeout() if timeout is None else timeout)
    _flush_transport(timeout=timeout)


def win_state_dict(name: str) -> Dict[str, object]:
    """A window's whole state on the CPU, for checkpointing: the owned
    ranks' main, the staging buffers (keys ``"dst:src"``), the version
    counters, the associated-P scalars and the async mode's stale-residual
    store (empty outside it).  Serialized against a running
    ``win_update``.  The copy to the host is made here, only when
    called."""
    win = _store.get(name)
    with win.update_lock, win.lock, _stream(win.device):
        return {
            "main": {str(r): win.main[r].cpu().clone() for r in win.owned},
            "staging": {f"{d}:{s}": a.cpu().clone()
                        for (d, s), a in win.staging.items()},
            "versions": {f"{d}:{s}": int(v)
                         for (d, s), v in win.versions.items()},
            "main_versions": {str(r): int(win.main_versions[r])
                              for r in win.owned},
            "p_main": {str(r): float(win.p_main[r]) for r in win.owned},
            "p_staging": {f"{d}:{s}": float(v)
                          for (d, s), v in win.p_staging.items()},
            "stale_residual": {f"{d}:{s}": a.cpu().clone()
                               for (d, s), a in win.stale_residual.items()},
            "p_stale_residual": {
                f"{d}:{s}": float(v)
                for (d, s), v in win.p_stale_residual.items()},
        }


def _edge(key: str) -> tuple:
    return tuple(int(x) for x in key.split(":"))


def win_load_state_dict(name: str, state: Dict[str, object]) -> None:
    """Restore a window from :func:`win_state_dict`.  The window must
    exist under the topology it was saved with; rows and staging edges
    must match it in shape and dtype."""
    win = _store.get(name)
    if not isinstance(state.get("main"), dict):
        raise ValueError(f"win_load_state_dict({name!r}): 'main' must map "
                         "each rank to its row (a win_state_dict snapshot)")
    main = {int(r): torch.as_tensor(v) for r, v in state["main"].items()}
    if set(main) != set(win.owned):
        raise ValueError(
            f"win_load_state_dict({name!r}): snapshot rows {sorted(main)} do "
            f"not match the window's ranks {win.owned}")
    staging = {_edge(k): torch.as_tensor(v)
               for k, v in dict(state["staging"]).items()}
    for what, rows in (("row", main), ("staging edge", staging)):
        for k, v in rows.items():
            if tuple(v.shape) != win.shape or v.dtype != win.dtype:
                raise ValueError(
                    f"win_load_state_dict({name!r}): snapshot {what} {k} "
                    f"{tuple(v.shape)}/{v.dtype} does not match the window "
                    f"{win.shape}/{win.dtype}")
    if set(staging) != set(win.staging):
        raise ValueError(
            f"win_load_state_dict({name!r}): snapshot edges do not match "
            "the window's topology (recreate the window under the topology "
            "it was saved with)")
    with win.update_lock, win.lock, _stream(win.device):
        for r, v in main.items():
            win.main[r] = v.to(win.device, copy=True)
        for k, v in staging.items():
            win.staging[k] = v.to(win.device, copy=True)
        for k, v in dict(state["versions"]).items():
            win.versions[_edge(k)] = int(v)
        for r, v in dict(state["main_versions"]).items():
            win.main_versions[int(r)] = int(v)
        for r, v in dict(state["p_main"]).items():
            win.p_main[int(r)] = float(v)
        for k, v in dict(state["p_staging"]).items():
            win.p_staging[_edge(k)] = float(v)
        # Optional (snapshots from before the async mode lack it): the
        # stale-residual store, for the edges the window still has.
        win.stale_residual.clear()
        win.p_stale_residual.clear()
        for k, v in dict(state.get("stale_residual", {})).items():
            if _edge(k) in win.staging:
                win.stale_residual[_edge(k)] = torch.as_tensor(v).to(
                    win.device, copy=True)
        for k, v in dict(state.get("p_stale_residual", {})).items():
            if _edge(k) in win.staging:
                win.p_stale_residual[_edge(k)] = float(v)


def get_win_version(name: str, rank: Optional[int] = None) -> Dict[int, int]:
    """Per-in-neighbor put counts since the last ``win_update`` of
    ``rank`` (default ``rank()``); only owned ranks carry them."""
    from bluefog_tpu_torch import basics
    win = _store.get(name)
    r = basics.rank() if rank is None else rank
    if r not in win.main_versions:
        raise ValueError(
            f"get_win_version({name!r}): rank {r} is owned by another "
            "process — query its owner")
    with win.lock:
        return {src: int(win.versions[r, src]) for src in win.in_nbrs[r]}


def win_associated_p(name: str, rank: Optional[int] = None):
    """The push-sum de-bias scalar of ``rank``, or with ``rank=None`` the
    ``(n,)`` float64 vector of every rank's (1.0, the initial value, for
    ranks another process owns; asking for one of them alone raises)."""
    win = _store.get(name)
    with win.lock:
        if rank is None:
            p = np.ones(win.n)
            for r in win.owned:
                p[r] = win.p_main[r]
            return p
        if rank not in win.p_main:
            raise ValueError(
                f"win_associated_p({name!r}): rank {rank} is owned by "
                "another process — query its owner")
        return float(win.p_main[rank])


def turn_on_win_ops_with_associated_p() -> None:
    _store.associated_p_enabled = True


def turn_off_win_ops_with_associated_p() -> None:
    _store.associated_p_enabled = False
