"""Put plans: a window put's remote edges encoded in C from one staging
copy (``BLUEFOG_TPU_WIN_XLA``).

The port of ``bluefog_tpu/ops/xlaffi.py``; the name is kept so that a
reader finds its counterpart.  On CUDA this is the card's put-plan path.
A put or accumulate whose remote edges all ride the native transport is
compiled once into a PUT PLAN (``native/src/xlacall.cc``: per edge the
peer endpoint, wire op, weight, row and stripe, and the codec), and each
dispatch hands one buffer pointer to ``bf_xla_plan_run``, which encodes
every edge's row into the ``bf_wintx_*`` per-peer arenas: no per-edge
staging, no per-edge Python loop.

* **On the CPU** the plan reads the tensor's own memory (the JAX
  package's CPU backend does the same with the XLA buffer).
* **On a card** the owned rows the put sends are copied ONCE a put into
  one pinned buffer of the plan (a window's plan, a bucket's window), on a
  side stream; one event orders the copy after the producer, and the plan
  runs on the pinned pointer once it has fired (:func:`stage_rows`).  The
  fused step (``ops/fused_step.py``) captures the same copy and a stream
  host function that runs the plan (``csrc/hostfn.cu``) into its program.

The frames are byte for byte those of the host-staged path
(``window._stage`` and ``_send_put_edge``), which stays as the
``BLUEFOG_TPU_WIN_XLA=0`` oracle, for every codec: raw rows, bf16 rounded
to nearest even, and ``sparse:<frac>`` with the sender residuals handed
between the two paths' stores (:func:`take_native_residual`,
:func:`push_native_residual`), so a stream that switches path strands no
mass.  The top-k ties break by index here and arbitrarily in
``torch.topk``: the bits agree for distinct magnitudes.

This module also keeps ``bf_win_host_copy_bytes_total{path}``: every
host-side staging copy on the put path counts its bytes here
(``plan_stage`` for this path's one copy, ``stage`` for the host-staged
path's per-row copies on a card, ``enqueue`` for the Python sender's own
copy), which is how the two paths' copies compare.

Left out, as they have no counterpart: ``host_view``, ``commit_to_jax``,
``_jax_aliases`` and ``drain_to_device`` (the port's windows live on the
card already), and the XLA FFI lowering (``xla_put_program``, its
passthrough and probe variants), whose role the CUDA graph's host nodes
take.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import native
from bluefog_tpu_torch.utils import config

__all__ = ["armed", "disarm_reason", "keep_device_ok", "PutPlan",
           "prepare_put", "stage_rows", "run_group", "invalidate",
           "PlanVanished", "set_group_p", "take_native_residual",
           "push_native_residual", "record_dispatch", "count_host_copy",
           "info"]

# Wire op mirror (ops/transport.py is the source).
_OP_ACCUMULATE = 2

_lib_cache = [None]


def _lib():
    lib = _lib_cache[0]
    if lib is None:
        lib = _lib_cache[0] = native.lib()
    return lib


def count_host_copy(nbytes, path: str) -> None:
    """One host-side staging copy of ``nbytes`` on the put path."""
    from bluefog_tpu_torch.utils import telemetry
    if nbytes and telemetry.enabled():
        telemetry.inc("bf_win_host_copy_bytes_total", float(nbytes),
                      path=path)


# ---------------------------------------------------------------------------
# Arming
# ---------------------------------------------------------------------------

_lock = threading.RLock()
# (config instance, armed, reason): re-evaluated when the config reloads.
_armed_cache: Tuple[object, bool, Optional[str]] = (None, False, None)


def armed() -> bool:
    """Whether the put-plan path is armed: ``BLUEFOG_TPU_WIN_XLA`` (default
    on).  The plans live in the service's library, which is built from the
    sources and never missing (a failed build raises), so the knob is the
    only reason to disarm."""
    global _armed_cache
    cfg = config.get()
    with _lock:
        if _armed_cache[0] is not cfg:
            ok = bool(cfg.win_xla)
            _armed_cache = (cfg, ok, None if ok else "BLUEFOG_TPU_WIN_XLA=0")
        return _armed_cache[1]


def disarm_reason() -> Optional[str]:
    armed()
    return _armed_cache[2]


def info() -> dict:
    """Diagnostic summary (``bf.win_xla_info``)."""
    return {"armed": armed(), "reason": disarm_reason(),
            "plans": len(_plan_cache)}


def keep_device_ok(tensor: torch.Tensor, win) -> bool:
    """Can the plan path serve a put of ``tensor`` into ``win``?  A float32
    tensor on a float32 window, the path armed, and a live native sender
    across processes."""
    if tensor.dtype != torch.float32 or win.dtype != torch.float32:
        return False
    from bluefog_tpu_torch.ops import window as W
    d = W._store.distrib
    if d is None or not armed():
        return False
    t = d.transport
    return bool(getattr(t, "native_path", False) and getattr(t, "_tx", None))


# ---------------------------------------------------------------------------
# Put plans
# ---------------------------------------------------------------------------

class PutPlan:
    """One compiled put dispatch: one native plan over every remote edge
    (``groups == [(plan_id, edges)]``), or one a edge (the
    ``require_mutex`` form, each run inside its edge's mutex hold).

    ``srcs`` are the owned source ranks the plan reads, in the order of
    the rows of its buffer: on a card the pinned buffer ``pinned`` holds
    exactly those rows (``compact``); on the CPU the plan's rows are the
    tensor's own (``win.row_of``)."""

    __slots__ = ("name", "op", "comp", "codec", "elems", "groups",
                 "proc_bytes", "total_bytes", "n_edges", "dispatch_lock",
                 "p_set", "srcs", "compact", "pinned", "stage_lock")

    def __init__(self, name, op, comp, elems, groups, edge_bytes,
                 edge_procs, srcs, compact):
        # Serializes the P refresh and the run of a plan: two puts sharing
        # it must each ship their own push-sum mass.
        self.dispatch_lock = threading.Lock()
        # The pinned buffer is reused by every put of the plan.
        self.stage_lock = threading.Lock()
        self.name = name
        self.op = op
        self.comp = comp
        self.codec = _codec_id(comp, op)
        # Whether the native edges carry nonzero P: after
        # turn_off_win_ops_with_associated_p() a cached plan re-zeros them
        # (the host-staged oracle ships 0.0).
        self.p_set = False
        self.elems = elems
        self.groups = groups          # [(plan_id, [((src, dst), w), ...])]
        self.n_edges = len(edge_bytes)
        self.srcs = list(srcs)
        self.compact = compact
        self.pinned: Optional[torch.Tensor] = None
        # Wire bytes a peer process, summed at build time: one counter
        # bump a process a dispatch.
        self.proc_bytes: Dict[int, float] = {}
        for proc, nbytes in zip(edge_procs, edge_bytes):
            self.proc_bytes[proc] = self.proc_bytes.get(proc, 0.0) + nbytes
        self.total_bytes = float(sum(edge_bytes))


# (id(distrib), name, op, comp, per_edge, compact, edges) -> PutPlan
_plan_cache: Dict[tuple, PutPlan] = {}
_PLAN_CACHE_MAX = 256


def _wire_bytes(comp: str, op: int, elems: int) -> int:
    """Wire payload bytes of one encoded row (sparse rides accumulates
    only, as in ``window._encode_row``)."""
    if comp.startswith("sparse") and (op & 0x8F) == _OP_ACCUMULATE:
        k = max(1, int(np.ceil(config.parse_sparse_frac(comp) * elems)))
        return 4 + 8 * min(k, elems)
    if comp == "bf16":
        return elems * 2
    return elems * 4


def _codec_id(comp: str, op: int) -> int:
    if comp.startswith("sparse") and (op & 0x8F) == _OP_ACCUMULATE:
        return 2
    if comp == "bf16":
        return 1
    return 0


def prepare_put(d, win, name: str, op: int,
                remote_edges: Sequence[Tuple[Tuple[int, int], float]],
                per_edge: bool, compact: bool) -> Optional[PutPlan]:
    """The (cached) put plan of one dispatch, or None when the path
    cannot serve it (the caller then takes the host-staged path).
    ``compact``: the plan's rows are its pinned buffer's (a card), not the
    tensor's (the CPU)."""
    if not remote_edges:
        return None
    comp = config.get().win_compression
    key = (id(d), name, op, comp, bool(per_edge), bool(compact),
           tuple(remote_edges))
    with _lock:
        plan = _plan_cache.get(key)
        if plan is not None:
            return plan
    lib = _lib()
    elems = int(np.prod(win.shape, dtype=np.int64))
    if elems <= 0 or len(name.encode()) >= 128:
        return None
    codec = _codec_id(comp, op)
    if codec == 2:
        # The tuner's override, as the host-staged encoder reads it.
        from bluefog_tpu_torch.utils import tuner
        frac = tuner.override_float("sparse_frac",
                                    config.parse_sparse_frac(comp))
    else:
        frac = 1.0
    edge_list = list(remote_edges)
    srcs = sorted({src for (src, _dst), _w in edge_list})
    row_of = ({s: i for i, s in enumerate(srcs)} if compact
              else win.row_of)
    from bluefog_tpu_torch.ops.transport import stripe_for
    n_stripes = int(getattr(d.transport, "n_stripes", 1) or 1)
    groups: List[tuple] = []
    for grp in ([[e] for e in edge_list] if per_edge else [edge_list]):
        pid = lib.bf_xla_plan_new(name.encode(), elems, len(grp), codec,
                                  frac)
        ok = pid > 0
        # Each edge's stripe is pinned at build time to the (window, row)
        # shard the host-staged sender computes, so both paths ride one
        # FIFO an edge and mixing them never reorders its stream.
        for i, ((src, dst), w) in enumerate(grp if ok else ()):
            host, port = d.proc_addr[d.rank_owner[dst]]
            if lib.bf_xla_plan_edge(pid, i, host.encode(), port, op, src,
                                    dst, float(w), row_of[src],
                                    stripe_for(name, src, op,
                                               n_stripes)) != 0:
                ok = False
                break
        if not ok:
            if pid > 0:
                lib.bf_xla_plan_free(pid)
            for gpid, _ in groups:
                lib.bf_xla_plan_free(gpid)
            return None
        groups.append((pid, grp))
    wb = _wire_bytes(comp, op, elems)
    plan = PutPlan(name, op, comp, elems, groups, [wb] * len(edge_list),
                   [d.rank_owner[dst] for (_, dst), _ in edge_list], srcs,
                   compact)
    with _lock:
        existing = _plan_cache.get(key)
        if existing is not None:
            # A concurrent build won: keep its plan, free ours.
            _free_plan(plan)
            return existing
        if len(_plan_cache) >= _PLAN_CACHE_MAX:
            _free_plan(_plan_cache.pop(next(iter(_plan_cache))))
        _plan_cache[key] = plan
    return plan


def _free_plan(plan: PutPlan) -> None:
    lib = native.loaded()
    if lib is None:
        return
    for pid, _ in plan.groups:
        try:
            lib.bf_xla_plan_free(pid)
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass


def invalidate(name: Optional[str] = None) -> None:
    """Drop cached plans (one window's, or all) and the native sparse
    residuals: at ``win_free`` and transport shutdown, as
    ``window._drop_ef_residuals``."""
    with _lock:
        keys = [k for k in _plan_cache if name is None or k[1] == name]
        plans = [_plan_cache.pop(k) for k in keys]
    for p in plans:
        _free_plan(p)
    lib = native.loaded()
    if lib is not None:
        try:
            lib.bf_xla_drop_residuals(None if name is None
                                      else name.encode())
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass


class PlanVanished(ValueError):
    """The native plan was freed between the cache fetch and the dispatch
    (eviction or a concurrent invalidate).  Nothing was sent: the executor
    checks the plan before any edge, so the caller may rebuild and run."""


def set_group_p(plan_id: int, p_vals: Sequence[float]) -> None:
    """Refresh a native plan's per-edge associated-P masses (push-sum)."""
    arr = (ctypes.c_double * len(p_vals))(*p_vals)
    _lib().bf_xla_plan_set_p(plan_id, arr, len(p_vals))


def refresh_p(plan: PutPlan, win, enabled: bool) -> None:
    """Every group's P masses before a dispatch: ``w * p_main[src]`` from
    one snapshot under ``win.lock`` with associated-P on, else zeros once
    after it was turned off."""
    if enabled:
        with win.lock:
            for pid, grp in plan.groups:
                set_group_p(pid, [w * float(win.p_main[src])
                                  for (src, _dst), w in grp])
        plan.p_set = True
    elif plan.p_set:
        for pid, grp in plan.groups:
            set_group_p(pid, [0.0] * len(grp))
        plan.p_set = False


def take_native_residual(name: str, src: int, dst: int,
                         n: int) -> Optional[np.ndarray]:
    """Copy and erase the native sparse residual of one edge (None when
    absent): the host-staged encoder folds it in when a stream switches
    from the plan path."""
    lib = native.loaded()
    if lib is None:
        return None
    buf = np.empty(n, np.float32)
    got = int(lib.bf_xla_take_residual(
        name.encode(), src, dst,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n))
    return buf if got == n else None


def push_native_residual(name: str, src: int, dst: int,
                         arr: torch.Tensor) -> None:
    """Fold a host-staged residual into the native store (a switch to the
    plan path: its next sparse send carries it)."""
    a = np.ascontiguousarray(arr.detach().float().cpu().numpy())
    _lib().bf_xla_add_residual(
        name.encode(), src, dst,
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a.size)


def migrate_residuals(plan: PutPlan, ef_residuals: dict, ef_lock) -> None:
    """Move the host-staged residuals of a sparse plan's edges into the
    native store before the plan runs."""
    if plan.codec != 2:
        return
    with ef_lock:
        taken = []
        for _pid, grp in plan.groups:
            for (src, dst), _w in grp:
                r = ef_residuals.pop((plan.name, src, dst), None)
                if r is not None:
                    taken.append((src, dst, r))
    for src, dst, r in taken:
        push_native_residual(plan.name, src, dst, r)


def pinned_rows(plan: PutPlan) -> torch.Tensor:
    """The plan's pinned buffer: one row a source in ``plan.srcs``."""
    shape = (len(plan.srcs), plan.elems)
    if plan.pinned is None or tuple(plan.pinned.shape) != shape:
        plan.pinned = torch.empty(shape, dtype=torch.float32,
                                  pin_memory=True)
    return plan.pinned


def copy_rows_async(plan: PutPlan, tensor: torch.Tensor, win) -> None:
    """Enqueue, on the current stream, the card-to-pinned copy of the
    plan's source rows of ``tensor`` (one copy a contiguous run of rows)."""
    buf = pinned_rows(plan)
    flat = tensor.reshape(tensor.shape[0], -1)
    rows = [win.row_of[s] for s in plan.srcs]
    i = 0
    while i < len(rows):
        j = i + 1
        while j < len(rows) and rows[j] == rows[j - 1] + 1:
            j += 1
        buf[i:j].copy_(flat[rows[i]:rows[j - 1] + 1], non_blocking=True)
        i = j


def stage_rows(plan: PutPlan, tensor: torch.Tensor, win) -> torch.Tensor:
    """The buffer the plan reads (float32, contiguous; the caller keeps it
    while the plan runs).  On the CPU the tensor's own memory (a strided
    view is made contiguous); on a card the pinned copy of the plan's
    source rows, made on a side stream ordered after the current stream by
    one event, and waited for (the caller holds ``plan.stage_lock``)."""
    if tensor.device.type != "cuda":
        return tensor.contiguous()
    from bluefog_tpu_torch.ops import window as W
    t0 = time.perf_counter()
    dev = tensor.device
    producer = torch.cuda.current_stream(dev)
    side = _copy_stream(dev)
    side.wait_stream(producer)
    with torch.cuda.stream(side):
        copy_rows_async(plan, tensor, win)
        done = torch.cuda.Event()
        done.record(side)
    tensor.record_stream(side)
    done.synchronize()
    buf = plan.pinned
    nbytes = buf.numel() * 4
    W.stats.add(plan_stage_s=time.perf_counter() - t0,
                plan_stage_bytes=nbytes)
    count_host_copy(nbytes, "plan_stage")
    return buf


_copy_streams: Dict[int, torch.cuda.Stream] = {}


def _copy_stream(dev: torch.device) -> "torch.cuda.Stream":
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with _lock:
        s = _copy_streams.get(idx)
        if s is None:
            s = _copy_streams[idx] = torch.cuda.Stream(device=idx)
        return s


def check_rc(rc: int) -> None:
    """Raise on a nonzero ``bf_xla_plan_run`` status, with the host-staged
    path's error classes."""
    if rc == 0:
        return
    if rc == -4:
        raise ValueError(
            "window transport: window name exceeds the receiver's "
            "128-byte name field (127 usable bytes)")
    if rc == -9:
        raise PlanVanished(
            "window put plan: the native plan vanished before dispatch "
            "(cache eviction or invalidate race); nothing was sent")
    if rc == -10:
        raise ValueError(
            "window put plan: a plan row falls outside the payload buffer "
            "(was the window recreated with a different shape mid-put?)")
    raise ConnectionError(
        f"window put plan: native enqueue failed (code {rc})")


_trace_cfg = [None]


def sync_trace_period() -> None:
    """The native encoder's trace-tag period set to the live config's
    ``BLUEFOG_TPU_TRACE_SAMPLE`` (the transport set it at its start; a
    scoped ``config.override`` may have changed it since), so a plan
    tags as the host-staged path's ``make_trace_tag`` does.  One ctypes
    call a config load."""
    cfg = config.get()
    if _trace_cfg[0] is not cfg:
        _lib().bf_trace_configure(int(cfg.trace_sample))
        _trace_cfg[0] = cfg


def run_group(plan_id: int, tx: int, ptr: int, total: int) -> None:
    """Run one native plan on the f32 buffer at ``ptr`` (``total``
    elements).  Raises on a transport failure as the host-staged path
    does."""
    check_rc(int(_lib().bf_xla_plan_run(plan_id, tx, ptr, total)))


def record_dispatch(plan: PutPlan) -> None:
    """The telemetry of ``window._send_to_proc`` from the plan's build-time
    sums: bytes a peer process, the dcn level, and the puts served."""
    from bluefog_tpu_torch.utils import telemetry
    if not telemetry.enabled():
        return
    for proc, nbytes in plan.proc_bytes.items():
        telemetry.inc("bf_win_proc_tx_bytes_total", nbytes, proc=proc)
    telemetry.inc("bf_comm_level_bytes_total", plan.total_bytes,
                  level="dcn")
    telemetry.inc("bf_win_xla_puts_total", float(plan.n_edges))


def _reset_for_tests() -> None:
    """Drop every cache (plans, arming)."""
    global _armed_cache
    with _lock:
        plans = list(_plan_cache.values())
        _plan_cache.clear()
        _armed_cache = (None, False, None)
    for p in plans:
        _free_plan(p)
