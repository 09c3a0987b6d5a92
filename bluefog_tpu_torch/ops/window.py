"""One-sided window ops: the async gossip family, in one process.

The port of ``bluefog_tpu/ops/window.py``'s single-process store.  A window
holds, for every rank, its exposed memory (``main``) and one staging buffer
per in-neighbor edge, with per-rank mutexes, per-edge version counters and
the associated-P scalars of push-sum.  ``win_put`` overwrites each
destination's buffer-for-me with ``w * t``, ``win_accumulate`` adds into
it, ``win_get`` pulls ``w * main[src]``; ``win_update`` combines self
memory with the staging buffers, and ``win_update_then_collect`` sums them
with weight 1 and empties them (push-sum's collect).  The nonblocking ops
run on a worker pool and return an integer handle for :func:`win_wait`.

The JAX package keeps this store in host numpy because a TPU has no RMA.
Here every rank of a single-process run lives on one device, so ``main``
and the staging buffers stay on ``bf.device()``: a put is a device copy,
``win_update`` a device weighted sum, and nothing is staged through the
host (a tensor on another device is refused).  The host keeps only the
bookkeeping: versions, ``main_versions`` and the P scalars.

**One stream.**  Every window op, including the jobs of the pool threads,
is enqueued on one CUDA stream, the device's default stream
(:func:`_stream`).  Under the locks, enqueue order is then execution
order, which is what the store's locking argues about.  The host
bookkeeping is updated when a job *runs*, not when the device finishes;
each bookkeeping step stays inside the locks exactly as in the JAX
package.  A caller may have another stream current: an op (a job at its
dispatch) first makes the default stream wait for the caller's stream,
so it reads what the caller wrote; an op that returns rows, and
:func:`win_wait`, :func:`win_fence` and :func:`win_flush`, make the
caller's stream wait for the default stream, so the caller reads the
results, and overwrites a payload, after the window ops.  Moving window
ops themselves to a side stream needs events at every lock boundary.

A nonblocking op reads its payload when its job runs: the caller must not
change the tensor before :func:`win_wait` (MPI's rule for a nonblocking
put).

Left out, each raising an error that names its ROADMAP item: windows
across processes (item 17b: the transport, ``_Distrib``, the owned layout,
window compression across processes) and the async staleness mode
(``BLUEFOG_TPU_ASYNC=1``, item 17c).  ``BLUEFOG_TPU_WIN_COMPRESSION`` acts on
cross-process edges only, so in one process it changes nothing.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, List, Optional

import numpy as np
import torch

from bluefog_tpu_torch.utils import config

__all__ = [
    "win_create", "win_free", "win_put", "win_put_nonblocking",
    "win_get", "win_get_nonblocking", "win_accumulate",
    "win_accumulate_nonblocking", "win_update", "win_update_then_collect",
    "win_wait", "win_poll", "win_mutex", "win_fence", "win_flush",
    "get_win_version", "win_state_dict", "win_load_state_dict",
    "get_current_created_window_names", "win_associated_p",
    "turn_on_win_ops_with_associated_p", "turn_off_win_ops_with_associated_p",
]

# Wait bound of win_fence on the outstanding ops (the JAX package's
# BLUEFOG_TPU_WIN_TIMEOUT default).
_MSG_TIMEOUT_SEC = 300.0


class _Window:
    """State of one named window, every rank owned (the JAX package's
    owned-slice layout with ``layout="rank"``): ``main``, ``p_main``,
    ``main_versions`` and ``mutexes`` keyed by rank, ``staging``,
    ``p_staging`` and ``versions`` by ``(dst, src)`` edge."""

    def __init__(self, name: str, tensor: torch.Tensor,
                 in_nbrs: List[List[int]], out_nbrs: List[List[int]],
                 zero_init: bool):
        n = len(in_nbrs)
        self.name = name
        self.n = n
        self.shape = tuple(tensor.shape[1:])
        self.dtype = tensor.dtype
        self.device = tensor.device
        self.in_nbrs = in_nbrs
        self.out_nbrs = out_nbrs
        self.owned = list(range(n))
        # main[r]: rank r's exposed memory (win_get's source, win_update's
        # self term).
        self.main: Dict[int, torch.Tensor] = {
            r: tensor[r].clone() for r in self.owned}
        # staging[(dst, src)]: what src pushed toward dst (or dst pulled
        # from src); seeded with the neighbor's initial value.
        self.staging: Dict[tuple, torch.Tensor] = {
            (dst, src): (torch.zeros_like(tensor[src]) if zero_init
                         else tensor[src].clone())
            for dst in self.owned for src in in_nbrs[dst]}
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
        # of two updates must not interleave); puts take only `lock`, so
        # they stay concurrent with the combine.
        self.update_lock = threading.Lock()
        # associated-P scalars (push-sum weights); self starts at 1.0
        self.p_main: Dict[int, float] = {r: 1.0 for r in self.owned}
        self.p_staging: Dict[tuple, float] = {k: 0.0 for k in self.staging}


class _WindowStore:
    def __init__(self):
        self.windows: Dict[str, _Window] = {}
        self.lock = threading.RLock()
        self.pool = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix="bf-win")
        self.handles: Dict[int, Future] = {}
        self.next_handle = 0
        self.associated_p_enabled = False

    def get(self, name: str) -> _Window:
        with self.lock:
            if name not in self.windows:
                raise KeyError(f"window {name!r} does not exist")
            return self.windows[name]

    def submit(self, fn, device: torch.device,
               payload: Optional[torch.Tensor] = None) -> int:
        """Run ``fn`` on the pool; the job returns ``device``, for the
        waiter's stream order.  Called on the caller's thread, it orders
        the default stream after the caller's (see :func:`_stream`)."""
        _default_waits_for_caller(device, payload)

        def job():
            with _stream(device):
                fn()
            return device
        with self.lock:
            h = self.next_handle
            self.next_handle += 1
            self.handles[h] = self.pool.submit(job)
            return h


_store = _WindowStore()


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
    """Run the enclosed window ops on ``device``'s default stream (a no-op
    on the CPU), ordered after the work the calling thread has enqueued
    on its current stream, which waits for them in turn."""
    if device.type != "cuda":
        yield
        return
    _default_waits_for_caller(device)
    with torch.cuda.device(device), \
            torch.cuda.stream(torch.cuda.default_stream(device)):
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
    with _store.lock:
        for f in _store.handles.values():
            f.cancel()
        _store.handles.clear()
        _store.windows.clear()


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
    """Create a named window from a rank-major ``(size, ...)`` tensor on
    ``bf.device()``: one staging buffer per in-neighbor edge of the
    current topology, which is frozen while windows exist (as in the
    reference).  Returns False if the name is taken."""
    from bluefog_tpu_torch import basics
    if basics.process_ranks() is not None:
        raise NotImplementedError(
            "windows across processes need the window transport (ROADMAP "
            "Queue 1, item 17b: ops/transport.py, winsvc.cc, _Distrib, the "
            "owned layout and window compression); they run in one process "
            "only so far")
    if config.get().async_mode:
        raise NotImplementedError(
            "BLUEFOG_TPU_ASYNC=1 (the barrier-free async window mode: the "
            "staleness policy and the stale-residual store) is not ported "
            "yet (ROADMAP Queue 1, item 17c: async mode); unset it for the "
            "lockstep window ops")
    n, in_nbrs, out_nbrs = _neighbors_from_topology()
    t = _device_tensor(tensor, f"win_create({name!r})")
    if t.dim() == 0 or t.shape[0] != n:
        raise ValueError(
            f"win_create({name!r}): leading dim "
            f"{t.shape[0] if t.dim() else None} is not the world size {n} "
            "(rank-major; the owned layout comes with item 17b)")
    with _store.lock:
        if name in _store.windows:
            return False
        with _stream(t.device):
            _store.windows[name] = _Window(name, t, in_nbrs, out_nbrs,
                                           zero_init)
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Free one window (all with ``name=None``); False if there is none of
    that name."""
    with _store.lock:
        if name is None:
            _store.windows.clear()
        elif name in _store.windows:
            del _store.windows[name]
        else:
            return False
    return True


def get_current_created_window_names() -> List[str]:
    with _store.lock:
        return sorted(_store.windows)


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


def _validate_payload(win: _Window, t: torch.Tensor, op: str) -> None:
    if t.dim() == 0 or t.shape[0] != win.n:
        raise ValueError(f"{op}({win.name!r}): leading dim != {win.n} — "
                         "this window uses the rank-major layout")


def _validate_self_weight(win: _Window, self_weight) -> None:
    """At dispatch, before the job: a bad vector fails at the call site."""
    if self_weight is None:
        return
    sw = np.asarray(self_weight, dtype=float)
    if sw.ndim and sw.shape != (win.n,):
        raise ValueError(
            f"self_weight vector must have shape ({win.n},) — one entry "
            f"per rank — got {sw.shape}")


def _do_put(name: str, tensor: torch.Tensor, edges: Dict[tuple, float],
            require_mutex: bool, accumulate: bool, self_weight=None) -> None:
    try:
        win = _store.get(name)
    except KeyError:
        return  # window freed after dispatch: the put becomes a no-op
    for (src, dst), w in edges.items():
        _do_put_edge(win, tensor, src, dst, w, accumulate, require_mutex)
    if self_weight is not None:
        _publish_self(win, tensor, self_weight)


def _do_put_edge(win: _Window, tensor: torch.Tensor, src: int, dst: int,
                 w: float, accumulate: bool, require_mutex: bool) -> None:
    """One (src, dst) edge of a put or accumulate: ``w * tensor[src]`` in
    the window's dtype (a float32 multiply by ``w`` for a float32 payload,
    as numpy's)."""
    payload = (tensor[src] * w).to(win.dtype)
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
    the dst weights is 1 on p_old).  The JAX package multiplies the row by
    a float64 weight, which numpy does in float64 before the cast to the
    window's dtype; so does this, except for a weight of 1.0, which is
    exact either way."""
    sw = np.asarray(self_weight, dtype=float)
    with win.lock:
        sw_vec = sw if sw.ndim else np.full(win.n, float(sw))
        for r in win.owned:
            s = float(sw_vec[r])
            row = tensor[r]
            if s == 1.0:
                win.main[r] = row.to(win.dtype, copy=True)
            else:
                wide = torch.promote_types(row.dtype, torch.float64)
                win.main[r] = (row.to(wide) * s).to(win.dtype)
            win.main_versions[r] += 1
            if _store.associated_p_enabled:
                win.p_main[r] *= s


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
    return _store.submit(lambda: _do_put(
        name, t, edges, require_mutex, accumulate=accumulate,
        self_weight=self_weight), win.device, payload=t)


def win_put_nonblocking(tensor, name: str, *, self_weight=None,
                        dst_weights=None, require_mutex: bool = False) -> int:
    """Scaled overwrite of each destination's buffer-for-me (async).

    ``dst_weights``: None (every out-edge, weight 1), a ``{(src, dst): w}``
    or ``{dst: w}`` dict, or an ``(n, n)`` matrix ``W[src, dst]``.
    ``self_weight`` — a scalar or a per-rank ``(n,)`` vector — rescales
    each rank's exposed memory to ``self_weight * tensor`` after the
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
    for (dst, src), w in edges.items():
        mutex = win.mutexes[src] if require_mutex else None
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


def win_get_nonblocking(name: str, *, src_weights=None,
                        require_mutex: bool = False) -> int:
    """Pull ``w * main[src]`` from each in-neighbor into my staging
    (async); ``src_weights`` in the forms of ``dst_weights``, keyed
    ``(dst, src)`` (a matrix still reads ``W[src, dst]``)."""
    win = _store.get(name)
    edges = _resolve_edge_weights(src_weights, win.in_nbrs, 1.0,
                                  peer_is_src=True, ranks=win.owned)
    _validate_edges(edges, win.in_nbrs, peer_is_src=True, op="win_get")
    return _store.submit(lambda: _do_get(name, edges, require_mutex),
                         win.device)


def win_get(name: str, *, src_weights=None,
            require_mutex: bool = False) -> bool:
    win_wait(win_get_nonblocking(name, src_weights=src_weights,
                                 require_mutex=require_mutex))
    return True


# ---------------------------------------------------------------------------
# Update (sync + weighted combine)
# ---------------------------------------------------------------------------

def _default_update_weights(win: _Window):
    """The topology's combine weights: its edge weights when the topology
    is weighted, else uniform ``1/(indeg+1)``."""
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


def win_update(name: str, *, self_weight=None, neighbor_weights=None,
               reset_weights: bool = False,
               require_mutex: bool = False) -> torch.Tensor:
    """Combine self memory with the in-neighbor staging buffers, in place:
    ``out_i = sw_i * main_i + sum_src w[i, src] * staging[i, src]``, in
    ``in_nbrs`` order (``acc = sw * main``, then ``acc += w * staging``
    an edge at a time, as the JAX package's numpy, so float32 results
    agree bit for bit).  Writes the result to self memory and returns it,
    rank-major ``(n, ...)``.  ``reset_weights`` empties the consumed
    staging buffers.  An edge left out of an explicit partial
    ``neighbor_weights`` is not consumed: its staging, P and version
    counter stay pending.

    Locking: ``win.lock`` is held to snapshot the inputs, to swap the
    results back and, without ``reset_weights``, for one edge's multiply
    at a time.  With ``reset_weights`` the staging buffers are moved out
    at the snapshot (fresh zeros swap in): a put landing mid-combine goes
    into the fresh buffer and waits for the next update.  A self-publish
    landing mid-combine (``main_versions`` moved) serializes after the
    update: its main stands, and its P factor applies on top of the
    combined P."""
    return torch.stack(_update_rows(
        name, self_weight=self_weight, neighbor_weights=neighbor_weights,
        reset_weights=reset_weights, require_mutex=require_mutex))


def _update_rows(name: str, *, self_weight=None, neighbor_weights=None,
                 reset_weights: bool = False,
                 require_mutex: bool = False) -> List[torch.Tensor]:
    """:func:`win_update`'s rows, one a rank: the window's new memory
    itself, not copies, so that a caller that copies them out (the window
    optimizers) allocates no rank-major tensor.  Read them, never write
    them."""
    win = _store.get(name)
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
        with _stream(win.device):
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
    # -- swap (under lock)
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
    return torch.stack(_collect_rows(name, require_mutex=require_mutex))


def _collect_rows(name: str, *,
                  require_mutex: bool = True) -> List[torch.Tensor]:
    """:func:`win_update_then_collect`'s rows (see :func:`_update_rows`)."""
    win = _store.get(name)
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
    if fut is None:
        return True
    try:
        _caller_waits(fut.result())
    except KeyError:
        return False
    return True


def win_poll(handle: int) -> bool:
    with _store.lock:
        fut = _store.handles.get(handle)
    return fut is None or fut.done()


@contextlib.contextmanager
def win_mutex(name: str, *, for_self: bool = False,
              ranks: Optional[List[int]] = None):
    """Hold the mutexes of ``ranks`` (default: ``rank()``'s out-neighbors,
    and with ``for_self`` itself), taken in ascending rank order so that
    no lock cycle forms; ``require_mutex`` writers to them wait."""
    from bluefog_tpu_torch import basics
    from bluefog_tpu_torch import topology as topology_util
    win = _store.get(name)
    me = basics.rank()
    if ranks is None:
        ranks = topology_util.out_neighbor_ranks(basics.load_topology(), me)
        if for_self:
            ranks = list(ranks) + [me]
    with contextlib.ExitStack() as stack:
        for r in sorted(set(ranks)):
            win.mutexes[r].acquire()
            stack.callback(win.mutexes[r].release)
        yield


def win_fence(name: Optional[str] = None) -> None:
    """Epoch fence over the one-sided family: on return every window op
    dispatched so far has run (the first error among them is raised).
    Across processes it also acks every peer's sends (item 17b)."""
    with _store.lock:
        outstanding = list(_store.handles.items())
    errors = []
    for _, fut in outstanding:
        try:
            _caller_waits(fut.result(timeout=_MSG_TIMEOUT_SEC))
        except KeyError:
            pass  # window freed while the op ran (win_wait's reading)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)
    with _store.lock:
        for h, _ in outstanding:
            _store.handles.pop(h, None)
    if errors:
        raise errors[0]


def win_flush(wait: bool = True, timeout: Optional[float] = None) -> None:
    """Push queued window work out now.  Without a transport (one process)
    there are no send queues: with ``wait`` it drains the outstanding ops
    (their errors stay for ``win_wait``), without it, it does nothing."""
    if wait:
        _drain_handles(_MSG_TIMEOUT_SEC if timeout is None else timeout)


def win_state_dict(name: str) -> Dict[str, object]:
    """A window's whole state on the CPU, for checkpointing: main, the
    staging buffers (keys ``"dst:src"``), the version counters and the
    associated-P scalars.  Serialized against a running ``win_update``.
    The copy to the host is made here, only when called."""
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
    if state.get("stale_residual"):
        raise NotImplementedError(
            "the snapshot holds async-mode stale residuals (BLUEFOG_TPU_ASYNC"
            "); they are not ported yet (ROADMAP Queue 1, item 17c: async "
            "mode)")
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


def get_win_version(name: str, rank: Optional[int] = None) -> Dict[int, int]:
    """Per-in-neighbor put counts since the last ``win_update`` of
    ``rank`` (default ``rank()``)."""
    from bluefog_tpu_torch import basics
    win = _store.get(name)
    r = basics.rank() if rank is None else rank
    with win.lock:
        return {src: int(win.versions[r, src]) for src in win.in_nbrs[r]}


def win_associated_p(name: str, rank: Optional[int] = None):
    """The push-sum de-bias scalar of ``rank``, or with ``rank=None`` the
    ``(n,)`` float64 vector of every rank's."""
    win = _store.get(name)
    with win.lock:
        if rank is None:
            return np.array([win.p_main[r] for r in range(win.n)])
        return float(win.p_main[rank])


def turn_on_win_ops_with_associated_p() -> None:
    _store.associated_p_enabled = True


def turn_off_win_ops_with_associated_p() -> None:
    _store.associated_p_enabled = False
