"""Stream host functions of the fused window step (``csrc/hostfn.cu``).

``enqueue_plan_run`` and ``enqueue_probe`` put one host function on the
current CUDA stream: under stream capture a host node of the graph,
outside it a stream callback.  The plan run calls the service's
``bf_xla_plan_run`` on a pinned buffer and writes its return code into a
pinned status slot; the probe calls ``bf_probe_note``.  Neither takes the
GIL or makes a CUDA call.  The library builds at first use with
``ops/_nvcc.py`` into ``_build/hostfn-<hash>.so`` (host code only, a few
seconds) and is bound to the service's functions by address, so it links
against neither the service nor ``libcuda``.

Each call returns the node's argument record, which the caller keeps as
long as a graph holds the node and then releases with :func:`free`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

__all__ = ["load", "enqueue_plan_run", "enqueue_probe", "free"]

_LIB = None
_lock = threading.Lock()


def load():
    """Build (at first use), load and bind the library."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        from bluefog_tpu_torch import native
        from bluefog_tpu_torch.ops import _nvcc
        path, _ = _nvcc.build("hostfn")
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bf_hostfn_bind.argtypes = [P, P]
        lib.bf_hostfn_bind.restype = I
        lib.bf_hostfn_plan_args.argtypes = [ctypes.c_int64, P, P,
                                            ctypes.c_uint64, P]
        lib.bf_hostfn_plan_args.restype = P
        lib.bf_hostfn_probe_args.argtypes = [ctypes.c_int32]
        lib.bf_hostfn_probe_args.restype = P
        lib.bf_hostfn_free.argtypes = [P]
        lib.bf_hostfn_free.restype = None
        for fn in (lib.bf_hostfn_enqueue_plan, lib.bf_hostfn_enqueue_probe):
            fn.argtypes = [P, P]
            fn.restype = I
        svc = native.lib()
        rc = lib.bf_hostfn_bind(
            ctypes.cast(svc.bf_xla_plan_run, P).value,
            ctypes.cast(svc.bf_probe_note, P).value)
        if rc != 0:
            raise RuntimeError(f"bf_hostfn_bind failed (code {rc}): the "
                               "driver's cuLaunchHostFunc was not found")
        _LIB = lib
        return lib


def _stream(stream: Optional["torch.cuda.Stream"]) -> int:
    s = torch.cuda.current_stream() if stream is None else stream
    return s.cuda_stream


def _enqueue(fn, stream, args: int) -> int:
    if not args:
        raise MemoryError("host function arguments")
    rc = fn(_stream(stream), args)
    if rc != 0:
        load().bf_hostfn_free(args)
        raise RuntimeError(f"cuLaunchHostFunc failed (code {rc})")
    return args


def enqueue_plan_run(plan_id: int, tx: int, pinned_ptr: int, total: int,
                     status_slot: int, stream=None) -> int:
    """Enqueue ``bf_xla_plan_run(plan_id, tx, pinned_ptr, total)`` with its
    return code written to the int32 at ``status_slot`` (pinned)."""
    lib = load()
    args = lib.bf_hostfn_plan_args(plan_id, tx, pinned_ptr, total,
                                   status_slot)
    return _enqueue(lib.bf_hostfn_enqueue_plan, stream, args)


def enqueue_probe(probe_id: int, stream=None) -> int:
    """Enqueue ``bf_probe_note(probe_id)``."""
    lib = load()
    return _enqueue(lib.bf_hostfn_enqueue_probe, stream,
                    lib.bf_hostfn_probe_args(probe_id))


def free(args: int) -> None:
    """Release a node's argument record (after its graph is gone)."""
    if args and _LIB is not None:
        _LIB.bf_hostfn_free(args)
