"""The native libraries of the port, built at first use and bound with
``ctypes``: the window transport's service (with the timeline writer and
the flight recorder) and the round compiler.

The port of ``bluefog_tpu/native/__init__.py`` for the window transport's
library, ``src/winsvc.cc`` and ``src/timeline.cc`` (copies of the JAX
package's, with the declarations of its header that they define) compile
with one ``g++`` call into ``bluefog_tpu_torch/_build/winsvc-<hash>.so``,
keyed by a hash of the sources and the flags, as ``ops/_nvcc.py`` keys the CUDA
kernels: an edited source rebuilds, an unchanged tree loads the previous
build.  The flags are the JAX Makefile's, ``-ffp-contract=off`` included:
the drain's fold promises f32 sums bit for bit equal to the Python fold's,
and a fused multiply-add would break that.

There is no silent fallback.  A failed build raises with the compiler's
output; the Python hot loop runs only when the caller asks for it
(``BLUEFOG_TPU_WIN_NATIVE=0``).  The service itself (the TCP listener and
``bf_winsvc_send``) is native on both paths, as in the JAX package.

:func:`fastcall` is the optional ``_bf_fastcall`` module (``src/fastcall.cc``,
a copy of the JAX package's): one METH_FASTCALL C call a send on the native
path instead of a ``ctypes`` call, the payload taken through the buffer
protocol.  It builds at first use with ``g++`` and ``Python.h`` into
``_build/fastcall-<hash><EXT_SUFFIX>``, linked against the service's
library, whose hash covers ``fastcall.cc`` too.  As in the JAX package it
is the reference's optional fast path: where ``Python.h`` is missing or the
build fails, the send stays on ``ctypes`` (the transport's ``send_path``
says which ran).

:func:`schedule_lib` is the round compiler, ``src/schedule.cc`` (a copy of
the JAX package's): ``bf_rounds_from_matrix`` splits a weight matrix's
edges into shift-distance rounds in one O(n^2) pass, bit for bit the numpy
``ops.schedule._rounds_from_matrix_py``.  It builds with the same flags
into a library of its own, ``_build/schedule-<hash>.so``, keyed by a hash
of ``schedule.cc``, the headers and the flags; a failed build raises with
the compiler's output, as the service's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

from bluefog_tpu_torch.utils.logging import get_logger

__all__ = ["CXX_FLAGS", "library_path", "build", "lib", "fastcall",
           "fastcall_path", "schedule_library_path", "build_schedule",
           "schedule_lib", "WinMsg", "WinItem", "WinRxStats", "WinTxStats",
           "RecEvent"]

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("winsvc.cc",)
# The chrome-trace writer (utils/timeline.py), linked into the service's
# library and keyed into its hash.
TIMELINE_SOURCE = "timeline.cc"
# Keyed into the service's hash with SOURCES, built on its own.
FASTCALL_SOURCE = "fastcall.cc"
# The round compiler: a library of its own, with its own key.
SCHEDULE_SOURCE = "schedule.cc"
# The argument contract of fastcall.cc's wintx_send (BF_FASTCALL_ABI).
FASTCALL_ABI = 2

# bluefog_tpu/native/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread",
             "-ffp-contract=off", "-shared")

_lib = None
_lock = threading.Lock()
_fastcall = None
_fastcall_tried = False
_schedule_lib = None


class WinMsg(ctypes.Structure):
    """Mirror of ``bf_win_msg_t``: one inbound message of the Python
    drain."""
    _fields_ = [
        ("op", ctypes.c_uint8),
        ("src", ctypes.c_int32),
        ("dst", ctypes.c_int32),
        ("weight", ctypes.c_double),
        ("p_weight", ctypes.c_double),
        ("name", ctypes.c_char * 128),
        ("payload_len", ctypes.c_uint64),
    ]


class WinItem(ctypes.Structure):
    """Mirror of ``bf_win_item_t``: one ordered drain item, a raw message
    (kind 0) or a folded commit entry (kind 1)."""
    _fields_ = [
        ("kind", ctypes.c_uint8),
        ("op", ctypes.c_uint8),
        ("replace", ctypes.c_uint8),
        ("frame", ctypes.c_uint8),
        ("src", ctypes.c_int32),
        ("dst", ctypes.c_int32),
        ("puts", ctypes.c_int32),
        ("accs", ctypes.c_int32),
        ("weight", ctypes.c_double),
        ("p_weight", ctypes.c_double),
        ("off", ctypes.c_uint64),
        ("len", ctypes.c_uint64),
        ("wire_bytes", ctypes.c_uint64),
        ("trace_seq", ctypes.c_uint32),
        ("trace_src", ctypes.c_int32),
        ("trace_mono_us", ctypes.c_int64),
        ("trace_unix_us", ctypes.c_int64),
        ("trace_step", ctypes.c_int64),
        ("name", ctypes.c_char * 128),
    ]


class WinRxStats(ctypes.Structure):
    """Mirror of ``bf_winrx_stats_t``: the native drain's cumulative
    counters."""
    _fields_ = [
        ("batch_frames", ctypes.c_uint64),
        ("msgs", ctypes.c_uint64),
        ("folded_msgs", ctypes.c_uint64),
        ("commits", ctypes.c_uint64),
        ("bytes", ctypes.c_uint64),
        ("by_op", ctypes.c_uint64 * 16),
        ("batch_size_hist", ctypes.c_uint64 * 25),
        ("batch_size_sum", ctypes.c_double),
        ("decode_busy", ctypes.c_uint64),
        ("decode_threads", ctypes.c_uint64),
        ("decoded_frames", ctypes.c_uint64),
    ]


class WinTxStats(ctypes.Structure):
    """Mirror of ``bf_wintx_stats_t``: the native sender's cumulative
    counters (all peers, one peer or one stripe)."""
    _fields_ = [
        ("msgs_enq", ctypes.c_uint64),
        ("msgs_done", ctypes.c_uint64),
        ("frames", ctypes.c_uint64),
        ("batches", ctypes.c_uint64),
        ("batched_msgs", ctypes.c_uint64),
        ("bytes", ctypes.c_uint64),
        ("errors", ctypes.c_uint64),
        ("retries", ctypes.c_uint64),
        ("dropped_msgs", ctypes.c_uint64),
        ("queue_len", ctypes.c_uint64),
        ("by_op", ctypes.c_uint64 * 16),
        ("batch_size_hist", ctypes.c_uint64 * 25),
        ("send_sec_hist", ctypes.c_uint64 * 25),
        ("batch_size_sum", ctypes.c_double),
        ("send_sec_sum", ctypes.c_double),
    ]


class RecEvent(ctypes.Structure):
    """Mirror of ``bf_rec_event_t``: one flight-recorder ring slot (48
    bytes; ``utils/flightrec.EVENT_DTYPE`` is its numpy twin)."""
    _fields_ = [
        ("t_us", ctypes.c_int64),
        ("src", ctypes.c_int32),
        ("dst", ctypes.c_int32),
        ("seq", ctypes.c_uint32),
        ("len", ctypes.c_uint32),
        ("etype", ctypes.c_uint8),
        ("op", ctypes.c_uint8),
        ("stripe", ctypes.c_uint8),
        ("flags", ctypes.c_uint8),
        ("name", ctypes.c_char * 20),
    ]


def _service_sources() -> tuple:
    """The sources of the service's library: ``winsvc.cc`` and, where the
    tree has it, ``timeline.cc``."""
    extra = (TIMELINE_SOURCE,) if (SRC_DIR / TIMELINE_SOURCE).exists() \
        else ()
    return SOURCES + extra


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError(
            "no C++ compiler (g++, or $CXX) on PATH: the port's native "
            "libraries (bluefog_tpu_torch/native/src/) build with it at "
            "first use")
    return found


def library_path() -> Path:
    """Where the service builds to under the current sources and flags."""
    return BUILD_DIR / f"winsvc-{_hash()}.so"


def _hash() -> str:
    """The build key: the flags, the service's sources (the timeline
    writer's too), ``fastcall.cc`` and the headers."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    fast = SRC_DIR / FASTCALL_SOURCE
    for path in [*(SRC_DIR / s for s in _service_sources()),
                 *([fast] if fast.exists() else []),
                 *sorted(SRC_DIR.glob("*.h"))]:
        h.update(f"\0{path.name}\0".encode() + path.read_bytes())
    return h.hexdigest()[:16]


def fastcall_path() -> Path:
    """Where the ``_bf_fastcall`` module builds to, beside the service."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"fastcall-{_hash()}{suffix}"


def _compile(out: Path, sources, what: str) -> Path:
    """``sources`` compiled into the shared library ``out`` unless it is
    built already; a failed build raises with what the compiler printed."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # The soname is the file's name, which fastcall's module records.
    cmd = [_cxx(), *CXX_FLAGS, f"-Wl,-soname,{out.name}", "-o", str(tmp),
           *(str(SRC_DIR / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {what} failed:\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile the service unless its library is already built; a failed
    build raises with what the compiler printed."""
    return _compile(library_path(), _service_sources(),
                    "the window transport's native service")


def schedule_library_path() -> Path:
    """Where the round compiler builds to: keyed by the flags,
    ``schedule.cc`` and the headers."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in [SRC_DIR / SCHEDULE_SOURCE, *sorted(SRC_DIR.glob("*.h"))]:
        h.update(f"\0{path.name}\0".encode() + path.read_bytes())
    return BUILD_DIR / f"schedule-{h.hexdigest()[:16]}.so"


def build_schedule() -> Path:
    """Compile the round compiler unless it is built; a failed build
    raises with what the compiler printed."""
    return _compile(schedule_library_path(), (SCHEDULE_SOURCE,),
                    "the native round compiler")


def schedule_lib() -> ctypes.CDLL:
    """The loaded round compiler, built first when needed (raises when it
    cannot be built)."""
    global _schedule_lib
    with _lock:
        if _schedule_lib is None:
            lib_ = ctypes.CDLL(str(build_schedule()))
            i32, dbl = ctypes.c_int32, ctypes.c_double
            ptr = ctypes.POINTER
            lib_.bf_rounds_from_matrix.restype = i32
            lib_.bf_rounds_from_matrix.argtypes = [
                i32, ptr(dbl), ptr(i32), ptr(dbl), ptr(dbl), ptr(i32)]
            _schedule_lib = lib_
        return _schedule_lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64, u64, dbl = (ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,
                          ctypes.c_double)
    vp, cp, u8 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint8
    ptr = ctypes.POINTER
    sigs = {
        "bf_winsvc_start": (vp, [i32, i32]),
        "bf_winsvc_port": (i32, [vp]),
        "bf_winsvc_recv": (i32, [vp, ptr(WinMsg), ptr(u8), u64]),
        "bf_winsvc_send": (i32, [cp, i32, u8, cp, i32, i32, dbl, dbl,
                                 ptr(u8), u64]),
        "bf_winsvc_stop": (None, [vp]),
        "bf_winsvc_win_set": (i32, [vp, cp, i64]),
        "bf_winsvc_drain": (i32, [vp, ptr(WinItem), i32, ptr(u8), u64,
                                  ptr(ctypes.c_float), u64, i32, i32]),
        "bf_winsvc_set_decode": (i32, [vp, i32]),
        "bf_wintx_start": (vp, [u64, u64, i32, i32, dbl, i32]),
        # The payload rides as c_void_p: a raw address (the pinned staging
        # row, or a numpy buffer); bf_wintx_send copies it into its arena
        # before it returns.
        "bf_wintx_send": (i32, [vp, cp, i32, u8, cp, i32, i32, dbl, dbl, vp,
                                u64, i32, i32]),
        "bf_wintx_flush": (i32, [vp, cp, i32, dbl]),
        "bf_wintx_err_count": (i64, [vp, cp, i32]),
        "bf_wintx_kick": (None, [vp]),
        "bf_wintx_drop_peer": (i64, [vp, cp, i32]),
        "bf_wintx_set_partition": (None, [vp, cp]),
        "bf_wintx_stop": (None, [vp]),
        "bf_trace_configure": (None, [i32]),
        "bf_trace_period": (i32, []),
        "bf_trace_set_step": (None, [i64]),
        "bf_trace_step": (i64, []),
        "bf_winsvc_set_fold_across_put": (None, [i32]),
        "bf_winsvc_rx_stats": (None, [vp, ptr(WinRxStats)]),
        "bf_wintx_stats": (None, [vp, cp, i32, ptr(WinTxStats)]),
        "bf_wintx_stripe_stats": (None, [vp, cp, i32, i32,
                                         ptr(WinTxStats)]),
        "bf_rec_enable": (i64, [i64]),
        "bf_rec_is_enabled": (i32, []),
        "bf_rec_note": (None, [i32, i32, i32, i32, i32, ctypes.c_uint32,
                               u64, cp]),
        "bf_rec_snapshot": (i64, [ptr(RecEvent), i64]),
        "bf_rec_reset": (None, []),
        "bf_timeline_open": (vp, [cp, i32]),
        "bf_timeline_event": (None, [vp, cp, cp, ctypes.c_char, i64, i64,
                                     i64]),
        "bf_timeline_dropped": (i64, [vp]),
        "bf_timeline_close": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def lib() -> ctypes.CDLL:
    """The loaded service, built first when needed (raises when it cannot
    be built)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def loaded() -> Optional[ctypes.CDLL]:
    """The service if it is loaded already, else None (no build)."""
    return _lib


def _build_fastcall(service: Path) -> Optional[Path]:
    """Compile ``_bf_fastcall`` against ``service`` unless it is built;
    None (logged) when ``Python.h`` is missing or the build fails."""
    out = fastcall_path()
    if out.exists():
        return out
    inc = sysconfig.get_paths().get("include")
    if not inc or not Path(inc, "Python.h").exists():
        get_logger().info(
            "no Python.h: the window transport sends through ctypes")
        return None
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, f"-I{inc}", "-o", str(tmp),
           str(SRC_DIR / FASTCALL_SOURCE), f"-L{service.parent}",
           f"-l:{service.name}", "-Wl,-rpath,$ORIGIN"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        get_logger().warning(
            "building the _bf_fastcall send module failed; the window "
            "transport sends through ctypes:\n%s", proc.stderr[-2000:])
        return None
    os.replace(tmp, out)
    return out


def fastcall():
    """The ``_bf_fastcall`` module, built first when needed; None where it
    cannot be built or its ABI differs (the send stays on ctypes)."""
    global _fastcall, _fastcall_tried
    service = lib()
    del service  # loaded first: the module binds to this instance
    with _lock:
        if _fastcall_tried:
            return _fastcall
        _fastcall_tried = True
        path = _build_fastcall(library_path())
        if path is None:
            return None
        spec = importlib.util.spec_from_file_location("_bf_fastcall",
                                                      str(path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if getattr(mod, "ABI_VERSION", None) != FASTCALL_ABI:
            get_logger().warning(
                "_bf_fastcall ABI %s != %s; sending through ctypes",
                getattr(mod, "ABI_VERSION", None), FASTCALL_ABI)
            return None
        _fastcall = mod
        return _fastcall
