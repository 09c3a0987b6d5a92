"""Build the port's CUDA sources into shared libraries at first use.

Each source under ``bluefog_tpu_torch/csrc/`` compiles with one ``nvcc``
call into ``bluefog_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of
the source, every header beside it (``csrc/*.cuh``), the flags and the
call's macro definitions (``defines``: one source can build several
libraries, say one per kernel instance, in calls that run at once), so an
edited source or header rebuilds and an unchanged tree loads from the
previous build.  The library has a plain C interface and is
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# The flash-attention libraries by dtype: the source and the macro
# definitions that pick its element type (the bf16 source builds float16
# with -DFLASH_F16), and the head-dim instances (ops/flash_attention.
# INSTANCES), a library each: -DFLASH_D=<instance>, the wide route of every
# head dim past 256 -DFLASH_D=0; the float32 source's also one a copy route
# (its kernels' template flag), -DFLASH_COPY=<bytes>, so that no nvcc
# compiles both routes and the longest one is half as long.
WIDE = "wide"
FLASH_DTYPES = {"bf16": ("flash_attention", ()),
                "f16": ("flash_attention", ("FLASH_F16=1",)),
                "f32": ("flash_attention_f32", ())}
FLASH_INSTANCES = {"bf16": (64, 128, 256, WIDE), "f16": (64, 128, 256, WIDE),
                   "f32": (16, 64, 128, 256, WIDE)}
FLASH_ROUTES = {"f32": (16, 4)}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the port's CUDA kernels are built on the machine "
                       "with the card")


def _flags(defines: Sequence[str]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to under the current sources, with
    the macro definitions ``defines`` (``"NAME=VALUE"``)."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(f"\0{path.name}\0".encode() + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False,
          defines: Sequence[str] = ()) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` (with ``-D`` each of ``defines``) unless
    its library is already built.

    Returns ``(path, log)``; with ``verbose`` the build passes
    ``-Xptxas -v`` and ``log`` holds what the compiler printed (registers,
    shared memory and spills of each kernel)."""
    out = library_path(name, defines)
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *_flags(defines), *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def flash_libraries():
    """``(dtype tag, instance, route)`` of every flash library: each
    instance of ``FLASH_INSTANCES``, and of a dtype in ``FLASH_ROUTES``
    each copy route (route 0 where the dtype has none)."""
    return [(tag, d, r) for tag, ds in FLASH_INSTANCES.items() for d in ds
            for r in FLASH_ROUTES.get(tag, (0,))]


def flash_defines(tag, d, route) -> Tuple[str, ...]:
    """The macro definitions of one flash library."""
    return (FLASH_DTYPES[tag][1] + (f"FLASH_D={0 if d == WIDE else d}",)
            + ((f"FLASH_COPY={route}",) if route else ()))


def build_flash(verbose: bool = False, keys=None):
    """``build`` of every library of :func:`flash_libraries` (or of
    ``keys``, some of them), every ``nvcc`` at once, so that the build
    takes the time of its slowest library; returns ``{(dtype tag, instance,
    route): (path, log)}``.  It needs no torch, so a caller can start it
    before torch loads."""
    keys = list(keys or flash_libraries())

    def one(key):
        return build(FLASH_DTYPES[key[0]][0], verbose, flash_defines(*key))
    with ThreadPoolExecutor(len(keys)) as pool:
        return dict(zip(keys, pool.map(one, keys)))
