"""Build the port's CUDA sources into shared libraries at first use.

Each source under ``bluefog_tpu_torch/csrc/`` compiles with one ``nvcc``
call into ``bluefog_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads from the previous build.  The library has a plain C interface and is
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to under the current source."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str, verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns ``(path, log)``; with ``verbose`` the build passes
    ``-Xptxas -v`` and ``log`` holds what the compiler printed (registers,
    shared memory and spills of each kernel)."""
    out = library_path(name)
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
