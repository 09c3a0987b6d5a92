"""Load the JAX package's native core before a port test builds a JAX
``WindowTransport`` (not collected: the name does not start with
``test_``).

The JAX package builds ``libbluefog_tpu_native.so`` with ``make`` at its
first ``native.lib()`` and latches a failed build for the life of the
process (``_tried``).  When several pytest workers start on a tree with
no built library, their ``make`` runs race, or one outlasts its 120 s
timeout on a loaded machine, and a worker is left with no native core:
every JAX transport it builds raises "native core unavailable".  The
helper serialises the build under a file lock and, until the core
loads, builds again (``make`` is idempotent once a racing build has
ended), clears the latch and loads again.  It skips only where there is
no toolchain, never because of a race.
"""

import fcntl
import os
import shutil
import tempfile
import time

import pytest

_DEADLINE_S = 240.0
_LOCK_NAME = "bluefog_tpu_native_build.lock"


def _usable(jnative) -> bool:
    return jnative.lib() is not None and jnative.has_win_native()


def ensure_jax_native():
    """The JAX package's native module, its core loaded and current."""
    from bluefog_tpu import native as jnative
    if _usable(jnative):
        return jnative
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("no g++ or make on this machine: the JAX package's "
                    "native core cannot be built")
    lock_path = os.path.join(tempfile.gettempdir(), _LOCK_NAME)
    with open(lock_path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + _DEADLINE_S
            while True:
                jnative.build()
                with jnative._lock:
                    jnative._lib = None
                    jnative._tried = False
                    jnative._stale = False
                if jnative._fastcall is None:
                    jnative._fastcall_tried = False
                if _usable(jnative) or time.monotonic() > deadline:
                    break
                time.sleep(1.0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if not _usable(jnative):
        raise RuntimeError(
            f"the JAX package's native core did not build or load within "
            f"{_DEADLINE_S:.0f} s (make -C bluefog_tpu/native)")
    return jnative
