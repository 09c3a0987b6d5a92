"""Run a JAX rig of the root ``bench_comm.py`` and its port
(``python -m bluefog_tpu_torch.bench_comm``) in subprocesses, side by side
(not collected: the name does not start with ``test_``).

Each rig runs in a process of its own: the JAX one needs ``JAX_PLATFORMS``
and ``XLA_FLAGS`` set before ``import jax``, and the two packages' native
libraries each open loopback sockets.  Every subprocess has a timeout, and
``faulthandler`` dumps its stacks before it is killed.  A rig whose last
line says ``no_native`` or ``skipped`` fails the test: the JAX rigs print
such a line when their native core did not build.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 110

_WRAP = ("import faulthandler, runpy, sys; "
         "faulthandler.dump_traceback_later({t}, exit=True); "
         "sys.argv = {argv!r}; {run}")


def _env(jax: bool, extra=None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_TPU_", "BFTPU_"))
           and k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    env.update(extra or {})
    return env


def _popen(code: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def jax_rig(args):
    """The root ``bench_comm.py`` with ``args``: a started process."""
    from _jax_native import ensure_jax_native
    ensure_jax_native()
    code = _WRAP.format(t=TIMEOUT_S - 5, argv=["bench_comm.py", *args],
                        run="runpy.run_path('bench_comm.py', "
                            "run_name='__main__')")
    return _popen(code, _env(True))


def port_rig(args, module="bluefog_tpu_torch.bench_comm"):
    """The port's ``module`` with ``args`` (on the CPU): a started
    process."""
    code = _WRAP.format(t=TIMEOUT_S - 5, argv=[module, *args],
                        run=f"runpy.run_module({module!r}, "
                            "run_name='__main__', alter_sys=True)")
    return _popen(code, _env(False))


def python_snippet(code: str, jax: bool, extra=None):
    """``code`` in a fresh interpreter (a started process)."""
    wrapped = (f"import faulthandler; faulthandler.dump_traceback_later("
               f"{TIMEOUT_S - 5}, exit=True)\n" + code)
    return _popen(wrapped, _env(jax, extra))


def finish(proc, what: str) -> dict:
    """Wait for ``proc``; its last stdout line as JSON, after checking
    that it exited 0 and reported no skip."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{what}: timed out\n{err[-4000:]}")
    assert proc.returncode == 0, (
        f"{what}: exit {proc.returncode}\n{out[-2000:]}\n{err[-4000:]}")
    lines = out.strip().splitlines()
    assert lines, f"{what}: no output\n{err[-4000:]}"
    line = json.loads(lines[-1])
    text = lines[-1]
    assert "no_native" not in text and '"skipped"' not in text \
        and line.get("status") is None, f"{what}: {text}"
    return line


def run_pair(args):
    """The JAX rig and the port's (``--device cpu``) with ``args``, side
    by side: ``(jax_line, port_line)``."""
    pj = jax_rig(args)
    pt = port_rig([*args, "--device", "cpu"])
    try:
        port = finish(pt, f"port {args}")
        return finish(pj, f"jax {args}"), port
    finally:
        stop(pj, pt)


def stop(*procs):
    """Kill what is still running (a failed leg's partner)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
