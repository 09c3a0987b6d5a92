"""The port's ``ibfrun`` (``python -m bluefog_tpu_torch.run.interactive``)
against the JAX package's ``bluefog_tpu/run/interactive.py``, on the CPU.

- the parser: every JAX option with the same flags, dest and default, and
  the port's own ``--device`` (default ``cuda``) and ``--backend``;
- the refusals (rc 2, the JAX launcher's text): ``--hosts`` with a
  command or ``--no-init``, ``--kernel-file`` without ``--hosts``, a first
  host that is not this machine, and a bad host list;
- the environment: ``BFTPU_LOCAL_DEVICES`` and ``BFTPU_DEVICE``, and no
  ``sitecustomize`` shim on ``PYTHONPATH`` (there is no jax to pin);
- command mode ``-np 4 --device cpu <probe>`` prints ``DEVS 4``;
- ``test_ibfrun_piped_repl_session``'s three cells through the launched
  REPL (IPython, and ``python -i`` where IPython is not on the PATH);
- without a GPU, a CUDA session (one process, or a ``--hosts`` gang) ends
  with a nonzero exit and ``resolve_device``'s message.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bluefog_tpu.run import interactive as JI
from bluefog_tpu_torch.run import interactive as TI

REPO = Path(__file__).resolve().parents[1]

_JAX_ACTIONS = {a.dest: a for a in JI.build_parser()._actions
                if a.dest != "help"}
_PORT_ACTIONS = {a.dest: a for a in TI.build_parser()._actions
                 if a.dest != "help"}


@pytest.mark.parametrize("dest", sorted(_JAX_ACTIONS))
def test_parser_option_equals_jax(dest):
    j, t = _JAX_ACTIONS[dest], _PORT_ACTIONS[dest]
    assert t.option_strings == j.option_strings
    assert (t.default, t.nargs, t.type, t.const) == \
        (j.default, j.nargs, j.type, j.const)
    assert type(t) is type(j)


def test_parser_device_and_backend():
    assert set(_PORT_ACTIONS) - set(_JAX_ACTIONS) == {"device", "backend"}
    args = TI.build_parser().parse_args([])
    assert args.device == "cuda" and args.backend is None
    args = TI.build_parser().parse_args(
        ["--device", "cpu", "--backend", "gloo", "-np", "3"])
    assert (args.device, args.backend, args.num_proc) == ("cpu", "gloo", 3)
    with pytest.raises(SystemExit):
        TI.build_parser().parse_args(["--backend", "mpi"])


@pytest.mark.parametrize("argv,says", [
    (["--hosts", "127.0.0.1:1", "echo", "hi"], "drives a REPL only"),
    (["--hosts", "127.0.0.1:1", "--no-init"], "drives a REPL only"),
    (["--kernel-file", "k.json"], "needs --hosts"),
    (["-np", "2", "--hosts", "203.0.113.7:1,127.0.0.1:1"],
     "must be this machine"),
])
def test_refusals_equal_jax(argv, says, capsys):
    """Refused before anything starts, with the JAX launcher's text."""
    assert TI.main(argv) == 2
    port = capsys.readouterr().err
    assert JI.main(argv) == 2
    jax = capsys.readouterr().err
    assert says in port and port == jax


def test_bad_host_list_is_refused(capsys):
    assert TI.main(["-np", "3", "--hosts", "127.0.0.1:2"]) == 2
    assert "host slots (2) < requested processes (3)" in \
        capsys.readouterr().err


def test_prepared_env_exports_ranks_and_device(monkeypatch):
    monkeypatch.setenv("BFTPU_BACKEND", "nccl")
    env = TI._prepared_env(TI.build_parser().parse_args(
        ["-np", "8", "--device", "cpu"]))
    assert env["BFTPU_LOCAL_DEVICES"] == "8" and env["BFTPU_DEVICE"] == "cpu"
    assert "BFTPU_BACKEND" not in env
    assert env.get("PYTHONPATH") == os.environ.get("PYTHONPATH")
    env = TI._prepared_env(TI.build_parser().parse_args(
        ["--backend", "gloo"]))
    assert env["BFTPU_DEVICE"] == "cuda" and env["BFTPU_BACKEND"] == "gloo"
    assert env.get("BFTPU_LOCAL_DEVICES") == os.environ.get(
        "BFTPU_LOCAL_DEVICES")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "BFTPU_DEVICE",
                        "BFTPU_LOCAL_DEVICES", "BFTPU_BACKEND")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO)
    env.update(extra)
    return env


def _ibfrun(argv, timeout, **kw):
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.interactive", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, **kw)


def test_ibfrun_command_mode(tmp_path):
    """``ibfrun -np 4 --device cpu <cmd>`` prepares the environment the
    command reads its ranks and device from."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import os\n"
        "import bluefog_tpu_torch as bf\n"
        "bf.init(int(os.environ['BFTPU_LOCAL_DEVICES']),\n"
        "        device=os.environ['BFTPU_DEVICE'])\n"
        "print('DEVS', bf.size(), bf.device())\n")
    out = _ibfrun(["-np", "4", "--device", "cpu", sys.executable,
                   str(script)], timeout=120, env=_env())
    assert out.returncode == 0, out.stderr
    assert "DEVS 4 cpu" in out.stdout


CELLS = """
import torch
x = torch.arange(bf.size(), dtype=torch.float32, device=bf.device())[:, None]
for _ in range(60): x = bf.neighbor_allreduce(x)

print('CELL1', float(abs(x - x.mean()).max()) < 1e-3)
bf.suspend()
try:
    bf.neighbor_allreduce(x)
    print('CELL2 False')
except RuntimeError:
    print('CELL2 True')

bf.resume()
print('CELL3', float(bf.allreduce(x).mean()) >= 0)
print('ROWS', tuple(x.shape), x.device)
"""


@pytest.mark.parametrize("shell", ["ipython", "python"])
def test_ibfrun_piped_repl_session(shell, tmp_path):
    """A real session: the JAX test's cells piped into the launched REPL —
    the boot, consensus, suspend, a refused op, resume, an allreduce —
    through IPython, and through ``python -i`` when IPython is not on the
    PATH."""
    env = _env()
    if shell == "ipython":
        if not shutil.which("ipython"):
            pytest.skip("IPython is not on the PATH")
    else:
        # A PATH holding only a link to this interpreter.
        (tmp_path / "bin").mkdir()
        os.symlink(sys.executable, tmp_path / "bin" / "python3")
        env["PATH"] = str(tmp_path / "bin")
    out = _ibfrun(["-np", "4", "--device", "cpu"], timeout=120,
                  input=CELLS, env=env)
    assert out.returncode == 0, f"stdout={out.stdout}\nstderr={out.stderr}"
    assert "4 rank(s) ready on cpu" in out.stdout, out.stdout
    for marker in ("CELL1 True", "CELL2 True", "CELL3 True",
                   "ROWS (4, 1) cpu"):
        assert marker in out.stdout, out.stdout
    assert ("IPython" in out.stdout) == (shell == "ipython")


@pytest.mark.parametrize("argv", [["-np", "2"],
                                  ["-np", "2", "--hosts", "127.0.0.1:2"]],
                         ids=["single", "hosts"])
def test_no_gpu_ends_the_session(argv):
    """The default device is the card: without one the session ends with a
    nonzero exit and ``resolve_device``'s message, never on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _ibfrun(argv, timeout=120, input="print('RAN ON', bf.device())\n",
                  env=_env())
    assert out.returncode != 0
    assert "CUDA was requested (the default) but no GPU is available" in \
        out.stderr, out.stderr
    assert "RAN ON" not in out.stdout and "ready" not in out.stdout
