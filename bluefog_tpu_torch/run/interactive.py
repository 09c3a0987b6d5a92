"""``ibfrun``: interactive sessions, ``python -m
bluefog_tpu_torch.run.interactive``.

The port of ``bluefog_tpu/run/interactive.py`` (reference
``run/interactive_run.py:34-90``: ``ibfrun start -np 4`` boots an
ipcontroller plus mpirun'd ipengines so a notebook can drive the MPI world,
paired with ``bf.suspend()/bf.resume()`` to park the session between
cells).  One process drives every rank of ``bf.init(n)``, so any Jupyter
kernel or plain REPL that imports ``bluefog_tpu_torch`` *is* the
interactive mode; this launcher adds the environment bootstrap:

* ``ibfrun`` — an IPython (fallback: ``python -i``) shell with ``bf``
  imported and ``bf.init(n)`` already run, ``n`` the visible cards.
* ``ibfrun -np 8`` — the same over 8 virtual ranks on the device.
* ``ibfrun -np 8 jupyter notebook`` (any command) — run that command in the
  prepared environment instead of a REPL: it exports
  ``BFTPU_LOCAL_DEVICES=8`` and ``BFTPU_DEVICE``, which the port's
  notebooks (``bluefog_tpu_torch/notebooks/``) read.
* ``ibfrun -np 4 --hosts h1:2,h2:2`` — MULTI-MACHINE mode (reference
  ``interactive_run.py:271-420``): processes 1..n-1 run exec-loop workers
  launched over bfrun's ``--rsh``/ssh transport, process 0 is a REPL that
  ships every complete cell to the fleet before running it locally, so
  collectives inside a cell run SPMD across the gang
  (``run/cluster_repl.py``).  With ``--hosts``, ``-np`` counts processes
  (as in bfrun) and ``--devices-per-proc`` gives each process that many
  ranks.
* ``ibfrun -np 4 --hosts h1:2,h2:2 --kernel-file /tmp/bf-kernel.json`` —
  multi-machine JUPYTER mode: process 0 becomes an ipykernel in front of
  the same cell-shipping channel; connect any notebook or console client
  to the connection file and every executed cell drives the whole gang
  (``notebooks/cluster_notebook.ipynb``).

``--device`` (default ``cuda``) and ``--backend`` (``nccl`` or ``gloo``;
default by device, as ``bf.init_distributed`` chooses) take the place of
the JAX launcher's virtual CPU mesh and platform pin: ``--device cpu``
runs everything on the CPU over gloo.  Without a GPU a CUDA session ends
with a nonzero exit and ``resolve_device``'s message; nothing falls back
to the CPU.  On a machine with fewer cards than local processes, the
processes share the cards (card ``BFTPU_LOCAL_ID`` modulo their count);
NCCL refuses two processes on one card, so such a gang needs ``--backend
gloo``.

Inside the session, ``bf.suspend()`` / ``bf.resume()`` quiesce and
re-enable communication between cells (reference
``common/basics.py:497-515``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
import uuid

from bluefog_tpu_torch.run.run import local_devices_env

__all__ = ["main", "build_parser"]

# The boot: ``-np`` ranks (else the visible cards) on the device.  A device
# that cannot be had ends the session (``os._exit``: ``-i`` would otherwise
# drop into the prompt after the error).
_BOOT = """\
import sys as _s, torch as _t, bluefog_tpu_torch as bf
try:
    bf.init({n} or max(_t.cuda.device_count(), 1), device={device!r})
except RuntimeError as _e:
    print('ibfrun:', _e, file=_s.stderr, flush=True)
    import os as _o; _o._exit(1)
print('bluefog_tpu_torch interactive: %d rank(s) ready on %s; '
      'bf.suspend()/bf.resume() park the session' % (bf.size(), bf.device()),
      flush=True)
del _s, _t
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ibfrun", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="virtual rank count (default: the visible cards); "
                        "with --hosts: number of processes (bfrun "
                        "semantics)")
    p.add_argument("--no-init", action="store_true",
                   help="prepare the environment but skip bf.init()")
    p.add_argument("-H", "--hosts", default=None,
                   help="multi-machine mode: comma-separated host[:slots] "
                        "entries; process 0 is the local REPL, the rest "
                        "are exec-loop workers")
    p.add_argument("--rsh", default=None,
                   help="remote-shell command for --hosts workers "
                        "(default: ssh -p <ssh-port>).  Must forward "
                        "stdin to the remote command like ssh does — the "
                        "per-gang auth token travels that way, never on "
                        "a command line")
    p.add_argument("--ssh-port", type=int, default=22)
    p.add_argument("--devices-per-proc", type=int, default=None,
                   help="ranks per process (--hosts mode; "
                        "BFTPU_LOCAL_DEVICES)")
    p.add_argument("--kernel-file", default=None,
                   help="--hosts mode: run process 0 as a JUPYTER KERNEL "
                        "writing this connection file instead of a line "
                        "REPL — connect a notebook client to it and every "
                        "executed cell runs SPMD on the whole gang")
    p.add_argument("--device", default="cuda",
                   help="device of every rank: cuda (default; each "
                        "process on card BFTPU_LOCAL_ID modulo the cards "
                        "present), cuda:N or cpu; exported as "
                        "BFTPU_DEVICE")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="--hosts mode: the process group's backend "
                        "(default: nccl on CUDA, gloo on the CPU); "
                        "exported as BFTPU_BACKEND")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="command to run instead of a REPL")
    return p


def _device_env(env: dict, args) -> dict:
    env["BFTPU_DEVICE"] = args.device
    if args.backend:
        env["BFTPU_BACKEND"] = args.backend
    else:
        env.pop("BFTPU_BACKEND", None)
    return env


def _cluster(args) -> int:
    """Launch the multi-machine interactive gang: process-0 REPL locally,
    the others as cluster_repl workers over the rsh/ssh transport (the
    launch/kill/env machinery is bfrun's — one remote code path to
    trust)."""
    from bluefog_tpu_torch.run import run as R
    n = args.num_proc or 1
    try:
        placement = R.parse_hosts(args.hosts, n)
    except ValueError as e:
        print(f"ibfrun: {e}", file=sys.stderr)
        return 2
    coord_host = placement[0][0]
    if not R.is_local_host(coord_host):
        # Process 0 (REPL + coordinator + control socket) always runs
        # HERE; fail fast instead of letting workers dial a host where
        # nothing listens and time out opaquely two minutes later.
        print(f"ibfrun: the first --hosts entry ({coord_host}) must be this "
              "machine — rank 0 is the local REPL", file=sys.stderr)
        return 2
    rsh = R.rsh_argv(args.rsh, args.ssh_port)
    coord = f"{coord_host}:{R._free_port()}"
    ctrl = f"{coord_host}:{R._free_port()}"
    tag = f"ibfrun-gang-{uuid.uuid4().hex[:12]}"
    # Per-gang shared secret: workers exec() shipped cells, so both sides
    # of the control channel prove possession via an HMAC challenge-
    # response at connect time (cluster_repl handshake).
    import secrets
    token = secrets.token_hex(16)
    host_slots = {}
    for host, _ in placement:
        host_slots[host] = host_slots.get(host, 0) + 1

    def child_env(rank, local_rank, local_size):
        env = dict(os.environ)
        env["BFTPU_COORDINATOR"] = coord
        env["BFTPU_NUM_PROCESSES"] = str(n)
        env["BFTPU_PROCESS_ID"] = str(rank)
        env["BFTPU_LOCAL_ID"] = str(local_rank)
        env["BFTPU_LOCAL_SIZE"] = str(local_size)
        env["BFTPU_GANG_TAG"] = tag
        env["BFTPU_IBF_TOKEN"] = token
        if args.devices_per_proc:
            local_devices_env(env, args.devices_per_proc)
        return _device_env(env, args)

    wcmd = [sys.executable, "-m", "bluefog_tpu_torch.run.cluster_repl",
            "--ctrl", ctrl]
    entries = []
    try:
        for rank, (host, local_rank) in enumerate(placement):
            if rank == 0:
                continue  # the REPL below
            env = child_env(rank, local_rank, host_slots[host])
            if R.is_local_host(host):
                # Local children get the token via the env DICT (never a
                # command line); remote ones read it from the rsh stdin
                # below — remote_run_cmd refuses to inline it into argv,
                # where /proc would expose it to every local user.
                entries.append((subprocess.Popen(wcmd, env=env), host,
                                False))
            else:
                run_cmd = ("IFS= read -r BFTPU_IBF_TOKEN && "
                           "export BFTPU_IBF_TOKEN && "
                           + R.remote_run_cmd(env, wcmd))
                remote = R._launch_shell(tag, rank, run_cmd)
                p = subprocess.Popen(rsh + [host, remote],
                                     stdin=subprocess.PIPE, text=True)
                # Registered BEFORE the token is fed: a dead rsh client
                # (bad host, instant ssh failure) raises BrokenPipeError
                # on the write, and the cleanup below must reach it too.
                entries.append((p, host, True))
                p.stdin.write(token + "\n")
                p.stdin.close()
        front = (["--kernel-file", args.kernel_file] if args.kernel_file
                 else ["--repl"])
        rc = subprocess.call(
            [sys.executable, "-m", "bluefog_tpu_torch.run.cluster_repl"]
            + front + ["--ctrl", ctrl, "--expect", str(n - 1)],
            env=child_env(0, placement[0][1], host_slots[coord_host]))
    except KeyboardInterrupt:
        print("ibfrun: interrupted; stopping the gang", file=sys.stderr)
        R._kill_gang(entries, rsh, tag)
        return 130
    except OSError as e:
        # A failing rsh client (e.g. BrokenPipeError writing the gang
        # token) must not leak the already-launched workers: kill the
        # gang, then surface the real error.
        print(f"ibfrun: gang launch failed ({e}); stopping the gang",
              file=sys.stderr)
        R._kill_gang(entries, rsh, tag)
        raise
    # The REPL's exit ends the session: workers exit on control-channel
    # EOF, within 15 s or they are stopped.
    deadline = time.monotonic() + 15
    for p, _, _ in entries:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    if any(p.poll() is None for p, _, _ in entries):
        R._kill_gang(entries, rsh, tag)
    return rc


def _prepared_env(args) -> dict:
    """The session's environment: ``BFTPU_LOCAL_DEVICES=-np`` and the
    device (``BFTPU_DEVICE``, ``BFTPU_BACKEND``).  The JAX launcher also
    injects a ``sitecustomize`` that pins jax's platform; the port has no
    platform to pin."""
    env = dict(os.environ)
    if args.num_proc:
        local_devices_env(env, args.num_proc)
    return _device_env(env, args)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if args.hosts:
        if cmd or args.no_init:
            # The fleet protocol IS the session: an arbitrary command has
            # no cell stream to broadcast, and workers must init to
            # rendezvous.  Refuse rather than silently ignore.
            print("ibfrun: --hosts mode drives a REPL only; a command and "
                  "--no-init are not supported with it", file=sys.stderr)
            return 2
        return _cluster(args)
    if args.kernel_file:
        print("ibfrun: --kernel-file drives the multi-machine gang and "
              "needs --hosts (single-machine notebooks just start any "
              "kernel under `ibfrun -np N jupyter ...`)", file=sys.stderr)
        return 2
    env = _prepared_env(args)
    if cmd:
        return subprocess.call(cmd, env=env)
    boot = "" if args.no_init else _BOOT.format(n=args.num_proc or 0,
                                                device=args.device)
    if shutil.which("ipython"):
        argv = ["ipython", "-i", "-c", boot] if boot else ["ipython"]
    else:
        argv = [sys.executable, "-i"] + (["-c", boot] if boot else [])
    return subprocess.call(argv, env=env)


if __name__ == "__main__":
    sys.exit(main())
