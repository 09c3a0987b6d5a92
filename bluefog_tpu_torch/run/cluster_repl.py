"""Multi-machine interactive sessions: a rank-0 front-end driving a worker
fleet — a line REPL (``repl_main``) or a Jupyter KERNEL (``kernel_main``),
sharing one cell-shipping channel.  ``python -m
bluefog_tpu_torch.run.cluster_repl``; ``python -m
bluefog_tpu_torch.run.interactive --hosts ...`` launches the gang.

The port of ``bluefog_tpu/run/cluster_repl.py`` (reference
``run/interactive_run.py:271-420``: ``ibfrun``'s multi-machine mode boots an
ipcontroller plus ssh-launched ipengines so one notebook drives the MPI
world).  Every process of a ``torch.distributed`` gang must issue the same
collectives, so the "engine fleet" is a set of exec-loop workers and the
"controller" is a rank-0 front-end that ships each complete cell to every
worker over a TCP control channel, then executes it locally — collectives
inside a cell line up across the gang exactly as in a batch run.
``kernel_main`` puts an ipykernel in front of the same channel: a NOTEBOOK
connected to the standard Jupyter connection file drives the whole gang.

Every process boots with ``bf.init_distributed`` on the device and backend
the launcher exported (``BFTPU_DEVICE``, default ``cuda``;
``BFTPU_BACKEND``, default by device: NCCL on CUDA, gloo on the CPU).  On
CUDA a process takes card ``BFTPU_LOCAL_ID`` modulo the cards present, so a
one-card machine runs the whole gang on card 0 (with ``gloo``: NCCL refuses
two processes on one card).  Without a GPU a CUDA boot raises; nothing
falls back to the CPU.

Wire protocol (length-prefixed JSON, byte for byte the JAX package's):
``{"op": "exec", "src": ...}`` answered by ``{"ok": true}`` or ``{"ok":
false, "tb": ...}``; ``{"op": "exit"}`` ends the session.  Cells run
CONCURRENTLY on workers and the front-end — the ack is collected only after
the local exec, because a collective would otherwise deadlock (workers
blocked in the op, front-end blocked on acks).
"""

from __future__ import annotations

import argparse
import code
import json
import os
import socket
import struct
import sys
import time
import traceback

__all__ = ["main", "worker_main", "repl_main", "kernel_main", "Fleet",
           "ClusterConsole", "bfstat_text"]

_ACK_TIMEOUT = float(os.environ.get("BLUEFOG_TPU_IBF_ACK_TIMEOUT", "600"))

# ``%bfstat``: the one status "magic" both front-ends understand.  It is
# rewritten into this plain-Python cell and shipped like any other — every
# rank (front-end AND workers) prints its own gossip-health line, so a
# wedged worker is visible from the notebook.
_BFSTAT_SRC = ("from bluefog_tpu_torch.run.cluster_repl import bfstat_text "
               "as _bf_stat_fn; print(_bf_stat_fn(), flush=True)")


def bfstat_text() -> str:
    """One process's status block: identity, topology, windows, health and
    the comm-telemetry snapshot (``utils/telemetry``)."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.utils import telemetry
    if not bf.initialized():
        return "[bfstat] bluefog_tpu_torch not initialized"
    comm = bf.process_ranks()
    proc, nprocs = (comm.process, comm.nprocs) if comm is not None else (0, 1)
    lines = [
        f"[bfstat] proc {proc}/{nprocs}: "
        f"ranks {bf.owned_ranks()} of {bf.size()}"
        + (" (SUSPENDED)" if bf.suspended() else "")]
    topo = bf.load_topology()
    if topo is not None:
        lines.append(f"[bfstat] topology: {topo.number_of_nodes()} nodes, "
                     f"{topo.number_of_edges()} edges"
                     + (" (weighted)" if bf.is_topo_weighted() else ""))
    health = telemetry.health()
    port = telemetry.server_port()
    windows = bf.get_current_created_window_names()
    lines.append(
        f"[bfstat] health: {health['status']}"
        + ("; overdue: " + ", ".join(
            f"{o['op']} ({o['waited_sec']:.0f}s)"
            for o in health["overdue_ops"])
           if health["overdue_ops"] else "")
        + (f"; unreachable ranks: {health['unreachable_peer_ranks']}"
           if health.get("unreachable_peer_ranks") else "")
        + (f"; windows: {', '.join(windows)}" if windows else "")
        + (f"; /metrics on :{port}" if port else ""))
    member = health.get("membership")
    if member:
        import datetime
        when = member.get("last_change_unix")
        lines.append(
            f"[bfstat] membership: epoch {member['epoch']}, "
            f"{len(member['active_ranks'])}/{member['world_ranks']} ranks "
            f"active {member['active_ranks']}"
            + (f"; suspects {member['suspect_ranks']}"
               if member.get("suspect_ranks") else "")
            + (f"; admitting ranks {member['pending_join_ranks']}"
               if member.get("pending_join_ranks") else "")
            + (" (JOINING)" if member.get("joining") else "")
            + (" (EVICTED)" if member.get("evicted") else "")
            + (f"; last change {datetime.datetime.fromtimestamp(when):%H:%M:%S}"
               if when else ""))
    gd = health.get("gang_directory")
    if gd:
        # The replicated endpoint directory this process would serve a
        # joining replacement from (ops/gang.py).
        lines.append(
            f"[bfstat] gang directory: epoch {gd['epoch']}, "
            f"{len(gd.get('active_procs', []))} procs / "
            f"{gd.get('endpoints', 0)} endpoints"
            + (f"; vacant ranks {gd['vacant_ranks']}"
               if gd.get("vacant_ranks") else "")
            + (f"; grants {gd['grants_total']}"
               if gd.get("grants_total") else "")
            + (f"; persisted @{gd['persist_prefix']}"
               if gd.get("persist_prefix") else ""))
    ages = health.get("contribution_age")
    if ages:
        # Per-edge gossip staleness (wire trace tags): how old each
        # in-neighbor's contribution was when it folded here.
        parts = ", ".join(
            f"src {s} {a.get('freshest_sec', 0):.3f}.."
            f"{a.get('stalest_sec', 0):.3f}s"
            for s, a in sorted(ages.items(), key=lambda kv: int(kv[0])))
        lines.append(f"[bfstat] contribution age: {parts}")
    a = health.get("async")
    if a:
        # Barrier-free async mode: my step clock against the freshest
        # peer, the staleness policy in force and the mass it held back.
        rej = sum(a.get("stale_rejected", {}).values())
        dwn = sum(a.get("stale_downweighted", {}).values())
        lines.append(
            f"[bfstat] async: step {a['step']}, lag {a['step_lag']}, "
            f"bound {a['staleness_steps']} steps ({a['policy']}), "
            f"collect every {a['collect_every']}"
            + (f"; stale rejected {rej:g}" if rej else "")
            + (f", downweighted {dwn:g}" if dwn else ""))
    links = health.get("links")
    if links:
        # Link observatory (utils/linkobs.py): the worst measured edge,
        # the divergence from the placement model, the SLO verdict.
        slo = links.get("slo", {})
        lines.append(
            f"[bfstat] links: {links.get('edges', 0)} edge(s)"
            + (f", worst {links['worst_edge']} "
               f"({links['worst_delay_us']:.0f} us)"
               if links.get("worst_edge") else "")
            + (f", max divergence x{links['max_divergence_ratio']:.2f}"
               if links.get("max_divergence_ratio") is not None else "")
            + (f"; SLO BREACHED: {', '.join(slo['breached'])}"
               if slo.get("breached") else
               (f"; SLO ok ({len(slo['rules'])} rule(s))"
                if slo.get("rules") else "")))
    straggler = health.get("straggler")
    if straggler:
        slow = straggler["slowest_rank"]
        lines.append(
            f"[bfstat] straggler: score {straggler['straggler_score']:.2f}"
            f" (x{straggler.get('slowest_over_mean', 1.0):.2f} mean), "
            f"slowest rank {slow} "
            f"({straggler['step_seconds'][slow]:.4f}s vs mean "
            f"{straggler['mean_sec']:.4f}s over "
            f"{len(straggler['step_seconds'])} ranks)")
    snap = telemetry.snapshot()
    if snap:
        for k in sorted(snap):
            lines.append(f"[bfstat]   {k} = {snap[k]:g}")
    else:
        lines.append("[bfstat]   (telemetry registry empty"
                     + ("" if telemetry.enabled()
                        else " — BLUEFOG_TPU_TELEMETRY=0") + ")")
    return "\n".join(lines)


def _gang_token() -> str:
    """Shared secret binding workers to THIS gang.

    Workers exec() whatever arrives on the control channel, so both ends
    must prove they were launched by the same ``ibfrun`` invocation.  The
    launcher exports one random token per gang (``BFTPU_IBF_TOKEN``); the
    wire carries only HMACs over per-connection nonces (``_mac``, the
    handshake of ``_worker_handshake`` and ``_admit``), never the token
    itself — a rogue listener on the ctrl port cannot harvest it from a
    connecting worker."""
    return os.environ.get("BFTPU_IBF_TOKEN", "")


def _mac(token: str, nonce: str) -> str:
    import hashlib
    import hmac
    return hmac.new(token.encode(), nonce.encode(),
                    hashlib.sha256).hexdigest()


def _mac_ok(token: str, nonce: str, mac) -> bool:
    import hmac
    return isinstance(mac, str) and hmac.compare_digest(
        _mac(token, nonce), mac)


def _warn_if_unauthenticated(token: str, side: str) -> None:
    if not token:
        print(f"[ibfrun] {side}: BFTPU_IBF_TOKEN is not set — the control "
              "channel is UNAUTHENTICATED (fine for manual single-machine "
              "use; ibfrun's launcher always sets a per-gang token)",
              file=sys.stderr)


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            raise EOFError("control channel closed")
        data += chunk
    return data


def _recv_msg(sock: socket.socket) -> dict:
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n).decode())


def _whole_lines() -> None:
    """Write each line of this process's stdout whole, when it ends: the
    gang's processes share one terminal (or pipe), which takes a write of
    up to ``PIPE_BUF`` bytes whole, so their lines interleave but never
    tear (block buffering would cut lines at its boundary and hold a
    worker's output until its exit; ``PYTHONUNBUFFERED`` writes each
    ``print`` argument apart)."""
    try:
        sys.stdout.reconfigure(line_buffering=True, write_through=False)
    except (AttributeError, ValueError):
        pass  # not a TextIOWrapper: leave it as it is


def _boot_bf():
    """Shared SPMD boot: join the launcher's rendezvous on the exported
    device and backend (``init_distributed`` takes the process's card)."""
    import bluefog_tpu_torch as bf
    bf.init_distributed(device=os.environ.get("BFTPU_DEVICE") or "cuda",
                        backend=os.environ.get("BFTPU_BACKEND") or None)
    return bf


def _worker_handshake(sock: socket.socket, token: str, rank: int) -> None:
    """The worker's half of the mutual HMAC handshake (nothing secret on
    the wire): the front-end sends a nonce challenge; the worker answers
    with ``HMAC(token, front_nonce)`` plus its own nonce; the front-end's
    welcome carries ``HMAC(token, worker_nonce)``.  Raises unless the
    front-end proved possession of the token."""
    import secrets
    challenge = _recv_msg(sock)
    if challenge.get("op") != "challenge" or "nonce" not in challenge:
        raise ConnectionError(
            "ibfrun worker: the ctrl endpoint did not issue a handshake "
            "challenge — refusing to join (is something else listening "
            "on the control port?)")
    my_nonce = secrets.token_hex(16)
    _send_msg(sock, {"op": "hello", "rank": int(rank), "nonce": my_nonce,
                     "mac": _mac(token, str(challenge["nonce"]))})
    welcome = _recv_msg(sock)
    if (welcome.get("op") != "welcome"
            or not _mac_ok(token, my_nonce, welcome.get("mac"))):
        raise ConnectionError(
            "ibfrun worker: the ctrl endpoint failed the gang-token "
            "handshake — refusing to run cells from it")


def _admit(conn: socket.socket, token: str):
    """The front-end's half: challenge one connection, verify its hello
    and prove our own possession back.  Returns the hello, or None for a
    connection that could not prove possession of the token (or said
    nothing within the socket's timeout)."""
    import secrets
    nonce = secrets.token_hex(16)
    try:
        _send_msg(conn, {"op": "challenge", "nonce": nonce})
        hello = _recv_msg(conn)
    except (EOFError, OSError, ValueError):
        return None
    if (hello.get("op") != "hello"
            or not _mac_ok(token, nonce, hello.get("mac"))):
        return None
    _send_msg(conn, {"op": "welcome",
                     "mac": _mac(token, str(hello.get("nonce", "")))})
    return hello


def worker_main(ctrl: str) -> int:
    """Exec-loop worker (the reference's ipengine role): rendezvous,
    connect to the front-end's control socket, complete the mutual HMAC
    handshake (:func:`_worker_handshake`), run every shipped cell in a
    persistent namespace.  Each side proves possession of the gang token
    to the other, so neither a rogue ctrl listener nor a rogue client can
    enter the exec loop — including its ``exit`` op."""
    _whole_lines()
    bf = _boot_bf()
    host, port_s = ctrl.rsplit(":", 1)
    deadline = time.monotonic() + 120
    sock = None
    while sock is None:
        try:
            sock = socket.create_connection((host, int(port_s)), timeout=10)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    token = _gang_token()
    _warn_if_unauthenticated(token, f"worker rank {int(bf.rank())}")
    sock.settimeout(30)
    _worker_handshake(sock, token, bf.rank())
    sock.settimeout(None)
    ns: dict = {"bf": bf, "__name__": "__main__"}
    while True:
        try:
            msg = _recv_msg(sock)
        except EOFError:
            break  # front-end gone: shut down with it
        if msg.get("op") == "exit":
            break
        seq = msg.get("seq")
        try:
            exec(compile(msg["src"], "<cluster>", "exec"), ns)  # noqa: S102
        except SystemExit:
            _send_msg(sock, {"ok": True, "seq": seq})
            break
        except BaseException:  # noqa: BLE001 — report, stay alive
            _send_msg(sock, {"ok": False, "tb": traceback.format_exc(),
                             "seq": seq})
            continue
        _send_msg(sock, {"ok": True, "seq": seq})
    try:
        sock.close()
    except OSError:
        pass
    bf.shutdown()
    return 0


class Fleet:
    """The cell-shipping channel to the worker exec loops — shared by the
    line REPL (:class:`ClusterConsole`) and the Jupyter kernel
    (:func:`kernel_main`)."""

    def __init__(self, workers):
        self._workers = list(workers)  # live [(rank, sock)]
        self._seq = 0

    def _drop(self, rank, sock, why):
        print(f"[ibfrun] rank {rank}: control channel lost ({why}); "
              "continuing without it", file=sys.stderr)
        try:
            sock.close()
        except OSError:
            pass
        self._workers = [(r, s) for r, s in self._workers if s is not sock]

    def ship(self, source: str) -> int:
        """Send one cell to every worker (returns its sequence number).
        The connections were mutually authenticated at handshake time, so
        messages need no per-cell credential."""
        self._seq += 1
        for rank, sock in list(self._workers):
            try:
                _send_msg(sock, {"op": "exec", "src": source,
                                 "seq": self._seq})
            except OSError as e:
                self._drop(rank, sock, e)
        return self._seq

    def collect_acks(self) -> None:
        """One ack per worker for the LAST shipped cell.  Sequence numbers
        keep the pairing exact: a late ack from a previous slow cell is
        drained and discarded, never attributed to the current one; a
        worker that exceeds the timeout stays in the fleet (its stale ack
        is skipped on the next collect), while a closed channel removes
        it."""
        for rank, sock in list(self._workers):
            # The timeout is scoped to THIS recv loop: left on the socket,
            # a later sendall to a slow-but-healthy worker (long cell, full
            # TCP buffer) would raise and drop it from the fleet, and the
            # gang would then deadlock on the next collective.
            sock.settimeout(_ACK_TIMEOUT)
            try:
                while True:
                    try:
                        reply = _recv_msg(sock)
                    except socket.timeout:
                        print(f"[ibfrun] rank {rank}: no ack within "
                              f"{_ACK_TIMEOUT:.0f}s (cell still running "
                              "there?)", file=sys.stderr)
                        break
                    except (EOFError, OSError) as e:
                        self._drop(rank, sock, e)
                        break
                    if reply.get("seq") == self._seq:
                        if not reply.get("ok"):
                            tb = reply.get("tb", "").rstrip().splitlines()
                            tail = tb[-1] if tb else "unknown error"
                            print(f"[ibfrun] rank {rank} raised: {tail}",
                                  file=sys.stderr)
                        break
                    # Stale ack from an earlier timed-out cell: drain it.
            finally:
                try:
                    sock.settimeout(None)
                except OSError:
                    pass  # already closed by _drop

    def close(self) -> None:
        for _, sock in self._workers:
            try:
                _send_msg(sock, {"op": "exit"})
                sock.close()
            except OSError:
                pass
        self._workers = []


class ClusterConsole(code.InteractiveConsole):
    """REPL that ships each COMPLETE cell to the worker fleet before running
    it locally (concurrent SPMD execution), then surfaces worker errors."""

    def __init__(self, workers, locals=None):  # noqa: A002 — stdlib name
        super().__init__(locals=locals)
        self._fleet = workers if isinstance(workers, Fleet) \
            else Fleet(workers)

    @property
    def _workers(self):  # introspection/tests
        return self._fleet._workers

    def runsource(self, source, filename="<input>", symbol="single"):
        if source.strip() == "%bfstat":
            # Status "magic": rewritten to a plain-Python cell so it runs
            # SPMD like everything else — every rank prints its own block.
            source = _BFSTAT_SRC
        try:
            compiled = self.compile(source, filename, symbol)
        except (OverflowError, SyntaxError, ValueError):
            self.showsyntaxerror(filename)
            return False
        if compiled is None:
            return True  # incomplete cell: keep buffering
        self._fleet.ship(source)
        self.runcode(compiled)
        self._fleet.collect_acks()
        return False


def _accept_fleet(ctrl: str, expect: int, side: str):
    """Rank-0 side shared by the REPL and the kernel: listen on the ctrl
    endpoint FIRST (workers dial it right after their boot), boot the SPMD
    world, then mutually authenticate ``expect`` workers (:func:`_admit`).
    Returns ``(srv, workers, bf)`` with ``workers`` rank-sorted."""
    host, port_s = ctrl.rsplit(":", 1)
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        # Bind the coordinator interface the workers were told to dial,
        # not every interface on the machine.
        srv.bind((host, int(port_s)))
    except OSError as e:
        import errno
        if e.errno != errno.EADDRNOTAVAIL:
            raise  # EADDRINUSE etc: surface the REAL cause, don't mask it
        # The --ctrl host does not resolve to a local interface (NAT'd or
        # misresolved name): fall back to a wildcard bind, LOUDLY — the
        # exec() channel is now reachable on every interface.
        print(f"[ibfrun] ctrl host {host!r} is not a local address; "
              "binding ALL interfaces (the handshake still gates exec)",
              file=sys.stderr)
        srv.bind(("", int(port_s)))
    srv.listen(expect)
    bf = _boot_bf()
    token = _gang_token()
    _warn_if_unauthenticated(token, side)
    workers = []
    # 120 s of patience PER MISSING WORKER, not a shared deadline a slow
    # ssh fan-out could overrun.
    srv.settimeout(120)
    while len(workers) < expect:
        conn, peer = srv.accept()
        conn.settimeout(10)  # a silent connection must not wedge accept
        hello = _admit(conn, token)
        if hello is None:
            # A connection that cannot prove possession of this gang's
            # secret is not a worker: close it and keep listening (it must
            # not consume one of the ``expect`` fleet slots).
            print(f"[ibfrun] rejected unauthenticated connection from "
                  f"{peer}", file=sys.stderr)
            try:
                conn.close()
            except OSError:
                pass
            continue
        conn.settimeout(None)
        workers.append((int(hello.get("rank", -1)), conn))
    workers.sort(key=lambda w: w[0])
    return srv, workers, bf


def repl_main(ctrl: str, expect: int) -> int:
    """Rank-0 side: listen for ``expect`` workers, rendezvous, drive the
    interactive session."""
    _whole_lines()
    srv, workers, bf = _accept_fleet(ctrl, expect, "repl")
    print(f"bluefog_tpu_torch interactive: {bf.size()} rank(s) across "
          f"{bf.process_ranks().nprocs} process(es) ready on {bf.device()}"
          "; every cell runs SPMD on the whole gang", flush=True)
    fleet = Fleet(workers)
    console = ClusterConsole(fleet, locals={"bf": bf,
                                            "__name__": "__main__"})
    try:
        console.interact(banner="", exitmsg="")
    except SystemExit:
        pass
    sys.stdout.flush()
    fleet.close()
    srv.close()
    bf.shutdown()
    return 0


_IPYTHON_ONLY = ("raise RuntimeError('ibfrun cluster kernel: IPython-only "
                 "syntax (magics/!shell/?help) cannot run SPMD on the "
                 "worker fleet — use plain Python in cluster cells')")


def kernel_main(ctrl: str, expect: int, conn_file: str) -> int:
    """Rank-0 side as a JUPYTER KERNEL: a notebook client connected to
    ``conn_file`` (standard Jupyter connection file, written on startup)
    drives the whole gang — every executed cell is shipped to the worker
    fleet before running in the kernel, so collectives line up SPMD
    exactly as in the line REPL.  Jupyter's own connection-file HMAC key
    authenticates the notebook client side."""
    srv, workers, bf = _accept_fleet(ctrl, expect, "kernel")
    fleet = Fleet(workers)

    from ipykernel.ipkernel import IPythonKernel
    from ipykernel.kernelapp import IPKernelApp

    class ClusterKernel(IPythonKernel):
        implementation = "bluefog_tpu_torch-cluster"
        banner = ("bluefog_tpu_torch SPMD cluster kernel: every cell runs "
                  "on the whole gang")

        async def do_execute(self, code, silent, store_history=True,
                             user_expressions=None, allow_stdin=False,
                             **kwargs):
            if code.strip() == "%bfstat":
                # The one supported "magic": rewritten to plain Python and
                # shipped SPMD, so every rank reports its gossip health.
                code = _BFSTAT_SRC
            # Line endings are normalised BEFORE the guard comparison: the
            # transformer normalises CRLF cells textually, so without this
            # they would be rejected as IPython-only syntax.  The
            # normalised form is also what ships (workers' exec and the
            # local run must see the same bytes).
            code = code.replace("\r\n", "\n").replace("\r", "\n")
            # IPython-only syntax (magics, !shell, obj?) would execute in
            # THIS kernel but be a SyntaxError in the workers' plain
            # exec() — the kernel could then enter a collective the
            # workers never reach and hang the gang.  Such cells are
            # refused BEFORE anything ships or executes.
            transformed = self.shell.transform_cell(code)
            if transformed.strip() != code.strip():
                return await super().do_execute(
                    _IPYTHON_ONLY, silent, store_history=False,
                    user_expressions=user_expressions,
                    allow_stdin=allow_stdin, **kwargs)
            fleet.ship(code)
            try:
                # The local exec runs CONCURRENTLY with the workers' —
                # collectives inside the cell rendezvous across the gang.
                return await super().do_execute(
                    code, silent, store_history=store_history,
                    user_expressions=user_expressions,
                    allow_stdin=allow_stdin, **kwargs)
            finally:
                # Inside do_execute sys.stderr forwards to the client, so
                # worker errors and timeouts surface in the notebook.
                fleet.collect_acks()

    app = IPKernelApp.instance(connection_file=conn_file,
                               kernel_class=ClusterKernel)
    app.initialize([])
    app.kernel.shell.user_ns.update({"bf": bf})
    # To the terminal: after ``initialize`` sys.stdout is the kernel's
    # stream to its (not yet connected) clients.
    print(f"bluefog_tpu_torch cluster kernel: {bf.size()} rank(s) across "
          f"{bf.process_ranks().nprocs} process(es) on {bf.device()}; "
          f"connection file {app.abs_connection_file}", flush=True,
          file=sys.__stdout__)
    try:
        app.start()  # returns after the client's shutdown_request
    except SystemExit:
        pass
    fleet.close()
    srv.close()
    bf.shutdown()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bf-cluster-repl", description=__doc__)
    p.add_argument("--ctrl", required=True, help="rank-0 control host:port")
    p.add_argument("--repl", action="store_true",
                   help="run the rank-0 REPL (default: worker exec loop)")
    p.add_argument("--kernel-file", default=None,
                   help="run the rank-0 side as a Jupyter kernel writing "
                        "this connection file (notebook front-end)")
    p.add_argument("--expect", type=int, default=None,
                   help="worker connections the rank-0 side waits for "
                        "(default: processes - 1)")
    args = p.parse_args(argv)
    if args.repl or args.kernel_file:
        expect = args.expect
        if expect is None:
            expect = int(os.environ.get("BFTPU_NUM_PROCESSES", "1")) - 1
        if args.kernel_file:
            return kernel_main(args.ctrl, expect, args.kernel_file)
        return repl_main(args.ctrl, expect)
    return worker_main(args.ctrl)


if __name__ == "__main__":
    sys.exit(main())
