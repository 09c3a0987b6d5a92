"""The port's interactive cell channel (``bluefog_tpu_torch.run.cluster_repl``)
against the JAX package's ``bluefog_tpu/run/cluster_repl.py``, on the CPU.

- the wire: ``_send_msg`` writes the JAX package's bytes for the same
  messages, and ``_recv_msg`` survives chunked reads of them;
- the gang token: ``_mac`` equals the JAX function, ``_mac_ok`` refuses a
  wrong nonce, a wrong token and a missing MAC;
- the handshake across packages, both ways: the port's ``worker_main``
  against the JAX package's challenge side (which then drives its exec
  loop), a JAX-side hello against the port's ``_accept_fleet``; a rogue
  client does not take a fleet slot, a rogue listener is refused
  (``test_cluster_repl_gang_token_handshake``'s cases);
- ``test_cluster_console_acks_and_error_reporting``, ported;
- the boot's device and card (``cuda``: the local slot modulo the cards;
  ``cuda:N``: card N) and backend;
- ``bfstat_text`` against the JAX package's for 8 ranks, Exp2 and a window;
- a two-process ``ibfrun --hosts 127.0.0.1:2`` REPL gang (4 ranks a
  process, gloo): the cluster notebook's cells, its consensus against the
  same dynamic Exp2 rounds through the JAX package in one process (within
  1e-6), ``%bfstat`` from both processes, a worker's error reported by
  rank, the next cell still run, exit 0, and the gang token on no
  process's command line;
- a worker on another "host" launched over ``--rsh`` (ssh's process
  model), its token on the rsh client's stdin.
"""

import json
import os
import queue
import re
import secrets
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
from bluefog_tpu.run import cluster_repl as JCR
from bluefog_tpu_torch.run import cluster_repl as TCR

REPO = Path(__file__).resolve().parents[1]
CLUSTER_NB = (REPO / "bluefog_tpu_torch" / "notebooks"
              / "cluster_notebook.ipynb")

MESSAGES = [
    {"op": "exec", "src": "x = 1\n" * 100, "seq": 7},
    {"op": "challenge", "nonce": "ab" * 16},
    {"op": "hello", "rank": 3, "nonce": "cd" * 16, "mac": "ef" * 32},
    {"op": "welcome", "mac": "01" * 32},
    {"ok": False, "seq": 2,
     "tb": "Traceback (most recent call last):\nValueError: ünïcöde — boom"},
    {"ok": True, "seq": None},
    {"op": "exit"},
    {"op": "exec", "src": "s = '\\u00e9\\t\"q\"'\n" + "y" * 70000, "seq": 1},
]


def _wire_bytes(send, msg) -> bytes:
    """What ``send`` writes for ``msg`` (read on a thread: a large message
    does not fit a socket buffer)."""
    a, b = socket.socketpair()
    got = []
    reader = threading.Thread(target=lambda: got.append(b"".join(
        iter(lambda: b.recv(65536), b""))))
    reader.start()
    try:
        send(a, msg)
        a.shutdown(socket.SHUT_WR)
        reader.join(timeout=10)
    finally:
        a.close()
        b.close()
    return got[0]


@pytest.mark.parametrize("msg", MESSAGES,
                         ids=[f"msg{i}" for i in range(len(MESSAGES))])
def test_send_msg_bytes_equal_jax(msg):
    port = _wire_bytes(TCR._send_msg, msg)
    assert port == _wire_bytes(JCR._send_msg, msg)
    assert int.from_bytes(port[:4], "big") == len(port) - 4


@pytest.mark.parametrize("chunk", [1, 3, 4096])
def test_recv_msg_survives_chunked_reads(chunk):
    """The JAX package's bytes, dribbled ``chunk`` bytes at a time, parse
    into the message; a channel closed mid-message is an EOFError."""
    msg = MESSAGES[0]
    data = _wire_bytes(JCR._send_msg, msg)
    a, b = socket.socketpair()

    def dribble():
        for i in range(0, len(data), chunk):
            a.sendall(data[i:i + chunk])
            if chunk < 8 and i < 64:
                time.sleep(0.001)

    t = threading.Thread(target=dribble)
    t.start()
    try:
        assert TCR._recv_msg(b) == msg
        t.join(timeout=10)
        a.sendall(data[:len(data) // 2])
        a.close()
        with pytest.raises(EOFError, match="control channel closed"):
            TCR._recv_msg(b)
    finally:
        b.close()


@pytest.mark.parametrize("token,nonce", [
    ("s3cret", "aa" * 16), ("", "00" * 16),
    ("tök€n-" + "z" * 40, "5f" * 16)])
def test_mac_equals_jax(token, nonce):
    mac = TCR._mac(token, nonce)
    assert mac == JCR._mac(token, nonce)
    assert len(mac) == 64 and (not token or token not in mac)
    assert TCR._mac_ok(token, nonce, JCR._mac(token, nonce))


def test_mac_ok_refuses_wrong_nonce_token_or_mac():
    token, n1 = "s3cret", "aa" * 16
    assert TCR._mac_ok(token, n1, TCR._mac(token, n1))
    assert not TCR._mac_ok(token, n1, TCR._mac(token, "bb" * 16))
    assert not TCR._mac_ok(token, n1, TCR._mac("other", n1))
    assert not TCR._mac_ok(token, n1, None)
    assert not TCR._mac_ok(token, n1, 12345)


class _FakeBf:
    """The booted package as the exec loop sees it (no rendezvous)."""

    def __init__(self, rank):
        self._rank = rank
        self.shut = False

    def rank(self):
        return self._rank

    def shutdown(self):
        self.shut = True


def _listener():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    srv.settimeout(30)
    return srv, f"127.0.0.1:{srv.getsockname()[1]}"


def _run_worker(monkeypatch, ctrl, token, rank=1):
    """The port's real ``worker_main`` on a thread; returns (thread, fake
    bf, result list: its return value or the exception it raised)."""
    fake = _FakeBf(rank)
    monkeypatch.setattr(TCR, "_boot_bf", lambda: fake)
    monkeypatch.setenv("BFTPU_IBF_TOKEN", token)
    res = []

    def go():
        try:
            res.append(TCR.worker_main(ctrl))
        except Exception as e:  # noqa: BLE001 — the test reads it
            res.append(e)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    return t, fake, res


def test_port_worker_against_jax_challenge_side(monkeypatch):
    """The JAX package's front-end protocol (``_accept_fleet``'s
    challenge, the welcome, then ``Fleet``'s exec and exit messages, all
    with the JAX helpers) drives the port's worker: it authenticates the
    front-end, runs the cells in one namespace, reports an error by
    traceback and stays alive, and ends on exit."""
    token = "s3cret"
    srv, ctrl = _listener()
    t, fake, res = _run_worker(monkeypatch, ctrl, token)
    try:
        conn, _ = srv.accept()
        conn.settimeout(30)
        nonce = secrets.token_hex(16)
        JCR._send_msg(conn, {"op": "challenge", "nonce": nonce})
        hello = JCR._recv_msg(conn)
        assert hello["op"] == "hello" and hello["rank"] == 1
        assert JCR._mac_ok(token, nonce, hello["mac"])
        assert token not in json.dumps(hello)
        JCR._send_msg(conn, {"op": "welcome",
                             "mac": JCR._mac(token, hello["nonce"])})
        JCR._send_msg(conn, {"op": "exec", "src": "a = 20\nb = a + 1",
                             "seq": 1})
        assert JCR._recv_msg(conn) == {"ok": True, "seq": 1}
        JCR._send_msg(conn, {"op": "exec", "src": "raise ValueError(b)",
                             "seq": 2})
        reply = JCR._recv_msg(conn)
        assert reply["seq"] == 2 and reply["ok"] is False
        assert reply["tb"].rstrip().splitlines()[-1] == "ValueError: 21"
        JCR._send_msg(conn, {"op": "exec", "src": "assert b == 21",
                             "seq": 3})
        assert JCR._recv_msg(conn) == {"ok": True, "seq": 3}
        JCR._send_msg(conn, {"op": "exit"})
        t.join(timeout=10)
        assert res == [0] and fake.shut
        conn.close()
    finally:
        srv.close()


@pytest.mark.parametrize("rogue", ["forged_welcome", "no_challenge"])
def test_port_worker_refuses_rogue_listener(monkeypatch, rogue):
    """A listener without the token cannot forge the welcome, and one
    that does not challenge is not a front-end: the worker raises before
    its exec loop."""
    srv, ctrl = _listener()
    t, fake, res = _run_worker(monkeypatch, ctrl, "s3cret")
    try:
        conn, _ = srv.accept()
        conn.settimeout(30)
        if rogue == "forged_welcome":
            JCR._send_msg(conn, {"op": "challenge",
                                 "nonce": secrets.token_hex(16)})
            hello = JCR._recv_msg(conn)
            JCR._send_msg(conn, {"op": "welcome",
                                 "mac": JCR._mac("", hello["nonce"])})
        else:
            JCR._send_msg(conn, {"op": "exec", "src": "1", "seq": 1})
        t.join(timeout=10)
        assert len(res) == 1 and isinstance(res[0], ConnectionError)
        assert not fake.shut
        conn.close()
    finally:
        srv.close()


def _dial(ctrl):
    host, port = ctrl.rsplit(":", 1)
    deadline = time.monotonic() + 30
    while True:
        try:
            s = socket.create_connection((host, int(port)), timeout=10)
            s.settimeout(30)
            return s
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def test_port_accept_fleet_admits_jax_hello_and_rejects_rogue(monkeypatch):
    """The port's ``_accept_fleet`` (binding, boot, then accept): a rogue
    client replaying a MAC of another nonce is closed without a slot;
    then a worker speaking the JAX package's hello (its helpers) is
    admitted, and the welcome proves the front-end to it."""
    token = "s3cret"
    monkeypatch.setenv("BFTPU_IBF_TOKEN", token)
    fake = _FakeBf(0)
    monkeypatch.setattr(TCR, "_boot_bf", lambda: fake)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        ctrl = f"127.0.0.1:{s.getsockname()[1]}"
    res = []
    t = threading.Thread(target=lambda: res.append(
        TCR._accept_fleet(ctrl, 1, "repl")), daemon=True)
    t.start()
    rogue = _dial(ctrl)
    JCR._recv_msg(rogue)
    JCR._send_msg(rogue, {"op": "hello", "rank": 1, "nonce": "cc" * 16,
                          "mac": JCR._mac(token, "aa" * 16)})
    assert rogue.recv(1) == b""  # closed, no welcome
    rogue.close()
    honest = _dial(ctrl)
    ch = JCR._recv_msg(honest)
    wn = secrets.token_hex(16)
    JCR._send_msg(honest, {"op": "hello", "rank": 1, "nonce": wn,
                           "mac": JCR._mac(token, str(ch["nonce"]))})
    welcome = JCR._recv_msg(honest)
    assert welcome["op"] == "welcome"
    assert JCR._mac_ok(token, wn, welcome["mac"])
    t.join(timeout=10)
    srv, workers, bf = res[0]
    try:
        assert bf is fake and [r for r, _ in workers] == [1]
        # The admitted channel is the fleet's: a cell ships to it.
        fleet = TCR.Fleet(workers)
        seq = fleet.ship("x = 1")
        assert JCR._recv_msg(honest) == {"op": "exec", "src": "x = 1",
                                         "seq": seq}
        fleet.close()
        assert JCR._recv_msg(honest) == {"op": "exit"}
    finally:
        honest.close()
        srv.close()


def test_cluster_repl_gang_token_handshake(monkeypatch):
    """``test_cluster_repl_gang_token_handshake`` on the port's two halves
    of the handshake (``_admit``, ``_worker_handshake``): a replayed MAC
    is refused, an honest worker is admitted and authenticates the
    front-end, and a listener without the token cannot forge the
    welcome.  The token is never on the wire."""
    monkeypatch.setenv("BFTPU_IBF_TOKEN", "s3cret")
    token = TCR._gang_token()
    assert token == "s3cret"

    def admit(conn, results):
        results.append(TCR._admit(conn, token))

    # Rogue client: replays a MAC from ANOTHER session's nonce — refused.
    a, b = socket.socketpair()
    res = []
    t = threading.Thread(target=admit, args=(a, res), daemon=True)
    t.start()
    TCR._recv_msg(b)
    TCR._send_msg(b, {"op": "hello", "rank": 1, "nonce": "cc" * 16,
                      "mac": TCR._mac(token, "aa" * 16)})
    t.join(timeout=5)
    assert res == [None]
    a.close()
    b.close()

    # Honest worker against the honest front-end, the wire recorded.
    a, b = socket.socketpair()
    res = []
    t = threading.Thread(target=admit, args=(a, res), daemon=True)
    t.start()
    TCR._worker_handshake(b, token, 1)
    t.join(timeout=5)
    assert res[0]["op"] == "hello" and res[0]["rank"] == 1
    assert "s3cret" not in json.dumps(res[0])
    a.close()
    b.close()

    # A rogue LISTENER (no token) cannot forge the welcome.
    a, b = socket.socketpair()

    def rogue_listener():
        TCR._send_msg(a, {"op": "challenge", "nonce": "dd" * 16})
        hello = TCR._recv_msg(a)
        TCR._send_msg(a, {"op": "welcome",
                          "mac": TCR._mac("", hello["nonce"])})

    t = threading.Thread(target=rogue_listener, daemon=True)
    t.start()
    with pytest.raises(ConnectionError, match="gang-token"):
        TCR._worker_handshake(b, token, 1)
    t.join(timeout=5)
    a.close()
    b.close()


def test_cluster_console_acks_and_error_reporting(capsys):
    """The REPL pairs acks by sequence number, reports worker errors per
    rank, drains stale acks from a slow cell, and drops a dead worker
    without killing the session (the JAX package's test, on the port)."""
    orig_timeout = TCR._ACK_TIMEOUT
    TCR._ACK_TIMEOUT = 3.0
    repl_sock, worker_sock = socket.socketpair()
    console = TCR.ClusterConsole([(1, repl_sock)], locals={})

    def worker_one_cell(reply_ok=True, extra_stale=None):
        msg = TCR._recv_msg(worker_sock)
        assert msg["op"] == "exec"
        if extra_stale is not None:
            TCR._send_msg(worker_sock, {"ok": False, "seq": extra_stale,
                                        "tb": "STALE"})
        if reply_ok:
            TCR._send_msg(worker_sock, {"ok": True, "seq": msg["seq"]})
        else:
            TCR._send_msg(worker_sock, {"ok": False, "seq": msg["seq"],
                                        "tb": "Trace\nValueError: boom"})

    try:
        t = threading.Thread(target=worker_one_cell)
        t.start()
        assert console.runsource("a = 1") is False
        t.join(timeout=5)
        assert not t.is_alive()
        assert "[ibfrun]" not in capsys.readouterr().err

        t = threading.Thread(target=worker_one_cell,
                             kwargs={"reply_ok": False})
        t.start()
        console.runsource("a = 2")
        t.join(timeout=5)
        assert not t.is_alive()
        assert "rank 1 raised: ValueError: boom" in capsys.readouterr().err

        t = threading.Thread(target=worker_one_cell,
                             kwargs={"extra_stale": 0})
        t.start()
        console.runsource("a = 3")
        t.join(timeout=5)
        assert not t.is_alive()
        assert "raised" not in capsys.readouterr().err

        # An incomplete cell buffers and ships nothing.
        assert console.runsource("if a:") is True

        worker_sock.close()
        console.runsource("a = 4")
        err = capsys.readouterr().err
        assert "control channel lost" in err
        assert console._workers == []
        assert console.runsource("a = 5") is False
        assert console.locals["a"] == 5
    finally:
        TCR._ACK_TIMEOUT = orig_timeout
        repl_sock.close()
        try:
            worker_sock.close()
        except OSError:
            pass


@pytest.mark.parametrize("device,local_id,cards,want", [
    ("cuda", "1", 1, "0"), ("cuda", "3", 2, "1"), ("cuda:1", "0", 2, "1"),
    ("cpu", "3", 2, "3"), ("cuda", "1", 0, "1")])
def test_boot_device_and_card(monkeypatch, device, local_id, cards, want):
    """The boot hands ``init_distributed`` the launcher's device and
    backend (None: by device) and leaves the environment as the launcher
    set it; ``init_distributed`` takes the card: for ``cuda`` the local
    slot modulo the cards present (a one-card machine runs the gang on
    card 0), for ``cuda:N`` card N; without a card a CUDA boot raises
    ``resolve_device``'s error."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import basics
    monkeypatch.setenv("BFTPU_DEVICE", device)
    monkeypatch.setenv("BFTPU_LOCAL_ID", local_id)
    monkeypatch.delenv("BFTPU_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    seen = []
    monkeypatch.setattr(bf, "init_distributed", lambda **kw: seen.append(kw))
    assert TCR._boot_bf() is bf
    monkeypatch.setenv("BFTPU_BACKEND", "gloo")
    TCR._boot_bf()
    assert seen == [{"device": device, "backend": None},
                    {"device": device, "backend": "gloo"}]
    assert os.environ["BFTPU_LOCAL_ID"] == local_id
    dev = torch.device(device)
    if dev.type == "cuda" and cards:
        assert basics._local_card(dev, int(local_id)) == torch.device(
            "cuda", int(want))
    elif dev.type == "cuda":
        with pytest.raises(RuntimeError, match="no GPU"):
            basics.resolve_device(device)


def test_gang_stdout_writes_whole_lines():
    """Two processes printing to one pipe through ``_whole_lines`` (as a
    gang's REPL and worker do), under ``PYTHONUNBUFFERED``: no line is
    torn by the other's."""
    code = ("import os, sys; sys.path.insert(0, %r);"
            "from bluefog_tpu_torch.run import cluster_repl as C;"
            "C._whole_lines();"
            "[print('LINE', os.getpid(), i, 'x' * 20) for i in range(2000)]"
            % str(REPO))
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    r, w = os.pipe()
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=w,
                              env=env) for _ in range(2)]
    os.close(w)
    with os.fdopen(r) as f:
        lines = f.read().splitlines()
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    assert len(lines) == 4000
    torn = [ln for ln in lines
            if not re.fullmatch(r"LINE \d+ \d+ x{20}", ln)]
    assert torn == []


def _before_telemetry(text):
    lines = text.splitlines()
    return lines[:next(i for i, ln in enumerate(lines)
                       if ln.startswith("[bfstat]   "))]


def test_bfstat_text_equals_jax():
    """8 ranks, Exp2 and a window ``w`` in each package: the identity,
    topology and health lines are the JAX package's (``proc 0/1`` from
    ``process_ranks()`` in one process, as ``jax.process_index()``)."""
    import bluefog_tpu_torch as tbf
    assert TCR.bfstat_text() == "[bfstat] bluefog_tpu_torch not initialized"
    jbf.init()
    tbf.init(8, device="cpu")
    try:
        x = np.arange(16, dtype=np.float32).reshape(8, 2)
        jbf.win_create(x, "w")
        tbf.win_create(torch.as_tensor(x), "w")
        want, got = JCR.bfstat_text(), TCR.bfstat_text()
        head = _before_telemetry(got)
        assert head == _before_telemetry(want)
        assert head[0] == ("[bfstat] proc 0/1: ranks [0, 1, 2, 3, 4, 5, 6, "
                           "7] of 8")
        assert head[2] == "[bfstat] health: ok; windows: w"
        tbf.suspend()
        assert TCR.bfstat_text().splitlines()[0].endswith("(SUSPENDED)")
        tbf.resume()
    finally:
        tbf.win_free("w")
        jbf.win_free("w")
        tbf.shutdown()


# -- a two-process REPL gang through the launcher ---------------------------

def _cluster_cells():
    nb = json.loads(CLUSTER_NB.read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def _line_repl(cell):
    """A cell as the line REPL reads it: a compound statement ends at a
    blank line."""
    return cell.rstrip("\n") + "\n\n"


def jax_dynamic_exp2(n=8, steps=12):
    """The cluster notebook's rounds through the JAX package, one process."""
    jbf.init()
    assert jbf.size() == n
    x = (np.arange(n, dtype=np.float32)[:, None] + 1.0) * 10.0
    for step in range(steps):
        x = np.asarray(jbf.dynamic_neighbor_allreduce(x, step))
    return x.ravel()


_LAUNCH = [sys.executable, "-m", "bluefog_tpu_torch.run.interactive",
           "-np", "2", "--hosts", "127.0.0.1:2", "--devices-per-proc", "4",
           "--device", "cpu"]


def _gang_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "BFTPU_IBF_TOKEN")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO)
    return env


def _cmdlines():
    out = {}
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                out[int(d.name)] = (d / "cmdline").read_bytes()
            except OSError:
                pass
    return out


def _descendants(root):
    """The pids under ``root`` (other tests' gangs may run beside it)."""
    parent = {}
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            parent[int(d.name)] = int(stat.rsplit(")", 1)[1].split()[1])
    out, todo = set(), [root]
    while todo:
        pid = todo.pop()
        kids = [c for c, pp in parent.items() if pp == pid]
        out.update(kids)
        todo += kids
    return out


@pytest.fixture(scope="module")
def repl_gang(tmp_path_factory):
    """One session: the notebook's cells and a print of the gathered rows,
    then (with the gang live) every process's command line read, then
    ``%bfstat``, a cell raising on the worker only, one more cell, EOF."""
    err_path = tmp_path_factory.mktemp("gang") / "stderr.txt"
    t0 = time.monotonic()
    with open(err_path, "w") as err:
        p = subprocess.Popen(_LAUNCH, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, stderr=err, text=True,
                             cwd=REPO, env=_gang_env())
        lines = queue.Queue()
        reader = threading.Thread(
            target=lambda: [lines.put(ln) for ln in p.stdout], daemon=True)
        reader.start()
        out = []
        try:
            first = "".join(_line_repl(c) for c in _cluster_cells()) + \
                "print('CONS', json.dumps(x.ravel().tolist()))\n"
            p.stdin.write("import json\n" + first)
            p.stdin.flush()
            while not any("CONS" in ln for ln in out):
                out.append(lines.get(timeout=120))
            mine = _descendants(p.pid)
            procs = {pid: cl for pid, cl in _cmdlines().items()
                     if pid in mine
                     and b"bluefog_tpu_torch.run.cluster_repl" in cl}
            tokens = set()
            for pid in procs:
                try:
                    env = Path(f"/proc/{pid}/environ").read_bytes()
                except OSError:
                    continue
                tokens |= {kv.split(b"=", 1)[1] for kv in env.split(b"\0")
                           if kv.startswith(b"BFTPU_IBF_TOKEN=")}
            cmdlines = _cmdlines()
            p.stdin.write(
                "%bfstat\n"
                "if bf.process_ranks().process == 1: raise ValueError("
                "'only on the worker')\n\n"
                "print('AFTER', bf.rank(), float(bf.allreduce(torch.ones("
                "len(bf.owned_ranks()), 1), average=False)[0, 0]))\n")
            p.stdin.close()
            rc = p.wait(timeout=120)
            reader.join(timeout=10)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    while not lines.empty():
        out.append(lines.get())
    return {"rc": rc, "out": "".join(out), "err": err_path.read_text(),
            "procs": procs, "tokens": tokens, "cmdlines": cmdlines,
            "seconds": time.monotonic() - t0}


def test_gang_runs_the_cluster_notebook(repl_gang):
    out = repl_gang["out"]
    assert "8 rank(s) across 2 process(es) ready on cpu" in out, out
    assert out.count("ranks: 8 processes: 2") == 2, out
    assert out.count("CLUSTER-NB-OK True") == 2, out


def test_gang_consensus_equals_jax(repl_gang):
    line = next(ln for ln in repl_gang["out"].splitlines() if "CONS" in ln)
    got = np.array(json.loads(line.split("CONS", 1)[1]))
    np.testing.assert_allclose(got, jax_dynamic_exp2(), rtol=0, atol=1e-6)


def test_gang_bfstat_from_every_process(repl_gang):
    out = repl_gang["out"]
    assert "[bfstat] proc 0/2: ranks [0, 1, 2, 3] of 8" in out, out
    assert "[bfstat] proc 1/2: ranks [4, 5, 6, 7] of 8" in out, out
    assert out.count("[bfstat] health: ok") == 2, out


def test_gang_reports_a_worker_error_by_rank(repl_gang):
    assert ("[ibfrun] rank 4 raised: ValueError: only on the worker"
            in repl_gang["err"]), repl_gang["err"]


def test_gang_runs_the_cell_after_the_error(repl_gang):
    out = repl_gang["out"]
    assert "AFTER 0 8.0" in out and "AFTER 4 8.0" in out, out


def test_gang_exits_zero(repl_gang):
    assert repl_gang["rc"] == 0, repl_gang["err"][-3000:]
    assert repl_gang["seconds"] < 120


def test_gang_token_stays_off_every_command_line(repl_gang):
    assert len(repl_gang["procs"]) == 2, repl_gang["procs"]
    (token,) = repl_gang["tokens"]
    assert len(token) == 32
    assert not [pid for pid, cl in repl_gang["cmdlines"].items()
                if token in cl]


# ssh's process model (tests/test_runtime_services.py's stand-in): the
# "remote" command runs in a session of its own and gets the client's
# stdin, which carries the gang token.
_FAKERSH = r"""#!/bin/sh
host="$1"; shift
exec 3<&0
setsid -w sh -c "$*" <&3 &
child=$!
wait "$child"
exit $?
"""


def test_remote_worker_gets_the_token_over_rsh_stdin(tmp_path):
    """A worker on another "host" (127.0.0.2) launched over ``--rsh``: its
    token arrives on the rsh client's stdin, never on a command line, the
    handshake admits it, a cell runs on both processes, and the gang ends
    with no pidfile left."""
    import glob
    rsh = tmp_path / "fakersh.sh"
    rsh.write_text(_FAKERSH)
    before = set(glob.glob("/tmp/ibfrun-gang-*.pid"))
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.interactive", "-np",
         "2", "--hosts", "127.0.0.1:1,127.0.0.2:1", "--rsh", f"sh {rsh}",
         "--device", "cpu"],
        input="import torch\nprint('SUM', bf.rank(), float(bf.allreduce("
              "torch.ones(1, 1), average=False)[0, 0]))\n",
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=_gang_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SUM 0 2.0" in out.stdout and "SUM 1 2.0" in out.stdout, \
        out.stdout
    assert "rejected" not in out.stderr and "UNAUTHENTICATED" not in \
        out.stderr, out.stderr[-3000:]
    assert set(glob.glob("/tmp/ibfrun-gang-*.pid")) <= before
