"""The joiner's admission split: where a fresh process's seconds go from
its launch to its seat in the gang (``tools chaos``'s join leg prints it
on its ``admission split`` line; ``chip_smoke.py``'s ``chaos_tool`` phase
carries it).

- ``gang.join_gang`` stamps each step of the admission on the log's info
  level, in order, against a member that is a bare transport answering
  the request with a grant: the candidates, each probe (a dead one
  fails), the transport, the request, the grant, its decode and the
  install.
- A member's service stamps its own split (the request's arrival, its
  service pool taking it, the row snapshot, the send) the same way, and
  the tool reads it back.
- The tool's split from recorded stderr: seconds after the join launch,
  the granting member's stamps of the joiner's request only, the
  joiner's and the members' margins to the deadline; None where the
  joiner printed nothing (no request to match).
- A process's start time from ``/proc`` lies between its parent's clock
  before and after the launch.
"""

import json
import logging
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as tbf
from bluefog_tpu_torch.ops import gang as TG
from bluefog_tpu_torch.ops import membership as TM
from bluefog_tpu_torch.ops import transport as T
from bluefog_tpu_torch.ops import window as W
from bluefog_tpu_torch.tools import chaos as TC
from bluefog_tpu_torch.utils import config
from bluefog_tpu_torch.utils.logging import LOGGER_NAME, get_logger


@pytest.fixture(autouse=True)
def _clean():
    yield
    TG.install(None)
    TM.install(None)
    config.reload()


class _Member:
    """A live member as the joiner sees it: a transport that answers a
    ``join_req`` with a grant of rank 2 at epoch 1 (proc 4)."""

    def __init__(self):
        self.transport = T.WindowTransport(
            self._apply, apply_batch=self._apply_batch,
            apply_items=self._apply_items)
        self.ep = f"127.0.0.1:{self.transport.port}"

    def _apply(self, op, name, src, dst, weight, p_weight, payload):
        if (op & ~T.OP_FLAG_MASK) != T.OP_GANG:
            return
        msg = json.loads(bytes(payload))
        if msg.get("k") != "join_req":
            return
        grant = {"k": "grant", "nonce": msg["nonce"], "proc": 4,
                 "ranks": [2], "epoch": 1, "active": [0, 1, 3],
                 "n_ranks": 4,
                 "rank_owner": {str(r): r for r in range(4)},
                 "endpoints": {"0": self.ep}, "windows": {}}
        host, port = TG._ep_addr(msg["ep"])
        threading.Thread(target=self._reply, args=(host, port, grant),
                         daemon=True).start()

    def _reply(self, host, port, grant):
        self.transport.send(host, port, T.OP_GANG, "", 0, -1, 0.0,
                            np.frombuffer(json.dumps(grant).encode(),
                                          np.uint8))
        self.transport.flush(timeout=10.0)

    def _apply_batch(self, msgs):
        for msg in msgs:
            self._apply(*msg)

    def _apply_items(self, items):
        for kind, msg in items:
            if not kind:
                self._apply(*msg)


def _stamps(caplog) -> list:
    """The admission stamps among the records ``caplog`` took."""
    return TC._admission_stamps("\n".join(r.getMessage()
                                           for r in caplog.records))


def _dead_endpoint() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@pytest.mark.parametrize("target", ["endpoint", "directory"])
def test_join_gang_stamps_each_step(target, tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("BLUEFOG_TPU_ELASTIC_JOIN", "1")
    monkeypatch.setenv("BFTPU_WIN_HOST", "127.0.0.1")
    config.reload()
    member = _Member()
    get_logger()
    tbf.init(4, device="cpu")
    try:
        if target == "endpoint":
            spec, probes = member.ep, [(member.ep, True)]
        else:
            dead = _dead_endpoint()
            TG.GangDirectory(4, {0: member.ep, 1: dead}, epoch=1,
                             active=(0, 1),
                             rank_owner={r: r for r in range(4)}).persist(
                str(tmp_path / "gang.0.json"))
            spec = "@" + str(tmp_path / "gang")
            probes = [(member.ep, True), (dead, False)]
        t0 = time.time()
        with caplog.at_level(logging.INFO, logger=LOGGER_NAME):
            grant = TG.join_gang(spec)
        t1 = time.time()
        assert grant.proc == 4 and grant.ranks == (2,)
    finally:
        tbf.shutdown()
        member.transport.stop()
    stamps = _stamps(caplog)
    steps = [r.pop("step") for r in stamps]
    times = [r.pop("unix") for r in stamps]
    assert steps == (["candidates"] + ["probe"] * len(probes)
                     + ["transport", "join_req", "grant", "decode",
                        "installed"])
    assert stamps[0] == {"n": len(probes)}
    assert [(r["addr"], r["ok"]) for s, r in zip(steps, stamps)
            if s == "probe"] == probes
    req = stamps[steps.index("join_req")]
    assert req["addr"] == member.ep and len(req["nonce"]) == 32
    assert stamps[steps.index("grant")] == {"proc": 4}
    assert times == sorted(times)
    assert t0 - 1e-4 <= times[0] and times[-1] <= t1 + 1e-4


def test_grant_stamps_carry_the_split_the_tool_reads(caplog, monkeypatch):
    """A member's ``join_req``, through its service's ``handle`` (the
    drain's entry) onto the service pool: the service stamps the
    request's arrival, the pool taking it, the row snapshot and the send,
    in order and with the request's nonce, and the chaos tool's split
    reads them back."""
    monkeypatch.setenv("BLUEFOG_TPU_ELASTIC_JOIN", "1")
    config.reload()
    tbf.init(4, device="cpu")
    ctrl = TM.MembershipController(
        4, 0, {r: r for r in range(4)}, send_fn=lambda q, p: None,
        active=(0, 1, 3), epoch=1)
    TM.install(ctrl)
    svc = TG.GangService(TG.GangDirectory(
        4, {p: f"h:{p + 1}" for p in range(4)}, epoch=1, active=(0, 1, 3),
        rank_owner={r: r for r in range(4)}))
    sent = []
    get_logger()
    assert W.win_create(torch.ones(4, 3), "g")
    W._store.distrib = types.SimpleNamespace(
        my_proc=0, my_rank=0,
        transport=types.SimpleNamespace(
            send=lambda *a, **kw: sent.append(a)))
    try:
        with caplog.at_level(logging.INFO, logger=LOGGER_NAME):
            t_req = time.time()
            svc.handle({"k": "join_req", "nonce": "n1",
                        "ep": "10.0.0.9:7001", "want": 1})
            deadline = time.monotonic() + 10.0
            while not sent and time.monotonic() < deadline:
                time.sleep(0.01)
            W._store.svc_pool.submit(lambda: None).result(10.0)
    finally:
        W._store.distrib = None
        tbf.shutdown()
    assert len(sent) == 1
    assert [(r["step"], r["nonce"]) for r in _stamps(caplog)] == \
        [("request", "n1"), ("pool", "n1"), ("rows", "n1"), ("sent", "n1")]
    text = "\n".join(r.getMessage() for r in caplog.records)
    join_req = TG.ADMISSION_STAMP + json.dumps(
        {"step": "join_req", "unix": t_req, "nonce": "n1"})
    split = TC._admission_split(t_req, t_req + 40.0, join_req, text, {})
    g = split["grant"]
    assert g is not None, text
    assert 0.0 <= g["received_s"] < 5.0
    assert 0.0 <= g["pool_s"] <= g["rows_s"] <= g["sent_s"] < 5.0


_STAMPS = [("process", 0.4), ("main", 0.6), ("import", 3.1),
           ("init_world", 3.3), ("device_context", 5.0),
           ("candidates", 5.01), ("probe", 5.02), ("transport", 5.2),
           ("join_req", 5.21), ("grant", 5.3), ("decode", 5.31),
           ("installed", 5.32), ("admitted", 5.6), ("loop", 5.65)]


@pytest.mark.parametrize("case", ["complete", "no_joiner_output",
                                  "never_seated"])
def test_admission_split_from_recorded_output(case):
    launch, deadline = 1000.0, 1030.0
    stamps = {"complete": _STAMPS, "no_joiner_output": [],
              "never_seated": _STAMPS[:-3]}[case]

    def line(step, unix, **detail):
        return ("noise\n2026-01-01 00:00:00,000 INFO bluefog_tpu_torch: "
                + TG.ADMISSION_STAMP
                + json.dumps(dict(step=step, unix=unix, **detail)) + "\n")
    join_err = "".join(
        line(s, launch + dt, **({"nonce": "n1"} if s == "join_req" else {}))
        for s, dt in stamps)
    # The member's stamps of the joiner's request, among another
    # request's (nonce n0), which the split leaves out.
    gang_err = "".join(line(s, t, nonce=n) for s, t, n in [
        ("request", 1004.0, "n0"), ("pool", 1004.1, "n0"),
        ("request", 1005.25, "n1"), ("pool", 1005.2521, "n1"),
        ("rows", 1005.2604, "n1"), ("rows", 1004.2, "n0"),
        ("sent", 1005.2651, "n1"), ("sent", 1004.3, "n0")])
    members = {0: {"changes": [[1, 1002.0, 0.01], [2, 1006.5, 0.02]]},
               1: {"changes": [[1, 1002.1, 0.01], [2, 1006.25, 0.02]]}}
    split = TC._admission_split(launch, deadline, join_err, gang_err,
                                members)
    assert [s["step"] for s in split["steps"]] == [s for s, _ in stamps]
    assert [s["s"] for s in split["steps"]] == \
        pytest.approx([dt for _, dt in stamps])
    if case == "no_joiner_output":
        assert split["grant"] is None
    else:
        assert split["grant"] == pytest.approx(
            {"received_s": 5.25, "pool_s": 0.0021, "rows_s": 0.0104,
             "sent_s": 0.0151})
    assert split["deadline_s"] == 30.0
    assert split["members_margin_s"] == pytest.approx([23.5, 23.75])
    if case == "complete":
        assert split["joiner_margin_s"] == pytest.approx(30.0 - 5.65)
    else:
        assert split["joiner_margin_s"] is None


def test_process_start_from_proc_lies_within_the_launch():
    code = ("from bluefog_tpu_torch.tools import chaos; "
            "print(repr(chaos._process_start_unix()))")
    before = time.time()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    after = time.time()
    start = float(out.strip())
    # /proc counts in clock ticks of 10 ms.
    assert before - 0.02 <= start <= after
