"""Heartbeat liveness under load: the control lane, the start-up window
and the async mode's arming, against the JAX package where it has the
same code.

- The control lane (``ops/transport.py``, ``native/src/winsvc.cc``): a
  heartbeat sent while the receiver's drain folds a 64 MB row reaches
  the membership controller within ``NOTE_BOUND`` seconds, well under
  the chaos demo's 500 ms of suspicion (without the lane it waits for the
  fold, 2 s here), on the native and the Python drain alike.
- The start-up schedule: a process whose supervisor starts 1.8 s before
  its peers' (each builds its model first) commits a gang of itself and
  is then voted out by the others, with the JAX controller as with the
  port's on the same fake-clock schedule (the reference's behavior, kept
  by the port's controller); the port's supervisor holds a peer whose
  transport answers as alive until its first heartbeat, for at most
  ``startup_grace_sec`` (the measured skew, doubled, plus 3 x the
  suspicion); a dead one still ages out, and one that answers but never
  heartbeats is voted out 3 x the suspicion after the window.
- ``install_distrib`` arms the async mode (``BLUEFOG_TPU_ASYNC``) as the
  JAX package's does.
- The opt-in straggler rule is the reference's: on steps much shorter
  than the heartbeat, peers in lockstep read as stragglers in both
  packages alike (a fault shared with the reference); a grant of a remote
  mutex goes only to a requester in the committed view.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

from bluefog_tpu.ops import membership as JM
from bluefog_tpu_torch.ops import membership as TM
from bluefog_tpu_torch.ops import transport as T
from bluefog_tpu_torch.utils import config

NOTE_BOUND = 0.25          # seconds from the heartbeat's send to its note
FOLD_SEC = 2.0             # the busy drain's fold of the row
ROW_BYTES = 64 << 20


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_heartbeat_reaches_membership_past_a_busy_drain(native):
    """A 64 MB row is in the receiver's drain (its fold takes 2 s) when
    the peer's heartbeat, sent behind it on the same FIFO, arrives: the
    controller notes it within ``NOTE_BOUND``."""
    folding = threading.Event()

    def slow_data(*a):
        folding.set()
        time.sleep(FOLD_SEC)

    def apply(op, name, src, dst, weight, p_weight, payload):
        if (op & ~T.OP_FLAG_MASK) == T.OP_MEMBER:
            TM.handle_wire(payload)
        else:
            slow_data()

    ctrl = TM.MembershipController(2, 0, {0: 0, 1: 1},
                                   send_fn=lambda p, b: None,
                                   suspect_sec=0.5)
    TM.install(ctrl)
    with config.override(win_native=native):
        server = T.WindowTransport(apply, apply_items=slow_data,
                                   apply_batch=slow_data)
        client = T.WindowTransport(lambda *a: None)
    try:
        assert server.native_path is native
        row = np.ones(ROW_BYTES // 4, np.float32)
        client.send("127.0.0.1", server.port, T.OP_PUT, "w", 1, 0, 1.0, row)
        client.flush(timeout=60.0)
        assert folding.wait(timeout=60.0)
        heard0 = ctrl.last_seen[1]
        hb = json.dumps({"k": "hb", "proc": 1, "epoch": 0, "step": 3,
                         "active": [0, 1], "prop": None}).encode()
        t_send = time.monotonic()
        client.send("127.0.0.1", server.port, T.OP_MEMBER, "", 1, -1, 0.0,
                    np.frombuffer(hb, np.uint8))
        deadline = t_send + FOLD_SEC
        while ctrl.last_seen[1] == heard0 and time.monotonic() < deadline:
            time.sleep(0.002)
        noted = ctrl.last_seen[1]
        assert noted != heard0, "the heartbeat waited for the fold"
        assert noted - t_send < NOTE_BOUND, noted - t_send
        assert ctrl.peer_step[1] == 3
        (read, popped), = server.member_rx[1]
        assert t_send <= read <= popped <= noted
    finally:
        TM.install(None)
        client.stop()
        server.stop()


class _Router:
    """In-memory wire among fake-clock controllers; a process's messages
    reach only the controllers that exist (a process whose supervisor has
    not started drops membership frames)."""

    def __init__(self, mod, n, starts, clock):
        self.mod, self.n, self.starts, self.clock = mod, n, starts, clock
        self.ctrls = {}

    def start_due(self):
        for p, t0 in self.starts.items():
            if p not in self.ctrls and self.clock[0] >= t0:
                self.ctrls[p] = self.mod.MembershipController(
                    self.n, p, {r: r for r in range(self.n)},
                    send_fn=lambda q, b, p=p: self.deliver(q, b),
                    probe_fn=lambda q: True,
                    now_fn=lambda: self.clock[0], suspect_sec=0.5)

    def deliver(self, q, payload):
        c = self.ctrls.get(q)
        if c is not None:
            c.on_message(json.loads(payload))


def _late_starter_schedule(mod):
    """Process 3's supervisor starts at t=0, processes 0-2 at t=1.8 s;
    every started controller ticks each 80 ms (the chaos demo's
    heartbeat) to t=4 s.  Each process's (epoch, active, evicted)."""
    clock = [0.0]
    r = _Router(mod, 4, {3: 0.0, 0: 1.8, 1: 1.8, 2: 1.8}, clock)
    while clock[0] <= 4.0:
        r.start_due()
        for p in sorted(r.ctrls):
            r.ctrls[p].tick()
        clock[0] = round(clock[0] + 0.08, 6)
    return {p: (c.epoch, sorted(c.active), c.evicted)
            for p, c in sorted(r.ctrls.items())}


def test_late_starter_is_voted_out_by_both_controllers():
    """The reference's behavior on a start-up skew of 3 x the suspicion,
    held by the port's controller: process 3 heard nobody for 1.5 s and
    committed a gang of itself; the others, starting, committed epoch 1
    without it, and it was voted out, alive."""
    port = _late_starter_schedule(TM)
    assert port == _late_starter_schedule(JM)
    assert port == {0: (1, [0, 1, 2], False), 1: (1, [0, 1, 2], False),
                    2: (1, [0, 1, 2], False), 3: (1, [3], True)}


class _FakeTransport:
    n_stripes = 1

    def send(self, *a, **kw):
        pass

    def set_partition(self, addrs):
        pass

    def set_send_delay(self, sec):
        pass


@pytest.fixture
def supervisor(monkeypatch):
    """A churn supervisor of process 0 in a gang of 4 over a fake
    transport, its heartbeat thread idle, on a fake clock."""
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.run import supervisor as S
    monkeypatch.setenv("BLUEFOG_TPU_CHURN", "1")
    monkeypatch.setenv("BLUEFOG_TPU_CHURN_HEARTBEAT_MS", "100000")
    monkeypatch.setenv("BLUEFOG_TPU_CHURN_SUSPECT_MS", "500")
    config.reload()
    bf.init(4, device="cpu")
    W._store.distrib = types.SimpleNamespace(
        transport=_FakeTransport(), rank_owner={r: r for r in range(4)},
        proc_addr={p: ("127.0.0.1", 1 + p) for p in range(4)}, my_proc=0,
        my_rank=0)
    sup = S.ChurnSupervisor()
    clock = [0.0]
    sup.ctrl.now_fn = lambda: clock[0]
    sup.ctrl.last_seen = {p: 0.0 for p in (1, 2, 3)}
    sup._started = 0.0
    sup._grace_until = S.startup_grace_sec(sup.ctrl.suspect_sec)
    try:
        yield sup, clock, S
    finally:
        sup.stop()
        W._store.distrib = None
        bf.shutdown()
        monkeypatch.delenv("BLUEFOG_TPU_CHURN")
        config.reload()


def _rounds(sup, clock, until, beating=()):
    """Heartbeat rounds every 80 ms to ``until``, each after a heartbeat
    from every process of ``beating``."""
    while clock[0] < until:
        for p in beating:
            sup.ctrl.on_message({"k": "hb", "proc": p, "epoch": 0,
                                 "step": 1, "active": [0, 1, 2, 3],
                                 "prop": None})
        sup._round()
        clock[0] = round(clock[0] + 0.08, 6)


def test_startup_window_keeps_a_late_starter(supervisor):
    """Peers 1 and 3 answer the probe but have not heartbeated yet (their
    supervisors start later), peer 2 is dead: 2 is proposed out at once,
    1 and 3 are not, and no view commits; 3, still silent after the
    window, is then suspected as a wedged process."""
    sup, clock, S = supervisor
    sup._probe = lambda p: p != 2
    _rounds(sup, clock, 2.0)
    ctrl = sup.ctrl
    assert (ctrl.epoch, ctrl.evicted) == (0, False)
    assert ctrl.proposals[0][1] == frozenset({0, 1, 3})
    _rounds(sup, clock, 2.5, beating=(1,))
    assert 1 not in sup._unheard and 3 in sup._unheard
    assert ctrl.proposals[0][1] == frozenset({0, 1, 3})
    assert sup.startup_heard == {1: 2.0}
    # Past the window, a peer that answers but never heartbeats is wedged.
    grace = S.startup_grace_sec(0.5)
    clock[0] = grace + 0.5
    _rounds(sup, clock, grace + 2.5, beating=(1,))
    assert not sup._unheard
    assert ctrl.proposals[0][1] == frozenset({0, 1})
    assert (ctrl.epoch, ctrl.evicted) == (0, False)


def test_startup_window_votes_out_a_silent_listener_in_bound(supervisor):
    """Peer 3's listener answers the probe but it never heartbeats (wedged
    before its first heartbeat); peers 1 and 2 heartbeat and propose what
    process 0 proposes.  3 stays in every proposal through the start-up
    window, and the gang commits without it within 3 x the suspicion
    after the window's end, one heartbeat round allowed."""
    sup, clock, S = supervisor
    sup._probe = lambda p: True
    ctrl = sup.ctrl
    grace = S.startup_grace_sec(0.5)
    assert grace == S.STARTUP_SKEW_SEC + 1.5 < 10.0
    committed = None
    while clock[0] < grace + 5.0 and committed is None:
        own = ctrl.proposals.get(0)
        for p in (1, 2):
            ctrl.on_message({"k": "hb", "proc": p, "epoch": ctrl.epoch,
                             "step": 1, "active": sorted(ctrl.active),
                             "prop": None if own is None
                             else sorted(own[1])})
        sup._round()
        if clock[0] < grace:
            own = ctrl.proposals.get(0)
            assert (own is None or 3 in own[1]) and ctrl.epoch == 0
        if ctrl.epoch == 1:
            committed = clock[0]
        clock[0] = round(clock[0] + 0.08, 6)
    assert committed is not None
    assert grace < committed <= grace + 3 * 0.5 + 0.08, committed
    assert sorted(ctrl.active) == [0, 1, 2] and not ctrl.evicted


def test_install_distrib_arms_the_async_mode_as_jax(monkeypatch):
    """``BLUEFOG_TPU_ASYNC=1``: installing the transport's rank directory
    arms the async mode in both packages (raw window gossip is aged and
    folded without an optimizer), and leaves it off without the knob."""
    from bluefog_tpu.ops import window as JW
    from bluefog_tpu.utils import config as jconfig
    from bluefog_tpu_torch.ops import window as W
    armed = {}
    try:
        for knob in ("1", "0"):
            monkeypatch.setenv("BLUEFOG_TPU_ASYNC", knob)
            config.reload()
            jconfig.reload()
            for name, mod in (("port", W), ("jax", JW)):
                mod.configure_async(False)
                mod.install_distrib(_FakeTransport(), {0: 0, 1: 1},
                                    {0: ("h", 1), 1: ("h", 2)}, 0)
                armed[(name, knob)] = mod.async_armed()
                mod._store.distrib = None
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_ASYNC")
        config.reload()
        jconfig.reload()
        W.configure_async(False)
        JW.configure_async(False)
    assert armed == {("port", "1"): True, ("jax", "1"): True,
                     ("port", "0"): False, ("jax", "0"): False}


class _GrantTransport(_FakeTransport):
    def __init__(self):
        self.sent = []

    def send(self, host, port, op, name, src, dst, weight, payload, *a,
             **kw):
        self.sent.append((port, op & ~T.OP_FLAG_MASK, src, dst))

    def error_token(self, addrs):
        return 0

    def flush(self, timeout=None, addrs=None, since=None):
        pass


@pytest.mark.parametrize("in_view", [True, False], ids=["member", "removed"])
def test_mutex_grant_only_to_a_requester_in_the_view(in_view):
    """Process 0 owns rank 0; process 1 asks for its mutex.  In the
    committed view, 1 gets the grant and holds the mutex until its
    release; voted out (alive: its release never comes), it gets no grant
    and the mutex stays free for the survivors."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    bf.init(2, device="cpu")
    W.win_create(torch.zeros(2, 4), "m")
    tr = _GrantTransport()
    ctrl = TM.MembershipController(2, 0, {0: 0, 1: 1},
                                   send_fn=lambda p, b: None,
                                   active={0, 1} if in_view else {0})
    TM.install(ctrl)
    W._store.distrib = W._Distrib(tr, {0: 0, 1: 1},
                                  {0: ("127.0.0.1", 1), 1: ("127.0.0.1", 2)},
                                  0)
    try:
        t = threading.Thread(target=W._hold_mutex_for_remote,
                             args=("m", 0, 1), daemon=True)
        t.start()
        t.join(timeout=0.5)
        win = W._store.get("m")
        if in_view:
            assert t.is_alive() and tr.sent == [(2, T.OP_MUTEX_GRANT, 1, 0)]
            assert not win.mutexes[0].acquire(blocking=False)
            W._release_remote_holds([1])
            t.join(timeout=5)
        else:
            assert tr.sent == []
        assert not t.is_alive()
        assert win.mutexes[0].acquire(blocking=False)
        win.mutexes[0].release()
    finally:
        TM.install(None)
        W._store.distrib = None
        bf.shutdown()


def _lockstep_fast_steps(mod, steps_per_round=16):
    """4 controllers in lockstep, each stepping ``steps_per_round`` steps
    (5 ms steps under 80 ms heartbeats, as the chaos delay leg's sync
    gang on a fast host) with straggler eviction armed at 10 steps.  Each
    process's (epoch, active, evicted) after 2 s."""
    clock = [0.0]
    r = _Router(mod, 4, {p: 0.0 for p in range(4)}, clock)
    r.start_due()
    for c in r.ctrls.values():
        c.straggler_steps = 10
    rnd = 0
    while clock[0] <= 2.0:
        for p in sorted(r.ctrls):
            r.ctrls[p].note_step(rnd * steps_per_round)
            r.ctrls[p].tick()
        rnd += 1
        clock[0] = round(clock[0] + 0.08, 6)
    return {p: (c.epoch, sorted(c.active), c.evicted)
            for p, c in sorted(r.ctrls.items())}


def test_lockstep_fast_steps_straggler_votes_equal_jax():
    """A fault shared with the reference, held equal: the straggler rule
    reads a peer's lag against this process's step at its tick, so peers
    in lockstep look 16 steps behind between heartbeats, and process 0,
    ticking first, votes the others out; the port's controller does as
    the JAX one does."""
    port = _lockstep_fast_steps(TM)
    assert port == _lockstep_fast_steps(JM)
    assert port == {
        0: (1, [0], False), 1: (0, [0, 1, 2, 3], True),
        2: (0, [0, 1, 2, 3], True), 3: (0, [0, 1, 2, 3], True)}


@pytest.mark.parametrize("native", [True, False], ids=["plan", "python"])
def test_send_delay_holds_each_data_enqueue_never_a_heartbeat(monkeypatch,
                                                              native):
    """The chaos link delay on the put's own path: with the native sender
    a put plan's run sleeps it before each remote edge's enqueue (in
    ``bf_wintx_send``, which a Python ``send`` reaches too); with the
    Python sender ``send`` sleeps it.  A heartbeat is never delayed."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.ops import xlaffi
    from bluefog_tpu_torch.utils import telemetry
    n, delay = 8, 0.02
    for k, v in (("BLUEFOG_TPU_WIN_COALESCE", "1"),
                 ("BLUEFOG_TPU_WIN_NATIVE", "1" if native else "0"),
                 ("BLUEFOG_TPU_WIN_XLA", "1" if native else "0")):
        monkeypatch.setenv(k, v)
    config.reload()
    xlaffi._reset_for_tests()
    telemetry.reset()
    bf.init(n, device="cpu", topology_fn=lambda: topology.RingGraph(n))
    got = threading.Semaphore(0)
    server = T.WindowTransport(lambda *a: got.release(),
                               apply_batch=lambda m: [got.release()
                                                      for _ in m],
                               apply_items=lambda it: [got.release()
                                                       for _ in it])
    client = T.WindowTransport(lambda *a: None)
    saved = W._store.distrib
    try:
        assert client.native_path is native
        assert bf.win_create(torch.zeros(n, 6), "dl", zero_init=True)
        W._store.distrib = W._Distrib(
            client, rank_owner={r: r % 2 for r in range(n)},
            proc_addr={0: ("127.0.0.1", 1),
                       1: ("127.0.0.1", server.port)}, my_proc=0)
        client.set_send_delay(delay)
        t0 = time.monotonic()
        W.win_put(torch.ones(n, 6), "dl", require_mutex=False)
        put_s = time.monotonic() - t0
        # The ring's 8 remote edges from the even ranks, each delayed.
        assert put_s >= n * delay, put_s
        plans = telemetry.snapshot().get("bf_win_xla_puts_total", 0.0)
        assert plans == (n if native else 0.0)
        hb = np.frombuffer(b'{"k": "hb"}', np.uint8)
        t0 = time.monotonic()
        for _ in range(4):
            client.send("127.0.0.1", server.port, T.OP_MEMBER, "", 0, -1,
                        0.0, hb)
        assert time.monotonic() - t0 < delay
        client.set_send_delay(0.0)
        t0 = time.monotonic()
        W.win_put(torch.ones(n, 6), "dl", require_mutex=False)
        assert time.monotonic() - t0 < n * delay
    finally:
        W._store.distrib = saved
        bf.win_free("dl")
        client.stop()
        server.stop()
        bf.shutdown()
        for k in ("BLUEFOG_TPU_WIN_COALESCE", "BLUEFOG_TPU_WIN_NATIVE",
                  "BLUEFOG_TPU_WIN_XLA"):
            monkeypatch.delenv(k)
        config.reload()
        xlaffi._reset_for_tests()
