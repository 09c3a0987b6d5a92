"""The port's membership consensus against the JAX package's.

``ops/membership.py`` is host logic: a JAX and a port
``MembershipController`` gang, fed the same message sequence on the same
fake clock, must send byte-identical heartbeat payloads (the JSON key
order and float formatting are the wire) and commit the same views, in
every scenario of the JAX package's own tests: two sequential failures, a
silent but reachable peer, straggler eviction opt-in, withdrawn
proposals, divergent views, joins, epoch-ahead adoption and the joiner's
rebase, and a seeded property run of interleaved joins and kills over
lossy links.  ``survivor_topology`` is bitwise the JAX one.  Then the
registry, the wire entry point, the telemetry and ``/healthz`` block.
Tolerance: exact throughout.
"""

import json
import random

import numpy as np
import pytest

from bluefog_tpu import topology as JTOPO
from bluefog_tpu.ops import membership as JM
from bluefog_tpu.utils import telemetry as JT
from bluefog_tpu_torch import topology as TTOPO
from bluefog_tpu_torch.ops import membership as TM
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import telemetry as TT


@pytest.fixture(autouse=True)
def _clean():
    yield
    for m in (JM, TM):
        m.install(None)
    TT.reset()
    JT.reset()
    tconfig.reload()


class _Gang:
    """``n`` controllers of module ``M`` on a fake clock behind an
    in-memory router that records every payload sent (sender, receiver,
    bytes), with losable links, a scriptable probe and mid-run joiners."""

    def __init__(self, M, n, suspect_sec=1.0, straggler_steps=0,
                 drop_prob=0.0, seed=None):
        self.M = M
        self.n = n
        self.suspect_sec = suspect_sec
        self.clock = 0.0
        self.dead = set()
        self.mute = set()
        self.drop_prob = drop_prob
        self.rng = random.Random(seed) if seed is not None else None
        self.log = []
        self.ctrls = {}
        for p in range(n):
            self.ctrls[p] = M.MembershipController(
                n, p, {r: r for r in range(n)}, send_fn=self._send_from(p),
                probe_fn=lambda q: q not in self.dead,
                now_fn=lambda: self.clock, suspect_sec=suspect_sec,
                straggler_steps=straggler_steps)

    def _send_from(self, p):
        def send(q, payload):
            self.log.append((p, q, bytes(payload)))
            if p in self.mute:
                return
            if self.rng is not None and self.rng.random() < self.drop_prob:
                return
            if q not in self.dead and q in self.ctrls:
                self.ctrls[q].on_message(json.loads(payload.decode()))
        return send

    def add_joiner(self, ranks, grantor):
        p = max(self.ctrls) + 1
        base = self.ctrls[grantor]
        self.ctrls[p] = self.M.MembershipController(
            self.n, p, dict(base.rank_owner), send_fn=self._send_from(p),
            probe_fn=lambda q: q not in self.dead,
            now_fn=lambda: self.clock, suspect_sec=self.suspect_sec,
            active=tuple(base.active), epoch=base.epoch, joining=True,
            my_join_ranks=tuple(ranks), my_endpoint=f"j:{p}")
        base.note_join(p, tuple(ranks), f"j:{p}")
        return p

    def run(self, seconds, dt=0.25, step_of=None):
        t = 0.0
        while t < seconds:
            self.clock += dt
            t += dt
            for p, c in self.ctrls.items():
                if p not in self.dead:
                    if step_of is not None:
                        c.note_step(step_of(p))
                    c.tick()

    def transcript(self):
        """Everything observable: the payloads, each controller's views
        (drained), state and summary (less the wall-clock stamp)."""
        out = {"log": self.log, "ctrls": {}}
        for p, c in sorted(self.ctrls.items()):
            views = []
            while True:
                v = c.poll_change()
                if v is None:
                    break
                views.append((v.epoch, v.active_procs, v.active_ranks,
                              v.removed_procs, v.removed_ranks, v.evicted,
                              v.added_procs, v.added_ranks,
                              sorted(v.added_endpoints.items()), repr(v)))
            s = c.summary()
            s.pop("last_change_unix")
            out["ctrls"][p] = {
                "views": views, "epoch": c.epoch,
                "active": sorted(c.active), "evicted": c.evicted,
                "joining": c.joining, "owner": sorted(c.rank_owner.items()),
                "summary": s}
        return out


def sc_two_sequential_failures(M):
    g = _Gang(M, 5)
    g.run(1.0)
    g.dead.add(4)
    g.run(5.0)
    g.dead.add(3)
    g.run(5.0)
    assert all(c.epoch == 2 for p, c in g.ctrls.items() if p < 3)
    return g.transcript()


def sc_silent_but_reachable(M):
    g = _Gang(M, 3)
    g.run(1.0)
    g.mute.add(2)        # heartbeats lost, listener still answers
    g.run(2.0)
    assert all(c.epoch == 0 for c in g.ctrls.values())
    g.run(3.0)
    assert g.ctrls[0].epoch == 1
    return g.transcript()


def sc_straggler(M, steps):
    g = _Gang(M, 3, straggler_steps=steps)
    clock = {"s": 0}

    def step_of(p):
        return 3 if p == 2 else clock["s"]
    for s in range(40):
        clock["s"] = s
        g.run(0.25, step_of=step_of)
    return g.transcript()


def sc_withdrawn_proposal(M):
    clock = [0.0]
    sent = []
    ctrl = M.MembershipController(
        4, 0, {r: r for r in range(4)},
        send_fn=lambda q, p: sent.append((q, bytes(p))),
        probe_fn=lambda q: q != 3, now_fn=lambda: clock[0],
        suspect_sec=1.0)

    def hb(proc, prop):
        ctrl.on_message({"k": "hb", "proc": proc, "epoch": 0, "step": 0,
                         "active": [0, 1, 2, 3], "prop": prop})
    hb(1, [0, 1, 2])
    hb(2, [0, 1, 2])
    hb(1, None)
    hb(2, None)
    clock[0] += 2.0
    hb(1, None)
    hb(2, None)
    ctrl.tick()
    assert ctrl.epoch == 0
    hb(1, [0, 1, 2])
    hb(2, [0, 1, 2])
    ctrl.tick()
    assert ctrl.epoch == 1
    return sent, ctrl.view().active_ranks, ctrl.poll_change().removed_ranks


def sc_divergent_views(M):
    out = []
    for my in (0, 2):
        sent = []
        c = M.MembershipController(
            4, my, {r: r for r in range(4)},
            send_fn=lambda q, p: sent.append((q, bytes(p))),
            probe_fn=lambda q: True, now_fn=lambda: 0.0)
        c.epoch = 1
        c.active = frozenset({0, 1, 2})
        c.on_message({"k": "hb", "proc": 1, "epoch": 1, "step": 0,
                      "active": [0, 1], "prop": None})
        c.tick()
        v = c.poll_change()
        out.append((c.epoch, sorted(c.active), c.evicted, sent,
                    None if v is None else repr(v)))
    assert out[1][2]     # the rank outside the intersection is evicted
    return out


def sc_superset_views(M):
    def mk(my):
        return M.MembershipController(
            4, my, {r: r for r in range(4)}, send_fn=lambda q, p: None,
            probe_fn=lambda q: True, now_fn=lambda: 0.0)
    a = mk(0)
    a.epoch, a.active = 2, frozenset({0, 1, 3})
    a.on_message({"k": "hb", "proc": 1, "epoch": 2, "step": 0,
                  "active": [0, 1, 3, 4], "prop": None, "joined": [4],
                  "joined_ranks": {"4": [2]}, "joined_eps": {"4": "j:4"}})
    b = mk(1)
    b.epoch, b.active = 2, frozenset({0, 1, 3, 4})
    b.joined_at_epoch = frozenset({4})
    b.joined_info[4] = ((2,), "j:4")
    b.rank_owner[2] = 4
    b.on_message({"k": "hb", "proc": 0, "epoch": 2, "step": 0,
                  "active": [0, 1, 3], "prop": None})
    return ([sorted(a.active), a.rank_owner[2], repr(a.poll_change()),
             a._payload(None)],
            [sorted(b.active), b._payload(frozenset({0, 1}))])


def sc_join(M):
    g = _Gang(M, 4)
    g.dead.add(2)
    g.run(5.0)
    j = g.add_joiner([2], grantor=0)
    g.run(3.0)
    assert all(c.epoch == 2 for p, c in g.ctrls.items() if p != 2)
    assert g.ctrls[0].rank_owner[2] == j
    return g.transcript()


def sc_epoch_ahead(M):
    g = _Gang(M, 4)
    g.ctrls[1].on_message({"k": "hb", "proc": 0, "epoch": 3, "step": 0,
                           "active": [0, 1], "prop": None})
    g.ctrls[2].on_message({"k": "hb", "proc": 0, "epoch": 2, "step": 0,
                           "active": [0, 1], "prop": None})
    c = M.MembershipController(4, 3, {r: r for r in range(4)},
                               send_fn=lambda q, p: None)
    c.on_message({"k": "hb", "proc": 0, "epoch": 2, "step": 0,
                  "active": [0, 1, 3, 4], "prop": None, "joined": [4],
                  "joined_ranks": {"4": [2]},
                  "joined_eps": {"4": "10.0.0.9:7001"}})
    assert g.ctrls[2].evicted and not g.ctrls[1].evicted
    return (g.transcript(), c.epoch, sorted(c.rank_owner.items()),
            c.view().active_ranks, c.peer_endpoint_hint(4))


def sc_joiner_rebase(M):
    g = _Gang(M, 4)
    g.dead.add(3)
    g.run(5.0)
    j = g.add_joiner([3], grantor=0)
    g.dead.add(2)
    g.run(5.0)
    assert not g.ctrls[j].evicted and not g.ctrls[j].joining
    return g.transcript()


def sc_interleaved(M, seed):
    rng = random.Random(seed)
    g = _Gang(M, 4, drop_prob=0.15, seed=seed + 1000)
    g.run(1.0)
    victim = rng.choice([1, 2, 3])
    g.dead.add(victim)
    g.run(rng.choice([0.25, 1.5, 3.0, 6.0]))
    grantor = rng.choice(sorted(set(g.ctrls) - g.dead))
    g.add_joiner([victim], grantor=grantor)
    g.run(14.0)
    alive = [c for p, c in g.ctrls.items()
             if p not in g.dead and not c.evicted]
    assert len({(c.epoch, c.active) for c in alive}) == 1
    return g.transcript()


def sc_note_join_and_expiry(M):
    clock = [0.0]
    ctrl = M.MembershipController(
        4, 0, {r: r for r in range(4)}, send_fn=lambda q, p: None,
        probe_fn=lambda q: True, now_fn=lambda: clock[0],
        active=(0, 1, 3), epoch=1, suspect_sec=1.0)
    ctrl.note_join(4, (2,), "h:9")
    ctrl.note_join(5, (2,), "h:10")       # collides: ignored
    ctrl.note_join(6, (1,), "h:11")       # a live rank: ignored
    ctrl.note_join(0, (2,), "h:12")       # already active
    before = (sorted(ctrl.pending_joins), ctrl.peer_endpoint_hint(4),
              ctrl._payload(ctrl.proposals.get(0, (0, None))[1]))
    clock[0] = 5.0
    ctrl.tick()
    return before, sorted(ctrl.pending_joins), ctrl.summary()["epoch"]


SCENARIOS = {
    "two_sequential_failures": sc_two_sequential_failures,
    "silent_but_reachable": sc_silent_but_reachable,
    "straggler_off": lambda M: sc_straggler(M, 0),
    "straggler_on": lambda M: sc_straggler(M, 10),
    "withdrawn_proposal": sc_withdrawn_proposal,
    "divergent_views": sc_divergent_views,
    "superset_views": sc_superset_views,
    "join": sc_join,
    "epoch_ahead": sc_epoch_ahead,
    "joiner_rebase": sc_joiner_rebase,
    "note_join_and_expiry": sc_note_join_and_expiry,
    **{f"interleaved_{s}": (lambda M, s=s: sc_interleaved(M, s))
       for s in range(6)},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name):
    """Byte-identical payloads, identical views and state."""
    jax_out = SCENARIOS[name](JM)
    port_out = SCENARIOS[name](TM)
    assert port_out == jax_out


def test_straggler_opt_in_evicts_and_off_does_not():
    off = sc_straggler(TM, 0)
    on = sc_straggler(TM, 10)
    assert all(c["epoch"] == 0 for c in off["ctrls"].values())
    assert on["ctrls"][0]["active"] == [0, 1]
    assert on["ctrls"][2]["evicted"]


def test_heartbeats_without_joins_are_the_legacy_bytes():
    for M in (JM, TM):
        c = M.MembershipController(3, 1, {r: r for r in range(3)},
                                   send_fn=lambda q, p: None)
        c.my_step = 7
        assert c._payload(None) == json.dumps(
            {"k": "hb", "proc": 1, "epoch": 0, "step": 7,
             "active": [0, 1, 2], "prop": None}).encode()
        assert c._payload(frozenset({1, 0})) == (
            b'{"k": "hb", "proc": 1, "epoch": 0, "step": 7, '
            b'"active": [0, 1, 2], "prop": [0, 1]}')


@pytest.mark.parametrize("n,active,builder", [
    (8, [0, 2, 3, 5, 6], None), (4, [0, 1, 2], None), (4, [1, 3], None),
    (6, [0, 1, 2, 3, 4, 5], None), (8, [0, 1, 2, 4, 6, 7], "ring"),
    (5, [4], None), (16, list(range(0, 16, 3)), "exp2"),
])
def test_survivor_topology_is_bitwise_jax(n, active, builder):
    jb = {None: None, "ring": JTOPO.RingGraph,
          "exp2": JTOPO.ExponentialTwoGraph}[builder]
    tb = {None: None, "ring": TTOPO.RingGraph,
          "exp2": TTOPO.ExponentialTwoGraph}[builder]
    jt = JM.survivor_topology(n, active, builder=jb)
    tt = TM.survivor_topology(n, active, builder=tb)
    assert sorted(tt.nodes) == sorted(jt.nodes)
    assert sorted(tt.edges(data=True)) == sorted(jt.edges(data=True))
    wj, wt = JTOPO.weight_matrix(jt), TTOPO.weight_matrix(tt)
    assert wt.tobytes() == wj.tobytes()
    np.testing.assert_allclose(wt.sum(axis=0), 1.0)
    np.testing.assert_allclose(wt.sum(axis=1), 1.0)
    for dead in set(range(n)) - set(active):
        assert wt[dead, dead] == 1.0 and np.count_nonzero(wt[dead]) == 1


@pytest.mark.parametrize("bad", [[], [0, 0, 1], [0, 9], [-1, 2]])
def test_survivor_topology_rejects_as_jax(bad):
    with pytest.raises(ValueError) as jerr:
        JM.survivor_topology(4, bad)
    with pytest.raises(ValueError) as terr:
        TM.survivor_topology(4, bad)
    assert str(terr.value) == str(jerr.value)


def test_handle_wire_and_registry():
    TM.handle_wire(b"not json")           # no controller: dropped
    g = _Gang(TM, 2)
    TM.install(g.ctrls[0])
    assert TM.current() is g.ctrls[0]
    TM.handle_wire(b"\xff\xfe not json")  # undecodable: dropped
    TM.handle_wire(json.dumps({"k": "hb", "proc": 1, "epoch": 0, "step": 7,
                               "active": [0, 1], "prop": None}).encode())
    assert g.ctrls[0].peer_step[1] == 7


def test_window_routes_member_frames_to_the_controller():
    """``OP_MEMBER`` reaches ``membership.handle_wire`` through the window
    store's drain entry, before any directory (none exists here)."""
    from bluefog_tpu_torch.ops import transport as T
    from bluefog_tpu_torch.ops import window as W
    g = _Gang(TM, 2)
    TM.install(g.ctrls[0])
    W._apply_inbound(T.OP_MEMBER, "", 1, -1, 0.0, 0.0, memoryview(
        json.dumps({"k": "hb", "proc": 1, "epoch": 0, "step": 9,
                    "active": [0, 1], "prop": None}).encode()))
    assert g.ctrls[0].peer_step[1] == 9
    assert W._store.preinit_msgs == []


def test_commit_publishes_telemetry_and_health_block():
    """The installed controller's commit sets the JAX package's gauges
    (``bf_active_ranks``, ``bf_membership_epoch``) and counters, and
    ``/healthz`` carries the ``membership`` block (absent without one)."""
    assert "membership" not in TT.health()
    g = _Gang(TM, 4)
    TM.install(g.ctrls[0])
    assert TT.health()["membership"]["epoch"] == 0
    g.dead.add(2)
    g.run(5.0)
    snap = TT.snapshot()
    assert snap.get("bf_membership_changes_total") == 1.0
    assert snap.get("bf_active_ranks") == 3.0
    assert snap.get("bf_membership_epoch") == 1.0
    assert snap.get("bf_churn_last_change_timestamp", 0) > 0
    m = TT.health()["membership"]
    assert m["epoch"] == 1 and m["active_ranks"] == [0, 1, 3]
    import bluefog_tpu_torch as bf
    assert bf.membership_info()["epoch"] == 1


def test_bench_churn_block_equals_jax(monkeypatch):
    """The port bench's ``churn`` block, as the root ``bench.py``'s
    ``_churn_summary``: the stub with churn off, the installed
    controller's view with it on."""
    import importlib.util
    from pathlib import Path

    from bluefog_tpu.utils import config as jconfig
    from bluefog_tpu_torch import bench
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  root / "bench.py")
    rb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rb)
    monkeypatch.delenv("BLUEFOG_TPU_CHURN", raising=False)
    jconfig.reload()
    tconfig.reload()
    assert bench._churn_summary() == rb._churn_summary() == \
        {"enabled": False}
    monkeypatch.setenv("BLUEFOG_TPU_CHURN", "1")
    jconfig.reload()
    tconfig.reload()
    try:
        assert bench._churn_summary() == rb._churn_summary()
        gangs = [_Gang(M, 3) for M in (JM, TM)]
        for g, M in zip(gangs, (JM, TM)):
            M.install(g.ctrls[0])
            g.dead.add(2)
            g.run(5.0)
        jb, tb = rb._churn_summary(), bench._churn_summary()
        assert tb["epoch"] == 1 and tb["active_ranks"] == [0, 1]
        assert {k: v for k, v in tb.items() if k != "last_change_unix"} \
            == {k: v for k, v in jb.items() if k != "last_change_unix"}
    finally:
        monkeypatch.delenv("BLUEFOG_TPU_CHURN")
        jconfig.reload()
        tconfig.reload()


# -- The survivors' recovery against the JAX package's -------------------
#
# Both packages' ``ChurnSupervisor._recover`` driven by a fake-clock gang's
# committed view (process 3 killed), over a 4-rank window optimizer in one
# process: the rebuilt windows' staging and versions right after the
# optimizer's post-commit hook, then the first post-commit combine, bit
# for bit in float32.  The gradients are zero, so the base SGD update is
# the identity in both packages and only the windows move the rows.  The
# first combine takes a subset of the edges (``dst_weights`` /
# ``src_weights`` as ``{(rank, peer): w}``), so the slots that no new put
# or get reaches show what the recovery left in them.

RN, RCOLS = 4, 6


class _NoChaos:
    def apply(self, step):
        pass


def _fake_supervisor(sup_mod, W, basics, membership, ctrl):
    """A ``ChurnSupervisor`` over an in-process window store: the gang's
    controller, a rank directory with no endpoints, no heartbeat thread."""
    import threading
    import types
    sup = object.__new__(sup_mod.ChurnSupervisor)
    sup._d = types.SimpleNamespace(
        rank_owner={r: r for r in range(RN)}, proc_addr={},
        transport=types.SimpleNamespace(drop_peer=lambda *a: None))
    sup._W, sup._n, sup._basics = W, RN, basics
    sup._membership, sup._topology_builder = membership, None
    sup._gang, sup.ctrl, sup.chaos = None, ctrl, _NoChaos()
    sup._stop = threading.Event()
    sup.on_change = sup._on_change = None
    sup.last_recovery = None
    sup_mod._singleton = sup
    membership.install(ctrl)
    return sup


def _subset(nbrs, first_only):
    """``{(rank, peer): 1.0}`` for each survivor's first neighbor."""
    return {(r, nb[0]): 1.0 for r, nb in enumerate(nbrs)
            if r < RN - 1 and nb and first_only}


def _window_state(W, names, as_np):
    out = []
    for name in names:
        win = W._store.get(name)
        out.append({
            "staging": {k: as_np(v) for k, v in win.staging.items()},
            "versions": dict(win.versions),
            "main": {r: as_np(win.main[r]) for r in range(RN)}})
    return out


def _jax_recovery(devices, family, rows, pre_steps):
    import jax.numpy as jnp
    import optax

    import bluefog_tpu as jbf
    from bluefog_tpu import basics as jbasics
    from bluefog_tpu.ops import window as JW
    from bluefog_tpu.run import supervisor as jsup
    jbf.init(lambda: JTOPO.ExponentialGraph(RN), devices=devices[:RN])
    cls = {"win_put": "DistributedWinPutOptimizer",
           "pull_get": "DistributedPullGetOptimizer"}[family]
    kw = {"fused": False} if family == "win_put" else {}
    opt = getattr(jbf.optim, cls)(optax.sgd(0.1), **kw)
    params = {"x": jnp.asarray(rows)}
    state = opt.init(params)
    zero = {"x": jnp.zeros_like(params["x"])}
    for _ in range(pre_steps):
        params, state = opt.step(params, zero, state)
    g = _Gang(JM, RN)
    g.dead.add(RN - 1)
    g.run(5.0)
    sup = _fake_supervisor(jsup, JW, jbasics, JM, g.ctrls[0])
    try:
        opt._maybe_churn_step(int(state.step))
        assert opt.membership_change is not None
        names = list(opt._names)
        after = _window_state(JW, names, np.asarray)
        key = "dst_weights" if family == "win_put" else "src_weights"
        nbrs = [JW._store.get(names[0]).out_nbrs[r] if family == "win_put"
                else JW._store.get(names[0]).in_nbrs[r] for r in range(RN)]
        params, state = opt.step(params, zero, state,
                                 **{key: _subset(nbrs, True)})
        first = np.asarray(params["x"])
        opt.free()
    finally:
        jsup._singleton = None
    return after, first, nbrs


def _port_recovery(family, rows, pre_steps):
    import torch

    import bluefog_tpu_torch as tbf
    from bluefog_tpu_torch import basics as tbasics
    from bluefog_tpu_torch.ops import window as TW
    from bluefog_tpu_torch.optim import window_optimizers as TWO
    from bluefog_tpu_torch.run import supervisor as tsup
    tbf.init(RN, device="cpu",
             topology_fn=lambda: TTOPO.ExponentialGraph(RN))
    cls = {"win_put": "DistributedWinPutOptimizer",
           "pull_get": "DistributedPullGetOptimizer"}[family]
    x = torch.tensor(rows, requires_grad=True)
    opt = getattr(TWO, cls)(torch.optim.SGD([x], lr=0.1))
    try:
        for _ in range(pre_steps):
            x.grad = torch.zeros_like(x)
            opt.step()
        g = _Gang(TM, RN)
        g.dead.add(RN - 1)
        g.run(5.0)
        _fake_supervisor(tsup, TW, tbasics, TM, g.ctrls[0])
        opt._maybe_churn_step(opt.step_count)
        assert opt.membership_change is not None
        names = list(opt._names)
        after = _window_state(TW, names, lambda t: t.numpy().copy())
        key = "dst_weights" if family == "win_put" else "src_weights"
        nbrs = [TW._store.get(names[0]).out_nbrs[r] if family == "win_put"
                else TW._store.get(names[0]).in_nbrs[r] for r in range(RN)]
        x.grad = torch.zeros_like(x)
        opt.step(**{key: _subset(nbrs, True)})
        first = x.detach().numpy().copy()
        opt.free()
        return after, first, nbrs
    finally:
        tsup._singleton = None
        tbf.shutdown()


@pytest.mark.parametrize("pre_steps", [1, 3])
@pytest.mark.parametrize("family", ["win_put", "pull_get"])
def test_recovery_staging_and_first_combine_equal_jax(devices, monkeypatch,
                                                       tmp_path, family,
                                                       pre_steps):
    """After a committed view the rebuilt windows' staging is zero and
    their versions 0 in both packages (``bluefog_tpu/run/supervisor.py``
    L312, ``zero_init=True``; the JAX optimizer's ``_maybe_churn_step``
    adds nothing), and every survivor's first post-commit combine equals
    the JAX one bit for bit (float32, exact)."""
    from bluefog_tpu.run import supervisor as jsup
    from bluefog_tpu.utils import config as jconfig
    from bluefog_tpu_torch.run import supervisor as tsup
    monkeypatch.chdir(tmp_path)        # the recovery's flight-recorder dump
    # One process holds the whole gang: the optimizers' step boundary
    # reaches the hand-built supervisor (the module's own refuses without
    # a multi-process transport).
    for m in (jsup, tsup):
        monkeypatch.setattr(m, "maybe_supervisor", lambda m=m: m._singleton)
    monkeypatch.setenv("BLUEFOG_TPU_CHURN", "1")
    jconfig.reload()
    tconfig.reload()
    rows = np.random.RandomState(11).randn(RN, RCOLS).astype(np.float32)
    want_after, want, jnbrs = _jax_recovery(devices, family, rows, pre_steps)
    got_after, got, tnbrs = _port_recovery(family, rows, pre_steps)
    assert jnbrs == tnbrs
    assert len(want_after) == len(got_after) == 1
    w, g = want_after[0], got_after[0]
    assert g["versions"] == w["versions"]
    assert set(w["versions"].values()) == {0}
    assert g["staging"].keys() == w["staging"].keys()
    for k in w["staging"]:
        np.testing.assert_array_equal(g["staging"][k], w["staging"][k],
                                      err_msg=f"staging {k}")
        assert not w["staging"][k].any(), k
    for r in range(RN):
        np.testing.assert_array_equal(g["main"][r], w["main"][r],
                                      err_msg=f"main {r}")
    np.testing.assert_array_equal(got, want)
