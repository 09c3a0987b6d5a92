"""The async window mode (``BLUEFOG_TPU_ASYNC``), its send-side trace tags
and the fastcall send, against the JAX package.

The cases of ``tests/test_async_gossip.py`` that need no telemetry, no
``stall.py`` and no chaos (those are ROADMAP items 21 and 20), each run
through both packages on the same scripted messages and compared bit for
bit: the staging, the stale-residual store, the associated P and the
version counters.

- The knobs: the policy parse and its errors, the trace-sample parse, the
  defaults.
- The policy on the per-message, batched and native-folded commit paths:
  reject, downweight with the wall-clock fallback (the clock pinned),
  untagged messages inheriting their edge's estimate, the mode off being
  inert, mass conservation over a random policy sequence, the store through
  a state-dict round trip (and ``models.convert``'s snapshot conversion
  both ways).
- The optimizers: push-sum with the mode on and an unbounded staleness is
  the lockstep step bit for bit; win_put's async implies overlap; the step
  clock reaches the wire tags.
- The wire: a tagged frame byte for byte the JAX encoder's (both clock
  fields pinned), the mode off leaving the wire and the windows as they
  were, and the fastcall and ctypes sends shipping the same frames.
- Across 2 gloo processes of 2 ranks, on both transport paths, under
  ``reject`` and ``downweight:0.5``: a scripted sequence of tagged
  accumulates whose origin steps are set by hand; every owned slot's
  staging, residual, P and version bit for bit the JAX package's
  ``_apply_inbound`` fed the same messages; after a fence and
  ``win_fold_stale_residuals`` the staging holds exactly what was shipped.

Run as a script, this file is the worker.
"""

import argparse
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import topology as jtopo
from bluefog_tpu.ops import transport as JT
from bluefog_tpu.ops import window as JW
from bluefog_tpu.utils import config as jconfig
from bluefog_tpu.utils import linkobs as jlinkobs
from bluefog_tpu_torch import native as tnative
from bluefog_tpu_torch import topology as ttopo
from bluefog_tpu_torch.models import convert
from bluefog_tpu_torch.ops import transport as TT
from bluefog_tpu_torch.ops import window as TW
from bluefog_tpu_torch.optim import window_optimizers as TWO
from bluefog_tpu_torch.utils import config as tconfig
from bluefog_tpu_torch.utils import linkobs as tlinkobs

ROOT = Path(__file__).resolve().parents[1]
N = 8
JOIN_TIMEOUT = 120
PINNED_NS = 1_700_000_000_123_456_789     # time.time_ns, pinned
PINNED_MONO_NS = 987_654_321_000          # time.monotonic_ns, pinned


def _reset_async():
    for cfg, W, T in ((jconfig, JW, JT), (tconfig, TW, TT)):
        cfg.reload()
        W.configure_async()
        W.clear_async_staleness()
        T.set_trace_origin_step(-1)


@pytest.fixture
def env(monkeypatch):
    """Set knobs for both packages (their configs reload); afterwards the
    knobs go, and both async modes are disarmed and cleared."""
    def set_env(**kv):
        for k, v in kv.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, str(v))
        jconfig.reload()
        tconfig.reload()
    yield set_env
    monkeypatch.undo()
    _reset_async()


class Side:
    """One package behind one interface, with a ring window whose ranks
    are all owned here and a fake process directory, so that
    ``_apply_inbound`` treats messages as transport-applied (the path the
    policy guards)."""

    def __init__(self, name, devices):
        self.name = name
        jax = name == "jax"
        self.bf, self.W, self.T = (jbf, JW, JT) if jax else (tbf, TW, TT)
        self.linkobs = jlinkobs if jax else tlinkobs
        self.devices = devices

    def window(self, n=N, dim=5, graph="RingGraph", owner=None):
        if self.name == "jax":
            jbf.init(lambda: getattr(jtopo, graph)(n),
                     devices=self.devices[:n])
            rows = np.zeros((n, dim), np.float32)
        else:
            tbf.init(n, device="cpu",
                     topology_fn=lambda: getattr(ttopo, graph)(n))
            rows = torch.zeros(n, dim)
        assert self.bf.win_create(rows, "async_w", zero_init=True)
        self.saved = self.W._store.distrib
        owner = owner or {r: 0 for r in range(n)}
        self.W._store.distrib = self.W._Distrib(
            types.SimpleNamespace(), rank_owner=owner,
            proc_addr={p: ("127.0.0.1", 1) for p in set(owner.values())},
            my_proc=0)
        return self.W._store.get("async_w")

    def close(self):
        self.W._store.distrib = self.saved
        # The fake transport's series go with it, as _shutdown_transport
        # retires a real one's: the per-edge contribution ages and the
        # link observatory's edges, which later tests in this process
        # would otherwise read (bfstat's health lines).
        self.W.clear_contribution_age()
        self.linkobs.clear_all()
        self.bf.win_free("async_w")
        self.W.turn_off_win_ops_with_associated_p()
        if self.name == "port":
            tbf.shutdown()

    @staticmethod
    def arr(v):
        return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def state(self, win):
        with win.lock:
            return {
                "staging": {k: self.arr(v).copy()
                            for k, v in win.staging.items()},
                "stale_residual": {k: self.arr(v).copy()
                                   for k, v in win.stale_residual.items()},
                "p_staging": dict(win.p_staging),
                "p_stale_residual": dict(win.p_stale_residual),
                "versions": dict(win.versions)}


def _both(devices, fn):
    out = []
    for name in ("jax", "port"):
        side = Side(name, devices)
        try:
            out.append(fn(side))
        finally:
            side.close()
    return out


def assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a, err_msg=where)
    else:
        assert a == b, where


def _tagged(T, row, src, step, seq=1, unix_us=1):
    return row.tobytes() + T.TRACE_TRAILER.pack(src, seq, 0, unix_us, step)


# ---------------------------------------------------------------------------
# The knobs
# ---------------------------------------------------------------------------

POLICIES = ["reject", "downweight:0.25", "downweight", "downweight:x",
            "downweight:0", "downweight:1.0", "downweight:1.5", "keep", ""]


@pytest.mark.parametrize("value", POLICIES)
def test_staleness_policy_parse_matches_jax(value):
    try:
        want = jconfig.parse_staleness_policy(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.parse_staleness_policy(value)
        assert str(got.value) == str(e)
        return
    assert tconfig.parse_staleness_policy(value) == want


@pytest.mark.parametrize("value", [None, "", "0", "off", "1/4", "3", "-2",
                                   "1/x"])
def test_trace_sample_parse_matches_jax(env, value):
    try:
        env(BLUEFOG_TPU_TRACE_SAMPLE=value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.reload()
        assert str(got.value) == str(e)
        return
    assert tconfig.get().trace_sample == jconfig.get().trace_sample


def test_async_knob_defaults_match_jax(env):
    env(BLUEFOG_TPU_ASYNC=None, BLUEFOG_TPU_ASYNC_STALENESS_STEPS=None,
        BLUEFOG_TPU_ASYNC_STALENESS_POLICY=None,
        BLUEFOG_TPU_ASYNC_COLLECT_EVERY=None, BLUEFOG_TPU_TRACE_SAMPLE=None)
    t, j = tconfig.get(), jconfig.get()
    for field in ("async_mode", "async_staleness_steps",
                  "async_staleness_policy", "async_collect_every",
                  "trace_sample"):
        assert getattr(t, field) == getattr(j, field), field
    assert not TW.configure_async() and TW.async_info() is None
    env(BLUEFOG_TPU_ASYNC="1", BLUEFOG_TPU_ASYNC_STALENESS_STEPS="3",
        BLUEFOG_TPU_ASYNC_STALENESS_POLICY="downweight:0.5",
        BLUEFOG_TPU_ASYNC_COLLECT_EVERY="5")
    assert TW.configure_async() and JW.configure_async()
    TW.set_async_step(4)
    JW.set_async_step(4)
    t_info, j_info = TW.async_info(), JW.async_info()
    for info in (t_info, j_info):
        info.pop("step_period_sec")
    assert t_info == j_info


# ---------------------------------------------------------------------------
# The policy on the three commit paths, both packages, bit for bit
# ---------------------------------------------------------------------------

def _reject_per_message(s):
    """A tagged contribution older than the bound goes whole into the
    store; a fresh one takes the lockstep arithmetic."""
    win = s.window()
    s.W.configure_async()
    s.W.set_async_step(10)
    fresh = np.arange(5, dtype=np.float32) + 1
    stale = np.full(5, 8.0, np.float32)
    s.W._apply_inbound(s.T.OP_ACCUMULATE | s.T.OP_TRACE_FLAG, "async_w", 1,
                       0, 1.0, 0.0, _tagged(s.T, fresh, 1, 9))
    s.W._apply_inbound(s.T.OP_ACCUMULATE | s.T.OP_TRACE_FLAG, "async_w", 1,
                       0, 1.0, 0.0, _tagged(s.T, stale, 1, 2, seq=2))
    st = s.state(win)
    np.testing.assert_array_equal(st["staging"][(0, 1)], fresh)
    np.testing.assert_array_equal(st["stale_residual"][(0, 1)], stale)
    assert s.W._async.peer_step[1] == 9 and s.W.async_step_lag() == -1
    return st


def _downweight_and_wallclock(s):
    """downweight:<alpha> admits alpha; a tag without an origin step ages
    by the wall clock over the step period (pinned: 50 ms at 10 ms a
    step, 5 steps > 2)."""
    win = s.window()
    s.W.configure_async()
    s.W.set_async_step(100)
    with s.W._async.lock:
        s.W._async.step_period = 0.010
    row = np.full(5, 4.0, np.float32)
    old_us = PINNED_NS // 1000 - 50_000
    s.W._apply_inbound(s.T.OP_ACCUMULATE | s.T.OP_TRACE_FLAG, "async_w", 1,
                       0, 0.75, 0.0,
                       _tagged(s.T, row, 1, -1, unix_us=old_us))
    st = s.state(win)
    np.testing.assert_array_equal(st["staging"][(0, 1)], row * 0.75 * 0.5)
    return st


def _unsampled_inherits(s):
    """An untagged message on an edge whose last sample was stale is
    stale too; on a never-sampled edge it is fresh."""
    win = s.window()
    s.W.configure_async()
    s.W.set_async_step(20)
    row = np.ones(5, np.float32)
    acc = s.T.OP_ACCUMULATE
    s.W._apply_inbound(acc, "async_w", 2, 1, 1.0, 0.0, row.tobytes())
    s.W._apply_inbound(acc | s.T.OP_TRACE_FLAG, "async_w", 7, 0, 1.0, 0.0,
                       _tagged(s.T, row, 7, 5))
    s.W._apply_inbound(acc, "async_w", 7, 0, 1.0, 0.0, (row * 7).tobytes())
    return s.state(win)


def _batched_and_native(s):
    """The batched run (a put, then a stale accumulate to the same slot:
    not folded into the put) and a native-folded entry with a stale
    trace."""
    win = s.window()
    s.W.configure_async()
    s.W.set_async_step(50)
    row = np.full(5, 2.0, np.float32)
    s.W._apply_inbound_batch([
        (s.T.OP_PUT, "async_w", 1, 0, 1.0, 0.0, row.tobytes()),
        (s.T.OP_ACCUMULATE | s.T.OP_TRACE_FLAG, "async_w", 1, 0, 1.0, 0.0,
         _tagged(s.T, row, 1, 10)),
        (s.T.OP_ACCUMULATE, "async_w", 3, 2, 0.5, 0.0, row.tobytes()),
        (s.T.OP_ACCUMULATE | s.T.OP_TRACE_FLAG, "async_w", 3, 2, 0.5, 0.0,
         _tagged(s.T, row * 3, 3, 49, seq=2)),
    ])
    s.W._commit_native_run("async_w", [
        ("async_w", False, 2, 1, 0.0, 0, 1, row * 3, row.nbytes,
         (2, 5, 0, 1, 40)),
        ("async_w", True, 4, 5, 0.0, 1, 0, row * 5, row.nbytes, None),
        ("async_w", False, 5, 4, 0.0, 0, 2, row * 6, row.nbytes,
         (5, 6, 0, 1, 50)),
    ])
    st = s.state(win)
    np.testing.assert_array_equal(st["staging"][(0, 1)], row)
    np.testing.assert_array_equal(st["stale_residual"][(1, 2)], row * 3)
    return st


def _async_off_inert(s):
    """The mode off: an arbitrarily old tag is admitted untouched."""
    win = s.window()
    s.W.configure_async()
    row = np.full(5, 3.0, np.float32)
    s.W._apply_inbound(s.T.OP_ACCUMULATE | s.T.OP_TRACE_FLAG, "async_w", 1,
                       0, 1.0, 0.0, _tagged(s.T, row, 1, 0))
    st = s.state(win)
    np.testing.assert_array_equal(st["staging"][(0, 1)], row)
    assert not st["stale_residual"]
    return st


def _mass_conservation(s):
    """A random mix of fresh, rejected and downweighted accumulates:
    staging plus residual is the input mass after every message (value and
    P), and the fold restores it all into staging."""
    win = s.window(dim=4)
    s.W.turn_on_win_ops_with_associated_p()
    s.W.configure_async()
    s.W.set_async_step(1000)
    rng = np.random.RandomState(17)
    key, total, p_total = (0, 1), np.zeros(4), 0.0
    trace = []
    for i in range(40):
        # Powers of two keep the 0.5 splits and the sums exact.
        row = (2.0 ** rng.randint(-2, 3, size=4)).astype(np.float32)
        age = int(rng.randint(0, 12))
        p_w = float(2.0 ** rng.randint(-3, 2))
        s.W._apply_inbound(s.T.OP_ACCUMULATE | s.T.OP_TRACE_FLAG, "async_w",
                           1, 0, 1.0, p_w,
                           _tagged(s.T, row, 1, 1000 - age, seq=i + 1))
        total += row
        p_total += p_w
        st = s.state(win)
        have = st["staging"][key].astype(np.float64) + st[
            "stale_residual"].get(key, np.zeros(4, np.float32))
        np.testing.assert_array_equal(have, total)
        assert st["p_staging"][key] + st["p_stale_residual"].get(
            key, 0.0) == p_total
        trace.append(st)
    assert trace[-1]["stale_residual"], "the policy never fired"
    assert s.W.win_fold_stale_residuals("async_w") == 1
    st = s.state(win)
    np.testing.assert_array_equal(st["staging"][key].astype(np.float64),
                                  total)
    assert st["p_staging"][key] == p_total and not st["stale_residual"]
    return trace + [st]


CASES = {"reject_per_message": _reject_per_message,
         "downweight_and_wallclock": _downweight_and_wallclock,
         "unsampled_inherits": _unsampled_inherits,
         "batched_and_native": _batched_and_native,
         "async_off_inert": _async_off_inert,
         "mass_conservation": _mass_conservation}
CASE_ENV = {
    "reject_per_message": dict(BLUEFOG_TPU_ASYNC="1",
                               BLUEFOG_TPU_ASYNC_STALENESS_STEPS="3"),
    "downweight_and_wallclock": dict(
        BLUEFOG_TPU_ASYNC="1", BLUEFOG_TPU_ASYNC_STALENESS_STEPS="2",
        BLUEFOG_TPU_ASYNC_STALENESS_POLICY="downweight:0.5"),
    "unsampled_inherits": dict(BLUEFOG_TPU_ASYNC="1",
                               BLUEFOG_TPU_ASYNC_STALENESS_STEPS="3"),
    "batched_and_native": dict(BLUEFOG_TPU_ASYNC="1",
                               BLUEFOG_TPU_ASYNC_STALENESS_STEPS="3"),
    "async_off_inert": dict(BLUEFOG_TPU_ASYNC=None,
                            BLUEFOG_TPU_ASYNC_STALENESS_STEPS="1"),
    "mass_conservation": dict(
        BLUEFOG_TPU_ASYNC="1", BLUEFOG_TPU_ASYNC_STALENESS_STEPS="5",
        BLUEFOG_TPU_ASYNC_STALENESS_POLICY="downweight:0.5"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_matches_jax_bitwise(devices, env, monkeypatch, case):
    env(**CASE_ENV[case])
    monkeypatch.setattr(time, "time_ns", lambda: PINNED_NS)
    want, got = _both(devices, CASES[case])
    assert_same(want, got)


def test_stale_residual_state_dict_round_trip_and_conversion(devices, env):
    """The store survives ``win_state_dict``/``win_load_state_dict``; a
    snapshot from before the async mode loads with an empty store; the
    port's snapshot converts to the JAX package's and back
    (``models.convert``), each loading into the other package."""
    env(BLUEFOG_TPU_ASYNC="1", BLUEFOG_TPU_ASYNC_STALENESS_STEPS="1")

    def run(s):
        win = s.window()
        s.W.turn_on_win_ops_with_associated_p()
        s.W.configure_async()
        s.W.set_async_step(10)
        row = np.full(5, 6.0, np.float32)
        s.W._apply_inbound(s.T.OP_ACCUMULATE | s.T.OP_TRACE_FLAG, "async_w",
                           1, 0, 1.0, 0.25, _tagged(s.T, row, 1, 0))
        snap = s.W.win_state_dict("async_w")
        assert "0:1" in snap["stale_residual"]
        with win.lock:
            win.stale_residual.clear()
            win.p_stale_residual.clear()
        s.W.win_load_state_dict("async_w", snap)
        restored = s.state(win)
        legacy = {k: v for k, v in snap.items()
                  if k not in ("stale_residual", "p_stale_residual")}
        s.W.win_load_state_dict("async_w", legacy)
        assert not win.stale_residual and not win.p_stale_residual
        return restored, snap

    (want, j_snap), (got, t_snap) = _both(devices, run)
    assert_same(want, got)
    as_jax = convert.window_state_to_jax(t_snap)
    assert_same({k: {kk: np.asarray(vv) for kk, vv in v.items()}
                 for k, v in j_snap.items()},
                {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                 for k, v in as_jax.items()})
    for k, v in as_jax.items():
        for kk, vv in v.items():
            assert type(vv) is type(j_snap[k][kk]), (k, kk)
    back = convert.window_state_from_jax(j_snap)
    for side, snap in ((Side("port", devices), back),
                       (Side("jax", devices), as_jax)):
        try:
            win = side.window()
            side.W.win_load_state_dict("async_w", snap)
            assert_same(want, side.state(win))
        finally:
            side.close()


# ---------------------------------------------------------------------------
# The optimizers
# ---------------------------------------------------------------------------

def _pushsum_run(steps=8, auto_collect_rounds=2):
    tbf.init(N, device="cpu",
             topology_fn=lambda: ttopo.RingGraph(N, connect_style=1))
    try:
        w = torch.from_numpy(np.random.RandomState(3).randn(N, 6).astype(
            np.float32))
        opt = TWO.DistributedPushSumOptimizer(
            torch.optim.SGD([w], lr=0.05),
            auto_collect_rounds=auto_collect_rounds)
        traj = []
        for _ in range(steps):
            w.grad = w.detach() * 0.1
            opt.step()
            traj.append(w.detach().numpy().copy())
        out = opt.debias()[0].numpy().copy()
        opt.free()
        return traj, out, opt.backstops
    finally:
        TW.turn_off_win_ops_with_associated_p()
        tbf.shutdown()


def test_equivalence_oracle_bitwise(env):
    """The mode on with an unbounded staleness is push-sum's lockstep
    step bit for bit, and the mode off reproduces itself."""
    env(BLUEFOG_TPU_ASYNC=None)
    legacy, legacy_out, _ = _pushsum_run()
    again, _, _ = _pushsum_run()
    env(BLUEFOG_TPU_ASYNC="1", BLUEFOG_TPU_ASYNC_STALENESS_STEPS="0",
        BLUEFOG_TPU_ASYNC_COLLECT_EVERY="2")
    async_traj, async_out, backstops = _pushsum_run()
    assert backstops == 0      # one process: no transport to fence
    for i, (a, b, c) in enumerate(zip(legacy, again, async_traj)):
        np.testing.assert_array_equal(a, b, err_msg=f"lockstep {i}")
        np.testing.assert_array_equal(a, c, err_msg=f"async {i}")
    np.testing.assert_array_equal(legacy_out, async_out)


def test_winput_async_implies_overlap(env):
    """The mode on: win_put steps without waiting for its puts (the
    overlap path) and still mixes."""
    env(BLUEFOG_TPU_ASYNC="1", BLUEFOG_TPU_ASYNC_COLLECT_EVERY="0")
    tbf.init(N, device="cpu", topology_fn=lambda: ttopo.ExponentialGraph(N))
    try:
        w = torch.from_numpy(np.random.RandomState(5).randn(N, 4).astype(
            np.float32))
        opt = TWO.DistributedWinPutOptimizer(torch.optim.SGD([w], lr=0.2))
        assert not opt.overlap and opt._async_on
        targets = torch.arange(N, dtype=torch.float32)[:, None]
        for _ in range(60):
            w.grad = w.detach() - targets
            opt.step()
        assert opt._pending
        assert TW.async_info()["step"] == 59
        opt.free()
        spread = (w - w.mean(0, keepdim=True)).abs().max()
        assert spread < 1.0, f"async win_put did not mix: {spread}"
    finally:
        tbf.shutdown()


def test_step_clock_reaches_wire_tags(env):
    """``set_async_step`` publishes the origin step both encoders stamp:
    the Python trailer and the native service's clock."""
    env(BLUEFOG_TPU_ASYNC="1", BLUEFOG_TPU_TRACE_SAMPLE="1")
    TW.configure_async()
    TW.set_async_step(123)
    tag = TT.make_trace_tag(0)
    assert TT.TRACE_TRAILER.unpack(tag)[4] == 123
    if shutil.which("g++") is not None:
        tnative.lib()
        TW.set_async_step(124)
        assert tnative.lib().bf_trace_step() == 124


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------

class _Capture:
    n_stripes = 1

    def __init__(self):
        self.sent = []

    def send(self, host, port, op, name, src, dst, weight, tensor,
             p_weight=0.0, stripe=None):
        self.sent.append((op, name, src, dst, float(weight),
                          float(p_weight),
                          np.ascontiguousarray(tensor).tobytes()))


def _sends(W, T, rows):
    cap = _Capture()
    saved = W._store.distrib
    W._store.distrib = W._Distrib(cap, rank_owner={0: 0, 1: 1},
                                  proc_addr={1: ("127.0.0.1", 1)},
                                  my_proc=0)
    try:
        for i, row in enumerate(rows):
            op = (T.OP_PUT, T.OP_ACCUMULATE, T.OP_GET_REPLY)[i % 3]
            W._send_to_proc(1, op, "w", 0, 1, 0.5, 0.25, row)
        W._send_to_proc(1, T.OP_FENCE_REQ, "", 0, 1, 0.0)
    finally:
        W._store.distrib = saved
    return cap.sent


def _pin_clocks(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: PINNED_NS)
    monkeypatch.setattr(time, "monotonic_ns", lambda: PINNED_MONO_NS)
    for mod in (JT, TT):
        monkeypatch.setattr(mod, "_trace_count", 0)
        monkeypatch.setattr(mod, "_trace_seq", 0)


@pytest.mark.parametrize("sample", ["1", "1/3"])
def test_tagged_frames_match_the_jax_encoder(env, monkeypatch, sample):
    """Sampled data messages carry the JAX package's flag and trailer
    (after the payload), byte for byte, with both clocks pinned; control
    ops and replies are never tagged."""
    env(BLUEFOG_TPU_TRACE_SAMPLE=sample)
    _pin_clocks(monkeypatch)
    for mod in (JT, TT):
        mod.set_trace_origin_step(42)
    rows = [np.random.RandomState(i).randn(6).astype(np.float32)
            for i in range(9)]
    want = _sends(JW, JT, rows)
    got = _sends(TW, TT, [r.view(np.uint8) for r in rows])
    assert got == want
    tagged = [m for m in got if m[0] & TT.OP_TRACE_FLAG]
    assert tagged and all(TT.trace_strip(m[6])[1] ==
                          (0, i + 1, PINNED_MONO_NS // 1000,
                           PINNED_NS // 1000, 42)
                          for i, m in enumerate(tagged))


def test_trace_off_keeps_the_wire_and_the_windows(env, monkeypatch):
    """``BLUEFOG_TPU_TRACE_SAMPLE`` unset and the mode off: every frame is
    the untagged one, no counter moves, and a commit is the lockstep
    arithmetic."""
    env(BLUEFOG_TPU_TRACE_SAMPLE=None, BLUEFOG_TPU_ASYNC=None)
    _pin_clocks(monkeypatch)
    rows = [np.random.RandomState(i).randn(6).astype(np.float32)
            for i in range(4)]
    sent = _sends(TW, TT, [r.view(np.uint8) for r in rows])
    assert all(not m[0] & TT.OP_FLAG_MASK for m in sent)
    assert [m[6] for m in sent[:-1]] == [r.tobytes() for r in rows]
    assert TT._trace_count == 0 and TT.make_trace_tag(0) is None


class _Recorder:
    def __init__(self):
        self.msgs = []
        self.cv = threading.Condition()

    def apply(self, op, name, src, dst, weight, p_weight, payload):
        with self.cv:
            self.msgs.append((op, name, src, dst, weight, p_weight,
                              bytes(payload)))
            self.cv.notify_all()

    def apply_batch(self, msgs):
        for m in msgs:
            self.apply(*m)

    def wait_for(self, n, timeout=30):
        with self.cv:
            assert self.cv.wait_for(lambda: len(self.msgs) >= n,
                                    timeout=timeout), len(self.msgs)


def test_fastcall_and_ctypes_send_the_same_frames(env):
    """The native send through ``_bf_fastcall`` and through ``ctypes``:
    the same frames reach a receiver, byte for byte (tags included)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native service cannot be built")
    env(BLUEFOG_TPU_WIN_COALESCE="1", BLUEFOG_TPU_WIN_NATIVE="1",
        BLUEFOG_TPU_WIN_COALESCE_LINGER_MS="50")
    assert tnative.fastcall() is not None, "Python.h is on this machine"
    rng = np.random.RandomState(9)
    msgs = []
    for i in range(60):
        row = rng.randn(int(rng.randint(1, 40))).astype(np.float32)
        payload = row.view(np.uint8)
        op = (TT.OP_PUT, TT.OP_ACCUMULATE)[i % 2]
        if i % 5 == 0:
            payload = np.frombuffer(
                payload.tobytes() + TT.TRACE_TRAILER.pack(0, i, 1, 2, i),
                np.uint8)
            op |= TT.OP_TRACE_FLAG
        msgs.append((op, f"w{i % 3}", i % 4, (i + 1) % 4,
                     float(rng.rand()), float(rng.rand()), payload))
    received = {}
    for path in ("fastcall", "ctypes"):
        env(BLUEFOG_TPU_WIN_NATIVE="0")
        rec = _Recorder()
        srv = TT.WindowTransport(rec.apply, apply_batch=rec.apply_batch)
        env(BLUEFOG_TPU_WIN_NATIVE="1")
        cli = TT.WindowTransport(lambda *a: None)
        try:
            assert cli.send_path == "fastcall"
            if path == "ctypes":
                cli._fc_send, cli.send_path = None, "ctypes"
            for m in msgs:
                cli.send("127.0.0.1", srv.port, *m[:5], m[6], p_weight=m[5])
            cli.flush()
            rec.wait_for(len(msgs))
            received[path] = rec.msgs
        finally:
            cli.stop()
            srv.stop()
    assert received["fastcall"] == received["ctypes"]
    assert [m[:6] for m in received["ctypes"]] == [m[:6] for m in msgs]
    assert [m[6] for m in received["ctypes"]] == \
        [m[6].tobytes() for m in msgs]


# ---------------------------------------------------------------------------
# Across gloo processes, both transport paths
# ---------------------------------------------------------------------------

DIST_N, DIST_DIM = 4, 6
# Each phase: every process's step (the receiver's clock and the origin
# step its sends carry); bound 1, so a message more than one step older
# than its receiver is stale.
PHASES = [(10, 7), (11, 11), (12, 14), (15, 14)]
EDGE_W = 0.5
OWNER = {0: 0, 1: 0, 2: 1, 3: 1}
DIST_POLICIES = ["reject", "downweight:0.5"]


def _rows():
    return ((np.arange(DIST_N * DIST_DIM) % 7) + 1).astype(
        np.float32).reshape(DIST_N, DIST_DIM)


def _edges(topo_mod):
    g = topo_mod.ExponentialGraph(DIST_N)
    return [(s, d) for s in range(DIST_N)
            for d in topo_mod.out_neighbor_ranks(g, s)]


def _owned_state(win, owned):
    def pick(d):
        return {f"{k[0]}:{k[1]}": (v.cpu().numpy().copy()
                                   if isinstance(v, torch.Tensor)
                                   else np.asarray(v).copy()
                                   if hasattr(v, "shape") else v)
                for k, v in d.items() if k[0] in owned}
    with win.lock:
        return {"staging": pick(win.staging),
                "stale_residual": pick(win.stale_residual),
                "p_staging": pick(win.p_staging),
                "p_stale_residual": pick(win.p_stale_residual),
                "versions": pick(win.versions)}


def dist_sequence(bf, W, config, device="cpu"):
    """The scripted sequence in this process of the world: per phase, set
    the step clock, barrier, ``win_accumulate`` the owned rows times the
    phase's factor over every out-edge, fence; then the state, and the
    staging after ``win_fold_stale_residuals``.  Every policy on both
    transport paths."""
    comm = bf.process_ranks()
    own = bf.owned_ranks()
    x = torch.from_numpy(_rows()[own]).to(device)
    weights = {e: EDGE_W for e in _edges(ttopo)}
    out = {}
    for policy in DIST_POLICIES:
        for path, native_on in (("native", True), ("python", False)):
            with config.override(async_mode=True, async_staleness_steps=1,
                                 async_staleness_policy=policy,
                                 trace_sample=1, win_native=native_on):
                W._shutdown_transport()
                W.init_transport()
                assert W._store.distrib.transport.native_path == native_on
                W.turn_on_win_ops_with_associated_p()
                assert W.configure_async()
                bf.win_create(torch.zeros(len(own), DIST_DIM, device=device),
                              "aw", zero_init=True)
                for phase, steps in enumerate(PHASES):
                    W.set_async_step(steps[comm.process])
                    bf.barrier()
                    bf.win_accumulate(x * float(phase + 1), "aw",
                                      dst_weights=weights)
                    bf.win_fence("aw")
                win = W._store.get("aw")
                res = {"before": _owned_state(win, own)}
                bf.win_fence("aw")
                res["folded"] = W.win_fold_stale_residuals("aw")
                res["after"] = _owned_state(win, own)
                res["send_path"] = W._store.distrib.transport.send_path
                bf.win_free("aw")
                W.turn_off_win_ops_with_associated_p()
                bf.barrier()
            W.configure_async(False)
            out[f"{policy}/{path}"] = res
    return out


def jax_reference(devices, policy):
    """The same messages through the JAX package's ``_apply_inbound`` in
    one process: local edges untagged (as they never cross a wire), remote
    edges tagged with the sender's step, each receiver's clock set first;
    the state, then the staging after the fold."""
    import jax  # noqa: F401  (the devices are the conftest's)
    jconfig.reload()
    with_env = {"BLUEFOG_TPU_ASYNC": "1",
                "BLUEFOG_TPU_ASYNC_STALENESS_STEPS": "1",
                "BLUEFOG_TPU_ASYNC_STALENESS_POLICY": policy}
    old = {k: os.environ.get(k) for k in with_env}
    os.environ.update(with_env)
    jconfig.reload()
    side = Side("jax", devices)
    try:
        win = side.window(n=DIST_N, dim=DIST_DIM, graph="ExponentialGraph",
                          owner=OWNER)
        JW.turn_on_win_ops_with_associated_p()
        JW.configure_async()
        rows = _rows()
        edges = _edges(jtopo)
        seq = 0
        for phase, steps in enumerate(PHASES):
            for proc in (0, 1):
                JW.set_async_step(steps[proc])
                for src, dst in edges:
                    if OWNER[dst] != proc:
                        continue
                    row = rows[src] * np.float32(phase + 1)
                    if OWNER[src] == proc:
                        JW._apply_inbound(JT.OP_ACCUMULATE, "async_w", src,
                                          dst, EDGE_W, EDGE_W,
                                          row.tobytes())
                        continue
                    seq += 1
                    JW._apply_inbound(
                        JT.OP_ACCUMULATE | JT.OP_TRACE_FLAG, "async_w",
                        src, dst, EDGE_W, EDGE_W,
                        _tagged(JT, row, src, steps[OWNER[src]], seq=seq))
        res = {"before": _owned_state(win, range(DIST_N))}
        res["folded"] = JW.win_fold_stale_residuals("async_w")
        res["after"] = _owned_state(win, range(DIST_N))
        shipped = {}
        for src, dst in edges:
            for phase in range(len(PHASES)):
                add = rows[src] * np.float32(phase + 1) * np.float32(EDGE_W)
                shipped[f"{dst}:{src}"] = shipped.get(
                    f"{dst}:{src}", np.zeros(DIST_DIM, np.float32)) + add
        res["shipped"] = shipped
        return res
    finally:
        side.close()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _reset_async()


def _worker(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import config
    bf.init_distributed(device="cpu")
    try:
        res = dist_sequence(bf, W, config)
        res["owned"] = bf.owned_ranks()
        torch.save(res, args.out)
    finally:
        bf.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the window transport cannot be built")
    tnative.lib()
    tmp = tmp_path_factory.mktemp("async")
    port = _free_port()
    children = []
    for p in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "BLUEFOG_TPU_", "MASTER_",
                                    "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), BFTPU_LOCAL_DEVICES="2",
                   OMP_NUM_THREADS="1", BFTPU_WIN_HOST="127.0.0.1",
                   BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                   BFTPU_NUM_PROCESSES="2", BFTPU_PROCESS_ID=str(p),
                   BFTPU_LOCAL_ID=str(p))
        children.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp / f"proc{p}.pt")], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for c in children:
            logs.append(c.communicate(timeout=JOIN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for c in children:
            c.kill()
        pytest.fail(f"the 2-process group hung past {JOIN_TIMEOUT} s")
    for p, c in enumerate(children):
        assert c.returncode == 0, f"process {p}:\n{logs[p][-4000:]}"
    return [torch.load(tmp / f"proc{p}.pt", weights_only=False)
            for p in range(2)]


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("policy", DIST_POLICIES)
def test_async_across_processes_matches_jax(devices, dist_run, policy,
                                            path):
    want = jax_reference(devices, policy)
    assert want["before"]["stale_residual"], "the policy never fired"
    for part in dist_run:
        got = part[f"{policy}/{path}"]
        own = part["owned"]
        for when in ("before", "after"):
            ref = {k: {e: v for e, v in d.items()
                       if int(e.split(":")[0]) in own}
                   for k, d in want[when].items()}
            assert_same(ref, got[when], f"{policy}/{path}/{when}")
        assert got["folded"] == len(got["before"]["stale_residual"])
        for e, v in got["after"]["staging"].items():
            np.testing.assert_array_equal(v, want["shipped"][e],
                                          err_msg=f"mass on {e}")
        assert got["send_path"] == ("fastcall" if path == "native"
                                    else "python")


if __name__ == "__main__":
    _worker()


def test_benchmark_win_put_async_across_processes(tmp_path):
    """``benchmark --dist-optimizer win_put`` with the async knobs across 2
    gloo processes: both finish (the last step's puts, still in flight,
    land before the transports stop), the combine shrinks the spread, and
    the JSON names the send path."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the window transport cannot be built")
    import json
    tnative.lib()
    port = _free_port()
    children = []
    for p in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BFTPU_", "BLUEFOG_TPU_", "MASTER_",
                                    "WORLD_SIZE", "RANK", "LOCAL_RANK"))}
        env.update(PYTHONPATH=str(ROOT), BFTPU_LOCAL_DEVICES="2",
                   OMP_NUM_THREADS="1", BFTPU_WIN_HOST="127.0.0.1",
                   BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                   BFTPU_NUM_PROCESSES="2", BFTPU_PROCESS_ID=str(p),
                   BLUEFOG_TPU_ASYNC="1", BLUEFOG_TPU_TRACE_SAMPLE="1",
                   BLUEFOG_TPU_ASYNC_STALENESS_STEPS="1",
                   BLUEFOG_TPU_ASYNC_COLLECT_EVERY="3")
        children.append(subprocess.Popen(
            [sys.executable, "-m", "bluefog_tpu_torch.benchmark",
             "--device", "cpu", "--backend", "gloo", "--model",
             "transformer", "--flash-attention", "--num-layers", "1",
             "--embed-dim", "32", "--num-heads", "2", "--seq-len", "16",
             "--batch-size", "2", "--vocab-size", "64", "--dist-optimizer",
             "win_put", "--num-warmup-batches", "1", "--num-iters", "2",
             "--num-batches-per-iter", "1"], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [c.communicate(timeout=JOIN_TIMEOUT)[0] for c in children]
    except subprocess.TimeoutExpired:
        for c in children:
            c.kill()
        pytest.fail(f"the processes hung past {JOIN_TIMEOUT} s")
    for p, (c, log) in enumerate(zip(children, logs)):
        assert c.returncode == 0, f"process {p}:\n{log[-4000:]}"
        res = json.loads(log.strip().splitlines()[-1])
        assert res["window"]["send_path"] == "fastcall"
        assert res["spread"]["after_combine"] < res["spread"]["after_adapt"]
