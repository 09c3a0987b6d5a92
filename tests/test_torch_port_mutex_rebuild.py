"""The remote window mutex across a window rebuild, on the native and the
Python drain.

The churn recovery (``run/supervisor.py`` ``_recover``) frees every
window and rebuilds it from its owned snapshot.  Here process 0 (this
store) owns rank 0 of window ``m``, and a peer process, a bare transport
owning rank 1, asks for rank 0's mutex.  Its MUTEX_ACQ arrives while the
window exists, and the drain starts the hold on a thread of its own.

- ``freed_before_lookup``: the window is freed before that thread looks
  it up, and rebuilt after.  The grant still reaches the peer within
  ``GRANT_BOUND`` seconds, and the rebuilt window's mutex is what it
  holds until the peer's MUTEX_REL.  (The JAX package's hold returns
  without a grant there, and the peer waits out
  ``BLUEFOG_TPU_WIN_TIMEOUT``: a known difference, ROADMAP Queue 3.)
- ``freed_while_waiting``: the owner holds its own rank-0 mutex (its
  ``win_update``) while the ACQ arrives, the free and the rebuild; the
  grant comes once the owner lets go, of the rebuilt window's mutex.
- ``held_across``: the grant comes before the free; the rebuilt window's
  mutex stays held until the release, so the owner's own ``win_update``
  with the mutex waits for the peer's critical section.
- ``recreated``: as ``freed_before_lookup``, but the window comes back
  through ``win_create`` (new mutexes): the grant is of its mutex.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import bluefog_tpu_torch as tbf
from bluefog_tpu_torch.ops import transport as T
from bluefog_tpu_torch.ops import window as W
from bluefog_tpu_torch.utils import config

GRANT_BOUND = 5.0     # seconds from the rebuild to the grant's arrival,
                      # and for the gated hold thread's own lookup


class _Peer:
    """Process 1: a transport of its own that records the grants sent to
    it and sends rank 1's ACQ and REL for rank 0."""

    def __init__(self):
        self.grants = []
        self.cv = threading.Condition()
        self.transport = T.WindowTransport(
            self._apply, apply_batch=self._apply_batch,
            apply_items=self._apply_items)

    def _apply(self, op, name, src, dst, weight, p_weight, payload):
        if (op & ~T.OP_FLAG_MASK) == T.OP_MUTEX_GRANT:
            with self.cv:
                self.grants.append((name, src, dst))
                self.cv.notify_all()

    def _apply_batch(self, msgs):
        for msg in msgs:
            self._apply(*msg)

    def _apply_items(self, items):
        for kind, msg in items:
            if not kind:
                self._apply(*msg)

    def wait_grant(self, timeout):
        with self.cv:
            return self.cv.wait_for(lambda: self.grants, timeout)

    def send(self, port, op):
        self.transport.send("127.0.0.1", port, op, "m", 1, 0, 0.0,
                            np.empty(0, np.uint8))
        self.transport.flush(timeout=10.0)


class _Holder:
    """A thread of the owner holding ``mutex`` until :meth:`release`."""

    def __init__(self, mutex):
        self.taken, self.done = threading.Event(), threading.Event()

        def hold():
            with mutex:
                self.taken.set()
                self.done.wait(30.0)
        self.thread = threading.Thread(target=hold, daemon=True)
        self.thread.start()
        assert self.taken.wait(10.0)

    def release(self):
        self.done.set()
        self.thread.join(10.0)


def _held_elsewhere(mutex) -> bool:
    """True while another thread holds ``mutex``."""
    got = []

    def probe():
        got.append(mutex.acquire(blocking=False))
        if got[0]:
            mutex.release()
    t = threading.Thread(target=probe)
    t.start()
    t.join(10.0)
    return not got[0]


@pytest.mark.parametrize("case", ["freed_before_lookup",
                                  "freed_while_waiting", "held_across",
                                  "recreated"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_grant_is_of_the_window_that_exists(native, case, monkeypatch):
    with config.override(win_native=native):
        owner = W.make_transport()
        peer = _Peer()
    tbf.init(2, device="cpu")
    W.install_distrib(owner, {0: 0, 1: 1},
                      {0: ("127.0.0.1", owner.port),
                       1: ("127.0.0.1", peer.transport.port)}, 0)
    hold = W._hold_mutex_for_remote
    arrived, go, looked = (threading.Event(), threading.Event(),
                           threading.Event())

    def gated_hold(name, rank, requester):
        arrived.set()
        go.wait(10.0)
        try:
            hold(name, rank, requester)
        finally:
            looked.set()

    gated = case in ("freed_before_lookup", "recreated")
    owner_hold = None
    try:
        assert owner.native_path is native
        assert W.win_create(torch.zeros(1, 4), "m", zero_init=True)
        old = W._store.get("m")
        if gated:
            monkeypatch.setattr(W, "_hold_mutex_for_remote", gated_hold)
        if case == "freed_while_waiting":
            owner_hold = _Holder(old.mutexes[0])
        peer.send(owner.port, T.OP_MUTEX_ACQ)
        if gated:
            # The ACQ was applied with the window present (not parked).
            assert arrived.wait(10.0)
            assert "m" not in W._store.distrib.parked
        elif case == "held_across":
            assert peer.wait_grant(GRANT_BOUND), "no grant before the free"
        else:
            time.sleep(0.2)      # the hold waits for the owner's mutex
            assert not peer.grants
        snap = W.owned_snapshot("m")
        W.win_free("m")
        go.set()
        if gated:
            # The hold thread has looked the window up and parked the ACQ
            # before the rebuild: the interleaving the case forces.  A
            # bound on this test's own thread, not on the port.
            assert looked.wait(GRANT_BOUND), \
                "the gated hold thread did not look the window up"
        if case == "recreated":
            assert W.win_create(torch.zeros(1, 4), "m", zero_init=True)
        else:
            W.rebuild_from_snapshot("m", snap)
        if owner_hold is not None:
            owner_hold.release()
        rebuilt = W._store.get("m")
        assert rebuilt is not old
        assert peer.wait_grant(GRANT_BOUND), \
            "the peer got no grant after the rebuild"
        assert peer.grants == [("m", 1, 0)]
        # The grant is of the new window's rank-0 mutex: held (by the hold
        # thread) until the peer's release.
        assert _held_elsewhere(rebuilt.mutexes[0])
        peer.send(owner.port, T.OP_MUTEX_REL)
        for _ in range(200):
            if not _held_elsewhere(rebuilt.mutexes[0]):
                break
            time.sleep(0.025)
        assert not _held_elsewhere(rebuilt.mutexes[0])
        assert W._store.distrib.remote_holds == {}
    finally:
        go.set()
        if owner_hold is not None:
            owner_hold.release()
        monkeypatch.undo()
        tbf.shutdown()
        peer.transport.stop()


def _wait_for_text(caplog, text: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while text not in caplog.text and time.monotonic() < deadline:
        time.sleep(0.01)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_grant_path_stamps_on_the_trace_level(native, caplog):
    """``BLUEFOG_TPU_LOG_LEVEL=trace`` stamps the owner's side of a grant
    in order: the ACQ's arrival, the hold's lookup, the grant sent, the
    REL's arrival (with its hold) and the release; the rebuild's free and
    rebuild are stamped too.  Off the trace level nothing is logged."""
    import logging

    from bluefog_tpu_torch.utils.logging import TRACE, get_logger
    with config.override(win_native=native):
        owner = W.make_transport()
        peer = _Peer()
    tbf.init(2, device="cpu")
    W.install_distrib(owner, {0: 0, 1: 1},
                      {0: ("127.0.0.1", owner.port),
                       1: ("127.0.0.1", peer.transport.port)}, 0)
    log = get_logger()
    level = log.level
    try:
        assert W.win_create(torch.zeros(1, 4), "m", zero_init=True)
        with caplog.at_level(logging.DEBUG, logger=log.name):
            peer.send(owner.port, T.OP_MUTEX_ACQ)
            assert peer.wait_grant(GRANT_BOUND)
            peer.send(owner.port, T.OP_MUTEX_REL)
            deadline = time.monotonic() + 30.0
            while W._store.distrib.remote_holds \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        assert not [r for r in caplog.records if "mutex" in r.getMessage()]
        caplog.clear()
        with caplog.at_level(TRACE, logger=log.name):
            peer.send(owner.port, T.OP_MUTEX_ACQ)
            with peer.cv:
                assert peer.cv.wait_for(lambda: len(peer.grants) == 2,
                                        30.0)
            # The hold stamps its grant after the send's flush, which the
            # peer's receipt can overtake: release once it is stamped.
            _wait_for_text(caplog, "grant_sent")
            peer.send(owner.port, T.OP_MUTEX_REL)
            _wait_for_text(caplog, "hold_released")
            snap = W.owned_snapshot("m")
            W.win_free("m")
            W.rebuild_from_snapshot("m", snap)
    finally:
        log.setLevel(level)
        tbf.shutdown()
        peer.transport.stop()
    stamps = [r.getMessage().split()[2] for r in caplog.records
              if r.getMessage().startswith("mutex ")]
    assert stamps == ["acq_in", "hold_lookup", "grant_sent", "rel_in",
                      "hold_released", "window_freed", "window_rebuilt"]
    assert "requester 1" in caplog.records[0].getMessage()
    assert "hold=True" in caplog.records[3].getMessage()


@pytest.mark.parametrize("layout", ["rank", "owned"])
def test_rebuild_keeps_the_owned_mutexes(layout):
    """``owned_snapshot`` carries the owned ranks' mutexes, and the
    rebuilt window holds the same lock objects (rows and push-sum scalars
    as before)."""
    tbf.init(4, device="cpu")
    try:
        rows = torch.arange(16.0).reshape(4, 4)
        if layout == "rank":
            assert W.win_create(rows, "k")
        else:
            W._store.distrib = types.SimpleNamespace(
                rank_owner={r: r % 2 for r in range(4)}, my_proc=0,
                transport=types.SimpleNamespace(
                    register_window=lambda *a: None,
                    unregister_window=lambda *a: None), parked={})
            assert W.win_create(rows[:2], "k", zero_init=True)
        old = W._store.get("k")
        snap = W.owned_snapshot("k")
        assert snap["mutexes"] == old.mutexes
        W.win_free("k")
        W.rebuild_from_snapshot("k", snap)
        new = W._store.get("k")
        assert new is not old and new.owned == old.owned
        assert all(new.mutexes[r] is old.mutexes[r] for r in old.owned)
        assert all(torch.equal(new.main[r], old.main[r]) for r in old.owned)
        assert new.p_main == old.p_main
        W.win_free("k")
    finally:
        W._store.distrib = None
        tbf.shutdown()
