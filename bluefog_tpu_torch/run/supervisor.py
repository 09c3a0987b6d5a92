"""Churn supervisor: elastic gossip as a service.

The port of ``bluefog_tpu/run/supervisor.py``.  The control loop that
joins failure detection (transport reachability probes, heartbeat
staleness, straggler step lag), the membership consensus
(``ops/membership.py``), the survivor re-plan (``bf.set_topology`` over a
doubly stochastic survivor topology, which re-enters the placement and
schedule pipeline) and the restart-free recovery of the windows from each
process's owned rows::

    sup = ChurnSupervisor()            # BLUEFOG_TPU_CHURN=1 and a live
    for step in range(num_steps):      # multi-process window transport
        change = sup.step(step)        # heartbeats ride a daemon thread
        if change is not None and change.evicted:
            break                      # this rank was voted out: exit
        train_step(...)                # windows and topology re-planned

The window optimizers drive it themselves (``_maybe_churn_step``).
``step()`` returns ``None`` while the membership is stable; after a commit
it has, before it returns, retired the dead peers' sender queues, rebuilt
every window under the survivor topology on the card (the owned rows
stacked on the device by ``window.owned_snapshot``, no row through the
host; push-sum mass kept, staging of the old epoch dropped) and recorded
``bf_churn_recovery_seconds``.  Nothing here calls a collective: the
process group may hold a dead member.

Everything is inert unless ``BLUEFOG_TPU_CHURN=1``: constructing a
supervisor without it raises.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bluefog_tpu_torch.utils import config

__all__ = ["ChurnSupervisor", "maybe_supervisor"]


class ChurnSupervisor:
    """One per-process churn control loop over the live window transport.

    ``on_change(view)`` runs on the caller's thread after each recovery;
    :attr:`last_recovery` describes the newest one (epoch, seconds, the
    windows rebuilt and whether their owned rows came back bit for bit)."""

    def __init__(self, *, topology_builder=None,
                 on_change: Optional[Callable] = None,
                 heartbeat_sec: Optional[float] = None,
                 probe_timeout: float = 0.75):
        cfg = config.get()
        if not cfg.churn:
            raise RuntimeError(
                "ChurnSupervisor requires BLUEFOG_TPU_CHURN=1 (default off: "
                "the churn controller must be an explicit operational "
                "decision, never ambient)")
        from bluefog_tpu_torch import basics
        from bluefog_tpu_torch.ops import gang, membership
        from bluefog_tpu_torch.ops import window as W
        from bluefog_tpu_torch.ops.transport import OP_MEMBER
        d = W._store.distrib
        if d is None:
            raise RuntimeError(
                "ChurnSupervisor needs the multi-process window transport "
                "(bf.init_distributed(), or gang.init_elastic()): one "
                "process has no gang to supervise")
        self._d = d
        self._senders: Dict[tuple, "_LatestSender"] = {}
        self._senders_lock = threading.Lock()
        self._W = W
        self._OP_MEMBER = OP_MEMBER
        self._n = basics.size()
        self._basics = basics
        self._membership = membership
        self._topology_builder = topology_builder
        self.on_change = on_change
        self._probe_timeout = probe_timeout
        self._hb_sec = (max(0.01, cfg.churn_heartbeat_ms / 1e3)
                        if heartbeat_sec is None else heartbeat_sec)
        self.last_recovery: Optional[dict] = None
        # Elastic scale-up (BLUEFOG_TPU_ELASTIC_JOIN, ops/gang.py): adopt
        # the service a bootstrap or a join installed, or build the
        # replicated directory from the live transport maps.
        self._gang = gang.current() if cfg.elastic_join else None
        if cfg.elastic_join and self._gang is None:
            directory = gang.GangDirectory(
                self._n,
                {p: f"{a[0]}:{a[1]}" for p, a in d.proc_addr.items()},
                epoch=0, active=sorted(d.proc_addr),
                rank_owner=dict(d.rank_owner))
            self._gang = gang.GangService(directory)
            gang.install(self._gang)
            self._gang.persist()
        grant = self._gang.pending_grant if self._gang is not None else None
        seed = {}
        if grant is not None:
            # A granted joiner: seed the controller with the grant's view
            # and propose its own admission until the grow epoch commits.
            seed = dict(active=grant.active, epoch=grant.epoch,
                        joining=True, my_join_ranks=grant.ranks,
                        my_endpoint=grant.my_endpoint)
        self.ctrl = membership.MembershipController(
            n_procs=len(d.proc_addr), my_proc=d.my_proc,
            rank_owner=dict(d.rank_owner),
            send_fn=self._send, probe_fn=self._probe, **seed)
        membership.install(self.ctrl)
        from bluefog_tpu_torch.utils import chaos, telemetry
        self.chaos = chaos.ChaosInjector(
            my_ranks=[r for r, p in d.rank_owner.items() if p == d.my_proc],
            transport=d.transport,
            peer_addrs=[a for p, a in d.proc_addr.items() if p != d.my_proc])
        telemetry.set_gauge("bf_active_ranks",
                            len(self.ctrl.active_ranks()))
        telemetry.set_gauge("bf_membership_epoch", self.ctrl.epoch)
        self._stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, daemon=True, name="bf-churn-hb")
        self._hb_thread.start()

    # -- plumbing ----------------------------------------------------------

    def _addr_of(self, proc: int):
        """A peer's endpoint: the rank directory, else the membership
        layer's join-claim hint (a joiner not yet in ``proc_addr``)."""
        addr = self._d.proc_addr.get(proc)
        if addr is None:
            addr = self.ctrl.peer_endpoint_hint(proc)
        if addr is None:
            raise ConnectionError(f"no known endpoint for proc {proc}")
        return addr

    def _send(self, proc: int, payload: bytes) -> None:
        host, port = self._addr_of(proc)
        # One copy a stripe: a peer whose data path is wedged on any
        # stripe must not look healthy through another (membership
        # messages are idempotent, the duplicates harmless).  Each copy
        # is handed to the (peer, stripe)'s own sender thread: a send
        # blocks while the native sender copies a row into that stripe's
        # queue under its lock (~1 s for a 0.94 GB row on the H100's
        # host), and a blocked copy must delay neither the other stripe's
        # copy, the other peers' heartbeats nor the next round.
        n = int(getattr(self._d.transport, "n_stripes", 1) or 1)
        for k in range(n):
            key = (host, port, k)
            with self._senders_lock:
                sender = self._senders.get(key)
                if sender is None:
                    sender = self._senders[key] = _LatestSender(
                        self._send_copy, key)
            sender.offer(payload)

    def _send_copy(self, key, payload: bytes) -> None:
        host, port, stripe = key
        self._d.transport.send(host, port, self._OP_MEMBER, "",
                               self._d.my_rank, -1, 0.0,
                               np.frombuffer(payload, np.uint8),
                               stripe=stripe)

    def _probe(self, proc: int) -> bool:
        try:
            socket.create_connection(self._addr_of(proc),
                                     timeout=self._probe_timeout).close()
            return True
        except (OSError, ConnectionError):
            return False

    def _hb_loop(self) -> None:
        ticks = 0
        while not self._stop.wait(self._hb_sec):
            try:
                self.ctrl.tick()
            except Exception:  # noqa: BLE001 — the heartbeat must survive
                from bluefog_tpu_torch.utils.logging import get_logger
                get_logger().exception("churn supervisor heartbeat failed")
            ticks += 1
            if self._gang is not None and ticks % 8 == 0:
                # Directory anti-entropy at an eighth of the cadence.
                try:
                    self._gang.announce()
                except Exception:  # noqa: BLE001
                    pass
            if self.ctrl.evicted:
                return

    # -- the step-boundary API --------------------------------------------

    def step(self, step: int):
        """Advance at a training-step boundary: apply this step's chaos
        faults, feed the step into the heartbeats, tick the link
        observatory and the tuner, and after a committed change run the
        recovery before returning the :class:`~bluefog_tpu_torch.ops.
        membership.MembershipView` (``None`` while stable).  Recovery runs
        on the caller's thread: it swaps topology and windows, which must
        not race the training loop's own window ops."""
        self.ctrl.note_step(step)
        self.chaos.apply(step)
        from bluefog_tpu_torch.utils import linkobs, tuner
        linkobs.on_step(step)
        # The tuner's adaptation epoch at this boundary (a no-op unless
        # BLUEFOG_TPU_TUNE=1): it may swap topology and windows too.
        tuner.tick(step)
        view = self.ctrl.poll_change()
        if view is None:
            return None
        if view.evicted:
            # The only record of what this process saw before it was
            # voted out: dump it before the process exits.
            from bluefog_tpu_torch.utils import flightrec
            flightrec.dump(reason=f"evicted at epoch {view.epoch}")
            self._stop.set()
            return view
        self._recover(view)
        if self.on_change is not None:
            self.on_change(view)
        return view

    def _recover(self, view) -> None:
        """The survivors' re-plan and restart-free resume, timed into
        ``bf_churn_recovery_seconds``, in this order: the flight recorder
        dump; the directory grown for admitted joiners; ``drop_peer`` of
        each dead process; its contribution-age, staleness and link
        gauges cleared; the window ops in flight and the card drained;
        every window's owned rows snapshotted on the card; ``win_free``;
        ``set_topology`` of the survivor topology; every window rebuilt
        from its snapshot (staging zeroed, push-sum scalars restored); the
        gang's directory updated and announced; the histogram observed."""
        from bluefog_tpu_torch.utils import flightrec, telemetry
        flightrec.dump(reason=f"membership change to epoch {view.epoch}")
        t0 = time.perf_counter()
        from bluefog_tpu_torch.ops.gang import _ep_addr
        for proc in view.added_procs:
            ep = view.added_endpoints.get(proc)
            if ep and proc not in self._d.proc_addr:
                try:
                    self._d.proc_addr[proc] = _ep_addr(ep)
                except ValueError:
                    pass
        for r in view.added_ranks:
            owner = self.ctrl.rank_owner.get(r)
            if owner is not None:
                self._d.rank_owner[r] = owner
        removed = set(view.removed_procs)
        dead_ranks = [r for r, p in self._d.rank_owner.items()
                      if p in removed]
        for proc in view.removed_procs:
            addr = self._d.proc_addr.get(proc)
            if addr is not None:
                self._d.transport.drop_peer(*addr)
        W = self._W
        W.clear_contribution_age(dead_ranks)
        W.clear_async_staleness(dead_ranks)
        from bluefog_tpu_torch.utils import linkobs
        linkobs.clear_edges(dead_ranks)
        # A dead requester's mutex hold never sees its release; window ops
        # still in flight (overlapped puts) land or fail before the
        # windows they hold go; the card finishes what reads the rows.
        W._release_remote_holds(dead_ranks)
        W._drain_handles()
        dev = self._basics.device()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        snaps: Dict[str, dict] = {
            name: W.owned_snapshot(name)
            for name in W.get_current_created_window_names()}
        W.win_free()
        topo = self._membership.survivor_topology(
            self._n, view.active_ranks, builder=self._topology_builder)
        self._basics.set_topology(topo, is_weighted=True)
        same = {}
        for name, snap in snaps.items():
            W.rebuild_from_snapshot(name, snap)
            win = W._store.get(name)
            same[name] = all(torch.equal(snap["rows"][i], win.main[r])
                             for i, r in enumerate(snap["owned"]))
        if self._gang is not None:
            # The commit into the replicated directory, persisted, then
            # pushed (freshly admitted members included).
            self._gang.on_commit(view, self._d.rank_owner)
            self._gang.announce()
        dt = time.perf_counter() - t0
        telemetry.observe("bf_churn_recovery_seconds", dt)
        self.last_recovery = {"epoch": view.epoch, "seconds": dt,
                              "active_ranks": list(view.active_ranks),
                              "removed_ranks": list(view.removed_ranks),
                              "windows": sorted(snaps),
                              "rows_equal": same}
        from bluefog_tpu_torch.utils.logging import get_logger
        get_logger().warning(
            "churn: recovered in %.3fs — epoch %d, %d/%d ranks active"
            "%s, %d window(s) re-planned", dt, view.epoch,
            len(view.active_ranks), self._n,
            f" (admitted ranks {list(view.added_ranks)})"
            if view.added_ranks else "", len(snaps))

    # -- lifecycle / introspection ----------------------------------------

    def info(self) -> dict:
        return self.ctrl.summary()

    def stop(self) -> None:
        self._stop.set()
        self._hb_thread.join(timeout=5)
        with self._senders_lock:
            senders, self._senders = list(self._senders.values()), {}
        for sender in senders:
            sender.close()
        if self._membership.current() is self.ctrl:
            self._membership.install(None)


class _LatestSender:
    """A daemon thread that sends the newest membership payload offered to
    it for one (peer, stripe); a payload offered while the previous send
    is still blocked replaces any older one waiting (each carries the
    sender's whole state).  A failed send is dropped: the heartbeat's
    silence is the signal."""

    def __init__(self, send: Callable, key: tuple):
        self._send, self._key = send, key
        self._cv = threading.Condition()
        self._payload: Optional[bytes] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"bf-churn-send-{key[0]}:{key[1]}#{key[2]}")
        self._thread.start()

    def offer(self, payload: bytes) -> None:
        with self._cv:
            self._payload = payload
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._payload is None and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                payload, self._payload = self._payload, None
            try:
                self._send(self._key, payload)
            except Exception:  # noqa: BLE001 — a failed send IS the signal
                pass


_singleton: Optional[ChurnSupervisor] = None
_singleton_lock = threading.Lock()


def maybe_supervisor() -> Optional[ChurnSupervisor]:
    """The process-wide supervisor iff churn is on and a multi-process
    transport is live; None otherwise (never raises).  Built once, lazily:
    a training loop or optimizer may call this every step."""
    global _singleton
    if not config.get().churn:
        return None
    from bluefog_tpu_torch.ops import window as W
    if W._store.distrib is None:
        return None
    with _singleton_lock:
        if _singleton is None or _singleton._d is not W._store.distrib:
            if _singleton is not None:
                _singleton.stop()
            _singleton = ChurnSupervisor()
        return _singleton


def _stop_singleton() -> None:
    """Stop the process-wide supervisor (``basics.shutdown``, before the
    transport goes)."""
    global _singleton
    with _singleton_lock:
        if _singleton is not None:
            _singleton.stop()
            _singleton = None
