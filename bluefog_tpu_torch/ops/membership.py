"""Gossip-consistent membership: failure consensus for elastic gossip.

The port of ``bluefog_tpu/ops/membership.py``, line for line: the view,
the consensus state machine, the survivor topology and the process-wide
registry are host logic with no framework in them.  The heartbeat payload
is the JAX encoder's byte for byte (the same ``json.dumps`` of the same
keys in the same order), so a port process and a JAX process agree on the
wire, as the transport's frames already do.

Design
------
* **Membership is per PROCESS** (a dead process takes all its owned ranks
  with it); the rank-level view is derived through the transport's
  ``rank_owner`` directory.
* **Messages ride the DCN window transport** as ``OP_MEMBER`` frames (JSON
  payloads) on the same per-peer FIFO TCP streams as gossip — a peer whose
  data path is wedged cannot look healthy through a side channel the data
  never takes.  No collective (gloo, NCCL) is ever used: the whole control plane
  must keep working exactly when the gang is broken, which is when a global
  collective cannot.
* **Detection** fuses the existing signals: heartbeat staleness (this
  module's own ``OP_MEMBER`` heartbeats), the transport's TCP reachability
  probe (``window._probe_missing_ranks``-style connect checks), and —
  opt-in via ``BLUEFOG_TPU_CHURN_STRAGGLER_STEPS`` — the step-lag that
  feeds ``bf_straggler_score``.
* **Consensus** is the symmetric all-survivors-agree rule: every process
  continuously broadcasts its current *proposal* (the survivor set it
  believes in) inside its heartbeats; a process commits epoch ``e -> e+1``
  exactly when every member of its proposal ``P`` has proposed the
  identical ``P`` for epoch ``e``.  The rule is deterministic in the
  proposal sets, so all survivors commit the same view without a leader,
  and the continuous rebroadcast makes it self-healing under message loss.
  Suspicion is unioned across proposers (a survivor adopts a peer's
  suspicion unless it can refute it with a fresh heartbeat), so transient
  disagreement converges instead of deadlocking.  A process that finds
  itself excluded from a committed view (its peers moved to epoch ``e+1``
  without it) marks itself EVICTED and stops participating — the graceful
  exit path for a persistently straggling or partitioned rank.

Everything here is inert unless ``BLUEFOG_TPU_CHURN=1``: no controller is
ever installed, no heartbeat is ever sent, and ``OP_MEMBER`` frames are
dropped on receipt.  The ``=0`` path is bit-identical to the pre-churn tree.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import networkx as nx

from bluefog_tpu_torch.utils import config

__all__ = ["MembershipView", "MembershipController", "survivor_topology",
           "install", "current", "handle_wire", "health_summary"]


class MembershipView:
    """One committed membership epoch: which processes (and therefore which
    ranks) are in the gang, and what the commit removed or admitted."""

    def __init__(self, epoch: int, active_procs: Tuple[int, ...],
                 active_ranks: Tuple[int, ...],
                 removed_procs: Tuple[int, ...] = (),
                 removed_ranks: Tuple[int, ...] = (),
                 evicted: bool = False,
                 added_procs: Tuple[int, ...] = (),
                 added_ranks: Tuple[int, ...] = (),
                 added_endpoints: Optional[Dict[int, str]] = None):
        self.epoch = epoch
        self.active_procs = tuple(sorted(active_procs))
        self.active_ranks = tuple(sorted(active_ranks))
        self.removed_procs = tuple(sorted(removed_procs))
        self.removed_ranks = tuple(sorted(removed_ranks))
        # Elastic scale-UP (ops/gang.py): processes admitted BY this
        # commit, the ranks they took over, and their transport
        # endpoints ("host:port") — what the supervisor's growth
        # recovery needs to extend the rank directory before re-planning.
        self.added_procs = tuple(sorted(added_procs))
        self.added_ranks = tuple(sorted(added_ranks))
        self.added_endpoints = dict(added_endpoints or {})
        # True when THIS process is the one voted out: it must stop
        # gossiping and exit gracefully, not re-plan around itself.
        self.evicted = evicted

    def __repr__(self):
        return (f"MembershipView(epoch={self.epoch}, "
                f"active_ranks={list(self.active_ranks)}"
                + (f", added={list(self.added_ranks)}"
                   if self.added_ranks else "")
                + (", EVICTED" if self.evicted else "") + ")")


class MembershipController:
    """The consensus state machine.  Transport-agnostic by construction:
    ``send_fn(proc, payload_bytes)`` ships one membership message to a peer
    process (best effort — failures are themselves a liveness signal) and
    ``probe_fn(proc) -> bool`` answers "does this peer still accept TCP?".
    Both are injectable, so the protocol is unit-testable with an in-memory
    router and a fake clock (``now_fn``)."""

    def __init__(self, n_procs: int, my_proc: int,
                 rank_owner: Dict[int, int], *,
                 send_fn: Callable[[int, bytes], None],
                 probe_fn: Optional[Callable[[int], bool]] = None,
                 now_fn: Callable[[], float] = time.monotonic,
                 suspect_sec: Optional[float] = None,
                 straggler_steps: Optional[int] = None,
                 active=None, epoch: int = 0, joining: bool = False,
                 my_join_ranks=(), my_endpoint: Optional[str] = None):
        cfg = config.get()
        self.n_procs = n_procs
        self.my_proc = my_proc
        self.rank_owner = dict(rank_owner)
        self.send_fn = send_fn
        self.probe_fn = probe_fn
        self.now_fn = now_fn
        self.suspect_sec = (cfg.churn_suspect_ms / 1e3
                            if suspect_sec is None else suspect_sec)
        self.straggler_steps = (cfg.churn_straggler_steps
                                if straggler_steps is None
                                else straggler_steps)
        # Barrier-free async mode (BLUEFOG_TPU_ASYNC): ranks LEGITIMATELY
        # run ahead of each other between exact-collect backstops, so a
        # raw step-lag threshold would evict peers that are merely slow.
        # The lag a healthy straggler can accumulate is bounded by the
        # backstop cadence (fast ranks block at the collect fence until
        # it arrives), so the effective threshold widens by exactly
        # ASYNC_COLLECT_EVERY; with no backstop (collect_every=0) lag is
        # unbounded by design and step-lag eviction disables itself —
        # the staleness policy, not membership, absorbs slow peers.
        self._async_mode = cfg.async_mode
        self._async_collect_every = cfg.async_collect_every
        self._lock = threading.RLock()
        self.epoch = int(epoch)
        self._warned_lag_eviction_off = False
        # `active` defaults to every process (the classic fixed-gang
        # construction); a JOINING process seeds it from its join grant —
        # the committed survivor set it is asking to be admitted into.
        self.active: frozenset = (frozenset(active) if active is not None
                                  else frozenset(range(n_procs)))
        # Elastic scale-up state (ops/gang.py).  `joining`: this process
        # is a granted-but-uncommitted joiner — it proposes
        # `active | {me}` and heartbeats with its rank/endpoint claim
        # until a commit admits it.  `pending_joins`: granted joiners
        # heard from (proc -> (ranks, endpoint, first-heard monotonic));
        # they enter every proposal while their heartbeats stay fresh.
        # `joined_info`: permanent record of admitted joiners' rank/
        # endpoint claims; `joined_at_epoch`: procs admitted by the
        # CURRENT epoch's commit, gossiped so a behind peer can adopt a
        # grown view it never saw the joiner's own heartbeats for.
        self.joining = bool(joining)
        self.my_join_ranks = tuple(int(r) for r in my_join_ranks)
        self.my_endpoint = my_endpoint
        self.pending_joins: Dict[int, tuple] = {}
        self.joined_info: Dict[int, tuple] = {}
        self.joined_at_epoch: frozenset = frozenset()
        self.evicted = False
        self.changes_total = 0
        self.last_change_unix: Optional[float] = None
        # Liveness bookkeeping.  last_seen starts at construction time so a
        # peer that NEVER heartbeats (died during init) still ages out.
        now = now_fn()
        self.last_seen: Dict[int, float] = {p: now for p in self.active
                                            if p != my_proc}
        self.peer_step: Dict[int, int] = {}
        self.my_step = 0
        # proc -> (epoch, frozenset proposal, monotonic time heard).  The
        # equality check reads the latest; staleness beyond the suspect
        # window retires an entry (a withdrawn proposal must not linger).
        self.proposals: Dict[int, Tuple[int, frozenset, float]] = {}
        self._pending: List[MembershipView] = []
        # One-shot eviction verdicts: procs removed by the last commit that
        # may still be ALIVE (straggler/partition eviction).  The next tick
        # sends them the committed view once, so an evicted-but-reachable
        # rank learns it was voted out instead of — having lost everyone
        # else's heartbeats — eventually committing a lonely gang of one.
        self._notify_removed: List[int] = []

    # -- derived views -----------------------------------------------------

    def active_ranks(self, procs=None) -> Tuple[int, ...]:
        procs = self.active if procs is None else procs
        return tuple(sorted(r for r, p in self.rank_owner.items()
                            if p in procs))

    def view(self) -> MembershipView:
        with self._lock:
            return MembershipView(self.epoch, tuple(self.active),
                                  self.active_ranks(),
                                  evicted=self.evicted)

    # -- wire --------------------------------------------------------------

    def _payload(self, prop: Optional[frozenset]) -> bytes:
        body = {
            "k": "hb",
            "proc": self.my_proc,
            "epoch": self.epoch,
            "step": self.my_step,
            "active": sorted(self.active),
            "prop": None if prop is None else sorted(prop),
        }
        # Join keys ride the heartbeat ONLY when a join is actually in
        # flight or was just committed — with no joins anywhere the
        # payload stays byte-identical to the pre-join wire (tested).
        if self.joining:
            body["join"] = list(self.my_join_ranks)
            if self.my_endpoint:
                body["ep"] = self.my_endpoint
        if self.joined_at_epoch:
            # Enough for a peer that never heard the joiner directly to
            # adopt the grown view: who joined, which ranks they own, and
            # where their transport listens.
            body["joined"] = sorted(self.joined_at_epoch)
            body["joined_ranks"] = {
                str(p): list(self.joined_info[p][0])
                for p in sorted(self.joined_at_epoch)
                if p in self.joined_info}
            body["joined_eps"] = {
                str(p): self.joined_info[p][1]
                for p in sorted(self.joined_at_epoch)
                if p in self.joined_info and self.joined_info[p][1]}
        return json.dumps(body).encode()

    def _adopt_joined_info(self, msg: dict) -> None:
        """Fold a heartbeat's joined-proc claims (ranks + endpoints) into
        ``joined_info`` so an adopted grown view can extend ``rank_owner``
        even when this process never saw the joiner's own heartbeats
        (caller holds the lock)."""
        ranks = msg.get("joined_ranks") or {}
        eps = msg.get("joined_eps") or {}
        for p_s, rr in ranks.items():
            p = int(p_s)
            if p not in self.joined_info:
                self.joined_info[p] = (tuple(int(r) for r in rr),
                                       eps.get(p_s))

    def on_message(self, msg: dict) -> None:
        """Apply one inbound membership message (drain-thread entry: takes
        only the controller lock, never blocks on peers)."""
        with self._lock:
            if self.evicted:
                return
            p = int(msg.get("proc", -1))
            if p < 0 or p == self.my_proc:
                return
            now = self.now_fn()
            self.last_seen[p] = now
            if "step" in msg:
                self.peer_step[p] = int(msg["step"])
            self._adopt_joined_info(msg)
            if "join" in msg and p not in self.active:
                self._note_pending_join(
                    p, msg.get("join") or [], msg.get("ep"), now)
            their_epoch = int(msg.get("epoch", 0))
            their_active = frozenset(int(x) for x in msg.get("active", []))
            if their_epoch > self.epoch and their_active:
                # A peer committed ahead of us (our agreement message was
                # still in flight when it crossed the threshold).  The
                # commit rule is deterministic, so adopting its view is the
                # same commit we were about to make — unless the view
                # excludes us, which is the eviction verdict.  A JOINING
                # process is different: it was never a member, so a newer
                # view without it (the gang shrank again while its
                # admission was in flight) is not a verdict — it adopts
                # the view as its new base and keeps proposing itself.
                if self.my_proc in their_active:
                    self._commit(their_epoch, their_active)
                elif self.joining:
                    self._rebase_while_joining(their_epoch, their_active)
                else:
                    self._evict()
                return
            if (their_epoch == self.epoch and self.epoch > 0
                    and their_active and their_active != self.active):
                # Same-epoch divergent views: two processes raced their
                # commits from proposal snapshots taken at different
                # instants.  Reconcile INCUMBENTS by INTERSECTION —
                # monotone (a proc both sides already carried survives
                # only in both), deterministic, both sides converge under
                # continuous heartbeats — and JOINERS by UNION: a proc
                # admitted at this epoch appears in a view precisely
                # because its committer verified full agreement including
                # the joiner, and the join announcement may simply not
                # have reached the other committer before its snapshot.
                # (The superset extension of the intersection rule:
                # with no joins the union term is empty and the rule is
                # exactly the old one.)
                their_joined = frozenset(
                    int(x) for x in msg.get("joined") or [])
                joiners = ((self.joined_at_epoch | their_joined)
                           & (self.active | their_active))
                merged = (self.active & their_active) | joiners
                if self.my_proc not in merged:
                    if self.joining:
                        self._rebase_while_joining(self.epoch, merged)
                    else:
                        self._evict()
                elif merged and merged != self.active:
                    self._commit(self.epoch, merged)
                return
            prop = msg.get("prop")
            if their_epoch == self.epoch:
                if prop is not None:
                    self.proposals[p] = (their_epoch,
                                         frozenset(int(x) for x in prop),
                                         now)
                else:
                    # An explicit withdrawal: the peer no longer suspects
                    # anyone.  Clearing the entry matters — a commit
                    # evaluated against a lingering withdrawn proposal
                    # could evict a live rank on votes already retracted.
                    self.proposals.pop(p, None)

    # -- elastic scale-up (ops/gang.py) ------------------------------------

    def _note_pending_join(self, proc: int, ranks, endpoint,
                           now: float) -> None:
        """Register a granted joiner's admission claim (lock held).  The
        claim is validated against the live world: its ranks must be
        VACANT (owned by no active proc) and must not collide with an
        earlier pending claim — a colliding later claim is ignored (the
        grantor-side reservation makes collisions a cross-grantor race,
        and dropping the newcomer deterministically keeps every
        controller's proposal convergent)."""
        ranks = tuple(int(r) for r in ranks)
        if proc in self.pending_joins:
            # Refresh liveness only; the claim itself is immutable.
            old = self.pending_joins[proc]
            self.pending_joins[proc] = (old[0], endpoint or old[1], old[2])
            return
        active_ranks = set(self.active_ranks())
        claimed = {r for info in self.pending_joins.values()
                   for r in info[0]}
        if (set(ranks) & active_ranks) or (set(ranks) & claimed) \
                or not ranks:
            from bluefog_tpu_torch.utils.logging import get_logger
            get_logger().warning(
                "membership: join claim from proc %d for ranks %s "
                "collides with live or already-claimed ranks — ignored",
                proc, list(ranks))
            return
        self.pending_joins[proc] = (ranks, endpoint, now)

    def _rebase_while_joining(self, epoch: int, active: frozenset) -> None:
        """The gang committed past us while our admission was in flight
        (lock held): adopt the newer survivor set as the join's new base
        — no view is emitted (we were never a member, there is nothing to
        recover) and the next tick proposes ``active | {me}`` again."""
        self.epoch = int(epoch)
        self.active = frozenset(active)
        self.proposals.clear()
        now = self.now_fn()
        for p in self.active:
            if p != self.my_proc:
                self.last_seen.setdefault(p, now)
        from bluefog_tpu_torch.utils.logging import get_logger
        get_logger().info(
            "membership: gang committed epoch %d while this process was "
            "still joining — rebasing the join on the new survivor set "
            "%s", self.epoch, sorted(self.active))

    def note_join(self, proc: int, ranks, endpoint: Optional[str]) -> None:
        """Grantor-side entry: record the joiner this process just granted
        so it enters our proposals immediately (its own heartbeats will
        reach the rest of the gang)."""
        with self._lock:
            if self.evicted or proc in self.active:
                return
            self._note_pending_join(proc, ranks, endpoint, self.now_fn())

    def peer_endpoint_hint(self, proc: int) -> Optional[tuple]:
        """(host, port) of a proc known only through the join protocol —
        what the supervisor's send path falls back to for peers not yet in
        the transport directory (pending or freshly admitted joiners)."""
        with self._lock:
            info = self.pending_joins.get(proc) \
                or self.joined_info.get(proc)
        ep = info[1] if info else None
        if not ep:
            return None
        try:
            from bluefog_tpu_torch.ops.gang import _ep_addr
            return _ep_addr(ep)
        except ValueError:
            return None

    # -- detection + consensus tick ---------------------------------------

    def note_step(self, step: int) -> None:
        with self._lock:
            self.my_step = int(step)

    def _straggler_bound(self) -> int:
        """Effective step-lag eviction threshold: 0 = lag eviction off.
        Lockstep mode: the raw CHURN_STRAGGLER_STEPS knob.  Async mode:
        widened by the collect-backstop cadence (the lag a merely-slow
        peer legitimately reaches); disabled entirely with no backstop —
        any threshold would evict healthy slow peers the staleness
        policy is already absorbing."""
        if not self.straggler_steps:
            return 0
        if not self._async_mode:
            return self.straggler_steps
        if not self._async_collect_every:
            if not self._warned_lag_eviction_off:
                self._warned_lag_eviction_off = True
                from bluefog_tpu_torch.utils.logging import get_logger
                get_logger().warning(
                    "churn: BLUEFOG_TPU_CHURN_STRAGGLER_STEPS is set but "
                    "BLUEFOG_TPU_ASYNC=1 with no collect backstop "
                    "(BLUEFOG_TPU_ASYNC_COLLECT_EVERY=0) makes step lag "
                    "unbounded by design — step-lag eviction is disabled")
            return 0
        return self.straggler_steps + self._async_collect_every

    def _stale_peers(self, now: float) -> List[int]:
        """Active peers whose heartbeats have gone stale (lock held by the
        caller) — the probe candidates."""
        fresh_cut = now - self.suspect_sec
        return [p for p in sorted(self.active)
                if p != self.my_proc
                and self.last_seen.get(p, 0.0) < fresh_cut]

    def _suspects(self, now: float, probes: Optional[dict] = None
                  ) -> frozenset:
        """Fuse the liveness signals into the set of suspected processes.

        ``probes`` carries pre-collected reachability verdicts for the
        stale peers ({proc: bool}); the blocking TCP probes themselves run
        OUTSIDE the controller lock (see :meth:`tick`) — a probe hanging
        to its timeout on a lost host must never starve the drain thread's
        ``on_message`` into making healthy peers look stale too.  A stale
        peer with no verdict (``summary()`` passes an empty dict: the
        /healthz path must not do network I/O) is suspected only on the
        hard-silence window."""
        out = set()
        fresh_cut = now - self.suspect_sec
        straggler_bound = self._straggler_bound()
        for p in sorted(self.active):
            if p == self.my_proc:
                continue
            stale = self.last_seen.get(p, 0.0) < fresh_cut
            if stale:
                verdict = None if probes is None else probes.get(p)
                if verdict is False or (self.probe_fn is None
                                        and probes is None):
                    out.add(p)  # silent AND unreachable: dead
                elif self.last_seen.get(p, 0.0) < now - 3 * self.suspect_sec:
                    # Reachable (or unprobed) but silent for 3x the
                    # window: its listener answers TCP but nothing flows
                    # (wedged process, or a chaos partition dropping its
                    # outbound traffic).
                    out.add(p)
            elif (straggler_bound
                  and self.my_step - self.peer_step.get(p, self.my_step)
                  > straggler_bound):
                # Alive but persistently behind: the straggler-eviction
                # policy (opt-in) proposes it out so the survivors stop
                # waiting on its gossip.
                out.add(p)
        # Union of suspicion: adopt a proposer's suspicion of q unless we
        # can refute it with a fresh heartbeat from q — transiently
        # disagreeing survivors converge to the same proposal instead of
        # deadlocking on each other's partial views.
        for p, (ep, prop, heard) in list(self.proposals.items()):
            if ep != self.epoch or heard < fresh_cut:
                self.proposals.pop(p, None)
                continue
            for q in self.active - prop:
                if q != self.my_proc and self.last_seen.get(q, 0.0) < fresh_cut:
                    out.add(q)
        return frozenset(out)

    def tick(self) -> None:
        """One detection + consensus round: re-evaluate suspicion, heartbeat
        every active peer (carrying the current proposal), and commit when
        all survivors agree.  Called on the supervisor's heartbeat cadence.

        The blocking TCP probes run between two short lock holds: a probe
        that hangs to its timeout (lost host) delays only this heartbeat
        round, never the drain thread's inbound message handling."""
        with self._lock:
            if self.evicted:
                return
            now = self.now_fn()
            candidates = self._stale_peers(now)
        probes: Dict[int, bool] = {}
        for p in candidates:
            if self.probe_fn is None:
                probes[p] = False  # no probe available: silence decides
            else:
                try:
                    probes[p] = bool(self.probe_fn(p))
                except Exception:  # noqa: BLE001 — a probe crash = down
                    probes[p] = False
        with self._lock:
            if self.evicted:
                return
            now = self.now_fn()
            suspects = self._suspects(now, probes)
            # A granted joiner that died (or went silent) before its
            # commit simply ages out of the pending set — its claim must
            # not keep every survivor proposing a grown view forever.
            fresh_cut = now - self.suspect_sec
            for p in [p for p, info in self.pending_joins.items()
                      if max(info[2], self.last_seen.get(p, 0.0))
                      < fresh_cut]:
                self.pending_joins.pop(p, None)
            joins = frozenset(self.pending_joins)
            prop = None
            if suspects or joins or self.joining:
                prop = frozenset((self.active - suspects) | joins
                                 | ({self.my_proc} if self.joining
                                    else frozenset()))
            if prop is not None:
                self.proposals[self.my_proc] = (self.epoch, prop, now)
            else:
                self.proposals.pop(self.my_proc, None)
            payload = self._payload(prop)
            targets = [p for p in sorted(self.active | joins)
                       if p != self.my_proc and p not in suspects]
            if prop is not None:
                self._maybe_commit(prop)
            if self._notify_removed:
                # Deliver eviction verdicts with the COMMITTED state (the
                # payload above may predate a commit _maybe_commit just
                # made), best effort, once.
                payload = self._payload(None)
                targets = targets + self._notify_removed
                self._notify_removed = []
        # Sends happen OUTSIDE the lock: send_fn may block briefly on a
        # backpressured queue, and the drain thread must keep delivering
        # inbound membership traffic meanwhile.
        for p in targets:
            try:
                self.send_fn(p, payload)
            except Exception:  # noqa: BLE001 — a failed send IS the signal
                pass

    def _maybe_commit(self, prop: frozenset) -> None:
        """Commit iff every member of the proposal has proposed exactly it
        for the current epoch (caller holds the lock)."""
        if self.my_proc not in prop:
            self._evict()
            return
        for q in prop:
            if q == self.my_proc:
                continue
            entry = self.proposals.get(q)
            if entry is None or entry[0] != self.epoch or entry[1] != prop:
                return
        self._commit(self.epoch + 1, prop)

    def _commit(self, epoch: int, active: frozenset) -> None:
        removed = frozenset(self.active) - active
        added = frozenset(active) - self.active
        now = self.now_fn()
        added_eps: Dict[int, str] = {}
        admission_secs = []
        for p in sorted(added):
            # The admitted proc's rank/endpoint claim: from its own join
            # heartbeats (pending_joins), from a peer's gossip about an
            # earlier commit (joined_info), or — when WE are the joiner —
            # from the grant itself.
            info = self.pending_joins.pop(p, None)
            if info is not None:
                ranks, ep, heard = info
                admission_secs.append(max(0.0, now - heard))
            elif p == self.my_proc:
                ranks, ep = self.my_join_ranks, self.my_endpoint
            elif p in self.joined_info:
                ranks, ep = self.joined_info[p]
            else:
                from bluefog_tpu_torch.utils.logging import get_logger
                get_logger().warning(
                    "membership: adopted a view admitting proc %d with no "
                    "rank claim on record — its ranks stay unowned until "
                    "its gossip arrives", p)
                continue
            for r in ranks:
                self.rank_owner[r] = p
            self.joined_info[p] = (tuple(ranks), ep)
            if ep:
                added_eps[p] = ep
            self.last_seen[p] = now
        self.joined_at_epoch = added
        if self.my_proc in added:
            self.joining = False
        view = MembershipView(
            epoch, tuple(active), self.active_ranks(active),
            removed_procs=tuple(removed),
            # After the reassignment above, so a rank revived by this
            # very commit is never reported as removed.
            removed_ranks=self.active_ranks(removed),
            added_procs=tuple(added),
            added_ranks=tuple(sorted(
                r for p in added for r in self.joined_info.get(p, ((),))[0]
            )),
            added_endpoints=added_eps)
        self.epoch = epoch
        self.active = frozenset(active)
        self.proposals.clear()
        self.changes_total += 1
        self.last_change_unix = time.time()
        self._pending.append(view)
        self._notify_removed = sorted(removed)
        self._publish_telemetry(n_joins=len(added),
                                admission_secs=admission_secs)
        from bluefog_tpu_torch.utils.logging import get_logger
        get_logger().warning(
            "membership: epoch %d committed — active ranks %s (removed "
            "ranks %s%s)", epoch, list(view.active_ranks),
            list(view.removed_ranks),
            f", added ranks {list(view.added_ranks)}"
            if view.added_ranks else "")

    def _evict(self) -> None:
        self.evicted = True
        self.changes_total += 1
        self.last_change_unix = time.time()
        self._pending.append(MembershipView(
            self.epoch + 1, (), (), removed_procs=(self.my_proc,),
            removed_ranks=self.active_ranks({self.my_proc}),
            evicted=True))
        from bluefog_tpu_torch.utils.logging import get_logger
        get_logger().warning(
            "membership: this process (proc %d) was voted out of the gang "
            "— stopping gossip participation", self.my_proc)

    def poll_change(self) -> Optional[MembershipView]:
        """One committed-but-unapplied membership change, oldest first
        (None when the view is stable).  The supervisor drains this at step
        boundaries and performs the actual re-plan."""
        with self._lock:
            return self._pending.pop(0) if self._pending else None

    # -- telemetry ---------------------------------------------------------

    def _publish_telemetry(self, n_joins: int = 0,
                           admission_secs=()) -> None:
        if current() is not self:
            # Only the process's INSTALLED controller owns the process-wide
            # gauges (hermetic tests wire several controllers in one
            # process; their commits must not multiply the counters).
            return
        from bluefog_tpu_torch.utils import telemetry
        telemetry.inc("bf_membership_changes_total")
        telemetry.set_gauge("bf_active_ranks", len(self.active_ranks()))
        telemetry.set_gauge("bf_membership_epoch", self.epoch)
        if n_joins:
            telemetry.inc("bf_membership_joins_total", float(n_joins))
        for sec in admission_secs:
            # First-heard join claim -> committed grow epoch, as observed
            # by this survivor: the admission latency an operator tunes
            # heartbeat/suspect windows against.
            telemetry.observe("bf_join_admission_seconds", float(sec))
        if self.last_change_unix is not None:
            telemetry.set_gauge("bf_churn_last_change_timestamp",
                                self.last_change_unix)

    def summary(self) -> dict:
        """The /healthz "membership" block (and the %bfstat line).  No
        network I/O: suspicion is reported from heartbeat staleness alone
        (empty probe verdicts), so a monitoring scrape can never stall on
        a dead host's connect timeout."""
        with self._lock:
            now = self.now_fn()
            suspects = sorted(self._suspects(now, {})) \
                if not self.evicted else []
            out = {
                "epoch": self.epoch,
                "active_ranks": list(self.active_ranks()),
                "world_ranks": len(self.rank_owner),
                "changes_total": self.changes_total,
                "suspect_ranks": sorted(
                    r for p in suspects for r, o in self.rank_owner.items()
                    if o == p),
                "evicted": self.evicted,
                "last_change_unix": self.last_change_unix,
            }
            if self.pending_joins:
                # Admission in flight: the ranks granted joiners are
                # claiming — what /healthz shows between the grant and
                # the committed grow epoch.
                out["pending_join_ranks"] = sorted(
                    r for info in self.pending_joins.values()
                    for r in info[0])
            if self.joining:
                out["joining"] = True
            return out


# ---------------------------------------------------------------------------
# Survivor re-planning
# ---------------------------------------------------------------------------

def survivor_topology(n: int, active_ranks, builder=None) -> nx.DiGraph:
    """A virtual topology over the full ``n``-rank world that gossips only
    among ``active_ranks``: the builder's graph over the survivors
    (relabeled onto their global rank ids) with every dead rank isolated
    under a self-loop of weight 1.

    The effective weight matrix stays doubly stochastic: the survivor
    submatrix is the builder's doubly-stochastic matrix (every standard
    generator in ``topology.py`` funnels through ``_circulant``), and the
    dead rows/columns are exactly the identity.  Keeping the dead ranks as
    isolated nodes means ``set_topology`` needs no world-size surgery —
    the mesh, the schedule compiler and the placement/synthesis pipeline
    all see an ordinary ``n``-node topology with no edges to price on the
    dead links."""
    from bluefog_tpu_torch import topology as topology_util
    active = sorted(int(r) for r in active_ranks)
    if not active:
        raise ValueError("survivor_topology: no active ranks")
    if len(set(active)) != len(active) or active[0] < 0 or active[-1] >= n:
        raise ValueError(
            f"survivor_topology: active ranks {active} must be distinct "
            f"ranks in range({n})")
    if builder is None:
        builder = topology_util.ExponentialGraph
    g = builder(len(active))
    topo = nx.relabel_nodes(g, dict(enumerate(active)), copy=True)
    topo.add_nodes_from(range(n))
    for r in range(n):
        if r not in topo or topo.degree(r) == 0:
            topo.add_edge(r, r, weight=1.0)
    return topo


# ---------------------------------------------------------------------------
# Process-wide registry (the transport's drain thread and /healthz both
# need to find the live controller without import cycles)
# ---------------------------------------------------------------------------

_active_controller: Optional[MembershipController] = None
_registry_lock = threading.Lock()


def install(ctrl: Optional[MembershipController]) -> None:
    global _active_controller
    with _registry_lock:
        _active_controller = ctrl


def current() -> Optional[MembershipController]:
    return _active_controller


def handle_wire(payload) -> None:
    """Entry point for inbound ``OP_MEMBER`` frames (called from the window
    store's drain-thread apply).  Payload is a zero-copy view into the recv
    buffer — decoded here, never retained.  Dropped silently when no
    controller is installed (churn off, or a straggling peer still
    heartbeating after our shutdown)."""
    ctrl = _active_controller
    if ctrl is None:
        return
    try:
        msg = json.loads(bytes(payload).decode())
    except (ValueError, UnicodeDecodeError):
        from bluefog_tpu_torch.utils.logging import get_logger
        get_logger().warning("membership: undecodable OP_MEMBER frame "
                             "dropped (%d bytes)", len(payload))
        return
    ctrl.on_message(msg)


def health_summary() -> Optional[dict]:
    """The membership block for ``/healthz`` (None when churn is off)."""
    ctrl = _active_controller
    if ctrl is None:
        return None
    return ctrl.summary()
