"""Gossip-native gang join/bootstrap: elastic scale-up without a coordinator.

The port of ``bluefog_tpu/ops/gang.py``.  The churn controller
(``ops/membership.py``) makes the gang shrink; this module is the other
half: capacity follows traffic in both directions, and no single
process's death can take the gang down.  The directory, its merge, its
persisted JSON and the wire messages are the JAX package's byte for byte;
what differs is where the windows live.  A grant's owned-row snapshot
leaves the card once, through one pinned host copy of the donor row, and
a joiner's rows go from the decoded grant straight to the card
(:class:`JoinGrant` ``windows[name]["rows"]`` are device tensors).

Two halves, both behind ``BLUEFOG_TPU_ELASTIC_JOIN`` (default off — with
the knob off nothing here is ever installed, ``OP_GANG`` frames are
dropped on receipt, and every legacy path is bit-identical):

**Wired join.**  A fresh process (``bfrun --join <endpoint>``) contacts
ANY live member over the window transport's FIFO streams with a
``join_req``; the member grants it a process id plus a set of VACANT
ranks (ranks whose owning process left the gang), chosen where the
placement model prices them cheapest (:func:`choose_admission_ranks`),
and ships the current epoch/view, the endpoint directory, and an
owned-row snapshot of every live window — the same per-process authority
contract ``utils/elastic.py`` and ``run/supervisor._recover`` already
enforce on shrink, applied in the grow direction (the joiner starts from
a survivor's consensus estimate).  The joiner then heartbeats every
member with its admission claim, and the gang commits epoch ``e -> e+1``
with the grown survivor topology through the ordinary all-survivors-agree
rule in ``ops/membership.py`` — join proposals are supersets, suspicion
proposals are subsets, and the two compose in one consensus round.

**Coordinator-free bootstrap.**  A gossip-replicated endpoint directory
(:class:`GangDirectory`: an epoch-versioned rank→endpoint map) replaces
the rendezvous store (c10d, or the JAX package's coordinator) for endpoint exchange and membership
rendezvous.  Endpoints are write-once per process id, so the endpoint map
union-merges conflict-free; the (epoch, active, rank_owner) triple adopts
whichever side committed further.  Every process persists its copy
(``BLUEFOG_TPU_GANG_DIR_PATH``: ``<prefix>.<proc>.json``, atomically,
beside ``owned_ranks.json`` when pointed at the checkpoint directory) and
anti-entropy rides ``OP_GANG`` urgent wire ops on the same per-peer FIFO
streams as gossip — killing rank 0's host removes one replica of a
replicated map, not the map.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.utils import config

__all__ = ["GangDirectory", "GangService", "JoinGrant", "parse_peers",
           "choose_admission_ranks", "init_elastic", "join_gang",
           "install", "current", "handle_wire", "health_summary",
           "bootstrap_endpoints"]


def parse_peers(spec: str) -> List[Tuple[str, int]]:
    """Parse ``BFTPU_GANG_PEERS`` (``host:port,host:port,...``, index =
    process id) into a list of endpoints."""
    peers = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        host, sep, port = item.rpartition(":")
        if not sep or not host:
            raise ValueError(f"gang: bad peer endpoint {item!r} "
                             "(expected host:port)")
        peers.append((host, int(port)))
    if not peers:
        raise ValueError("gang: BFTPU_GANG_PEERS is empty")
    return peers


def _stage_replica(path: str, text: str) -> str:
    """Write ``text`` to a temporary file beside ``path`` and return its
    name.  The name is this write's own (process and thread), so two
    writes of one path at once never rename each other's file (the rename
    race); it does not end in ``.json``, so
    :meth:`GangDirectory.load_any` never reads one."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    try:
        with open(tmp, "w") as fh:
            fh.write(text)
    except BaseException:
        _place_replica(tmp, None)
        raise
    return tmp


def _place_replica(tmp: str, path: Optional[str]) -> None:
    """Replace ``path`` with a staged replica atomically (a reader never
    sees a torn replica, and a crash mid-write leaves the previous copy),
    or, with ``path`` None, drop it; a failed replace drops it too."""
    placed = False
    try:
        if path is not None:
            os.replace(tmp, path)
            placed = True
    finally:
        if not placed:
            try:
                os.unlink(tmp)
            except OSError:
                pass


ADMISSION_STAMP = "gang admission "


def _admission_stamp(step: str, unix: Optional[float] = None,
                     **detail) -> None:
    """One step of a join's admission, the joiner's or its granting
    member's, on the log's info level (``BLUEFOG_TPU_LOG_LEVEL=info``):
    :data:`ADMISSION_STAMP` and one JSON object, ``step``, ``unix`` (the
    step's time on the unix clock, which a host's processes share) and
    ``detail``.  ``tools chaos``'s join leg reads them from both sides'
    stderr."""
    from bluefog_tpu_torch.utils.logging import get_logger
    log = get_logger()
    if log.isEnabledFor(logging.INFO):
        rec = {"step": step,
               "unix": round(time.time() if unix is None else unix, 4)}
        rec.update(detail)
        log.info("%s%s", ADMISSION_STAMP, json.dumps(rec))


def _ep_str(addr: Tuple[str, int]) -> str:
    return f"{addr[0]}:{addr[1]}"


def _ep_addr(ep: str) -> Tuple[str, int]:
    """``"host:port"`` → ``(host, port)`` — the ONE parse every consumer
    of directory/claim endpoints shares (membership hints and the
    supervisor's growth recovery included)."""
    host, sep, port = ep.rpartition(":")
    if not sep or not host:
        raise ValueError(f"gang: bad endpoint {ep!r} (expected host:port)")
    return (host, int(port))


class GangDirectory:
    """The gossip-replicated endpoint directory: who is in the gang, which
    ranks each process owns, and where its transport listens.

    Merge semantics are CRDT-shaped so replicas converge without
    coordination: ``endpoints`` entries are write-once per proc id (a
    restarted process gets a NEW id, never a recycled one) and
    union-merge; the ``(epoch, active, rank_owner)`` triple is owned by
    the membership consensus and the higher epoch wins wholesale.  A
    same-proc endpoint conflict — only reachable through a cross-grantor
    id race — resolves deterministically to the lexicographically smaller
    endpoint, with a warning."""

    def __init__(self, n_ranks: int, endpoints: Dict[int, str],
                 epoch: int = 0, active=(), rank_owner=None):
        self.n_ranks = int(n_ranks)
        self.endpoints = {int(p): str(e) for p, e in endpoints.items()}
        self.epoch = int(epoch)
        self.active = tuple(sorted(int(p) for p in active))
        self.rank_owner = {int(r): int(p)
                           for r, p in (rank_owner or {}).items()}

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "n_ranks": self.n_ranks,
            "endpoints": {str(p): e
                          for p, e in sorted(self.endpoints.items())},
            "epoch": self.epoch,
            "active": list(self.active),
            "rank_owner": {str(r): p
                           for r, p in sorted(self.rank_owner.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GangDirectory":
        return cls(d["n_ranks"],
                   {int(p): e for p, e in d.get("endpoints", {}).items()},
                   epoch=d.get("epoch", 0), active=d.get("active", ()),
                   rank_owner={int(r): p
                               for r, p in d.get("rank_owner", {}).items()})

    # -- CRDT merge ---------------------------------------------------------

    def merge(self, other: "GangDirectory") -> bool:
        """Fold another replica in; returns True when anything changed."""
        changed = False
        for p, ep in other.endpoints.items():
            mine = self.endpoints.get(p)
            if mine is None:
                self.endpoints[p] = ep
                changed = True
            elif mine != ep:
                from bluefog_tpu_torch.utils.logging import get_logger
                get_logger().warning(
                    "gang directory: conflicting endpoints for proc %d "
                    "(%s vs %s) — keeping %s (cross-grantor id race?)",
                    p, mine, ep, min(mine, ep))
                if ep < mine:
                    self.endpoints[p] = ep
                    changed = True
        if other.epoch > self.epoch:
            self.epoch = other.epoch
            self.active = tuple(other.active)
            self.rank_owner = dict(other.rank_owner)
            changed = True
        return changed

    def vacant_ranks(self) -> List[int]:
        """Ranks owned by no active process — the admission pool."""
        active = set(self.active)
        return sorted(r for r, p in self.rank_owner.items()
                      if p not in active)

    def live_endpoints(self) -> List[Tuple[str, int]]:
        """Endpoints of the ACTIVE processes (join candidates), active
        order."""
        return [_ep_addr(self.endpoints[p]) for p in self.active
                if p in self.endpoints]

    # -- persistence --------------------------------------------------------

    def persist(self, path: str) -> None:
        """Atomic write (:func:`_stage_replica`, :func:`_place_replica`):
        a reader can never observe a torn directory, and a crash
        mid-write leaves the previous copy."""
        _place_replica(_stage_replica(path, json.dumps(self.to_dict())),
                       path)

    @classmethod
    def load(cls, path: str) -> "GangDirectory":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    @classmethod
    def load_any(cls, prefix: str) -> "GangDirectory":
        """Merge every replica persisted under ``<prefix>.<proc>.json``
        (plus a bare ``<prefix>`` file) into one view — the freshest
        committed epoch wins, endpoints union.  This is what a joining
        process bootstraps from: any surviving replica is enough."""
        merged: Optional[GangDirectory] = None
        base = os.path.basename(prefix)
        dirname = os.path.dirname(prefix) or "."
        candidates = []
        try:
            for f in sorted(os.listdir(dirname)):
                if f == base or (f.startswith(base + ".")
                                 and f.endswith(".json")):
                    candidates.append(os.path.join(dirname, f))
        except OSError:
            pass
        for path in candidates:
            try:
                d = cls.load(path)
            except (OSError, ValueError, KeyError):
                continue
            if merged is None:
                merged = d
            else:
                merged.merge(d)
        if merged is None:
            raise FileNotFoundError(
                f"gang: no readable directory replica under {prefix!r}")
        return merged


class JoinGrant:
    """What a live member hands a joining process: identity, the committed
    view, the directory, and the owned-row snapshot to start from."""

    def __init__(self, proc: int, ranks: Tuple[int, ...], epoch: int,
                 active: Tuple[int, ...], directory: GangDirectory,
                 windows: Dict[str, dict], my_endpoint: str):
        self.proc = proc
        self.ranks = tuple(ranks)
        self.epoch = epoch
        self.active = tuple(active)
        self.directory = directory
        # name -> {"shape": tuple, "dtype": str, "rows": {rank: tensor}},
        # the rows on the joiner's device
        self.windows = windows
        self.my_endpoint = my_endpoint


# ---------------------------------------------------------------------------
# Placement-aware admission
# ---------------------------------------------------------------------------

def choose_admission_ranks(vacant, want: int, active_ranks=()) -> List[int]:
    """Pick which vacant ranks a joiner is admitted as.

    With a live interconnect model (``ops/placement.py``), each vacant
    rank is priced by the modeled distance from its (placed) device to
    the active ranks' devices and the cheapest seats win — the new
    capacity lands where ``optimize_placement`` prices it, not wherever
    the joiner happened to boot.  (The full re-plan still runs at the
    grow commit: ``set_topology`` re-enters the placement + synthesis
    pipeline for the grown edge set.)  Without a model: lowest rank ids,
    fully deterministic either way."""
    vacant = sorted(set(int(r) for r in vacant))
    want = max(1, int(want))
    if want >= len(vacant):
        return vacant
    try:
        from bluefog_tpu_torch.ops import placement
        state = placement.active()
    except Exception:  # noqa: BLE001 — pricing is an optimization only
        state = None
    if state is None or state[0] is None:
        return vacant[:want]
    model, perm = state

    def dev(rank: int) -> int:
        return int(perm[rank]) if perm is not None else int(rank)

    peers = [int(r) for r in active_ranks]

    def price(rank: int) -> float:
        if not peers:
            return 0.0
        try:
            return float(sum(model.distance(dev(rank), dev(s))
                             for s in peers))
        except Exception:  # noqa: BLE001 — an out-of-model rank: neutral
            return float("inf")

    return sorted(sorted(vacant), key=lambda r: (price(r), r))[:want]


# ---------------------------------------------------------------------------
# The service: join grants + directory anti-entropy
# ---------------------------------------------------------------------------

_RESERVATION_SEC = 60.0


class GangService:
    """Per-process join/directory service.  Installed (``install()``) when
    ``BLUEFOG_TPU_ELASTIC_JOIN=1`` and a gang transport is live; the
    window drain routes inbound ``OP_GANG`` frames here."""

    def __init__(self, directory: GangDirectory,
                 persist_path: Optional[str] = None):
        cfg = config.get()
        self.directory = directory
        # <prefix>.<proc>.json — per-process replica files, so concurrent
        # writers on one filesystem never race each other.
        self._prefix = (cfg.gang_dir_path if persist_path is None
                        else persist_path)
        self._lock = threading.Lock()
        # Persists replace the replica in snapshot order: a snapshot is
        # numbered under `_lock`, and one older than the replica on disk
        # is dropped (`_persist_lock` orders the replaces only; each
        # write's own temporary name keeps concurrent writes apart).
        self._persist_lock = threading.Lock()
        self._snapshots = 0
        self._persisted = 0
        self._reserved: Dict[int, tuple] = {}  # proc -> (ranks, expiry)
        self.pending_grant: Optional[JoinGrant] = None
        self.grants_total = 0

    # -- plumbing -----------------------------------------------------------

    def _distrib(self):
        from bluefog_tpu_torch.ops import window as W
        return W._store.distrib

    def _my_proc(self) -> Optional[int]:
        d = self._distrib()
        return None if d is None else d.my_proc

    def _send(self, addr: Tuple[str, int], body: dict) -> None:
        from bluefog_tpu_torch.ops.transport import OP_GANG
        d = self._distrib()
        if d is None:
            return
        payload = np.frombuffer(json.dumps(body).encode(), np.uint8)
        d.transport.send(addr[0], addr[1], OP_GANG, "",
                         d.my_rank, -1, 0.0, payload)

    def persist(self) -> None:
        from bluefog_tpu_torch.utils import telemetry
        # Snapshot under the service lock: the drain thread's anti-entropy
        # merges and the supervisor's commit follow-through mutate the
        # directory concurrently, and serializing a dict mid-mutation
        # raises.  The disk write happens on the snapshot, outside, in
        # snapshot order: the directory only grows, so a snapshot older
        # than the replica on disk (a lower epoch, or fewer endpoints)
        # never replaces it.
        with self._lock:
            body = json.dumps(self.directory.to_dict())
            epoch = self.directory.epoch
            self._snapshots += 1
            seq = self._snapshots
        telemetry.set_gauge("bf_gang_directory_epoch", epoch)
        if not self._prefix:
            return
        me = self._my_proc()
        path = (f"{self._prefix}.{me}.json" if me is not None
                else f"{self._prefix}.json")
        try:
            tmp = _stage_replica(path, body)
            with self._persist_lock:
                newer = seq >= self._persisted
                _place_replica(tmp, path if newer else None)
                if newer:
                    self._persisted = seq
        except OSError as e:
            from bluefog_tpu_torch.utils.logging import get_logger
            get_logger().warning("gang: directory persist to %s failed: %s",
                                 path, e)

    def announce(self, procs=None) -> None:
        """Anti-entropy push: ship the directory to peers (default: every
        active proc with a known endpoint, except self).  State-based and
        idempotent — duplicates and reordering are harmless."""
        me = self._my_proc()
        with self._lock:
            body = {"k": "dir", "dir": self.directory.to_dict()}
            if procs is None:
                procs = [p for p in self.directory.active if p != me]
            addrs = [_ep_addr(self.directory.endpoints[p]) for p in procs
                     if p in self.directory.endpoints]
        for addr in addrs:
            try:
                self._send(addr, body)
            except Exception:  # noqa: BLE001 — a dead peer is expected
                pass

    # -- inbound dispatch ---------------------------------------------------

    def handle(self, msg: dict) -> None:
        kind = msg.get("k")
        if kind == "dir":
            try:
                other = GangDirectory.from_dict(msg["dir"])
            except (KeyError, ValueError, TypeError):
                return
            with self._lock:
                changed = self.directory.merge(other)
            if changed:
                # Off the drain thread: persist() is disk I/O, and every
                # inbound window message would stall behind a slow
                # (checkpoint-grade NFS) write otherwise.
                from bluefog_tpu_torch.ops import window as W
                W._store.svc_pool.submit(self.persist)
            return
        if kind == "join_req":
            if not config.get().elastic_join:
                self._deny(msg, "BLUEFOG_TPU_ELASTIC_JOIN is off")
                return
            # Grant work (window snapshots under win locks + a reply
            # send) must not run on the drain thread.
            from bluefog_tpu_torch.ops import window as W
            _admission_stamp("request", nonce=msg.get("nonce"))
            W._store.svc_pool.submit(self._grant, msg)
            return
        if kind in ("grant", "deny"):
            _resolve_join_reply(msg)

    # -- the grant side -----------------------------------------------------

    def _deny(self, msg: dict, reason: str) -> None:
        ep = msg.get("ep")
        if ep:
            try:
                self._send(_ep_addr(ep), {"k": "deny",
                                          "nonce": msg.get("nonce"),
                                          "reason": reason})
            except Exception:  # noqa: BLE001
                pass

    def _grant(self, msg: dict) -> None:
        """Admit one joiner: assign a fresh proc id + placement-priced
        vacant ranks, snapshot the live windows' owned rows, reply with
        the grant, and seed the membership controller so the grow
        proposal starts propagating immediately.  Its admission stamps
        (:func:`_admission_stamp`): the pool took it, the rows are
        snapshotted, the grant is sent."""
        from bluefog_tpu_torch.ops import membership
        from bluefog_tpu_torch.ops import window as W
        from bluefog_tpu_torch.utils import telemetry
        _admission_stamp("pool", nonce=msg.get("nonce"))
        ctrl = membership.current()
        joiner_ep = msg.get("ep")
        if not joiner_ep:
            return
        if ctrl is None:
            self._deny(msg, "no membership controller (BLUEFOG_TPU_CHURN "
                            "off?)")
            return
        want = max(1, int(msg.get("want", 1)))
        now = time.monotonic()
        with ctrl._lock:
            epoch = ctrl.epoch
            active = frozenset(ctrl.active)
            rank_owner = dict(ctrl.rank_owner)
            active_ranks = ctrl.active_ranks()
            pending_claimed = {r for info in ctrl.pending_joins.values()
                               for r in info[0]}
            known_procs = (set(rank_owner.values()) | set(active)
                           | set(ctrl.pending_joins)
                           | set(ctrl.joined_info))
        with self._lock:
            self._reserved = {p: v for p, v in self._reserved.items()
                              if v[1] > now}
            reserved_ranks = {r for v in self._reserved.values()
                              for r in v[0]}
            vacant = [r for r, p in rank_owner.items()
                      if p not in active and r not in pending_claimed
                      and r not in reserved_ranks]
            if not vacant:
                pass  # denied below, outside the lock
            else:
                ranks = choose_admission_ranks(vacant,
                                               min(want, len(vacant)),
                                               active_ranks=active_ranks)
                proc = max(known_procs | set(self.directory.endpoints)
                           | {p for p in self._reserved}) + 1
                self._reserved[proc] = (tuple(ranks),
                                        now + _RESERVATION_SEC)
        if not vacant:
            self._deny(msg, "gang is at full strength (no vacant ranks)")
            return
        windows = {}
        donor_note = None
        for name in W.get_current_created_window_names():
            try:
                win = W._store.get(name)
            except KeyError:
                continue
            with win.lock:
                if not win.owned:
                    continue
                donor = win.owned[0]
                row = win.main[donor]
            # One device-to-host copy of the donor row, into pinned memory
            # on a card; every granted rank is sent the same bytes.
            enc = base64.b64encode(_host_bytes(row)).decode()
            windows[name] = {"shape": list(win.shape),
                             "dtype": _dtype_name(win.dtype),
                             "rows": {int(r): enc for r in ranks}}
            donor_note = donor
        _admission_stamp("rows", nonce=msg.get("nonce"))
        with self._lock:
            body = {
                "k": "grant", "nonce": msg.get("nonce"),
                "proc": proc, "ranks": list(ranks),
                "epoch": epoch, "active": sorted(active),
                "n_ranks": self.directory.n_ranks,
                "rank_owner": {str(r): p
                               for r, p in sorted(rank_owner.items())},
                "endpoints": {str(p): e for p, e in
                              sorted(self.directory.endpoints.items())},
                "windows": windows,
            }
        try:
            self._send(_ep_addr(joiner_ep), body)
        except Exception as e:  # noqa: BLE001 — joiner died mid-handshake
            from bluefog_tpu_torch.utils.logging import get_logger
            get_logger().warning("gang: join grant to %s failed: %s",
                                 joiner_ep, e)
            with self._lock:
                self._reserved.pop(proc, None)
            return
        _admission_stamp("sent", nonce=msg.get("nonce"))
        ctrl.note_join(proc, ranks, joiner_ep)
        self.grants_total += 1
        telemetry.inc("bf_gang_join_grants_total")
        from bluefog_tpu_torch.utils.logging import get_logger
        get_logger().warning(
            "gang: granted join — proc %d takes rank(s) %s (endpoint %s, "
            "window snapshot from rank %s)", proc, list(ranks), joiner_ep,
            donor_note)

    # -- commit follow-through ---------------------------------------------

    def on_commit(self, view, rank_owner: Dict[int, int]) -> None:
        """Fold a committed membership change into the directory (called by
        the supervisor AFTER it updated the transport's maps) and persist
        the new replica."""
        with self._lock:
            self.directory.epoch = view.epoch
            # The consensus view is authoritative (every committed
            # recovery view names its full active set).
            self.directory.active = tuple(view.active_procs)
            self.directory.rank_owner = dict(rank_owner)
            for p, ep in view.added_endpoints.items():
                self.directory.endpoints.setdefault(int(p), ep)
            for p in view.added_procs:
                self._reserved.pop(p, None)
        self.persist()

    def summary(self) -> dict:
        with self._lock:
            return {
                "epoch": self.directory.epoch,
                "n_ranks": self.directory.n_ranks,
                "active_procs": list(self.directory.active),
                "endpoints": len(self.directory.endpoints),
                "vacant_ranks": self.directory.vacant_ranks(),
                "grants_total": self.grants_total,
                "persist_prefix": self._prefix,
            }


# ---------------------------------------------------------------------------
# Process-wide registry (mirrors ops/membership.py's)
# ---------------------------------------------------------------------------

_active_service: Optional[GangService] = None
_registry_lock = threading.Lock()

# Joiner-side grant waiters, keyed by nonce: registered BEFORE the service
# exists (the joining process has no directory yet when the reply lands).
_join_waiters: Dict[str, list] = {}
_waiters_lock = threading.Lock()


def install(svc: Optional[GangService]) -> None:
    global _active_service
    with _registry_lock:
        _active_service = svc


def current() -> Optional[GangService]:
    return _active_service


def _resolve_join_reply(msg: dict) -> None:
    nonce = msg.get("nonce")
    with _waiters_lock:
        waiter = _join_waiters.get(nonce)
    if waiter is not None:
        waiter[1] = msg
        waiter[0].set()


def handle_wire(payload) -> None:
    """Entry point for inbound ``OP_GANG`` frames (window drain thread).
    Dropped silently when neither a service nor a join waiter is
    interested — exactly the OP_MEMBER contract, so a stale frame from a
    peer that still thinks we joined can never crash the drain."""
    try:
        msg = json.loads(bytes(payload).decode())
    except (ValueError, UnicodeDecodeError):
        from bluefog_tpu_torch.utils.logging import get_logger
        get_logger().warning("gang: undecodable OP_GANG frame dropped "
                             "(%d bytes)", len(payload))
        return
    if msg.get("k") in ("grant", "deny"):
        _resolve_join_reply(msg)
    svc = _active_service
    if svc is not None and msg.get("k") != "grant":
        svc.handle(msg)


def health_summary() -> Optional[dict]:
    """The gang-directory block for ``/healthz`` (None when the subsystem
    is not installed)."""
    svc = _active_service
    if svc is None:
        return None
    return svc.summary()


# ---------------------------------------------------------------------------
# Bootstrap entry points
# ---------------------------------------------------------------------------

def bootstrap_endpoints() -> Optional[List[Tuple[str, int]]]:
    """The pre-assigned gang endpoints from ``BFTPU_GANG_PEERS`` (set by
    ``bfrun --elastic``), or None when this launch is not elastic."""
    spec = os.environ.get("BFTPU_GANG_PEERS")
    return parse_peers(spec) if spec else None


def init_elastic(port: Optional[int] = None) -> GangService:
    """Coordinator-free gang bootstrap for one founding member.

    Requires ``bf.init()`` already called over the full virtual world (the
    process sees all ``n`` ranks; ownership is per-process through the
    directory) and ``BFTPU_GANG_PEERS`` in the environment (``bfrun
    --elastic`` pre-assigns one transport port per process and exports the
    full list, so NO key-value exchange — and no coordinator — is needed:
    every process starts with the complete endpoint map and gossip takes
    over from there).  Builds the window transport on this process's
    pinned port, installs the rank directory, and installs + persists the
    gang service."""
    cfg = config.get()
    if not cfg.elastic_join:
        raise RuntimeError(
            "gang.init_elastic requires BLUEFOG_TPU_ELASTIC_JOIN=1 (the "
            "join/bootstrap subsystem must be an explicit operational "
            "decision, never ambient)")
    spec = os.environ.get("BFTPU_GANG_PEERS")
    if not spec:
        raise RuntimeError("gang.init_elastic: BFTPU_GANG_PEERS is not "
                           "set (launch with `bfrun --elastic`)")
    peers = parse_peers(spec)
    my_proc = int(os.environ["BFTPU_PROCESS_ID"])
    from bluefog_tpu_torch import basics
    from bluefog_tpu_torch.ops import window as W
    n = basics.size()
    if n % len(peers):
        raise RuntimeError(
            f"gang.init_elastic: world size {n} is not divisible by the "
            f"{len(peers)}-process gang")
    per = n // len(peers)
    rank_owner = {r: r // per for r in range(n)}
    transport = W.make_transport(
        port=peers[my_proc][1] if port is None else port,
        device=basics.device())
    proc_addr = {p: addr for p, addr in enumerate(peers)}
    W.install_distrib(transport, rank_owner, proc_addr, my_proc)
    directory = GangDirectory(
        n, {p: _ep_str(a) for p, a in proc_addr.items()},
        epoch=0, active=range(len(peers)), rank_owner=rank_owner)
    svc = GangService(directory)
    install(svc)
    svc.persist()
    from bluefog_tpu_torch.utils.logging import get_logger
    get_logger().info(
        "gang: coordinator-free bootstrap — proc %d of %d, ranks %s, "
        "endpoint %s", my_proc, len(peers),
        [r for r, p in rank_owner.items() if p == my_proc],
        _ep_str(peers[my_proc]))
    return svc


def _dtype_name(dtype: torch.dtype) -> str:
    """A window dtype's wire name, numpy's spelling (``float32``,
    ``bfloat16``), as the JAX package's grant carries it."""
    return str(dtype).replace("torch.", "")


def _host_bytes(row: torch.Tensor) -> bytes:
    """One row's bytes on the host: a card's row through one pinned copy."""
    import torch
    if row.device.type == "cuda":
        host = torch.empty(row.shape, dtype=row.dtype, pin_memory=True)
        host.copy_(row)
    else:
        host = row.contiguous()
    return host.view(torch.uint8).numpy().tobytes()


def _decode_grant(msg: dict, my_endpoint: str,
                  device: Optional[torch.device] = None) -> JoinGrant:
    """A grant message as a :class:`JoinGrant`; the window rows are
    decoded onto ``device`` (default ``basics.device()``).  (torch is
    imported where rows cross, here and in :func:`_host_bytes`: a process
    that only reads the directory, as the chaos tool's launching process,
    never loads it.)"""
    import torch
    if device is None:
        from bluefog_tpu_torch import basics
        device = basics.device()
    directory = GangDirectory(
        msg["n_ranks"],
        {int(p): e for p, e in msg.get("endpoints", {}).items()},
        epoch=msg.get("epoch", 0), active=msg.get("active", ()),
        rank_owner={int(r): p
                    for r, p in msg.get("rank_owner", {}).items()})
    windows = {}
    for name, w in (msg.get("windows") or {}).items():
        shape = tuple(int(s) for s in w["shape"])
        dtype = getattr(torch, w["dtype"])
        rows = {int(r): torch.frombuffer(
                    bytearray(base64.b64decode(b)), dtype=dtype
                ).reshape(shape).to(device)
                for r, b in (w.get("rows") or {}).items()}
        windows[name] = {"shape": shape, "dtype": w["dtype"], "rows": rows}
    return JoinGrant(int(msg["proc"]),
                     tuple(int(r) for r in msg["ranks"]),
                     int(msg.get("epoch", 0)),
                     tuple(int(p) for p in msg.get("active", ())),
                     directory, windows, my_endpoint)


def _probe_addr(addr: Tuple[str, int], timeout: float = 0.75) -> bool:
    import socket
    try:
        socket.create_connection(addr, timeout=timeout).close()
        return True
    except OSError:
        return False


def join_gang(target: str, *, want: Optional[int] = None,
              timeout_ms: Optional[float] = None) -> JoinGrant:
    """Join a live gang as a fresh process.

    ``target`` is any live member's transport endpoint (``host:port``) or
    a persisted directory prefix (``@<prefix>`` — every replica under it
    is merged and each live member is tried in turn; this is the
    coordinator-free path a replacement uses after rank 0's host died).
    Requires ``bf.init()`` over the full virtual world.  On success the
    window transport + rank directory are installed (this process owning
    the granted ranks) and the returned :class:`JoinGrant` carries the
    window snapshot to ``win_create`` from once the grow epoch commits
    (drive a :class:`~bluefog_tpu.run.supervisor.ChurnSupervisor` — it
    seeds itself from the pending grant).  Each step of the admission is
    stamped (:func:`_admission_stamp`): the candidates, each endpoint
    probed, the transport up, each request sent, the grant received,
    decoded and installed."""
    import uuid
    cfg = config.get()
    if not cfg.elastic_join:
        raise RuntimeError(
            "gang.join_gang requires BLUEFOG_TPU_ELASTIC_JOIN=1")
    if want is None:
        # How many vacant ranks to claim: `bfrun --join --join-want N`
        # exports it; default 1.  A replacement for a multi-rank process
        # must ask for that process's whole seat count — a partial claim
        # commits a grow epoch that leaves the gang under strength.
        want = int(os.environ.get("BFTPU_GANG_JOIN_WANT", "1"))
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.ops.transport import OP_GANG
    from bluefog_tpu_torch.utils import telemetry
    wait_sec = (cfg.join_timeout_ms if timeout_ms is None
                else timeout_ms) / 1e3
    if target.startswith("@"):
        directory = GangDirectory.load_any(target[1:])
        candidates = directory.live_endpoints()
    else:
        candidates = [_ep_addr(target)]
    _admission_stamp("candidates", n=len(candidates))
    # Cheap TCP pre-filter so a dead member (say, the killed rank 0) costs
    # a sub-second probe, not a full grant timeout.
    live = []
    for a in candidates:
        ok = _probe_addr(a)
        _admission_stamp("probe", addr=_ep_str(a), ok=ok)
        if ok:
            live.append(a)
    if not live:
        raise ConnectionError(
            f"gang: no live member endpoint reachable among {candidates}")
    from bluefog_tpu_torch import basics
    transport = W.make_transport(device=basics.device())
    me_ep = f"{W._local_host_addr()}:{transport.port}"
    _admission_stamp("transport")
    grant_msg = None
    try:
        for addr in live:
            nonce = uuid.uuid4().hex
            waiter = [threading.Event(), None]
            with _waiters_lock:
                _join_waiters[nonce] = waiter
            body = {"k": "join_req", "nonce": nonce, "ep": me_ep,
                    "want": int(want)}
            try:
                payload = np.frombuffer(json.dumps(body).encode(),
                                        np.uint8)
                transport.send(addr[0], addr[1], OP_GANG, "", -1, -1,
                               0.0, payload)
                _admission_stamp("join_req", addr=_ep_str(addr),
                                 nonce=nonce)
                if waiter[0].wait(wait_sec) and waiter[1] is not None:
                    msg = waiter[1]
                    if msg.get("k") == "grant":
                        grant_msg = msg
                        break
                    from bluefog_tpu_torch.utils.logging import get_logger
                    get_logger().warning(
                        "gang: join denied by %s:%d — %s", addr[0],
                        addr[1], msg.get("reason"))
            except (ConnectionError, OSError):
                continue
            finally:
                with _waiters_lock:
                    _join_waiters.pop(nonce, None)
    except BaseException:
        transport.stop()
        raise
    if grant_msg is None:
        transport.stop()
        raise TimeoutError(
            f"gang: no member of {live} granted the join within "
            f"{wait_sec:.0f}s per endpoint")
    _admission_stamp("grant", proc=grant_msg.get("proc"))
    grant = _decode_grant(grant_msg, me_ep)
    _admission_stamp("decode")
    rank_owner = dict(grant.directory.rank_owner)
    for r in grant.ranks:
        rank_owner[r] = grant.proc
    proc_addr = {p: _ep_addr(e)
                 for p, e in grant.directory.endpoints.items()}
    proc_addr[grant.proc] = _ep_addr(me_ep)
    W.install_distrib(transport, rank_owner, proc_addr, grant.proc)
    directory = grant.directory
    directory.endpoints[grant.proc] = me_ep
    svc = GangService(directory)
    svc.pending_grant = grant
    install(svc)
    svc.persist()
    _admission_stamp("installed")
    telemetry.inc("bf_gang_joins_requested_total")
    from bluefog_tpu_torch.utils.logging import get_logger
    get_logger().warning(
        "gang: join granted — proc %d takes rank(s) %s at epoch %d "
        "(endpoint %s); awaiting the grow commit", grant.proc,
        list(grant.ranks), grant.epoch, me_ep)
    return grant
