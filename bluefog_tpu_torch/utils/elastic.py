"""Elastic training: a preemption-tolerant, restartable run loop.

The port of ``bluefog_tpu/utils/elastic.py``: the same loop, saves,
pruning, agreement and world-size resume, over ``utils/checkpoint.py``
(DCP).  The JAX calls map so: the process count and index are the port's
process directory (``basics.process_ranks()``, the window transport's
owners); the ``multihost_utils`` agreements are ``all_gather_object`` and
``all_reduce`` on the process group; a tree's leaves and paths are
``checkpoint._flatten``'s, in the JAX tree-leaf order, and a restored tree
is navigated by path as ``_lookup`` does.  Globally sharded state is a
tree with ``checkpoint.Shard`` leaves.

The reference *claims* fault tolerance as a goal (``README.rst:19``) but
implements none (SURVEY §5.3): a dead rank triggers a coordinator-driven
shutdown (``operations.cc:883-910``) and the job is simply gone.  Here the
run loop itself is restartable:

  * periodic checkpoints every ``save_every`` steps through
    ``utils.checkpoint`` (pruned to the newest ``keep``),
  * a SIGTERM handler (the cloud-preemption notice) that finishes the
    in-flight step, saves, and raises :class:`Preempted`,
  * on (re)start, the newest checkpoint is restored into the caller's state
    structure and the loop continues from that step — a crash between
    checkpoints replays at most ``save_every - 1`` steps and, with a
    deterministic ``step_fn``, reproduces the uninterrupted run bit-exactly.

Multi-process runs with process-local or replicated state pass
``per_process=True``: each process writes its own directory, and on restart
the resume step is agreed as the newest step *every* process has durably
saved (set intersection, not ``min(latest)`` — pruning or save skew may have
deleted a slow process's frontier elsewhere), so a crash that interleaves
with a save cannot resume ranks from different steps or name a step someone
is missing.

Multi-process runs with GLOBALLY-SHARDED state (``checkpoint.Shard``
leaves: the port's tensor parallelism across processes) pass
``per_process=False``: every process writes its own shards into ONE
coordinated DCP checkpoint (synchronous: the async saver writes one
process's directory), preemption is agreed collectively every step (a
one-host SIGTERM must not make one process enter the collective save
alone), and restore reads each process's shards back.
"""

from __future__ import annotations

import os
import shutil
import signal
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from bluefog_tpu_torch.utils import checkpoint
from bluefog_tpu_torch.utils.logging import get_logger

__all__ = ["run_elastic", "Preempted"]


def _procs():
    """``(process count, this process's index)`` of the process group (1,
    0 without one)."""
    from bluefog_tpu_torch import basics
    comm = basics.process_ranks() if basics.initialized() else None
    if comm is not None:
        return comm.nprocs, comm.process
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _all_gather(obj) -> list:
    import torch.distributed as dist
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class Preempted(RuntimeError):
    """Raised after a SIGTERM-triggered save; ``.step`` is the saved step."""

    def __init__(self, step: int):
        super().__init__(f"preempted; checkpoint saved at step {step}")
        self.step = step


def _prune(ckpt_dir: str, keep: int) -> None:
    if keep <= 0:
        return
    for s in checkpoint.list_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


# How many of each process's newest checkpoints enter the resume agreement.
_AGREE_WINDOW = 16


def _max_common_step(per_process_steps) -> int:
    """Newest step every process has durably saved, or 0 for a fresh start.

    Resuming from ``min(latest)`` would break whenever pruning (or save
    skew) removed that step on a faster process; intersecting the available
    sets cannot name a step anyone is missing."""
    common = None
    for steps in per_process_steps:
        s = set(int(x) for x in steps if x > 0)
        common = s if common is None else (common & s)
    return max(common) if common else 0


def _discard_steps_above(ckpt_dir: str, start: int) -> None:
    """Drop local checkpoints newer than the agreed resume step.

    A process restarting below its own frontier (e.g. a veteran paired with
    a replacement whose directory is empty) must not keep the stale newer
    dirs: ``_prune`` would treat them as the newest and delete every new
    save, and they would keep poisoning the next agreement — the run would
    never checkpoint durably again."""
    for s in checkpoint.list_steps(ckpt_dir):
        if s > start:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                          ignore_errors=True)


def _proc_dirs(base: str) -> list:
    """Old per-process checkpoint directories under ``base``, rank order."""
    if not os.path.isdir(base):
        return []
    ds = [d for d in os.listdir(base)
          if d.startswith("proc") and d[4:].isdigit()]
    return [os.path.join(base, d)
            for d in sorted(ds, key=lambda d: int(d[4:]))]


def _foreign_frontier(base: str) -> int:
    """Newest step common to the per-process directories under ``base``
    (directories with no steps yet are excluded — their ranks resume from
    peers' copies), or ``base``'s own newest step when no proc dirs exist
    (an earlier single-process run).  0 = nothing to resume from."""
    dirs = _proc_dirs(base)
    if dirs:
        per = [checkpoint.list_steps(d) for d in dirs]
        per = [s for s in per if s]
        return _max_common_step(per) if per else 0
    steps = checkpoint.list_steps(base)
    return steps[-1] if steps else 0


_OWNED_FILE = "owned_ranks.json"


def _write_owned_ranks(proc_dir: str) -> None:
    """Persist this process's rank-ownership alongside its checkpoints so a
    world-size resume can attribute rank-major rows to their authoritative
    owner even under non-uniform ``--hosts h1:3,h2:1`` placements (where an
    even ``array_split`` would take rows from the wrong process).

    The file also stamps the GEOMETRY it was written under (``nproc``), so
    a later resume at a different process count — a shrink, or a gang that
    GREW through the elastic join path — can tell a current map from a
    stale one instead of discovering the mismatch as a silently broken
    partition (see :func:`_invalidate_stale_owned_ranks`).  Pre-stamp
    files (a bare JSON list) keep being read."""
    import json
    # The framework's own rank directory (the window layer's rank_owner);
    # a process group without it: one rank a process.
    from bluefog_tpu_torch import basics
    owned = (list(basics.owned_ranks()) if basics.initialized()
             else [_procs()[1]])
    os.makedirs(proc_dir, exist_ok=True)
    tmp = os.path.join(proc_dir, _OWNED_FILE + ".tmp")
    with open(tmp, "w") as fh:
        json.dump({"ranks": owned, "nproc": _procs()[0]}, fh)
    os.replace(tmp, os.path.join(proc_dir, _OWNED_FILE))


def _parse_owned_map(raw):
    """One persisted ownership map: ``(ranks, nproc)`` — ``nproc`` None
    for pre-geometry-stamp files (a bare list)."""
    if isinstance(raw, dict):
        return ([int(r) for r in raw.get("ranks", [])],
                int(raw["nproc"]) if "nproc" in raw else None)
    return ([int(r) for r in raw], None)


def _owned_rows_of(dirs, n_rows: int):
    """Per-directory authoritative row lists for ``n_rows`` rank-major rows.

    Uses each old process's persisted ``owned_ranks.json`` when every
    directory has one and the lists exactly partition ``range(n_rows)``;
    otherwise falls back to even contiguous blocks (pre-ownership-file
    checkpoints, or a leaf whose leading dim is not the old world size)."""
    import json
    maps = []
    for d in dirs:
        # A map invalidated by a shrink resume lives on as .stale — its
        # content is exactly the old-geometry ownership a stitch of that
        # geometry's rows needs, so reading it keeps cross-geometry
        # resumes (and any process racing the invalidation) correct.
        for fname in (_OWNED_FILE, _OWNED_FILE + ".stale"):
            try:
                with open(os.path.join(d, fname)) as fh:
                    maps.append(_parse_owned_map(json.load(fh))[0])
                break
            except (OSError, ValueError, TypeError):
                continue
        else:
            maps.append(None)
    if all(m is not None for m in maps):
        flat = sorted(r for m in maps for r in m)
        if flat == list(range(n_rows)):
            return maps
    if any(m is not None for m in maps):
        # Some maps existed but the set does not partition range(n): the
        # silent even-block fallback is wrong for non-uniform placements,
        # so say so (missing maps land here too, not only the all-present
        # case).
        get_logger().warning(
            "elastic: persisted owned_ranks.json maps %s do not partition "
            "range(%d) (stale or missing maps from a previous world "
            "size?); falling back to even-block row attribution — WRONG "
            "for non-uniform host placements",
            [m if m is not None else "<missing>" for m in maps], n_rows)
    return [rows.tolist()
            for rows in np.array_split(np.arange(n_rows), len(dirs))]


def _invalidate_stale_owned_ranks(base: str, nproc: int) -> None:
    """World-size-resume hygiene, both directions.

    SHRINK: proc dirs beyond the NEW process count keep the old geometry's
    ``owned_ranks.json``; once the surviving dirs are rewritten for the
    new geometry, the combined maps would no longer partition ``range(n)``
    and ``_owned_rows_of`` would silently fall back to even blocks on the
    next world-size resume.

    GROWTH (elastic join): a surviving dir's map may carry a geometry
    stamp from BEFORE the gang grew — e.g. the 3-process post-shrink map
    a resume at 4 processes must not resurrect, because under the grown
    gang that process no longer owns the revived ranks.  Any map stamped
    with a different ``nproc`` than the resuming world is invalidated.

    Stale files are renamed aside (kept as ``.stale`` for forensics — the
    stitch path still reads them for cross-geometry row attribution) and
    warned about."""
    import json
    stale = []
    for d in _proc_dirs(base):
        try:
            idx = int(os.path.basename(d)[4:])
        except ValueError:
            continue
        f = os.path.join(d, _OWNED_FILE)
        if not os.path.exists(f):
            continue
        drop = idx >= nproc
        why = "beyond the new process count"
        if not drop:
            try:
                with open(f) as fh:
                    file_nproc = _parse_owned_map(json.load(fh))[1]
            except (OSError, ValueError, TypeError):
                file_nproc = None
            if file_nproc is not None and file_nproc != nproc:
                drop = True
                why = (f"stamped for a {file_nproc}-process geometry "
                       f"(resuming at {nproc})")
        if drop:
            try:
                os.replace(f, f + ".stale")
            except OSError:
                continue
            stale.append((os.path.basename(d), why))
    if stale:
        get_logger().warning(
            "elastic: world size changed to %d processes; invalidated the "
            "stale owned_ranks.json in %s (their ownership maps described "
            "a previous geometry — a resume after a join or shrink must "
            "not resurrect them, or future world-size resumes would "
            "silently degrade to even-block row attribution)",
            nproc, ", ".join(f"{d} [{w}]" for d, w in stale))


def _stitch(base: str, step: int):
    """Assemble the authoritative global state at ``step`` from every old
    process's directory: rank-major rows are taken from their OWNING
    process's copy (per the persisted ownership map; even contiguous
    blocks for pre-map checkpoints).  A directory missing the step
    contributes nothing; its rows come from a donor's copy (at most one
    gossip round stale).  Requires ``base`` on storage every process can
    read."""
    dirs = _proc_dirs(base)
    if not dirs:
        # An old single-process or coordinated-layout run: one directory
        # holds the full authoritative state (restore_host also joins the
        # shards of a coordinated checkpoint written by another geometry).
        return checkpoint.restore_host(base, step=step)
    raws = [checkpoint.restore_host(d, step=step)
            if step in checkpoint.list_steps(d) else None for d in dirs]
    donor = next(r for r in raws if r is not None)
    donor_pairs = checkpoint._flatten(donor)
    all_leaves = [[v for _, v in checkpoint._flatten(r)]
                  if r is not None else None for r in raws]
    owned_cache = {}
    out = []
    for i, (path, leaf) in enumerate(donor_pairs):
        s0 = _np(leaf)
        if s0.ndim == 0:
            out.append((path, s0))
            continue
        if s0.shape[0] not in owned_cache:
            owned_cache[s0.shape[0]] = _owned_rows_of(dirs, s0.shape[0])
        acc = s0.clone() if isinstance(s0, torch.Tensor) else s0.copy()
        for k, rows in enumerate(owned_cache[s0.shape[0]]):
            if all_leaves[k] is None or not len(rows):
                continue
            acc[rows] = _np(all_leaves[k][i])[rows]
        out.append((path, acc))
    return checkpoint._nest(out)


def _np(x):
    """A restored leaf as a numpy array; a bfloat16 leaf, which numpy
    cannot hold, stays a CPU tensor (indexed the same way)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x
        return x.numpy()
    return np.asarray(x)


def _fit_leaf(saved, tgt):
    """Fit one restored leaf to the live state's shape.  Equal shapes pass
    through; a rank-major leaf whose leading (world-size) axis changed is
    consensus-averaged over the old replicas and re-expanded by broadcast:
    every new rank resumes from the decentralized iterates' best single
    estimate."""
    s = _np(saved)
    if isinstance(tgt, checkpoint.Shard):
        tgt = tgt.local
    tshape = tuple(np.shape(tgt)) if not isinstance(tgt, torch.Tensor) \
        else tuple(tgt.shape)
    if tuple(s.shape) == tshape:
        return s
    if (s.ndim == len(tshape) and s.ndim >= 1
            and tuple(s.shape[1:]) == tshape[1:]):
        if isinstance(s, torch.Tensor):
            avg = s.float().mean(dim=0).to(s.dtype)
            return avg[None].expand(tshape).clone()
        avg = s.mean(axis=0)
        if np.issubdtype(s.dtype, np.integer):
            # A truncating cast would bias per-rank counters toward zero
            # (e.g. step counts averaging 99.5 -> 99); round to nearest.
            avg = np.rint(avg)
        avg = avg.astype(s.dtype)
        return np.broadcast_to(avg, tshape).copy()
    raise ValueError(
        f"elastic reshard: saved leaf shape {tuple(s.shape)} does not map "
        f"to the live state's {tshape} — only the leading rank-major axis "
        "may change across world sizes")


def _lookup(raw, path: str):
    """Navigate a generically restored tree by a live leaf's path
    (``checkpoint._flatten``'s): a dict by key, a list by index (or a
    dict by the index as a string), so leaves pair by name, never by flat
    order."""
    cur = raw
    for p in checkpoint._path_items(path):
        if isinstance(p, int):
            cur = cur[str(p)] if isinstance(cur, dict) else cur[p]
        else:
            cur = cur[p]
    return cur


def _fit_state(raw, state):
    """Fit a raw restored tree to the live state's structure and shapes,
    each leaf in the live leaf's kind and device (a :class:`checkpoint.
    Shard` leaf: this process's slice of the fitted whole).  Leaves pair by
    path (``_lookup``)."""
    fitted = []
    for path, t in checkpoint._flatten(state):
        f = _fit_leaf(_lookup(raw, path), t)
        f = f if isinstance(f, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(f))
        if isinstance(t, checkpoint.Shard):
            piece = f.chunk(t.count, dim=t.dim)[t.index]
            fitted.append(checkpoint.Shard(checkpoint._like(
                piece.contiguous(), t.local), t.index, t.count, t.dim))
        else:
            fitted.append(checkpoint._like(f, t))
    return checkpoint._unflatten_like(state, fitted)


def _agreed_start(ckpt_dir: str, per_process: bool) -> int:
    mine = checkpoint.list_steps(ckpt_dir)
    if not per_process or _procs()[0] == 1:
        return mine[-1] if mine else 0
    return _max_common_step(_all_gather(mine[-_AGREE_WINDOW:]))


def _block_until_ready(tree) -> None:
    if any(isinstance(v, torch.Tensor) and v.device.type == "cuda"
           for _, v in checkpoint._flatten(tree)):
        torch.cuda.synchronize()


def run_elastic(step_fn: Callable[[Any, int], Any], state: Any, *,
                ckpt_dir: str, num_steps: int, save_every: int = 100,
                keep: int = 3, per_process: bool = False,
                on_step: Optional[Callable[[Any, int], None]] = None,
                on_restore: Optional[Callable[[Any, int], None]] = None,
                on_save: Optional[Callable[[Any, int], Any]] = None,
                async_save: bool = True) -> Any:
    """Run ``state = step_fn(state, step)`` for ``num_steps`` steps with
    automatic checkpoint/resume.  Returns the final state.

    ``state`` is any tree (dicts, lists, tuples) of tensors, numpy arrays
    and numbers; its structure is the restore target.
    ``step_fn`` must be deterministic in ``(state, step)`` for bit-exact
    resume (fold the step into your PRNG key; data order via
    ``data.DistributedSampler.set_epoch`` is already step-derivable).
    ``on_step`` runs after every step (logging, eval); it is not
    exactly-once — after a crash, replayed steps invoke it again.
    ``on_restore(restored_state, start_step)`` fires only when a checkpoint
    was found, immediately after the restore and BEFORE the
    ``start >= num_steps`` early return — use it to re-install side-band
    state the tree cannot carry (e.g. window-store buffers via
    ``opt.load_window_state_dict``).
    ``on_save(state, step) -> tree`` transforms the state at SAVE time only
    (periodic, preemption and final saves) — refresh expensive side-band
    snapshots here (e.g. ``{**state, "win": opt.window_state_dict()}``)
    instead of rebuilding them every step; the returned tree must keep the
    restore-target structure.
    ``async_save=True`` copies the state to host synchronously but writes
    the file on a background worker, so training overlaps the disk write;
    at most one write is in flight, and the preemption/final saves join it
    before returning (the "checkpoint saved" promise stays durable).
    """
    sharded = checkpoint.has_global_shards(state)
    base_dir = ckpt_dir  # pre-suffix: where other world sizes' dirs live
    nproc, me = _procs()
    if nproc > 1:
        if sharded:
            # Sharded state: ONE coordinated DCP checkpoint — every process
            # writes its own shards; per-process directories would tear the
            # global arrays apart.
            if per_process:
                raise ValueError(
                    "run_elastic: globally-sharded state uses a single "
                    "shared checkpoint (coordinated DCP) — pass "
                    "per_process=False")
            if async_save:
                # The async saver writes one process's directory; the
                # coordinated write is synchronous by construction.
                get_logger().info(
                    "elastic: sharded state — using synchronous "
                    "coordinated saves")
                async_save = False
        elif not per_process:
            raise ValueError(
                "run_elastic in a multi-process run requires "
                "per_process=True: each process must write its own "
                "checkpoint directory (concurrent writes to one DCP path "
                "race), and resume must be agreed across processes")
        else:
            ckpt_dir = os.path.join(ckpt_dir, f"proc{me}")
            # NOTE: this geometry's owned_ranks.json is written AFTER the
            # resume decision below — writing it here would clobber the OLD
            # run's ownership maps before _stitch reads them (a world-size
            # resume at fewer processes reuses the same procN dirs).
    # Sharded mode shares one directory but still agrees explicitly — the
    # allgather doubles as the barrier that keeps a fast process from
    # restoring while a late one still holds the old run's state.
    start = _agreed_start(ckpt_dir, per_process or sharded)
    # WORLD-SIZE ELASTICITY (rank-major state only): a frontier left by a
    # DIFFERENT incarnation geometry — more/fewer processes, or an old
    # single-process run — that is newer than this geometry's own.  Stitch
    # the authoritative rows from every old directory and fit the leaves to
    # the live state (consensus-average + re-broadcast across the changed
    # rank axis).  Needs shared storage; every process must see one view.
    def _shape(t):
        if isinstance(t, checkpoint.Shard):
            whole = list(t.local.shape)
            whole[t.dim] *= t.count
            return tuple(whole)
        return tuple(t.shape) if isinstance(t, torch.Tensor) \
            else tuple(np.shape(t))
    live_shapes = sorted(_shape(t) for _, t in checkpoint._flatten(state))

    def _geom_differs(dir_: str, s: int) -> bool:
        # Multiset comparison: order-free, and a changed rank axis always
        # changes the multiset.
        return sorted(checkpoint.leaf_shapes(dir_, step=s)) != live_shapes

    fstart = 0 if sharded else _foreign_frontier(base_dir)
    if nproc > 1 and not sharded:
        import zlib
        # The agreement must cover the VIEW, not just the frontier value:
        # two hosts on non-shared storage can hold disjoint proc-dir
        # subsets with equal frontiers and would stitch DIFFERENT states.
        view = repr((fstart, sorted(os.path.basename(d)
                                    for d in _proc_dirs(base_dir))))
        views = _all_gather(zlib.crc32(view.encode()))
        if any(v != views[0] for v in views):
            # Non-shared storage: cross-geometry resume is impossible —
            # degrade to the this-geometry agreement (the pre-elastic-
            # resize behavior).
            get_logger().warning(
                "elastic: processes see different checkpoint directory "
                "views (ckpt_dir not on shared storage?); world-size "
                "elastic resume disabled for this restart")
            fstart = 0
    # The foreign path also covers a SAME-frontier geometry change: after a
    # resharded resume crashes before its first new-geometry save, the old
    # dirs still hold the frontier in the old shapes — without this check
    # every restart would feed old-shape leaves to a new-shape restore and
    # the job could never come back up.
    if fstart and fstart >= start and not sharded \
            and (fstart > start or _geom_differs(ckpt_dir, start)):
        state = _fit_state(_stitch(base_dir, fstart), state)
        start = fstart
        _discard_steps_above(ckpt_dir, start)
        get_logger().info(
            "elastic: resumed from step %d with a world-size change "
            "(resharded from %s)", start, base_dir)
        if on_restore is not None:
            on_restore(state, start)
    else:
        _discard_steps_above(ckpt_dir, start)
        if start:
            if sharded and _geom_differs(ckpt_dir, start):
                # The coordinated (shared-dir) layout's world-size change:
                # the old geometry's global arrays are read in full from
                # shared storage, consensus-averaged over the changed rank
                # axis, and re-placed into the live shardings.
                state = _fit_state(
                    checkpoint.restore_host(ckpt_dir, step=start), state)
                get_logger().info(
                    "elastic: resumed from step %d with a world-size "
                    "change (coordinated layout, %s)", start, ckpt_dir)
            else:
                state = checkpoint.restore(ckpt_dir, step=start,
                                           target=state)
                get_logger().info("elastic: resumed from step %d (%s)",
                                  start, ckpt_dir)
            if on_restore is not None:
                # Re-install side-band state the tree cannot carry by
                # itself (e.g. window-store buffers via
                # ``opt.load_window_state_dict(state[...])``).
                on_restore(state, start)
    if nproc > 1 and per_process and not sharded:
        # The resume decision is made; NOW record this geometry's ownership
        # for future world-size resumes (non-uniform placements attribute
        # rows to the wrong process without it).  Process 0 also retires
        # ownership maps in directories beyond the new process count (a
        # shrink leaves them describing the old geometry).
        if me == 0:
            _invalidate_stale_owned_ranks(base_dir, nproc)
        _write_owned_ranks(ckpt_dir)
    if start >= num_steps:
        return state

    preempt = threading.Event()
    prev_handler = None
    installed = False
    try:  # signals only work on the main thread; degrade gracefully off it
        prev_handler = signal.signal(
            signal.SIGTERM, lambda signum, frame: preempt.set())
        installed = True
    except ValueError:
        pass

    saver = checkpoint.AsyncSaver() if async_save else None

    def save(tree, step: int, *, wait: bool) -> None:
        if on_save is not None:
            tree = on_save(tree, step)
        if saver is None:
            _block_until_ready(tree)
            checkpoint.save(ckpt_dir, tree, step=step)
            _prune(ckpt_dir, keep)
            return
        saver.save(ckpt_dir, tree, step=step, wait=wait,
                   after=lambda: _prune(ckpt_dir, keep))

    def preempted_now() -> bool:
        """Sharded multi-process mode must AGREE on preemption: the save is
        a collective DCP write, and a one-host SIGTERM would otherwise
        send one process into the barrier while the others train on.  The
        per-step allgather is a host-side scalar sync — noise next to the
        coordinated save it protects."""
        if not (sharded and nproc > 1):
            return preempt.is_set()
        import torch.distributed as dist
        flag = torch.tensor([int(preempt.is_set())], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    try:
        for step in range(start, num_steps):
            state = step_fn(state, step)
            if on_step is not None:
                on_step(state, step)
            done = step + 1
            if preempted_now() and done < num_steps:
                # (a preemption during the FINAL step falls through to the
                # normal completion save/return — the work is already done)
                save(state, done, wait=True)
                raise Preempted(done)
            if save_every and done % save_every == 0 and done < num_steps:
                save(state, done, wait=False)
        save(state, num_steps, wait=True)
        return state
    finally:
        if saver is not None:
            import sys
            propagating = sys.exc_info()[0] is not None
            try:
                saver.shutdown()
            except Exception:
                # Another exception is already propagating (step_fn error,
                # Ctrl-C): don't let a stale background-write failure
                # replace it — log and let the real error through.
                if not propagating:
                    raise
                get_logger().exception(
                    "elastic: background checkpoint write failed")
        if installed:
            # prev_handler is None when the prior handler was installed
            # outside Python — unrepresentable, so fall back to the
            # default disposition rather than leaving our stale lambda
            # in place.
            signal.signal(signal.SIGTERM,
                          prev_handler if prev_handler is not None
                          else signal.SIG_DFL)
