"""Checkpoint and resume through ``torch.distributed.checkpoint`` (DCP).

The port of ``bluefog_tpu/utils/checkpoint.py``, with DCP's
``FileSystemWriter`` and ``FileSystemReader`` in place of orbax (a JAX
orbax checkpoint is not read here, nor a DCP one there).  A tree is a
nest of dicts (string keys), lists and tuples whose leaves are tensors,
numpy arrays or Python numbers; it is stored as one flat DCP state dict,
a leaf under its path (``['params']['flat']``, ``['opt'][0]``), so the
directory layout is DCP's and the step directories keep the JAX
package's ``step_%010d`` names (:func:`list_steps`, the pruning of
``utils/elastic.py``).

The decentralized concerns are the JAX package's: ``save`` can store the
consensus average of the rank replicas (the usual evaluation artifact),
and :func:`broadcast_to_ranks` expands a consensus tree back into per-rank
replicas.

Globally sharded state: a leaf wrapped in :class:`Shard` is one process's
slice of a tensor cut along ``dim`` over the processes (the port's tensor
parallelism across gloo processes).  Every process calls :func:`save`
with the same tree, writes its own shards under keys that name them
(``<path>#shard<i>of<k>@<dim>``) into one coordinated checkpoint, and the
other leaves, which DCP stores once, are first checked to be equal in
every process.  :func:`restore` with a target of shards reads each
process's own; :func:`restore_host` joins them into the whole tensor.

:class:`AsyncSaver` copies the device tensors into pinned host buffers
(``non_blocking``, one event waited for before ``save`` returns: the
caller may overwrite its tensors on the next step) and writes on a
worker thread.
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import os
import re
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "list_steps",
           "broadcast_to_ranks", "consensus_average", "AsyncSaver",
           "has_global_shards", "restore_host", "leaf_shapes", "Shard"]


class Shard:
    """One process's slice ``index`` of ``count`` of a tensor cut along
    ``dim`` (a globally sharded leaf)."""

    __slots__ = ("local", "index", "count", "dim")

    def __init__(self, local, index: int, count: int, dim: int = 0):
        self.local = local
        self.index = int(index)
        self.count = int(count)
        self.dim = int(dim)

    def __repr__(self):
        return (f"Shard({tuple(self.local.shape)}, {self.index}/"
                f"{self.count}, dim={self.dim})")


# -- trees ---------------------------------------------------------------

def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in the JAX package's tree-leaf order (dict keys
    sorted, sequences in order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"checkpoint: dict keys must be strings, "
                                f"got {k!r}")
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten_like(target, values):
    """``target``'s structure (its dict key order too) over ``values``,
    which are in :func:`_flatten`'s order."""
    it = iter(values)

    def rebuild(t):
        if isinstance(t, dict):
            vals = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)
    return rebuild(target)


_PATH_ITEM = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|\d+)\]")


def _path_items(path: str) -> list:
    items = []
    for m in _PATH_ITEM.finditer(path):
        tok = m.group(1)
        items.append(int(tok) if tok.isdigit() else ast.literal_eval(tok))
    return items


def _nest(pairs) -> Any:
    """Rebuild a generic tree (dicts, and lists where every key of a level
    is an index) from ``(path, value)`` pairs."""
    root: dict = {}
    for path, value in pairs:
        items = _path_items(path)
        if not items:
            return value
        cur = root
        for it in items[:-1]:
            cur = cur.setdefault(it, {})
        cur[items[-1]] = value

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[k]) for k in sorted(node)]
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


_SHARD_KEY = re.compile(r"^(.*)#shard(\d+)of(\d+)@(\d+)$")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, (bool, np.bool_)):
        return torch.tensor(bool(x))
    if isinstance(x, (int, np.integer)):
        return torch.tensor(int(x), dtype=torch.int64)
    if isinstance(x, (float, np.floating)):
        return torch.tensor(float(x), dtype=torch.float64)
    raise TypeError(f"checkpoint: unsupported leaf {type(x).__name__}")


def _state_dict(tree) -> Dict[str, Any]:
    """The flat DCP state dict of a tree (shards under their own keys)."""
    out = {}
    for path, leaf in _flatten(tree):
        if isinstance(leaf, Shard):
            key = f"{path}#shard{leaf.index}of{leaf.count}@{leaf.dim}"
            out[key] = _as_tensor(leaf.local).contiguous()
        else:
            out[path] = _as_tensor(leaf).contiguous()
    return out


def has_global_shards(tree: Any) -> bool:
    """True when a leaf is a :class:`Shard`."""
    return any(isinstance(v, Shard) for _, v in _flatten(tree))


def consensus_average(tree):
    """Average the rank replicas (leading axis) of every leaf (in float
    for integer leaves, rounded to nearest, as ``utils/elastic`` fits)."""
    def avg(x):
        t = _as_tensor(x)
        if t.dtype.is_floating_point:
            return t.mean(dim=0)
        return t.double().mean(dim=0).round().to(t.dtype)
    return _map(avg, tree)


def broadcast_to_ranks(tree, n: int):
    """Expand a consensus tree back to rank-major replicas."""
    return _map(lambda x: _as_tensor(x)[None].expand(
        (n,) + tuple(_as_tensor(x).shape)).clone(), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _step_path(path: str, step: Optional[int]) -> str:
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step:010d}")
    return path


def _dist_on() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _digest(t: torch.Tensor) -> str:
    h = t.detach().contiguous().cpu()
    return hashlib.sha256(h.reshape(-1).view(torch.uint8).numpy().tobytes()
                          if h.numel() else b"").hexdigest() + str(
                              (tuple(h.shape), str(h.dtype)))


def _assert_replicated_equal(sd: Dict[str, torch.Tensor]) -> None:
    """The coordinated checkpoint stores one copy of each leaf that is not
    a shard: a value that differs between processes would silently become
    one process's on restore, so refuse it (the JAX package's
    ``multihost_utils.assert_equal``)."""
    import torch.distributed as dist
    mine = {k: _digest(v) for k, v in sd.items() if not _SHARD_KEY.match(k)}
    allv: list = [None] * dist.get_world_size()
    dist.all_gather_object(allv, mine)
    if any(v != allv[0] for v in allv):
        raise ValueError(
            "checkpoint: non-sharded leaves differ across processes; a "
            "coordinated sharded checkpoint stores one copy — shard such "
            "leaves, make them identical, or save them per process")


@contextlib.contextmanager
def _quiet():
    """DCP warns that a ``no_dist`` call assumes one process: that is
    the intent here (a per-process or single-process checkpoint)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        yield


def _write(path: str, sd: Dict[str, torch.Tensor], *,
           coordinated: bool) -> None:
    import torch.distributed.checkpoint as dcp
    os.makedirs(path, exist_ok=True)
    # A writer thread a leaf, up to 8: a tree of several large leaves (a
    # rank's row each) is written in parallel.
    writer = dcp.FileSystemWriter(path, thread_count=max(1, min(8, len(sd))))
    with _quiet():
        dcp.save(sd, storage_writer=writer, no_dist=not coordinated)


def save(path: str, tree: Any, *, step: Optional[int] = None,
         average_ranks: bool = False, force: bool = True) -> str:
    """Save a tree; returns the directory written (``path/step_%010d``
    with ``step``).  ``average_ranks=True`` stores the consensus average
    of the replicas.  A tree with :class:`Shard` leaves is a coordinated
    save: every process calls it with the same tree."""
    if average_ranks:
        if has_global_shards(tree):
            raise ValueError(
                "checkpoint: average_ranks with globally sharded state is "
                "ambiguous (the leading axis of a shard is a model axis, "
                "not rank replicas) — save the sharded state directly")
        tree = consensus_average(tree)
    sd = _state_dict(tree)
    coordinated = has_global_shards(tree) and _dist_on()
    if coordinated:
        _assert_replicated_equal(sd)
    path = _step_path(path, step)
    if os.path.exists(os.path.join(path, ".metadata")) and not force:
        raise FileExistsError(f"checkpoint: {path} exists (force=False)")
    _write(path, sd, coordinated=coordinated)
    return path


def _metadata(path: str):
    import torch.distributed.checkpoint as dcp
    return dcp.FileSystemReader(path).read_metadata()


def _empty_like_meta(meta) -> torch.Tensor:
    return torch.empty(tuple(meta.size), dtype=meta.properties.dtype)


def _read(path: str, sd: Dict[str, torch.Tensor], *,
          coordinated: bool = False) -> None:
    import torch.distributed.checkpoint as dcp
    with _quiet():
        dcp.load(sd, storage_reader=dcp.FileSystemReader(path),
                 no_dist=not coordinated)


def _like(saved: torch.Tensor, target):
    """A restored tensor in the target leaf's kind: a tensor on its
    device, a numpy array, or a Python number."""
    if isinstance(target, torch.Tensor):
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        return saved.numpy().astype(target.dtype, copy=False)
    if isinstance(target, (bool, np.bool_)):
        return bool(saved.item())
    if isinstance(target, (int, np.integer)):
        return int(saved.item())
    if isinstance(target, (float, np.floating)):
        return float(saved.item())
    return saved


def restore(path: str, *, step: Optional[int] = None,
            target: Any = None) -> Any:
    """Restore a tree.  Without ``target``: nested dicts and lists of CPU
    tensors rebuilt from the saved paths (tuples come back as lists; a
    sharded leaf as its whole tensor, as :func:`restore_host`).  With
    ``target`` (a matching tree): its structure, each leaf in the target
    leaf's kind (a tensor on its device and dtype, a numpy array, a Python
    number), a :class:`Shard` leaf read as this process's own shard."""
    path = _step_path(path, step)
    if target is None:
        return restore_host(path, as_tensors=True)
    meta = _metadata(path).state_dict_metadata
    pairs = _flatten(target)
    sd: Dict[str, torch.Tensor] = {}
    keys = []
    for p, leaf in pairs:
        if isinstance(leaf, Shard):
            key = f"{p}#shard{leaf.index}of{leaf.count}@{leaf.dim}"
        else:
            key = p
        if key not in meta:
            raise KeyError(f"checkpoint {path}: no leaf {key!r} saved")
        sd[key] = _empty_like_meta(meta[key])
        keys.append(key)
    _read(path, sd, coordinated=has_global_shards(target) and _dist_on())
    values = []
    for (p, leaf), key in zip(pairs, keys):
        if isinstance(leaf, Shard):
            values.append(Shard(_like(sd[key], leaf.local), leaf.index,
                                leaf.count, leaf.dim))
        else:
            values.append(_like(sd[key], leaf))
    return _unflatten_like(target, values)


def _host_value(t: torch.Tensor, as_tensors: bool):
    if as_tensors or t.dtype == torch.bfloat16:
        return t
    return t.numpy()


def restore_host(path: str, *, step: Optional[int] = None,
                 as_tensors: bool = False) -> Any:
    """Every leaf on the host, whatever wrote it: numpy arrays (a
    bfloat16 leaf, which numpy cannot hold, as a CPU tensor; every leaf a
    CPU tensor with ``as_tensors``), in a generic tree; a sharded leaf's
    shards joined along their dim into the whole tensor (what a resume at
    another geometry fits to its own)."""
    path = _step_path(path, step)
    meta = _metadata(path).state_dict_metadata
    sd = {k: _empty_like_meta(m) for k, m in meta.items()
          if hasattr(m, "size")}
    _read(path, sd)
    whole: Dict[str, torch.Tensor] = {}
    shards: Dict[str, list] = {}
    for k, v in sd.items():
        m = _SHARD_KEY.match(k)
        if m:
            shards.setdefault(m.group(1), []).append(
                (int(m.group(2)), int(m.group(4)), v))
        else:
            whole[k] = v
    for p, parts in shards.items():
        parts.sort(key=lambda x: x[0])
        whole[p] = torch.cat([v for _, _, v in parts], dim=parts[0][1])
    pairs = sorted(whole.items(), key=lambda kv: _sort_key(kv[0]))
    return _nest([(p, _host_value(v, as_tensors)) for p, v in pairs])


def _sort_key(path: str):
    return [(0, it, "") if isinstance(it, int) else (1, 0, it)
            for it in _path_items(path)]


def leaf_shapes(path: str, *, step: Optional[int] = None) -> list:
    """The saved leaves' shapes in tree-leaf order (a sharded leaf's
    whole shape), from DCP's metadata alone: a restarting run can see that
    another geometry wrote the checkpoint before it reads any data."""
    path = _step_path(path, step)
    meta = _metadata(path).state_dict_metadata
    shapes: Dict[str, tuple] = {}
    for k, m in meta.items():
        if not hasattr(m, "size"):
            continue
        s = _SHARD_KEY.match(k)
        if s:
            p, dim = s.group(1), int(s.group(4))
            size = list(m.size)
            if p in shapes:
                prev = list(shapes[p])
                prev[dim] += size[dim]
                shapes[p] = tuple(prev)
            else:
                shapes[p] = tuple(size)
        else:
            shapes[k] = tuple(m.size)
    return [shapes[p] for p in sorted(shapes, key=_sort_key)]


def list_steps(path: str) -> list:
    """Sorted step numbers of the ``step_*`` checkpoints under ``path``."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and d.split("_")[1].isdigit())


def latest_step(path: str) -> Optional[int]:
    """Newest ``step_*`` subdirectory under ``path``, or None."""
    steps = list_steps(path)
    return steps[-1] if steps else None


class AsyncSaver:
    """Background checkpoint writer, at most one write in flight.

    ``save`` waits for the previous write, copies the tree to the host
    (device tensors into pinned buffers, reused from save to save, with
    ``non_blocking`` copies and one event waited for; host tensors and
    arrays cloned) and hands the write to one worker thread; the caller
    may change its tensors as soon as ``save`` returns.  ``flush`` joins
    the write and raises its error once.  ``last_copy_seconds``,
    ``last_write_seconds`` and ``last_bytes`` describe the newest save."""

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="bf-ckpt-save")
        self._pending = None
        self._pinned: Dict[str, torch.Tensor] = {}
        self.last_copy_seconds = 0.0
        self.last_write_seconds = 0.0
        self.last_bytes = 0

    def _host_copy(self, tree) -> Dict[str, torch.Tensor]:
        if has_global_shards(tree):
            raise ValueError(
                "checkpoint: AsyncSaver writes one process's directory; "
                "sharded state takes the synchronous coordinated save "
                "(checkpoint.save)")
        t0 = time.perf_counter()
        sd = _state_dict(tree)
        out: Dict[str, torch.Tensor] = {}
        events = {}
        for k, v in sd.items():
            if v.device.type == "cuda":
                buf = self._pinned.get(k)
                if buf is None or buf.shape != v.shape or \
                        buf.dtype != v.dtype:
                    buf = self._pinned[k] = torch.empty(
                        v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                out[k] = buf
                events[v.device] = None
            else:
                out[k] = v.detach().clone()
        for dev in events:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
        self.last_copy_seconds = time.perf_counter() - t0
        self.last_bytes = sum(v.numel() * v.element_size()
                              for v in out.values())
        return out

    def save(self, path: str, tree: Any, *, step: Optional[int] = None,
             wait: bool = False, after=None) -> None:
        self.flush()    # the pinned buffers are the previous write's input
        host = self._host_copy(tree)
        target = _step_path(path, step)

        def write():
            t0 = time.perf_counter()
            _write(target, host, coordinated=False)
            self.last_write_seconds = time.perf_counter() - t0
            if after is not None:
                after()

        self._pending = self._pool.submit(write)
        if wait:
            self.flush()

    def flush(self) -> None:
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def shutdown(self) -> None:
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)
