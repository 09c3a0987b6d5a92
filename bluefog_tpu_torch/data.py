"""Input pipeline: rank-partitioned sampling and a prefetch to the card.

The port of ``bluefog_tpu/data.py``.  :class:`DistributedSampler` is the
JAX package's, index for index (an epoch-seeded global permutation cut
into rank-major rows; ``static_shards`` shuffles within fixed shards).
:func:`prefetch_to_device` and :class:`ShardedLoader` keep a background
thread ahead of the consumer: on a card each batch is copied from pinned
host memory with ``non_blocking`` copies on a side stream, and the
consumer's stream waits on the copy's event before it reads the batch, so
the host-to-card transfer hides behind the step.

Batches are rank-major: leading dim ``bf.size()`` (or the ``num_ranks``
given), row ``r`` rank ``r``'s batch, as every op of the port takes them.
A batch is a tree of numpy arrays (dicts, lists and tuples of them); it
comes out as the same tree of tensors on the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = ["DistributedSampler", "ShardedLoader", "prefetch_to_device"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


class DistributedSampler:
    """Partition ``num_samples`` indices across ranks with per-epoch
    shuffles: the index matrix of every rank at once (row ``r`` is rank
    ``r``'s), the contract of the torch sampler the reference's examples
    use (``set_epoch`` reshuffles, ``drop_last`` keeps the shards equal).
    ``static_shards`` pins rank ``r`` to the ``r``-th contiguous block and
    shuffles within it (the heterogeneous-data setting)."""

    def __init__(self, num_samples: int, *, num_ranks: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, static_shards: bool = False):
        if num_ranks is None:
            from bluefog_tpu_torch import basics
            num_ranks = basics.size()
        if num_samples < num_ranks:
            raise ValueError(
                f"cannot shard {num_samples} samples over {num_ranks} ranks")
        self.num_samples = num_samples
        self.num_ranks = num_ranks
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.static_shards = static_shards
        self.epoch = 0
        self.per_rank = num_samples // num_ranks
        if not drop_last and num_samples % num_ranks:
            # pad by wrapping (the torch sampler repeats early samples)
            self.per_rank += 1

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle (once an epoch, in every process: the
        permutation must be the same everywhere)."""
        self.epoch = int(epoch)

    def indices(self) -> np.ndarray:
        """``(num_ranks, per_rank)`` int array; row ``r`` = rank ``r``."""
        total = self.per_rank * self.num_ranks
        if self.static_shards:
            perm = np.arange(self.num_samples)
            if total > perm.size:
                perm = np.concatenate([perm, perm[:total - perm.size]])
            shards = perm[:total].reshape(self.num_ranks, self.per_rank)
            if self.shuffle:
                rng = np.random.RandomState(self.seed + self.epoch)
                for r in range(self.num_ranks):  # within the shard only
                    shards[r] = shards[r][rng.permutation(self.per_rank)]
            return shards
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            perm = rng.permutation(self.num_samples)
        else:
            perm = np.arange(self.num_samples)
        if total > perm.size:  # wrap-pad (drop_last=False)
            perm = np.concatenate([perm, perm[:total - perm.size]])
        return perm[:total].reshape(self.num_ranks, self.per_rank)

    def __iter__(self) -> Iterator[np.ndarray]:
        """``(num_ranks,)`` index columns, one sample position at a time
        (:class:`ShardedLoader` is usually what is wanted)."""
        return iter(self.indices().T)

    def __len__(self) -> int:
        return self.per_rank


class _Staged:
    """A batch whose copies to the card were issued on a side stream:
    the tree, and the event the consumer's stream waits on."""

    __slots__ = ("tree", "event")

    def __init__(self, tree, event):
        self.tree = tree
        self.event = event


def _placer(device):
    """The producer's placement of one numpy batch: ``False`` leaves it as
    it is; the CPU takes the arrays as tensors; a card gets pinned copies
    issued ``non_blocking`` on a side stream, with their event."""
    if device is False:
        return lambda batch: batch
    if device is None:
        from bluefog_tpu_torch import basics
        device = basics.device()
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: _tree_map(
            lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(device),
            batch)
    stream = torch.cuda.Stream(device)

    def place(batch):
        with torch.cuda.stream(stream):
            tree = _tree_map(
                lambda x: torch.from_numpy(np.ascontiguousarray(x))
                .pin_memory().to(device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(tree, event)
    return place


def prefetch_to_device(it: Iterable, *, size: int = 2,
                       device=None) -> Iterator:
    """Wrap a host iterator of (trees of) numpy batches: a daemon thread
    stays ``size`` batches ahead, placing each on ``device`` (default
    ``bf.device()``; ``False`` yields the numpy batches as they are).  On
    a card the consumer's current stream waits on each batch's copy event
    before the batch is handed out, and the batch's memory is marked as
    used by that stream."""
    place = _placer(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    _END = object()
    stop = threading.Event()  # the consumer went away: the producer exits

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in it:
                if not offer(place(batch)):
                    return
        except Exception as e:  # surface in the consumer, not the thread
            offer(e)
            return
        offer(_END)

    threading.Thread(target=producer, daemon=True,
                     name="bf-data-prefetch").start()

    def consumer():
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                if isinstance(item, _Staged):
                    cur = torch.cuda.current_stream()
                    cur.wait_event(item.event)
                    for t in _tree_leaves(item.tree):
                        t.record_stream(cur)
                    item = item.tree
                yield item
        finally:
            # An early break or an error in the loop: release the producer
            # and drop the staged batches.
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    return consumer()


class ShardedLoader:
    """Batched, shuffled, prefetched feed over in-memory arrays.

    ``arrays`` is a tree of numpy arrays with one leading sample axis.
    Each batch is the tree with leaves of shape ``(num_ranks, batch_size,
    ...)`` on ``device`` (default ``bf.device()``; ``False``: numpy).
    ``transform`` maps the numpy batch before placement, on the prefetch
    thread."""

    def __init__(self, arrays, batch_size: int, *,
                 num_ranks: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 static_shards: bool = False,
                 transform: Optional[Callable] = None,
                 prefetch: int = 2, device=None):
        leaves = _tree_leaves(arrays)
        if not leaves:
            raise ValueError("empty dataset")
        n = leaves[0].shape[0]
        for leaf in leaves:
            if leaf.shape[0] != n:
                raise ValueError("all leaves need the same sample axis; got "
                                 f"{leaf.shape[0]} vs {n}")
        self.arrays = arrays
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.sampler = DistributedSampler(
            n, num_ranks=num_ranks, shuffle=shuffle, seed=seed,
            drop_last=drop_last, static_shards=static_shards)
        self.transform = transform
        self.prefetch = prefetch
        self.device = device
        if drop_last and self.sampler.per_rank < batch_size:
            raise ValueError(
                f"per-rank shard ({self.sampler.per_rank}) smaller than "
                f"batch_size ({batch_size})")

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.sampler.per_rank // self.batch_size
        # drop_last=False: the batch axis wraps too, so the tail trains.
        return -(-self.sampler.per_rank // self.batch_size)

    def _batches(self) -> Iterator:
        idx = self.sampler.indices()  # (ranks, per_rank)
        need = self.steps_per_epoch * self.batch_size
        if need > idx.shape[1]:  # drop_last=False tail: wrap within shards
            idx = np.concatenate([idx, idx[:, :need - idx.shape[1]]], axis=1)
        for s in range(self.steps_per_epoch):
            take = idx[:, s * self.batch_size:(s + 1) * self.batch_size]
            batch = _tree_map(lambda a: a[take], self.arrays)
            if self.transform is not None:
                batch = self.transform(batch)
            yield batch

    def __iter__(self) -> Iterator:
        return prefetch_to_device(self._batches(), size=self.prefetch,
                                  device=self.device)

    def __len__(self) -> int:
        return self.steps_per_epoch
