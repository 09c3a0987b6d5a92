"""Module-level context: the ``import bluefog_tpu_torch as bf`` surface.

The port's subset of ``bluefog_tpu/basics.py`` in single-process rank-major
mode, the same data model as the JAX package's eager API: ``n`` virtual ranks
live on one device, and rank ``i``'s tensor is row ``i`` of a rank-major
tensor of shape ``(n, ...)``.  The multi-process transport (one process per
card, rounds over NCCL) is a later slice.

The context holds the device every entry point defaults to.  It is CUDA
unless the caller asks for another device; with no GPU present, asking for
CUDA raises instead of falling back to the CPU.

The eager collectives take and return rank-major tensors on the context's
device.  They return once their work is queued on the device's stream, as
every torch op does: whatever reads the result waits for it.  The JAX
package's ``*_nonblocking`` handles wait for the multi-process transport.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import networkx as nx
import numpy as np
import torch

from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.ops import schedule as S

__all__ = ["init", "shutdown", "initialized", "size", "rank", "local_size",
           "device", "set_topology", "load_topology", "is_topo_weighted",
           "allreduce", "local_allreduce", "broadcast", "allgather",
           "allgather_v", "neighbor_allreduce", "dynamic_neighbor_allreduce",
           "neighbor_allgather", "neighbor_allgather_v", "pair_gossip",
           "broadcast_parameters", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent, so no entry point quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bluefog_tpu_torch: CUDA was requested (the default) but no GPU "
            "is available; pass device='cpu' to run on the CPU")
    return dev


class _Context:
    def __init__(self):
        self.initialized = False
        self.size = 0
        self.local_size = 0
        self.device: Optional[torch.device] = None
        self.topology: Optional[nx.DiGraph] = None
        self.is_topo_weighted = False
        self.topology_version = 0
        self._schedules: dict = {}

    def schedule(self, key, build):
        """Compiled schedules, cached per topology version."""
        key = (self.topology_version,) + key
        if key not in self._schedules:
            self._schedules[key] = build()
        return self._schedules[key]


_ctx = _Context()


def _require_init() -> _Context:
    if not _ctx.initialized:
        raise RuntimeError(
            "bluefog_tpu_torch is not initialized; call init() first")
    return _ctx


def init(size: int, device="cuda", topology_fn=None,
         is_weighted: bool = False, *,
         local_size: Optional[int] = None) -> None:
    """Initialize ``size`` virtual ranks on ``device``.

    ``topology_fn``: zero-arg callable returning the virtual topology
    (default ``ExponentialGraph(size)``, as the JAX package).
    ``is_weighted``: use the topology's edge weights instead of uniform
    ``1/(indeg+1)`` averaging.  ``local_size``: ranks per machine, for
    :func:`local_allreduce` (default ``size``: one machine)."""
    global _ctx
    if int(size) < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    local = int(size) if local_size is None else int(local_size)
    if local < 1 or int(size) % local:
        raise ValueError("world size must be divisible by local_size "
                         f"({size} ranks, local_size {local_size})")
    dev = resolve_device(device)
    _ctx = _Context()
    _ctx.size = int(size)
    _ctx.local_size = local
    _ctx.device = dev
    _ctx.initialized = True
    topo = topology_fn() if topology_fn is not None \
        else topology_util.ExponentialGraph(_ctx.size)
    set_topology(topo, is_weighted=is_weighted)


def shutdown() -> None:
    global _ctx
    _ctx = _Context()


def initialized() -> bool:
    return _ctx.initialized


def size() -> int:
    return _require_init().size


def rank() -> int:
    """Lowest rank this process drives: every rank lives in this process."""
    _require_init()
    return 0


def local_size() -> int:
    """Ranks per machine (``init(local_size=)``)."""
    return _require_init().local_size


def device() -> torch.device:
    return _require_init().device


def set_topology(topology: Optional[nx.DiGraph] = None,
                 is_weighted: bool = False) -> bool:
    """Install a new virtual topology; the next op compiles against it."""
    ctx = _require_init()
    if topology is None:
        topology = topology_util.ExponentialGraph(ctx.size)
    if topology.number_of_nodes() != ctx.size:
        raise ValueError(f"topology has {topology.number_of_nodes()} nodes, "
                         f"world size is {ctx.size}")
    ctx.topology = topology
    ctx.is_topo_weighted = is_weighted
    ctx.topology_version += 1
    ctx._schedules.clear()
    return True


def load_topology() -> nx.DiGraph:
    return _require_init().topology


def is_topo_weighted() -> bool:
    return _require_init().is_topo_weighted


def static_schedule() -> S.StaticSchedule:
    ctx = _require_init()
    return ctx.schedule(("static", ctx.is_topo_weighted), lambda: S.compile_static(
        ctx.topology, use_topo_weights=ctx.is_topo_weighted))


def dynamic_schedule(phases=None) -> S.DynamicSchedule:
    """Compiled one-peer walk: ``phases`` or the active topology's table."""
    ctx = _require_init()
    if phases is None:
        return ctx.schedule(("dynamic",), lambda: S.compile_dynamic(
            topology_util.dynamic_phase_table(ctx.topology), ctx.size))
    return ctx.schedule(
        ("dynphases", tuple(ph.send_to for ph in phases)),
        lambda: S.compile_dynamic(phases, ctx.size))


def _rank_major(x) -> torch.Tensor:
    ctx = _require_init()
    x = torch.as_tensor(x, device=ctx.device)
    if x.dim() == 0 or x.shape[0] != ctx.size:
        raise ValueError(f"expected a rank-major tensor with leading dim "
                         f"{ctx.size}, got shape {tuple(x.shape)}")
    return x


def _weight_override_matrix(
        self_weight: Optional[float],
        src_weights: Optional[Union[np.ndarray, Dict[int, float]]],
        dst_weights: Optional[Union[np.ndarray, Dict[int, float]]],
) -> Optional[np.ndarray]:
    """A full ``(n, n)`` weight matrix from the weight arguments of
    ``neighbor_allreduce`` and ``DistributedOptimizer.step``, as the JAX
    package builds it: a full matrix through ``src_weights`` (or
    ``dst_weights``); a ``{src: w}`` dict feeds every receiver of ``src``,
    a ``{dst: w}`` dict scales every edge into ``dst``; ``self_weight``
    sets the diagonal.  None when no argument is given."""
    if src_weights is None and dst_weights is None and self_weight is None:
        return None
    if self_weight is not None and src_weights is None and dst_weights is None:
        raise ValueError(
            "self_weight and src_weights/dst_weights have to be presented at "
            "the same time (matches reference torch/mpi_ops.py:532-534)")
    n = size()
    topo = load_topology()
    base = topology_util.weight_matrix(topo)
    if not is_topo_weighted():
        base = S.uniform_weights(base)
    src_is_matrix = src_weights is not None and not isinstance(src_weights, dict)
    dst_is_matrix = dst_weights is not None and not isinstance(dst_weights, dict)
    if src_is_matrix and dst_is_matrix:
        raise ValueError("pass a single full weight matrix, not both "
                         "src_weights and dst_weights matrices")
    if src_is_matrix or dst_is_matrix:
        w = np.asarray(src_weights if src_is_matrix else dst_weights, dtype=float)
        if w.shape != (n, n):
            raise ValueError(f"weight matrix must be ({n}, {n}), got {w.shape}")
    else:
        w = base.copy()
        if isinstance(src_weights, dict):
            sources = {s for s, d in topo.edges() if s != d}
            missing = sources - set(src_weights)
            if missing:
                raise ValueError(
                    "src_weights dict must cover every in-neighbor source; "
                    f"missing ranks {sorted(missing)} (reference raises too, "
                    "torch/mpi_ops.py:433-489)")
            off = np.zeros((n, n))
            for src, wt in src_weights.items():
                for dst in range(n):
                    if topo.has_edge(src, dst) and src != dst:
                        off[src, dst] = wt
            diag = np.diag(w).copy()
            w = off
            np.fill_diagonal(w, diag)
        if isinstance(dst_weights, dict):
            for dst, wt in dst_weights.items():
                for src in range(n):
                    if src != dst and topo.has_edge(src, dst):
                        w[src, dst] = wt
    if self_weight is not None:
        np.fill_diagonal(w, self_weight)
    return w


def allreduce(x, *, average: bool = True) -> torch.Tensor:
    """Every rank gets the rank mean (or with ``average=False`` the sum)."""
    return C.allreduce(_rank_major(x), average=average)


def local_allreduce(x, *, average: bool = True) -> torch.Tensor:
    """:func:`allreduce` within each machine's ``local_size()`` ranks."""
    return C.local_allreduce(_rank_major(x), local_size(), average=average)


def broadcast(x, root_rank: int) -> torch.Tensor:
    """Every rank gets ``root_rank``'s value."""
    return C.broadcast(_rank_major(x), root_rank)


def allgather(x) -> torch.Tensor:
    """Every rank receives the concatenation of all ranks' tensors along
    the leading (per-rank) axis; output shape ``(size, size*d0, ...)``."""
    return C.allgather(_rank_major(x))


def _ragged_pack(tensors):
    """Validate a per-rank list of tensors that may differ in their first
    dim only, and pad it into a rank-major ``(n, max_d, *trailing)``
    tensor; returns it with the lengths."""
    n = size()
    if len(tensors) != n:
        raise ValueError(
            f"expected one tensor per rank ({n}), got {len(tensors)}")
    ts = [torch.as_tensor(t, device=device()) for t in tensors]
    trailing = ts[0].shape[1:]
    dtype = ts[0].dtype
    for i, t in enumerate(ts):
        if t.dim() == 0:
            raise ValueError(f"rank {i}: scalar tensors have no first dim")
        if t.shape[1:] != trailing or t.dtype != dtype:
            raise ValueError(
                f"rank {i}: shape {tuple(t.shape)} / dtype {t.dtype} does "
                f"not match rank 0's trailing dims {tuple(trailing)} / "
                f"{dtype} (only the FIRST dim may vary, reference "
                "mpi_context.cc:443-504)")
    lengths = tuple(int(t.shape[0]) for t in ts)
    padded = ts[0].new_zeros((n, max(max(lengths), 1)) + tuple(trailing))
    for i, t in enumerate(ts):
        padded[i, :lengths[i]] = t
    return padded, lengths


def allgather_v(tensors) -> torch.Tensor:
    """Allgather of tensors whose first dims differ: rank ``i`` gives
    ``tensors[i]`` of shape ``(d_i, *trailing)``; returns the rank-major
    ``(size, sum_i d_i, *trailing)``, every row the concatenation in rank
    order."""
    padded, lengths = _ragged_pack(tensors)
    whole = torch.cat([padded[i, :d] for i, d in enumerate(lengths)])
    return whole.expand((size(),) + whole.shape).clone()


def _static_schedule_for(w: Optional[np.ndarray]) -> S.StaticSchedule:
    if w is None:
        return static_schedule()
    ctx = _require_init()
    return ctx.schedule(("override", w.tobytes()), lambda: S.compile_static(
        ctx.topology, src_weights=w))


def neighbor_allreduce(x, *, self_weight=None, src_weights=None,
                       dst_weights=None) -> torch.Tensor:
    """Weighted neighbor averaging over the active topology; the weight
    arguments override its weights (:func:`_weight_override_matrix`)."""
    w = _weight_override_matrix(self_weight, src_weights, dst_weights)
    return C.neighbor_allreduce(_rank_major(x), _static_schedule_for(w))


def dynamic_neighbor_allreduce(x, step: int, *, phases=None) -> torch.Tensor:
    """Neighbor averaging with the one-peer dynamic walk at ``step``;
    ``phases`` defaults to the phase table of the active topology."""
    return C.dynamic_neighbor_allreduce(_rank_major(x), step,
                                        dynamic_schedule(phases))


def neighbor_allgather(x) -> torch.Tensor:
    """Gather in-neighbor tensors: output ``(size, max_indegree, ...)`` in
    ascending-src order with zero padding for irregular indegree."""
    return C.neighbor_allgather(_rank_major(x), static_schedule())


def neighbor_allgather_v(tensors) -> list:
    """Neighbor allgather of tensors whose first dims differ: entry ``dst``
    of the returned list is the concatenation of ``tensors[src]`` over
    ``dst``'s in-neighbors in ascending src order.  The exchange is
    :func:`neighbor_allgather` of the padded rows; the segments are then
    cut out of each receiver's slots."""
    padded, lengths = _ragged_pack(tensors)
    rows = neighbor_allgather(padded)
    # The slots follow the compiled schedule, whose edges are the nonzero
    # entries of the weight matrix in use.
    w = topology_util.weight_matrix(load_topology())
    if not is_topo_weighted():
        w = S.uniform_weights(w)
    out = []
    for dst in range(size()):
        srcs = [s for s in range(size()) if s != dst and w[s, dst] != 0.0]
        segs = [rows[dst, slot, :lengths[src]]
                for slot, src in enumerate(srcs)]
        out.append(torch.cat(segs) if segs else padded.new_zeros(
            (0,) + tuple(padded.shape[2:])))
    return out


def pair_gossip(x, target_ranks, *, self_weight: float = 0.5,
                target_weight: float = 0.5) -> torch.Tensor:
    """Pairwise exchange and average.  ``target_ranks``: a list (or dict)
    giving each rank its partner, -1 (or missing) to sit out; it must be
    mutual."""
    n = size()
    if isinstance(target_ranks, dict):
        tgt = [-1] * n
        for r, t in target_ranks.items():
            tgt[r] = t
    else:
        tgt = list(target_ranks)
    sched = _require_init().schedule(
        ("gossip", tuple(tgt), self_weight, target_weight),
        lambda: S.compile_pair_gossip(tgt, n, self_weight=self_weight,
                                      target_weight=target_weight))
    return C.pair_gossip(_rank_major(x), sched)


def broadcast_parameters(params, root_rank: int = 0):
    """``root_rank``'s row of every rank-major tensor in ``params`` (a
    tensor, or a dict, list or tuple of them, nested), in the same
    structure."""
    if isinstance(params, dict):
        return type(params)((k, broadcast_parameters(v, root_rank))
                            for k, v in params.items())
    if isinstance(params, (list, tuple)):
        return type(params)(broadcast_parameters(v, root_rank)
                            for v in params)
    return broadcast(params, root_rank)
