"""Module-level context: the ``import bluefog_tpu_torch as bf`` surface.

The port of ``bluefog_tpu/basics.py``, with the JAX package's data model:
rank ``i``'s tensor is row ``i`` of a rank-major tensor.  Two modes:

- **One process** (:func:`init`): ``n`` virtual ranks live on one device,
  and a rank-major tensor has all ``n`` rows.
- **Many processes** (:func:`init_distributed`, one process per card
  under ``bfrun``'s or ``torchrun``'s environment): each process owns a
  contiguous block of ranks (:func:`owned_ranks`), a rank-major tensor
  holds those rows, and the rounds cross processes over
  ``torch.distributed`` (``ops.p2p``): NCCL on CUDA, gloo on the CPU.

The context holds the device every entry point defaults to.  It is CUDA
unless the caller asks for another device; with no GPU present, asking for
CUDA raises instead of falling back to the CPU.

The eager collectives take and return rank-major tensors on the context's
device.  In one process they return once their work is queued on the
device's stream, as every torch op does.  The ``*_nonblocking`` calls return
a :class:`Handle`: across processes it holds the async works and finishes
the combine at :func:`wait`; in one process the result is already queued,
and the handle holds a CUDA event recorded after it (on the CPU it is ready
at once).
"""

from __future__ import annotations

import hashlib
import os
import socket
from typing import Dict, List, Optional, Union

import networkx as nx
import numpy as np
import torch
import torch.distributed as dist

from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.ops import schedule as S
from bluefog_tpu_torch.ops.p2p import Pending, ProcessRanks

__all__ = ["init", "init_distributed", "shutdown", "initialized", "size",
           "rank", "owned_ranks", "local_size", "local_rank",
           "machine_size", "machine_rank", "is_homogeneous",
           "process_ranks", "device", "set_topology", "load_topology",
           "is_topo_weighted", "allreduce", "local_allreduce", "broadcast",
           "allgather", "allgather_v", "neighbor_allreduce",
           "dynamic_neighbor_allreduce", "neighbor_allgather",
           "neighbor_allgather_v", "pair_gossip", "broadcast_parameters",
           "Handle", "allreduce_nonblocking", "local_allreduce_nonblocking",
           "broadcast_nonblocking", "allgather_nonblocking",
           "neighbor_allreduce_nonblocking",
           "dynamic_neighbor_allreduce_nonblocking",
           "neighbor_allgather_nonblocking", "pair_gossip_nonblocking",
           "poll", "wait", "synchronize", "resolve_device",
           "set_machine_topology", "load_machine_topology",
           "hierarchical_neighbor_allreduce",
           "hierarchical_neighbor_allreduce_nonblocking",
           "dynamic_hierarchical_neighbor_allreduce",
           "dynamic_hierarchical_neighbor_allreduce_nonblocking",
           "hierarchical_gossip", "hierarchical_gossip_nonblocking"]


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
        self.comm: Optional[ProcessRanks] = None
        # {host digest: ranks on that host}, gathered by init_distributed.
        self.host_rank_counts: Optional[Dict[str, int]] = None
        self.topology: Optional[nx.DiGraph] = None
        self.is_topo_weighted = False
        self.topology_version = 0
        # The machine level of the hierarchical ops (set_machine_topology).
        self.machine_topology: Optional[nx.DiGraph] = None
        self.is_machine_topo_weighted = False
        self.machine_topology_version = 0
        self.hier_topology = None   # hierarchical_gossip's, with its key
        self._hier_key = None
        self._schedules: dict = {}

    def schedule(self, key, build):
        """Compiled schedules, cached per topology version."""
        key = (self.topology_version, self.machine_topology_version) + key
        if key not in self._schedules:
            self._schedules[key] = build()
        return self._schedules[key]


_ctx = _Context()


def _require_init() -> _Context:
    if not _ctx.initialized:
        raise RuntimeError(
            "bluefog_tpu_torch is not initialized; call init() first")
    return _ctx


def _setup(size: int, local: int, dev: torch.device, topology_fn,
           is_weighted: bool, comm: Optional[ProcessRanks] = None) -> None:
    global _ctx
    if local < 1 or size % local:
        raise ValueError("world size must be divisible by local_size "
                         f"({size} ranks, local_size {local})")
    _ctx = _Context()
    _ctx.size = size
    _ctx.local_size = local
    _ctx.device = dev
    _ctx.comm = comm
    _ctx.initialized = True
    topo = topology_fn() if topology_fn is not None \
        else topology_util.ExponentialGraph(_ctx.size)
    set_topology(topo, is_weighted=is_weighted)
    if size // local > 1:
        set_machine_topology(topology_util.ExponentialGraph(size // local),
                             is_weighted=False)


def init(size: int, device="cuda", topology_fn=None,
         is_weighted: bool = False, *,
         local_size: Optional[int] = None) -> None:
    """Initialize ``size`` virtual ranks on ``device``, all in this
    process.

    ``topology_fn``: zero-arg callable returning the virtual topology
    (default ``ExponentialGraph(size)``, as the JAX package).
    ``is_weighted``: use the topology's edge weights instead of uniform
    ``1/(indeg+1)`` averaging.  ``local_size``: ranks per machine, for
    :func:`local_allreduce` and the hierarchical ops (default ``size``:
    one machine); with more than one machine the machine topology starts
    as ``ExponentialGraph(machines)``, as in the JAX package."""
    if int(size) < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = resolve_device(device)
    shutdown()
    _setup(int(size), int(size) if local_size is None else int(local_size),
           dev, topology_fn, is_weighted)


def _rendezvous(env) -> tuple:
    """``(init_method, world_size, process id, local id)``: ``bfrun``'s
    ``BFTPU_COORDINATOR`` / ``BFTPU_NUM_PROCESSES`` / ``BFTPU_PROCESS_ID``
    / ``BFTPU_LOCAL_ID`` when set, else ``torchrun``'s environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``)."""
    coord = env.get("BFTPU_COORDINATOR")
    if coord is not None:
        return (f"tcp://{coord}", int(env["BFTPU_NUM_PROCESSES"]),
                int(env["BFTPU_PROCESS_ID"]),
                int(env.get("BFTPU_LOCAL_ID", "0")))
    if "WORLD_SIZE" not in env or "RANK" not in env:
        raise RuntimeError(
            "init_distributed: no launcher environment; set BFTPU_COORDINATOR"
            ", BFTPU_NUM_PROCESSES and BFTPU_PROCESS_ID (bfrun) or run under "
            "torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    return ("env://", int(env["WORLD_SIZE"]), int(env["RANK"]),
            int(env.get("LOCAL_RANK", "0")))


def init_distributed(topology_fn=None, is_weighted: bool = False, *,
                     backend: Optional[str] = None, device="cuda") -> None:
    """Multi-process init over ``torch.distributed``, the port of the JAX
    package's ``init_distributed`` (``bluefog_tpu/basics.py`` L234-272).

    The rendezvous reads the environment ``bfrun`` sets, else
    ``torchrun``'s (:func:`_rendezvous`).  ``backend``: NCCL for a CUDA
    ``device`` (default), gloo for the CPU; asking for NCCL without a GPU
    raises.  On CUDA the process takes card ``BFTPU_LOCAL_ID``
    (``LOCAL_RANK``).  Each process owns ``BFTPU_LOCAL_DEVICES`` ranks
    (default 1; the JAX package's virtual CPU mode gives a process that
    many devices), a contiguous block in process order; every process must
    own as many.  ``local_size`` is the ranks a process owns when there are
    several processes, else the world, as the JAX package's
    ``jax.local_device_count()``."""
    env = os.environ
    method, nprocs, proc, local_id = _rendezvous(env)
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: the NCCL backend needs a "
                               "GPU; pass backend='gloo' and device='cpu'")
        if dev.type != "cuda":
            raise ValueError(f"the NCCL backend moves CUDA tensors; device "
                             f"is {dev}")
    if dev.type == "cuda":
        dev = torch.device("cuda", local_id)
        torch.cuda.set_device(dev)
    per = int(env.get("BFTPU_LOCAL_DEVICES", "1"))
    shutdown()
    dist.init_process_group(backend, init_method=method, world_size=nprocs,
                            rank=proc)
    comm = ProcessRanks(per, proc, nprocs)
    # The JAX package's placement probe (L372-410): every process's host
    # and rank count.
    host = hashlib.blake2b(socket.gethostname().encode(),
                           digest_size=8).hexdigest()
    seen = comm.all_gather_object((host, per))
    if any(p != per for _, p in seen):
        dist.destroy_process_group()
        raise ValueError("every process must own as many ranks "
                         f"(BFTPU_LOCAL_DEVICES): {[p for _, p in seen]}")
    _setup(comm.n, per if nprocs > 1 else comm.n, dev, topology_fn,
           is_weighted, comm)
    counts: Dict[str, int] = {}
    for h, p in seen:
        counts[h] = counts.get(h, 0) + p
    _ctx.host_rank_counts = counts


def shutdown() -> None:
    """Free every window and drop the context; after
    :func:`init_distributed`, also the process group."""
    global _ctx
    from bluefog_tpu_torch.ops import window
    window._free_all_windows()
    if _ctx.comm is not None and dist.is_initialized():
        dist.destroy_process_group()
    _ctx = _Context()


def initialized() -> bool:
    return _ctx.initialized


def size() -> int:
    return _require_init().size


def owned_ranks() -> List[int]:
    """The ranks this process drives, ascending: every rank in one
    process."""
    ctx = _require_init()
    if ctx.comm is None:
        return list(range(ctx.size))
    return list(range(ctx.comm.lo, ctx.comm.hi))


def rank() -> int:
    """Lowest rank this process drives (:func:`owned_ranks`)."""
    return owned_ranks()[0]


def process_ranks() -> Optional[ProcessRanks]:
    """The transport of :func:`init_distributed` (None in one process): a
    sequence axis across processes for ``parallel.ring_attention`` and
    ``parallel.ulysses``."""
    return _require_init().comm


def local_size() -> int:
    """Ranks per machine (``init(local_size=)``; under
    :func:`init_distributed`, the ranks a process owns)."""
    return _require_init().local_size


def local_rank() -> int:
    """Local rank of :func:`rank` within its machine."""
    return rank() % local_size()


def machine_size() -> int:
    return size() // local_size()


def machine_rank() -> int:
    return rank() // local_size()


def is_homogeneous() -> bool:
    """True iff every host runs as many ranks: under
    :func:`init_distributed` by the hosts' rank counts gathered at init
    (the JAX package's placement probe), else trivially."""
    counts = _require_init().host_rank_counts
    return not counts or len(set(counts.values())) <= 1


def device() -> torch.device:
    return _require_init().device


def set_topology(topology: Optional[nx.DiGraph] = None,
                 is_weighted: bool = False) -> bool:
    """Install a new virtual topology; the next op compiles against it.
    Refused while windows exist: their staging buffers follow the
    topology they were created under (the reference's rule)."""
    ctx = _require_init()
    from bluefog_tpu_torch.ops import window
    if window._any_window_exists():
        raise RuntimeError(
            "cannot change the topology while windows exist; win_free() them "
            "first (matches reference basics.py set_topology restriction)")
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


def set_machine_topology(topology: nx.DiGraph,
                         is_weighted: bool = False) -> bool:
    """Install the machine-level topology of the hierarchical ops: a graph
    over the ``machine_size()`` machines (parity: ``basics.py:259-293``)."""
    ctx = _require_init()
    if topology.number_of_nodes() != machine_size():
        raise ValueError(
            f"machine topology has {topology.number_of_nodes()} nodes, "
            f"machine count is {machine_size()}")
    ctx.machine_topology = topology
    ctx.is_machine_topo_weighted = is_weighted
    ctx.machine_topology_version += 1
    ctx._schedules.clear()
    return True


def load_machine_topology() -> Optional[nx.DiGraph]:
    return _require_init().machine_topology


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
    rows = len(owned_ranks())
    if x.dim() == 0 or x.shape[0] != rows:
        raise ValueError(f"expected a rank-major tensor with leading dim "
                         f"{rows}, got shape {tuple(x.shape)}")
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


class Handle:
    """An op in flight, from a ``*_nonblocking`` call: :func:`poll` says
    whether it is done, :func:`wait` returns its result.  Across processes
    it holds the async works and finishes the op at :func:`wait`; in one
    process the result is already queued, and a CUDA event recorded after
    it tells when the device is through (on the CPU it is ready at once)."""

    def __init__(self, pending: Pending):
        self._pending = pending
        self._event = None
        if pending.is_completed():
            out = pending.wait()
            if isinstance(out, torch.Tensor) and out.is_cuda:
                self._event = torch.cuda.Event()
                self._event.record()

    def poll(self) -> bool:
        if self._event is not None:
            return self._event.query()
        return self._pending.is_completed()

    def wait(self):
        out = self._pending.wait()
        if self._event is not None:
            self._event.synchronize()
        elif isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        return out


def poll(handle: Handle) -> bool:
    """True iff the handle's op is done."""
    return handle.poll()


def wait(handle: Handle):
    """The handle's result, once the op is done."""
    return handle.wait()


def synchronize(handle: Handle):
    """:func:`wait` (the JAX package's name for it)."""
    return handle.wait()


def allreduce_nonblocking(x, *, average: bool = True) -> Handle:
    return Handle(C.allreduce(_rank_major(x), average=average,
                              comm=_ctx.comm, async_op=True))


def allreduce(x, *, average: bool = True) -> torch.Tensor:
    """Every rank gets the rank mean (or with ``average=False`` the sum)."""
    return C.allreduce(_rank_major(x), average=average, comm=_ctx.comm)


def local_allreduce_nonblocking(x, *, average: bool = True) -> Handle:
    return Handle(C.local_allreduce(_rank_major(x), local_size(),
                                    average=average, comm=_ctx.comm,
                                    async_op=True))


def local_allreduce(x, *, average: bool = True) -> torch.Tensor:
    """:func:`allreduce` within each machine's ``local_size()`` ranks."""
    return C.local_allreduce(_rank_major(x), local_size(), average=average,
                             comm=_ctx.comm)


def broadcast_nonblocking(x, root_rank: int) -> Handle:
    return Handle(C.broadcast(_rank_major(x), root_rank, comm=_ctx.comm,
                              async_op=True))


def broadcast(x, root_rank: int) -> torch.Tensor:
    """Every rank gets ``root_rank``'s value."""
    return C.broadcast(_rank_major(x), root_rank, comm=_ctx.comm)


def allgather_nonblocking(x) -> Handle:
    return Handle(C.allgather(_rank_major(x), comm=_ctx.comm, async_op=True))


def allgather(x) -> torch.Tensor:
    """Every rank receives the concatenation of all ranks' tensors along
    the leading (per-rank) axis; output shape ``(size, size*d0, ...)``."""
    return C.allgather(_rank_major(x), comm=_ctx.comm)


def _ragged_pack(tensors):
    """Validate a per-rank list of tensors (one an owned rank) that may
    differ in their first dim only, and pad it into a rank-major ``(m,
    max_d, *trailing)`` tensor, ``max_d`` the world's longest; returns it
    with every rank's length."""
    ctx = _require_init()
    m = len(owned_ranks())
    if len(tensors) != m:
        raise ValueError(
            f"expected one tensor per rank ({m}), got {len(tensors)}")
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
    if ctx.comm is not None:
        lengths = tuple(d for part in ctx.comm.all_gather_object(lengths)
                        for d in part)
    own = lengths[rank():rank() + m]
    padded = ts[0].new_zeros((m, max(max(lengths), 1)) + tuple(trailing))
    for i, t in enumerate(ts):
        padded[i, :own[i]] = t
    return padded, lengths


def allgather_v(tensors) -> torch.Tensor:
    """Allgather of tensors whose first dims differ: rank ``i`` gives
    ``tensors[i]`` of shape ``(d_i, *trailing)``; returns the rank-major
    ``(size, sum_i d_i, *trailing)``, every row the concatenation in rank
    order."""
    padded, lengths = _ragged_pack(tensors)
    rows = padded if _ctx.comm is None else _ctx.comm.all_gather(padded).wait()
    whole = torch.cat([rows[i, :d] for i, d in enumerate(lengths)])
    return whole.expand((padded.shape[0],) + whole.shape).clone()


def _static_schedule_for(w: Optional[np.ndarray]) -> S.StaticSchedule:
    if w is None:
        return static_schedule()
    ctx = _require_init()
    return ctx.schedule(("override", w.tobytes()), lambda: S.compile_static(
        ctx.topology, src_weights=w))


def neighbor_allreduce_nonblocking(x, *, self_weight=None, src_weights=None,
                                   dst_weights=None) -> Handle:
    w = _weight_override_matrix(self_weight, src_weights, dst_weights)
    return Handle(C.neighbor_allreduce(_rank_major(x), _static_schedule_for(w),
                                       comm=_ctx.comm, async_op=True))


def neighbor_allreduce(x, *, self_weight=None, src_weights=None,
                       dst_weights=None) -> torch.Tensor:
    """Weighted neighbor averaging over the active topology; the weight
    arguments override its weights (:func:`_weight_override_matrix`)."""
    w = _weight_override_matrix(self_weight, src_weights, dst_weights)
    return C.neighbor_allreduce(_rank_major(x), _static_schedule_for(w),
                                comm=_ctx.comm)


def dynamic_neighbor_allreduce_nonblocking(x, step: int, *,
                                           phases=None) -> Handle:
    return Handle(C.dynamic_neighbor_allreduce(
        _rank_major(x), step, dynamic_schedule(phases), comm=_ctx.comm,
        async_op=True))


def dynamic_neighbor_allreduce(x, step: int, *, phases=None) -> torch.Tensor:
    """Neighbor averaging with the one-peer dynamic walk at ``step``;
    ``phases`` defaults to the phase table of the active topology."""
    return C.dynamic_neighbor_allreduce(_rank_major(x), step,
                                        dynamic_schedule(phases),
                                        comm=_ctx.comm)


def neighbor_allgather_nonblocking(x) -> Handle:
    return Handle(C.neighbor_allgather(_rank_major(x), static_schedule(),
                                       comm=_ctx.comm, async_op=True))


def neighbor_allgather(x) -> torch.Tensor:
    """Gather in-neighbor tensors: output ``(size, max_indegree, ...)`` in
    ascending-src order with zero padding for irregular indegree."""
    return C.neighbor_allgather(_rank_major(x), static_schedule(),
                                comm=_ctx.comm)


def neighbor_allgather_v(tensors) -> list:
    """Neighbor allgather of tensors whose first dims differ: entry ``i``
    of the returned list, for owned rank ``dst``, is the concatenation of
    ``tensors[src]`` over ``dst``'s in-neighbors in ascending src order.
    The exchange is :func:`neighbor_allgather` of the padded rows; the
    segments are then cut out of each receiver's slots."""
    padded, lengths = _ragged_pack(tensors)
    rows = neighbor_allgather(padded)
    # The slots follow the compiled schedule, whose edges are the nonzero
    # entries of the weight matrix in use.
    w = topology_util.weight_matrix(load_topology())
    if not is_topo_weighted():
        w = S.uniform_weights(w)
    out = []
    for i, dst in enumerate(owned_ranks()):
        srcs = [s for s in range(size()) if s != dst and w[s, dst] != 0.0]
        segs = [rows[i, slot, :lengths[src]]
                for slot, src in enumerate(srcs)]
        out.append(torch.cat(segs) if segs else padded.new_zeros(
            (0,) + tuple(padded.shape[2:])))
    return out


def _pair_schedule(target_ranks, self_weight: float, target_weight: float):
    n = size()
    if isinstance(target_ranks, dict):
        tgt = [-1] * n
        for r, t in target_ranks.items():
            tgt[r] = t
    else:
        tgt = list(target_ranks)
    return _require_init().schedule(
        ("gossip", tuple(tgt), self_weight, target_weight),
        lambda: S.compile_pair_gossip(tgt, n, self_weight=self_weight,
                                      target_weight=target_weight))


def pair_gossip_nonblocking(x, target_ranks, *, self_weight: float = 0.5,
                            target_weight: float = 0.5) -> Handle:
    sched = _pair_schedule(target_ranks, self_weight, target_weight)
    return Handle(C.pair_gossip(_rank_major(x), sched, comm=_ctx.comm,
                                async_op=True))


def pair_gossip(x, target_ranks, *, self_weight: float = 0.5,
                target_weight: float = 0.5) -> torch.Tensor:
    """Pairwise exchange and average.  ``target_ranks``: a list (or dict)
    giving each rank its partner, -1 (or missing) to sit out; it must be
    mutual."""
    sched = _pair_schedule(target_ranks, self_weight, target_weight)
    return C.pair_gossip(_rank_major(x), sched, comm=_ctx.comm)


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


# ---------------------------------------------------------------------------
# Hierarchical family: machines of local_size() consecutive ranks
# ---------------------------------------------------------------------------

def _require_machine_topology() -> _Context:
    ctx = _require_init()
    if ctx.machine_topology is None:
        raise RuntimeError(
            "set_machine_topology() required for hierarchical ops")
    return ctx


def hierarchical_neighbor_allreduce_nonblocking(
        x, *, self_weight=None, src_machine_weights=None) -> Handle:
    ctx = _require_machine_topology()
    key = ("hier", ctx.is_machine_topo_weighted, self_weight,
           None if src_machine_weights is None
           else np.asarray(src_machine_weights, dtype=float).tobytes())
    sched = ctx.schedule(key, lambda: S.compile_static(
        ctx.machine_topology, use_topo_weights=ctx.is_machine_topo_weighted,
        self_weight=self_weight, src_weights=src_machine_weights))
    return Handle(C.hierarchical_neighbor_allreduce(
        _rank_major(x), sched, ctx.local_size, comm=ctx.comm,
        async_op=True))


def hierarchical_neighbor_allreduce(x, *, self_weight=None,
                                    src_machine_weights=None) -> torch.Tensor:
    """Machine-level neighbor averaging: each machine's local sum, the
    neighbor combine of the sums over the machine topology (its weights,
    or ``self_weight`` and the ``(machines, machines)``
    ``src_machine_weights``), then the division by ``local_size()``."""
    return hierarchical_neighbor_allreduce_nonblocking(
        x, self_weight=self_weight,
        src_machine_weights=src_machine_weights).wait()


def dynamic_hierarchical_neighbor_allreduce_nonblocking(
        x, step: int, *, phases=None) -> Handle:
    """Hierarchical averaging with a per-step machine-level topology;
    ``phases`` defaults to the one-peer walk of the machine topology (the
    analogue of driving ``GetExp2DynamicSendRecvMachineRanks`` by hand)."""
    ctx = _require_machine_topology()
    m = machine_size()
    if phases is None:
        sched = ctx.schedule(("dynhier",), lambda: S.compile_dynamic(
            topology_util.dynamic_phase_table(ctx.machine_topology), m))
    else:
        sched = ctx.schedule(
            ("dynhierphases", tuple(ph.send_to for ph in phases)),
            lambda: S.compile_dynamic(phases, m))
    return Handle(C.dynamic_hierarchical_neighbor_allreduce(
        _rank_major(x), step, sched, ctx.local_size, comm=ctx.comm,
        async_op=True))


def dynamic_hierarchical_neighbor_allreduce(x, step: int, *,
                                            phases=None) -> torch.Tensor:
    return dynamic_hierarchical_neighbor_allreduce_nonblocking(
        x, step, phases=phases).wait()


def _hier_topology(ctx: _Context, cfg):
    """The :class:`topology.HierarchicalTopology` of the
    ``BLUEFOG_TPU_HIER_*`` knobs (``cfg``) over the machines (slices =
    machines), cached until the knobs or the world change."""
    n_slices = ctx.size // ctx.local_size
    key = (ctx.size, n_slices, cfg.hier_inner, cfg.hier_outer,
           cfg.hier_outer_every, cfg.hier_outer_self_weight)
    if ctx._hier_key != key:
        ctx.hier_topology = topology_util.hierarchical_two_level(
            ctx.size, n_slices, inner=cfg.hier_inner, outer=cfg.hier_outer,
            outer_every=cfg.hier_outer_every,
            outer_self_weight=cfg.hier_outer_self_weight)
        ctx._hier_key = key
    return ctx.hier_topology


def _hier_plan(what: str, ht=None) -> dict:
    """The compiled two-level bundle of ``hierarchical_gossip`` (``what``
    names the caller in its errors): the inner schedule over a machine's
    ranks, the outer schedules, a phase each, over the machines, the
    cadence and the outer codec; ``ht`` overrides the knobs' topology.
    Requires ``BLUEFOG_TPU_HIER=1`` and more than one machine."""
    from bluefog_tpu_torch.utils import config
    ctx = _require_init()
    cfg = config.get()
    if not cfg.hier:
        raise RuntimeError(
            f"{what} requires BLUEFOG_TPU_HIER=1 (default off: the two-level "
            "mode must be an explicit operational decision)")
    if ctx.local_size >= ctx.size:
        raise RuntimeError(
            f"{what} needs more than one machine: call "
            "bf.init(size, local_size=<ranks per machine>) so "
            "machine_size() > 1")
    ht = ht or _hier_topology(ctx, cfg)
    sig = ("hier_gossip", ht.n, ht.n_slices, ht.inner_kind, ht.outer_kind,
           ht.outer_every, ht.outer_self_weight)
    inner, outer = ctx.schedule(sig, lambda: (
        S.compile_static(ht.inner, use_topo_weights=True),
        tuple(S._schedule_from_matrix(ht.outer_slice_matrix(p))
              for p in range(len(ht.outer_phases)))))
    comp = cfg.hier_outer_compression
    return {"inner_sched": inner, "outer_scheds": outer,
            "outer_every": ht.outer_every, "outer_compression": comp,
            "outer_frac": (config.parse_sparse_frac(comp)
                           if comp.startswith("sparse") else None)}


def hierarchical_gossip_nonblocking(x, step: int, *, ht=None) -> Handle:
    """Two-level gossip step: the dense inner combine within each machine
    every step, the one-peer exchange between machines every
    ``BLUEFOG_TPU_HIER_OUTER_EVERY`` steps with its own codec
    (``BLUEFOG_TPU_HIER_OUTER_COMPRESSION``).  Requires
    ``BLUEFOG_TPU_HIER=1`` and more than one machine; ``ht`` overrides the
    knobs' :class:`~bluefog_tpu_torch.topology.HierarchicalTopology`."""
    plan = _hier_plan("hierarchical_gossip", ht)
    out = C.hierarchical_gossip(
        _rank_major(x), step, plan.pop("inner_sched"),
        plan.pop("outer_scheds"), _ctx.local_size, comm=_ctx.comm, **plan)
    return Handle(Pending.done(out))


def hierarchical_gossip(x, step: int, *, ht=None) -> torch.Tensor:
    return hierarchical_gossip_nonblocking(x, step, ht=ht).wait()
