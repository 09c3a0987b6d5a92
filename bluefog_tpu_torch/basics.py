"""Module-level context: the ``import bluefog_tpu_torch as bf`` surface.

The port's subset of ``bluefog_tpu/basics.py`` in single-process rank-major
mode, the same data model as the JAX package's eager API: ``n`` virtual ranks
live on one device, and rank ``i``'s tensor is row ``i`` of a rank-major
tensor of shape ``(n, ...)``.  The multi-process transport (one process per
card, rounds over NCCL) is a later slice.

The context holds the device every entry point defaults to.  It is CUDA
unless the caller asks for another device; with no GPU present, asking for
CUDA raises instead of falling back to the CPU.
"""

from __future__ import annotations

from typing import Optional

import networkx as nx
import torch

from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.ops import schedule as S

__all__ = ["init", "shutdown", "initialized", "size", "rank", "device",
           "set_topology", "load_topology", "is_topo_weighted",
           "neighbor_allreduce", "dynamic_neighbor_allreduce",
           "resolve_device"]


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
         is_weighted: bool = False) -> None:
    """Initialize ``size`` virtual ranks on ``device``.

    ``topology_fn``: zero-arg callable returning the virtual topology
    (default ``ExponentialGraph(size)``, as the JAX package).
    ``is_weighted``: use the topology's edge weights instead of uniform
    ``1/(indeg+1)`` averaging."""
    global _ctx
    if int(size) < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = resolve_device(device)
    _ctx = _Context()
    _ctx.size = int(size)
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


def neighbor_allreduce(x) -> torch.Tensor:
    """Weighted neighbor averaging over the active topology."""
    return C.neighbor_allreduce(_rank_major(x), static_schedule())


def dynamic_neighbor_allreduce(x, step: int, *, phases=None) -> torch.Tensor:
    """Neighbor averaging with the one-peer dynamic walk at ``step``;
    ``phases`` defaults to the phase table of the active topology."""
    return C.dynamic_neighbor_allreduce(_rank_major(x), step,
                                        dynamic_schedule(phases))
