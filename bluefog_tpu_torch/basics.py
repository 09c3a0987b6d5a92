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

:func:`set_topology` also refreshes the physical placement, as the JAX
package's does: with an interconnect model (``BLUEFOG_TPU_FAKE_TORUS``;
CUDA and CPU devices carry no geometry, so without it there is none) it
searches the logical-rank -> device permutation over the static schedule,
the one-peer phase table and the hierarchical levels, and the eager
neighbor ops dispatch the congestion-repacked or synthesized schedules
(:func:`placement_info`, :func:`synthesis_info`).  The ranks are rows of
one tensor, so the permutation moves no data; it prices the schedules.

The eager collectives take and return rank-major tensors on the context's
device.  In one process they return once their work is queued on the
device's stream, as every torch op does.  Each call is recorded as the JAX
package's dispatch records it (``utils/telemetry``: calls, bytes, the
schedule's rounds and edges; an ``ENQUEUE`` span around the launch and a
``synchronize``/``COMMUNICATE`` span around the wait for its works), from
shapes and schedules only: the telemetry never synchronises the device.
The ``*_nonblocking`` calls return a :class:`Handle`: across processes it
holds the async works and finishes the combine at :func:`wait`; in one
process the result is already queued, and the handle holds a CUDA event
recorded after it (on the CPU it is ready at once).
"""

from __future__ import annotations

import collections
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
from bluefog_tpu_torch.utils import stall, telemetry
from bluefog_tpu_torch.utils.logging import get_logger
from bluefog_tpu_torch.utils.timeline import flush as _timeline_flush
from bluefog_tpu_torch.utils.timeline import op_span

__all__ = ["init", "init_distributed", "shutdown", "barrier", "initialized",
           "size", "rank", "owned_ranks", "local_size", "local_rank",
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
           "hierarchical_gossip", "hierarchical_gossip_nonblocking",
           "hierarchical_gossip_info", "suspend", "resume", "suspended",
           "in_neighbor_ranks", "out_neighbor_ranks",
           "in_neighbor_machine_ranks", "out_neighbor_machine_ranks",
           "allreduce_parameters", "broadcast_optimizer_state",
           "allreduce_", "allreduce_nonblocking_", "broadcast_",
           "broadcast_nonblocking_", "set_skip_negotiate_stage",
           "get_skip_negotiate_stage", "mpi_threads_supported",
           "nccl_built", "unified_mpi_window_model_supported",
           "placement_info", "synthesis_info"]


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
        # Dispatch keys seen (the JAX package's jit-cache keys): the
        # dispatch-cache hit and miss counters.
        self._dispatched: set = set()
        self.suspended = False      # suspend(): new communication refused
        # The physical placement (_refresh_placement): the interconnect
        # model (None: no geometry), the logical -> device permutation
        # (None: identity), the search's result, the synthesis selection,
        # and (model, perm) as one snapshot for the dispatch's repack; the
        # generation keys the dispatched schedules.
        self.placement_model = None
        self.placement = None
        self.placement_result = None
        self.synthesis_ratio: Optional[float] = None
        self.synthesis_provenance: Optional[str] = None
        self._placement_state: tuple = (None, None)
        self.placement_generation = 0

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


def _require_active() -> _Context:
    """The context, refusing while :func:`suspend` is in force."""
    ctx = _require_init()
    if ctx.suspended:
        raise RuntimeError(
            "bluefog_tpu_torch is suspended (suspend()); call resume() "
            "before issuing communication ops")
    return ctx


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
    # The opt-in /metrics + /healthz endpoint (BLUEFOG_TPU_TELEMETRY_PORT);
    # idempotent across re-init.
    telemetry.maybe_start_endpoint()


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
    # Windows across processes ride their own TCP transport (the JAX
    # package's init_distributed starts it here too).
    from bluefog_tpu_torch.ops import window
    window.init_transport()


def shutdown() -> None:
    """Free every window and drop the context; after
    :func:`init_distributed`, also the churn supervisor, the window
    transport and then the process group.  After the gang lost a member
    (a committed membership change) the process group is left to the
    process exit: it holds the dead member, and tearing it down would
    wait for it."""
    global _ctx
    from bluefog_tpu_torch.ops import membership, window
    from bluefog_tpu_torch.run import supervisor
    ctrl = membership.current()
    churned = ctrl is not None and (
        ctrl.evicted or set(ctrl.active) != set(range(ctrl.n_procs)))
    supervisor._stop_singleton()
    if membership.current() is not None:
        membership.install(None)
    window._free_all_windows()
    window._shutdown_transport()
    if _ctx.comm is not None and dist.is_initialized() and not churned:
        dist.destroy_process_group()
    stall._monitor.unpause()  # a suspended session must not outlive it
    _ctx = _Context()


def suspend() -> None:
    """Quiesce for interactive use (the reference's ``bf.suspend``, the
    JAX package's ``basics.py`` L283-309): wait for every outstanding
    window op, silence the stall watchdog (an idle prompt is not a stalled
    peer), flush the timeline, then refuse new communication ops until
    :func:`resume`.  Queries (rank, size, topology) and reading window
    state stay available."""
    ctx = _require_init()
    if ctx.suspended:
        return
    from bluefog_tpu_torch.ops import window
    if not window._drain_handles():
        get_logger().warning(
            "suspend: outstanding window ops did not drain within 60 s; "
            "suspending anyway (a hung peer or a dead transport is likely)")
    stall._monitor.pause()
    _timeline_flush()
    ctx.suspended = True


def resume() -> None:
    """Accept communication ops again after :func:`suspend`."""
    ctx = _require_init()
    stall._monitor.unpause()
    ctx.suspended = False


def suspended() -> bool:
    return _ctx.initialized and _ctx.suspended


def barrier() -> None:
    """Block until the device work enqueued so far is done and, across
    processes, until every process has reached the barrier (over the
    process group; one process needs no wire)."""
    ctx = _require_init()
    with stall.watch("barrier"):
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        if ctx.comm is not None and ctx.comm.nprocs > 1:
            dist.barrier()


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
    _refresh_placement(ctx)
    return True


# How many one-peer phases the placement search optimizes over jointly;
# longer periods price the static schedule alone (whose edges are every
# phase's).
_PLACEMENT_MAX_DYN_PHASES = 16

# Interconnect models keyed by the knobs and the devices: the model's route
# tables are the expensive part, and one model serves every set_topology.
_placement_model_cache: dict = {}

# Search results keyed by the model's geometry, the schedules' edges and
# the search's knobs, FIFO-bounded: re-installing a seen topology does not
# search again.
_placement_search_cache: "collections.OrderedDict" = collections.OrderedDict()
_PLACEMENT_SEARCH_CACHE_MAX = 64


def _placement_model(devices):
    """The interconnect model of ``devices`` (``ops.placement.
    build_model``), cached (the JAX package's ``basics.py`` L488), or the
    tuner's measured re-pricing of it (``utils.tuner.maybe_measured``;
    with ``BLUEFOG_TPU_TUNE=0`` the static model, bitwise)."""
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.utils import config
    cfg = config.get()
    key = (cfg.fake_torus, cfg.torus_wrap, tuple(map(str, devices)))
    if key not in _placement_model_cache:
        if len(_placement_model_cache) > 8:
            _placement_model_cache.clear()
        _placement_model_cache[key] = PL.build_model(devices)
    base = _placement_model_cache[key]
    if base is None or not cfg.tune:
        return base
    from bluefog_tpu_torch.utils import tuner
    return tuner.maybe_measured(base)


def _placement_search(model, scheds, n, *, iters, block, budget,
                      synth=False, sketch="auto"):
    """Memoized ``(PlacementResult, dispatched max link load, synthesis
    improvement ratio, dispatched provenance)`` of a model and schedule set
    (the JAX package's L508).  With ``synth`` the pricing runs the
    dispatch's packed-vs-synthesized selection, and the key carries the
    synthesis knobs."""
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import schedule_opt as SO
    sig = []
    for s in scheds:
        phs = getattr(s, "phases", None)
        for ph in (phs if phs is not None else (s,)):
            sig.extend(rnd.pairs for rnd in ph.rounds)
    key = (model.name, model.dims, model.wrap_dims, model.device_node,
           tuple(sig), n, iters, block, budget, synth,
           sketch if synth else None)
    hit = _placement_search_cache.get(key)
    if hit is not None:
        _placement_search_cache.move_to_end(key)
        return hit
    result = PL.optimize_placement(model, scheds, n, iters=iters, seed=0,
                                   block=block)
    # What dispatches: the placed, congestion-packed and (with synthesis)
    # selected schedules; these pricing repacks never run.
    dispatched = []
    packed_serial = 0.0
    chosen_serial = 0.0
    static_prov = None
    for s in scheds:
        phs = getattr(s, "phases", None)
        for ph in (phs if phs is not None else (s,)):
            packed = SO.congestion_aware_repack(
                ph, model, result.perm, budget_factor=budget, record=False)
            chosen = packed
            if synth:
                from bluefog_tpu_torch.ops import synthesis as SY
                chosen, _r = SY.select_schedule(
                    ph, packed, model, result.perm, sketch=sketch,
                    budget_factor=budget)
                packed_serial += PL.schedule_cost(
                    model, packed, result.perm).serial_link_time
                chosen_serial += PL.schedule_cost(
                    model, chosen, result.perm).serial_link_time
            if static_prov is None:  # scheds[0] is the static schedule
                static_prov = S.schedule_provenance(chosen)
            dispatched.append(chosen)
    mll = PL.schedule_cost(model, dispatched, result.perm).max_link_load
    ratio = (packed_serial / max(chosen_serial, 1e-12)
             if synth and chosen_serial else None)
    value = (result, mll, ratio, static_prov)
    _placement_search_cache[key] = value
    if len(_placement_search_cache) > _PLACEMENT_SEARCH_CACHE_MAX:
        _placement_search_cache.popitem(last=False)
    return value


def _refresh_placement(ctx: _Context) -> None:
    """Recompute the physical placement of the active topology (the JAX
    package's L574).

    Builds the interconnect model of the world's devices (only under
    ``BLUEFOG_TPU_FAKE_TORUS``: torch devices carry no coordinates) and
    searches the logical-rank -> device permutation minimizing the modeled
    ``(max_link_load, hop_bytes)`` jointly over the static schedule, the
    one-peer phase table and, under ``BLUEFOG_TPU_HIER`` with several
    machines, the hierarchical levels.  The weight matrix is untouched and
    no row moves: the permutation prices the dispatched schedules
    (:func:`_physical_repack`).  ``BLUEFOG_TPU_PLACEMENT=0`` turns it off.
    Deterministic, so every process computes the same permutation; across
    processes a rank is permuted only within its machine block."""
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.utils import config
    cfg = config.get()
    n = ctx.size
    model = perm = result = mll = None
    synth_ratio = dispatch_prov = None
    if cfg.placement and n > 1 and ctx.topology is not None:
        # Every rank's device is a torch device: no torus coordinates.
        model = _placement_model([ctx.device] * n)
    if model is not None:
        scheds = [S.compile_static(
            ctx.topology, use_topo_weights=ctx.is_topo_weighted)]
        try:
            phases = topology_util.dynamic_phase_table(
                ctx.topology, max_phases=_PLACEMENT_MAX_DYN_PHASES)
            scheds.append(S.compile_dynamic(phases, n))
        except ValueError:
            pass  # period too long: the static edge set covers the union
        if cfg.hier and 0 < ctx.local_size < n and n % ctx.local_size == 0:
            # The dense inner level and every outer one-peer phase join the
            # search, each priced against its own links.
            ht = _hier_topology(ctx, cfg)
            if ht.n_slices > 1:
                scheds.append(
                    S._schedule_from_matrix(ht.inner_full_matrix()))
                scheds.extend(
                    S._schedule_from_matrix(ht.outer_full_matrix(p))
                    for p in range(len(ht.outer_phases)))
        block = ctx.local_size if 0 < ctx.local_size < n else None
        result, mll, synth_ratio, dispatch_prov = _placement_search(
            model, scheds, n, iters=cfg.placement_iters, block=block,
            budget=cfg.placement_round_budget,
            synth=cfg.schedule_synth, sketch=cfg.schedule_synth_sketch)
        if not result.is_identity:
            perm = result.perm
    ctx.placement_model = model
    ctx.placement = perm
    ctx.placement_result = result
    ctx.synthesis_ratio = synth_ratio
    ctx.synthesis_provenance = dispatch_prov
    ctx._placement_state = (model, perm)
    ctx.placement_generation += 1
    ctx._schedules.clear()
    PL.set_active(model, perm)
    from bluefog_tpu_torch.ops import synthesis as SY
    if result is not None:
        telemetry.set_gauge("bf_placement_improvement_ratio",
                            result.improvement_ratio)
        telemetry.set_gauge("bf_schedule_max_link_load", mll)
    else:
        # No model: a stale value of an earlier topology would misreport.
        telemetry.clear_gauge("bf_placement_improvement_ratio")
        telemetry.clear_gauge("bf_schedule_max_link_load")
    if synth_ratio is not None:
        telemetry.set_gauge("bf_schedule_synth_improvement_ratio",
                            synth_ratio)
        SY._publish_provenance(dispatch_prov)
    else:
        telemetry.clear_gauge("bf_schedule_synth_improvement_ratio")
        SY._publish_provenance(None)


def _sched_path_tag(cfg) -> tuple:
    """The physical passes' knobs, folded into every dispatched schedule's
    cache key: a knob changed mid-process (``config.reload()``) misses the
    cache instead of serving the other path's schedule."""
    return (cfg.schedule_synth, cfg.schedule_synth_sketch,
            cfg.placement_round_budget)


def _physical_repack(sched, _state=None, _cfg=None):
    """The dispatch's physical pipeline (the JAX package's L685): the
    congestion-aware repack, then (``BLUEFOG_TPU_SCHEDULE_SYNTH``) the
    synthesized candidate when it strictly beats the packed one on modeled
    ``serial_link_time``.  A no-op without a model;
    ``BLUEFOG_TPU_PLACEMENT_ROUND_BUDGET=0`` turns both off.  ``_state``
    is the ``(model, perm)`` snapshot and ``_cfg`` the config snapshot the
    caller keyed its cache with."""
    from bluefog_tpu_torch.utils import config
    model, perm = _ctx._placement_state if _state is None else _state
    if model is None:
        return sched
    from bluefog_tpu_torch.ops import schedule_opt as SO
    from bluefog_tpu_torch.ops import synthesis as SY
    cfg = config.get() if _cfg is None else _cfg
    packed = SO.congestion_aware_repack(
        sched, model, perm, budget_factor=cfg.placement_round_budget)
    if not cfg.schedule_synth:
        # Switched off mid-process: synthesis_info() and the gauges stop
        # claiming it.
        if _ctx.synthesis_ratio is not None:
            _ctx.synthesis_ratio = None
            _ctx.synthesis_provenance = None
            telemetry.clear_gauge("bf_schedule_synth_improvement_ratio")
            SY._publish_provenance(None)
        return packed
    # Switched on after a refresh that ran without it: publish from this
    # selection.
    publish = _ctx.synthesis_ratio is None
    chosen, ratio = SY.select_schedule(
        sched, packed, model, perm, sketch=cfg.schedule_synth_sketch,
        budget_factor=cfg.placement_round_budget, record=publish)
    if publish:
        _ctx.synthesis_ratio = ratio
        _ctx.synthesis_provenance = S.schedule_provenance(chosen)
    return chosen


def _physical_repack_dynamic(dyn, _cfg=None):
    state = _ctx._placement_state
    if state[0] is None:
        return dyn
    return S.DynamicSchedule(
        n=dyn.n, phases=tuple(_physical_repack(ph, state, _cfg)
                              for ph in dyn.phases))


def placement_info() -> Optional[dict]:
    """The active physical placement (None without an interconnect
    model): the model's name, whether the permutation is the identity, and
    the modeled link costs of the identity and of the chosen placement."""
    ctx = _require_init()
    res = ctx.placement_result
    if res is None:
        return None
    return {
        "model": res.model_name,
        "identity": bool(res.is_identity),
        "max_link_load_naive": res.identity_cost.max_link_load,
        "max_link_load_opt": res.optimized_cost.max_link_load,
        "hop_bytes_naive": res.identity_cost.hop_bytes,
        "hop_bytes_opt": res.optimized_cost.hop_bytes,
        "improvement_ratio": res.improvement_ratio,
    }


def synthesis_info() -> Optional[dict]:
    """The schedule synthesis of the active topology (None when it is off
    or there is no model): the sketch knob, the provenance of the static
    schedule that dispatches, and the packed -> chosen modeled serial-time
    improvement."""
    from bluefog_tpu_torch.utils import config
    ctx = _require_init()
    cfg = config.get()
    if not cfg.schedule_synth or ctx.synthesis_ratio is None:
        return None
    return {
        "sketch": cfg.schedule_synth_sketch,
        "provenance": ctx.synthesis_provenance,
        "improvement_ratio": round(float(ctx.synthesis_ratio), 6),
    }


def membership_info() -> Optional[dict]:
    """The churn controller's committed view: epoch, active ranks, live
    suspicion, eviction (None when ``BLUEFOG_TPU_CHURN`` is off or no
    supervisor runs); the ``/healthz`` "membership" block."""
    from bluefog_tpu_torch.ops import membership
    return membership.health_summary()


def gang_info() -> Optional[dict]:
    """The gang directory (``ops/gang.py``): committed epoch, active
    processes, vacant ranks, grants (None when
    ``BLUEFOG_TPU_ELASTIC_JOIN`` is off or no gang service is installed);
    the ``/healthz`` "gang_directory" block."""
    from bluefog_tpu_torch.ops import gang
    return gang.health_summary()


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


def in_neighbor_ranks(rank_: Optional[int] = None) -> List[int]:
    """The in-neighbors of ``rank_`` (default :func:`rank`) in the
    topology that is set."""
    r = rank() if rank_ is None else rank_
    return topology_util.in_neighbor_ranks(load_topology(), r)


def out_neighbor_ranks(rank_: Optional[int] = None) -> List[int]:
    r = rank() if rank_ is None else rank_
    return topology_util.out_neighbor_ranks(load_topology(), r)


def in_neighbor_machine_ranks(rank_: Optional[int] = None) -> List[int]:
    """The in-neighbors of machine ``rank_`` (default
    :func:`machine_rank`) in the machine topology."""
    r = machine_rank() if rank_ is None else rank_
    return topology_util.in_neighbor_ranks(load_machine_topology(), r)


def out_neighbor_machine_ranks(rank_: Optional[int] = None) -> List[int]:
    r = machine_rank() if rank_ is None else rank_
    return topology_util.out_neighbor_ranks(load_machine_topology(), r)


def static_schedule() -> S.StaticSchedule:
    """The active topology's logical schedule (the optimizers'; the eager
    ops dispatch :func:`_dispatch_static`)."""
    ctx = _require_init()
    return ctx.schedule(("static", ctx.is_topo_weighted), lambda: S.compile_static(
        ctx.topology, use_topo_weights=ctx.is_topo_weighted))


def dynamic_schedule(phases=None) -> S.DynamicSchedule:
    """Compiled one-peer walk: ``phases`` or the active topology's table
    (logical, as :func:`static_schedule`)."""
    ctx = _require_init()
    if phases is None:
        return ctx.schedule(("dynamic",), lambda: S.compile_dynamic(
            topology_util.dynamic_phase_table(ctx.topology), ctx.size))
    return ctx.schedule(
        ("dynphases", tuple(ph.send_to for ph in phases)),
        lambda: S.compile_dynamic(phases, ctx.size))


def _static_keyed(w: Optional[np.ndarray] = None) -> tuple:
    """``(schedule, key)`` of the eager static ops (the JAX package's
    ``_nbr_schedule``): the active topology's schedule, or ``w``'s, through
    the physical pipeline, cached under the pipeline's knobs and the
    placement generation; ``key`` is the JAX package's content key."""
    from bluefog_tpu_torch.utils import config
    ctx = _require_init()
    cfg = config.get()
    tag, gen = _sched_path_tag(cfg), ctx.placement_generation
    if w is not None:
        key = ("static_override", w.tobytes(), tag, gen)
        return ctx.schedule(key, lambda: _physical_repack(S.compile_static(
            ctx.topology, src_weights=w), _cfg=cfg)), key
    key = ("static", ctx.topology_version, ctx.is_topo_weighted, tag, gen)
    return ctx.schedule(
        ("static_dispatch", ctx.is_topo_weighted, tag, gen),
        lambda: _physical_repack(S.compile_static(
            ctx.topology, use_topo_weights=ctx.is_topo_weighted),
            _cfg=cfg)), key


def _dispatch_static(w: Optional[np.ndarray] = None) -> S.StaticSchedule:
    """The schedule the eager static ops dispatch (:func:`_static_keyed`)."""
    return _static_keyed(w)[0]


def _dynamic_keyed(phases=None) -> tuple:
    """``(schedule, key)`` of the one-peer walk the eager dynamic op
    dispatches, through the physical pipeline (as :func:`_static_keyed`)."""
    from bluefog_tpu_torch.utils import config
    ctx = _require_init()
    cfg = config.get()
    tag, gen = _sched_path_tag(cfg), ctx.placement_generation
    key = (("dynamic", ctx.topology_version, tag, gen) if phases is None
           else ("dynphases", tuple(ph.send_to for ph in phases), tag, gen))
    return ctx.schedule(key, lambda: _physical_repack_dynamic(
        dynamic_schedule(phases), _cfg=cfg)), key


def _dispatch_dynamic(phases=None) -> S.DynamicSchedule:
    """The walk the eager dynamic op dispatches (:func:`_dynamic_keyed`)."""
    return _dynamic_keyed(phases)[0]


def _record_dispatch(op: str, x, sched=None) -> None:
    """A call's comm counters (the JAX package's L959): calls, the element
    bytes of the rank-major input and, from the schedule, rounds, edges and
    estimated wire bytes (``collective.schedule_wire_stats``; a dynamic
    schedule's per-call average)."""
    if not telemetry.enabled():
        return
    nbytes = x.numel() * x.element_size()
    telemetry.record_comm_traffic(
        op, nbytes, size=size(),
        sched_stats=None if sched is None else C.schedule_wire_stats(sched))


def _dispatch(key: tuple, x: torch.Tensor, sched, launch) -> Pending:
    """One eager op's launch, recorded: its counters, the dispatch-cache
    counter of ``key`` (the JAX package's jit-cache key: an op's first
    dispatch with its schedule or arguments misses), the
    ``bf_comm_dispatch_seconds`` histogram and an ``ENQUEUE`` span around
    ``launch()``, which returns the op's :class:`Pending`."""
    op = str(key[0])
    _record_dispatch(op, x, sched)
    t0 = telemetry.start_timer()
    with op_span(op, "ENQUEUE"):
        if telemetry.enabled():
            ctx = _ctx
            if key in ctx._dispatched:
                telemetry.inc("bf_dispatch_cache_hits_total")
            else:
                ctx._dispatched.add(key)
                telemetry.inc("bf_dispatch_cache_misses_total")
        pending = launch()
    telemetry.observe_since(t0, "bf_comm_dispatch_seconds", op=op)
    return pending


def _complete(pending):
    """Wait for an op's works (the JAX package's ``synchronize``, L1649):
    under the stall watchdog, in a ``synchronize``/``COMMUNICATE`` span,
    timed into ``bf_comm_sync_seconds``.  In one process the result is
    queued on the device's stream already, and this does not wait for the
    device."""
    t0 = telemetry.start_timer()
    with stall.watch("collective synchronize"), \
            op_span("synchronize", "COMMUNICATE"):
        out = pending.wait()
    telemetry.observe_since(t0, "bf_comm_sync_seconds")
    return out


def _rank_major(x) -> torch.Tensor:
    ctx = _require_active()
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
    """The handle's result, once the op is done (:func:`synchronize`)."""
    return synchronize(handle)


def synchronize(handle: Handle):
    """The handle's result, once the op is done, waited under the stall
    watchdog in a ``synchronize``/``COMMUNICATE`` span."""
    return _complete(handle)


def _allreduce(x, average: bool, in_place: bool) -> Pending:
    x = _rank_major(x)
    fn = C.allreduce_ if in_place else C.allreduce
    return _dispatch(("allreduce", average), x, None, lambda: fn(
        x, average=average, comm=_ctx.comm, async_op=True))


def allreduce_nonblocking(x, *, average: bool = True) -> Handle:
    return Handle(_allreduce(x, average, False))


def allreduce(x, *, average: bool = True) -> torch.Tensor:
    """Every rank gets the rank mean (or with ``average=False`` the sum)."""
    return _complete(_allreduce(x, average, False))


def allreduce_(x, *, average: bool = True) -> torch.Tensor:
    """:func:`allreduce` written into ``x``, which is returned (the
    reference's in-place op; the same bits as the out-of-place one)."""
    return _complete(_allreduce(x, average, True))


def allreduce_nonblocking_(x, *, average: bool = True) -> Handle:
    return Handle(_allreduce(x, average, True))


def _local_allreduce(x, average: bool) -> Pending:
    x = _rank_major(x)
    return _dispatch(("local_allreduce", average), x, None,
                     lambda: C.local_allreduce(x, local_size(),
                                               average=average,
                                               comm=_ctx.comm, async_op=True))


def local_allreduce_nonblocking(x, *, average: bool = True) -> Handle:
    return Handle(_local_allreduce(x, average))


def local_allreduce(x, *, average: bool = True) -> torch.Tensor:
    """:func:`allreduce` within each machine's ``local_size()`` ranks."""
    return _complete(_local_allreduce(x, average))


def _broadcast(x, root_rank: int, in_place: bool) -> Pending:
    x = _rank_major(x)
    fn = C.broadcast_ if in_place else C.broadcast
    return _dispatch(("broadcast", root_rank), x, None, lambda: fn(
        x, root_rank, comm=_ctx.comm, async_op=True))


def broadcast_nonblocking(x, root_rank: int) -> Handle:
    return Handle(_broadcast(x, root_rank, False))


def broadcast(x, root_rank: int) -> torch.Tensor:
    """Every rank gets ``root_rank``'s value."""
    return _complete(_broadcast(x, root_rank, False))


def broadcast_(x, root_rank: int) -> torch.Tensor:
    """:func:`broadcast` written into ``x``, which is returned."""
    return _complete(_broadcast(x, root_rank, True))


def broadcast_nonblocking_(x, root_rank: int) -> Handle:
    return Handle(_broadcast(x, root_rank, True))


def _allgather(x) -> Pending:
    x = _rank_major(x)
    return _dispatch(("allgather",), x, None, lambda: C.allgather(
        x, comm=_ctx.comm, async_op=True))


def allgather_nonblocking(x) -> Handle:
    return Handle(_allgather(x))


def allgather(x) -> torch.Tensor:
    """Every rank receives the concatenation of all ranks' tensors along
    the leading (per-rank) axis; output shape ``(size, size*d0, ...)``."""
    return _complete(_allgather(x))


def _ragged_pack(tensors):
    """Validate a per-rank list of tensors (one an owned rank) that may
    differ in their first dim only, and pad it into a rank-major ``(m,
    max_d, *trailing)`` tensor, ``max_d`` the world's longest; returns it
    with every rank's length."""
    ctx = _require_active()
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
    key = ("allgather_v", lengths, tuple(padded.shape), str(padded.dtype))
    rows = _complete(_dispatch(key, padded, None, lambda: (
        Pending.done(padded) if _ctx.comm is None
        else _ctx.comm.all_gather(padded))))
    whole = torch.cat([rows[i, :d] for i, d in enumerate(lengths)])
    return whole.expand((padded.shape[0],) + whole.shape).clone()


def _neighbor_allreduce(x, w) -> Pending:
    x = _rank_major(x)
    sched, skey = _static_keyed(w)
    return _dispatch(("neighbor_allreduce", skey), x, sched, lambda:
                     C.neighbor_allreduce(x, sched, comm=_ctx.comm,
                                          async_op=True))


def neighbor_allreduce_nonblocking(x, *, self_weight=None, src_weights=None,
                                   dst_weights=None) -> Handle:
    w = _weight_override_matrix(self_weight, src_weights, dst_weights)
    return Handle(_neighbor_allreduce(x, w))


def neighbor_allreduce(x, *, self_weight=None, src_weights=None,
                       dst_weights=None) -> torch.Tensor:
    """Weighted neighbor averaging over the active topology; the weight
    arguments override its weights (:func:`_weight_override_matrix`)."""
    w = _weight_override_matrix(self_weight, src_weights, dst_weights)
    return _complete(_neighbor_allreduce(x, w))


def _dynamic_neighbor_allreduce(x, step: int, phases) -> Pending:
    x = _rank_major(x)
    sched, key = _dynamic_keyed(phases)
    return _dispatch(("dynamic_neighbor_allreduce", key), x, sched, lambda:
                     C.dynamic_neighbor_allreduce(x, step, sched,
                                                  comm=_ctx.comm,
                                                  async_op=True))


def dynamic_neighbor_allreduce_nonblocking(x, step: int, *,
                                           phases=None) -> Handle:
    return Handle(_dynamic_neighbor_allreduce(x, step, phases))


def dynamic_neighbor_allreduce(x, step: int, *, phases=None) -> torch.Tensor:
    """Neighbor averaging with the one-peer dynamic walk at ``step``;
    ``phases`` defaults to the phase table of the active topology."""
    return _complete(_dynamic_neighbor_allreduce(x, step, phases))


def _neighbor_allgather(x) -> Pending:
    x = _rank_major(x)
    sched, skey = _static_keyed()
    return _dispatch(("neighbor_allgather", skey), x, sched, lambda:
                     C.neighbor_allgather(x, sched, comm=_ctx.comm,
                                          async_op=True))


def neighbor_allgather_nonblocking(x) -> Handle:
    return Handle(_neighbor_allgather(x))


def neighbor_allgather(x) -> torch.Tensor:
    """Gather in-neighbor tensors: output ``(size, max_indegree, ...)`` in
    ascending-src order with zero padding for irregular indegree."""
    return _complete(_neighbor_allgather(x))


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
    key = ("gossip", tuple(tgt), self_weight, target_weight)
    return _require_init().schedule(
        key, lambda: S.compile_pair_gossip(tgt, n, self_weight=self_weight,
                                           target_weight=target_weight)), key


def _pair_gossip(x, target_ranks, self_weight, target_weight) -> Pending:
    x = _rank_major(x)
    sched, key = _pair_schedule(target_ranks, self_weight, target_weight)
    return _dispatch(("pair_gossip", key), x, sched, lambda: C.pair_gossip(
        x, sched, comm=_ctx.comm, async_op=True))


def pair_gossip_nonblocking(x, target_ranks, *, self_weight: float = 0.5,
                            target_weight: float = 0.5) -> Handle:
    return Handle(_pair_gossip(x, target_ranks, self_weight, target_weight))


def pair_gossip(x, target_ranks, *, self_weight: float = 0.5,
                target_weight: float = 0.5) -> torch.Tensor:
    """Pairwise exchange and average.  ``target_ranks``: a list (or dict)
    giving each rank its partner, -1 (or missing) to sit out; it must be
    mutual."""
    return _complete(_pair_gossip(x, target_ranks, self_weight,
                                  target_weight))


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


def allreduce_parameters(params, *, average: bool = True):
    """The rank mean (or sum) of every rank-major tensor in ``params``, in
    the same structure (the JAX package's ``basics.py`` L1691)."""
    if isinstance(params, dict):
        return type(params)(
            (k, allreduce_parameters(v, average=average))
            for k, v in params.items())
    if isinstance(params, (list, tuple)):
        return type(params)(allreduce_parameters(v, average=average)
                            for v in params)
    return allreduce(params, average=average)


def broadcast_optimizer_state(state, root_rank: int = 0):
    """``root_rank``'s row of every rank-major tensor of an optimizer
    state (a ``state_dict()``-like tree of dicts, lists and tuples); 0-d
    tensors and other leaves (step counts, hyperparameters) pass through,
    as in the JAX package (L1696)."""
    if isinstance(state, dict):
        return type(state)((k, broadcast_optimizer_state(v, root_rank))
                           for k, v in state.items())
    if isinstance(state, (list, tuple)):
        return type(state)(broadcast_optimizer_state(v, root_rank)
                           for v in state)
    if not isinstance(state, torch.Tensor) or state.dim() == 0:
        return state
    return broadcast(state, root_rank)


# ---------------------------------------------------------------------------
# The reference's capability shims (the JAX package's L1731-1755)
# ---------------------------------------------------------------------------

def set_skip_negotiate_stage(value: bool) -> None:
    """A no-op: there is no negotiation stage to skip."""


def get_skip_negotiate_stage() -> bool:
    return True


def mpi_threads_supported() -> bool:
    """True: there is no MPI, and the ops may be called from any thread."""
    return True


def nccl_built() -> bool:
    """Whether torch has NCCL (``torch.distributed.is_nccl_available()``);
    the JAX package, which has no NCCL, answers False."""
    return bool(dist.is_available() and dist.is_nccl_available())


def unified_mpi_window_model_supported() -> bool:
    """True: the window store has one memory model."""
    return True


# ---------------------------------------------------------------------------
# Hierarchical family: machines of local_size() consecutive ranks
# ---------------------------------------------------------------------------

def _require_machine_topology() -> _Context:
    ctx = _require_init()
    if ctx.machine_topology is None:
        raise RuntimeError(
            "set_machine_topology() required for hierarchical ops")
    return ctx


def _hierarchical_neighbor_allreduce(x, self_weight,
                                     src_machine_weights) -> Pending:
    ctx = _require_machine_topology()
    x = _rank_major(x)
    key = ("hier", ctx.machine_topology_version,
           ctx.is_machine_topo_weighted, self_weight,
           None if src_machine_weights is None
           else np.asarray(src_machine_weights, dtype=float).tobytes())
    sched = ctx.schedule(key, lambda: S.compile_static(
        ctx.machine_topology, use_topo_weights=ctx.is_machine_topo_weighted,
        self_weight=self_weight, src_weights=src_machine_weights))
    return _dispatch(("hierarchical_neighbor_allreduce", key), x, sched,
                     lambda: C.hierarchical_neighbor_allreduce(
                         x, sched, ctx.local_size, comm=ctx.comm,
                         async_op=True))


def hierarchical_neighbor_allreduce_nonblocking(
        x, *, self_weight=None, src_machine_weights=None) -> Handle:
    return Handle(_hierarchical_neighbor_allreduce(x, self_weight,
                                                   src_machine_weights))


def hierarchical_neighbor_allreduce(x, *, self_weight=None,
                                    src_machine_weights=None) -> torch.Tensor:
    """Machine-level neighbor averaging: each machine's local sum, the
    neighbor combine of the sums over the machine topology (its weights,
    or ``self_weight`` and the ``(machines, machines)``
    ``src_machine_weights``), then the division by ``local_size()``."""
    return _complete(_hierarchical_neighbor_allreduce(x, self_weight,
                                                      src_machine_weights))


def _dynamic_hierarchical_neighbor_allreduce(x, step: int,
                                             phases) -> Pending:
    ctx = _require_machine_topology()
    x = _rank_major(x)
    m = machine_size()
    if phases is None:
        key = ("dynhier", ctx.machine_topology_version)
        sched = ctx.schedule(key, lambda: S.compile_dynamic(
            topology_util.dynamic_phase_table(ctx.machine_topology), m))
    else:
        key = ("dynhierphases", tuple(ph.send_to for ph in phases))
        sched = ctx.schedule(key, lambda: S.compile_dynamic(phases, m))
    return _dispatch(("dynamic_hierarchical_neighbor_allreduce", key), x,
                     sched, lambda: C.dynamic_hierarchical_neighbor_allreduce(
                         x, step, sched, ctx.local_size, comm=ctx.comm,
                         async_op=True))


def dynamic_hierarchical_neighbor_allreduce_nonblocking(
        x, step: int, *, phases=None) -> Handle:
    """Hierarchical averaging with a per-step machine-level topology;
    ``phases`` defaults to the one-peer walk of the machine topology (the
    analogue of driving ``GetExp2DynamicSendRecvMachineRanks`` by hand)."""
    return Handle(_dynamic_hierarchical_neighbor_allreduce(x, step, phases))


def dynamic_hierarchical_neighbor_allreduce(x, step: int, *,
                                            phases=None) -> torch.Tensor:
    return _complete(_dynamic_hierarchical_neighbor_allreduce(x, step,
                                                              phases))


def _hier_topology(ctx: _Context, cfg):
    """The :class:`topology.HierarchicalTopology` of the
    ``BLUEFOG_TPU_HIER_*`` knobs (``cfg``) over the machines (slices =
    machines), cached until the knobs or the world change."""
    n_slices = ctx.size // ctx.local_size
    # The outer cadence under the tuner's override (empty with
    # BLUEFOG_TPU_TUNE=0); the adapted value rides the key, so an epoch
    # rebuilds.
    from bluefog_tpu_torch.utils import tuner
    outer_every = tuner.override_int("hier_outer_every",
                                     cfg.hier_outer_every)
    key = (ctx.size, n_slices, cfg.hier_inner, cfg.hier_outer,
           outer_every, cfg.hier_outer_self_weight)
    if ctx._hier_key != key:
        ctx.hier_topology = topology_util.hierarchical_two_level(
            ctx.size, n_slices, inner=cfg.hier_inner, outer=cfg.hier_outer,
            outer_every=outer_every,
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
                           if comp.startswith("sparse") else None),
            "ht": ht, "sig": sig}


def _record_hier_levels(ht, step: int, nbytes: float, inner_edges: int,
                        compression: str) -> None:
    """One hierarchical gossip step's wire bytes by level (the JAX
    package's L1496): the inner level's dense edges every step
    (``level="ici"``), the outer one-peer exchange on outer steps scaled by
    its codec (``level="dcn"``), and the outer-step counter.  Shared by the
    eager op and the optimizers."""
    from bluefog_tpu_torch.utils import config
    if not telemetry.enabled():
        return
    row_bytes = float(nbytes) / max(ht.n, 1)
    telemetry.inc("bf_comm_level_bytes_total", row_bytes * inner_edges,
                  level="ici")
    if ht.n_slices > 1 and ht.is_outer_step(int(step)):
        telemetry.inc("bf_comm_level_bytes_total",
                      row_bytes * ht.dcn_edges_per_outer_step()
                      * config.compression_byte_factor(compression),
                      level="dcn")
        telemetry.inc("bf_hier_outer_steps_total")


def _hierarchical_gossip(x, step: int, ht) -> Pending:
    plan = _hier_plan("hierarchical_gossip", ht)
    x = _rank_major(x)
    ht, sig = plan.pop("ht"), plan.pop("sig")
    inner, outer = plan.pop("inner_sched"), plan.pop("outer_scheds")
    # Calls and bytes land through _dispatch; the split by level here.
    _record_hier_levels(ht, step, x.numel() * x.element_size(),
                        ht.ici_edges_per_step(), plan["outer_compression"])
    return _dispatch(("hierarchical_gossip", sig), x, None, lambda:
                     Pending.done(C.hierarchical_gossip(
                         x, step, inner, outer, _ctx.local_size,
                         comm=_ctx.comm, **plan)))


def hierarchical_gossip_nonblocking(x, step: int, *, ht=None) -> Handle:
    """Two-level gossip step: the dense inner combine within each machine
    every step, the one-peer exchange between machines every
    ``BLUEFOG_TPU_HIER_OUTER_EVERY`` steps with its own codec
    (``BLUEFOG_TPU_HIER_OUTER_COMPRESSION``).  Requires
    ``BLUEFOG_TPU_HIER=1`` and more than one machine; ``ht`` overrides the
    knobs' :class:`~bluefog_tpu_torch.topology.HierarchicalTopology`."""
    return Handle(_hierarchical_gossip(x, step, ht))


def hierarchical_gossip(x, step: int, *, ht=None) -> torch.Tensor:
    return _complete(_hierarchical_gossip(x, step, ht))


def hierarchical_gossip_info() -> Optional[dict]:
    """The two-level gossip policy in force (None when
    ``BLUEFOG_TPU_HIER`` is off or there is one machine): the levels'
    topologies, the outer cadence, self weight and codec, and each level's
    modeled rows on the wire a step."""
    from bluefog_tpu_torch.utils import config
    ctx = _require_init()
    cfg = config.get()
    if not cfg.hier or ctx.local_size >= ctx.size:
        return None
    ht = _hier_topology(ctx, cfg)
    comp = cfg.hier_outer_compression
    outer_rows = (ht.dcn_edges_per_outer_step()
                  * config.compression_byte_factor(comp)
                  / max(ht.outer_every, 1))
    return {
        "levels": 2,
        "n_slices": ht.n_slices,
        "slice_size": ht.slice_size,
        "inner": ht.inner_kind,
        "outer": ht.outer_kind,
        "outer_every": ht.outer_every,
        "outer_self_weight": ht.outer_self_weight,
        "outer_compression": comp,
        "ici_rows_per_step": ht.ici_edges_per_step(),
        "dcn_rows_per_step": round(outer_rows, 3),
    }
