"""Distributed optimizer classes — the ``Distributed*Optimizer`` surface.

The port of ``bluefog_tpu/optim/optimizers.py``: the parameter-consensus
orders and gradient allreduce.  Where the JAX package wraps an
``optax.GradientTransformation`` and returns new parameters and state,
these wrap a ``torch.optim.Optimizer`` whose parameters are rank-major
(leading dim: the ranks this process owns, ``len(owned_ranks())``, which is
``size()`` in one process), and ``step()`` updates them in place: the base
optimizer owns its state, so there is no separate ``init``.  ``torch.optim.SGD(lr, momentum, dampening=0)`` computes
what ``optax.sgd(lr, momentum)`` does.

Usage::

    rep = RankReplicas(make_model, bf.size(), bf.device(), init=...)
    opt = DistributedAdaptThenCombineOptimizer(
        torch.optim.SGD([rep.flat], lr=0.05), use_dynamic_topology=True)
    ...  # per-rank forward/backward into rep.flat.grad
    opt.step()

The step counter starts at 0 and advances after each combine; the dynamic
phase is ``step % period``.  ``step(self_weight=, src_weights=,
dst_weights=)`` overrides the topology's weights for one step
(``basics._weight_override_matrix``).

Observability (``utils/telemetry``, ``utils/profiler``): each combine
is an ``ENQUEUE`` span (the combiner and its schedules) and a
``COMMUNICATE`` span (the rounds), and its traffic is counted as the eager
op's would be (calls, bytes, the schedule's rounds and edges; the
hierarchical and sharded level bytes), from shapes and schedules only.
The JAX package's step is one jitted program and counts none of this per
step (its ``bench.py`` accounts a whole run at once).  ``step()`` times
itself into ``bf_optimizer_step_seconds{family="collective"}``; with
``profile_every=N`` (or ``BLUEFOG_TPU_PROFILE=1``) every Nth step waits
for the device (``torch.cuda.synchronize``, on that step only) and records
a synced sample and a straggler gather; the consensus-distance gauge
samples every ``BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY`` steps, only when
that variable is set (it costs a combine), on the device, with ``n``
floats read back.

Sharded gossip (``shard_specs``, ``ops/sharded.py``): the leaves whose spec
names an axis gossip each rank's own slice inside its replica group, over
the merged group schedule, while the replicated leaves ride the whole
topology; ``BLUEFOG_TPU_SHARDED_GOSSIP=0`` restores the replicated path bit
for bit.  The leaves of a single flat parameter are ``leaf_shapes``
(``RankReplicas.leaf_shapes``) and the specs a list in that order
(``models.convert.jax_leaf_specs`` takes the JAX package's spec tree onto
it); otherwise each parameter tensor is a leaf.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch

from bluefog_tpu_torch import basics
from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.ops import schedule as S
from bluefog_tpu_torch.ops import sharded as SH
from bluefog_tpu_torch.optim import functional as F
from bluefog_tpu_torch.optim.functional import CommunicationType
from bluefog_tpu_torch.utils import profiler, telemetry
from bluefog_tpu_torch.utils.timeline import op_span

__all__ = ["CommunicationType", "DistributedOptimizer",
           "DistributedGradientAllreduceOptimizer",
           "DistributedAllreduceOptimizer",
           "DistributedNeighborAllreduceOptimizer",
           "DistributedAdaptWithCombineOptimizer",
           "DistributedAdaptThenCombineOptimizer",
           "DistributedHierarchicalNeighborAllreduceOptimizer",
           "DistributedHierarchicalGossipOptimizer"]


class DistributedOptimizer:
    """Decentralized optimizer wrapper.

    Parameters
    ----------
    base : torch.optim.Optimizer over rank-major parameters.
    communication_type : CommunicationType.  The hierarchical types
        combine over machines of ``local_size()`` ranks:
        ``hierarchical_neighbor_allreduce`` over the machine topology
        (``use_dynamic_topology``: its one-peer walk, or ``phases`` over
        the machines), ``hierarchical_gossip`` over the
        ``BLUEFOG_TPU_HIER_*`` two-level topology.
    order : "awc" | "atc" | "gradient_allreduce" (the gradients averaged
        over the ranks before the base step; ``communication_type`` is
        then not used).
    num_steps_per_communication : communicate every J-th step.
    use_dynamic_topology : cycle the one-peer phase table of the active
        topology (or ``phases`` if given) by step index.
    phases : explicit list of ``topology.DynamicPhase`` for dynamic mode.
    fusion : combine all parameters as one flat buffer.
    fusion_buckets : split that buffer into this many byte-balanced runs
        of whole leaves, each combined on its own (None: one).
    leaf_sizes : the columns of each leaf of a single flat parameter
        (``RankReplicas.leaf_sizes``), for ``fusion_buckets``; default,
        each parameter tensor is a leaf.
    compression : ``"none"``, ``"bf16"`` or ``"sparse:<frac>"``: the
        combine's payload compressed (``functional.compress_combiner``),
        with the difference residual except under ``allreduce`` and
        gradient allreduce.
    shard_specs : one *model*-dimension spec a leaf, in the leaves' order
        (the JAX package's form: ``None``/``P()`` or a tuple of axis
        names), that arms sharded gossip.  Requires
        ``neighbor_allreduce`` with an awc/atc order.  ``None`` (default):
        the replicated path, bit for bit.
    shard_groups : explicit replica groups partitioning ``range(n)``;
        default ``num_shards`` contiguous blocks.
    num_shards : shard count along each sharded model dim.
    leaf_shapes : the per-rank shape of each leaf of a single flat
        parameter (``RankReplicas.leaf_shapes``); sets ``leaf_sizes``.
    profile_every : every this many steps, a synced step sample and a
        straggler gather (None: ``BLUEFOG_TPU_PROFILE`` and
        ``BLUEFOG_TPU_PROFILE_EVERY`` decide).
    """

    def __init__(self, base: torch.optim.Optimizer,
                 communication_type: CommunicationType =
                 CommunicationType.neighbor_allreduce,
                 *, order: str = "awc", num_steps_per_communication: int = 1,
                 use_dynamic_topology: bool = False, phases=None,
                 fusion: bool = True, fusion_buckets: Optional[int] = None,
                 leaf_sizes: Optional[Sequence[int]] = None,
                 compression: str = "none", shard_specs=None,
                 shard_groups=None, num_shards: Optional[int] = None,
                 leaf_shapes: Optional[Sequence[Sequence[int]]] = None,
                 profile_every: Optional[int] = None):
        if isinstance(communication_type, str):
            communication_type = CommunicationType(communication_type)
        if compression not in ("none", "bf16") and not (
                isinstance(compression, str)
                and compression.startswith(("sparse", "topk"))):
            raise ValueError(f"unknown compression {compression!r}; "
                             "expected 'none', 'bf16' or 'sparse:<frac>'")
        if order not in ("awc", "atc", "gradient_allreduce"):
            raise ValueError(f"unknown execution order {order!r}")
        if int(num_steps_per_communication) < 1:
            raise ValueError("num_steps_per_communication must be >= 1")
        if fusion_buckets is not None and int(fusion_buckets) < 1:
            raise ValueError(f"fusion_buckets must be >= 1, got {fusion_buckets}")
        self.base = base
        self.communication_type = communication_type
        self.order = order
        self.num_steps_per_communication = int(num_steps_per_communication)
        self.use_dynamic_topology = use_dynamic_topology
        self.phases = phases
        self.fusion = fusion
        self.fusion_buckets = (None if fusion_buckets is None
                               else int(fusion_buckets))
        if shard_specs is not None:
            if communication_type != CommunicationType.neighbor_allreduce:
                raise ValueError(
                    "shard_specs requires CommunicationType."
                    "neighbor_allreduce (sharded leaves gossip per replica "
                    f"group over the compiled schedule), got "
                    f"{communication_type}")
            if order not in ("awc", "atc"):
                raise ValueError(
                    "shard_specs requires a parameter-consensus order "
                    f"(awc/atc), got {order!r}")
        self.leaf_shapes = (None if leaf_shapes is None
                            else [tuple(int(d) for d in s)
                                  for s in leaf_shapes])
        if leaf_sizes is None and self.leaf_shapes is not None:
            leaf_sizes = [math.prod(s) for s in self.leaf_shapes]
        self.leaf_sizes = None if leaf_sizes is None else list(leaf_sizes)
        self.compression = compression
        self.shard_specs = shard_specs
        self.shard_groups = shard_groups
        self.num_shards = None if num_shards is None else int(num_shards)
        self._shard_plan_cache = {}   # (shapes, dtypes) -> ShardPlan
        self.step_count = 0
        self._acc = None   # gradient allreduce's J-step accumulator
        self.profile_every = profile_every
        self._steps_seen = 0          # step() calls: the sampling periods
        self._shard_meta_cache = {}   # level edge counts per plan/topology

    @property
    def params(self):
        return [p for group in self.base.param_groups for p in group["params"]]

    def _schedules(self):
        """``(static schedule, dynamic schedule)``, one of them None: over
        the ranks, or for ``hierarchical_neighbor_allreduce`` over the
        machines (``bluefog_tpu/optim/optimizers.py`` L184-207)."""
        if self.communication_type != \
                CommunicationType.hierarchical_neighbor_allreduce:
            if self.use_dynamic_topology:
                return None, basics.dynamic_schedule(self.phases)
            return basics.static_schedule(), None
        ctx = basics._require_machine_topology()
        topo, m = ctx.machine_topology, basics.machine_size()
        if self.use_dynamic_topology:
            phases = self.phases
            key = ("opt_dyn", None if phases is None
                   else tuple(ph.send_to for ph in phases))
            return None, ctx.schedule(key, lambda: S.compile_dynamic(
                phases if phases is not None
                else topology_util.dynamic_phase_table(topo), m))
        weighted = ctx.is_machine_topo_weighted
        return ctx.schedule(("opt_static", weighted), lambda: (
            S.compile_static(topo, use_topo_weights=weighted))), None

    def _combiner(self):
        transport = basics.process_ranks()
        kind = self.communication_type
        if kind in (CommunicationType.neighbor_allreduce,
                    CommunicationType.hierarchical_neighbor_allreduce):
            sched, dyn = self._schedules()
            combine = F.make_combiner(kind, sched=sched, dyn_sched=dyn,
                                      transport=transport,
                                      local_size=basics.local_size())
        elif kind == CommunicationType.hierarchical_gossip:
            combine = F.make_combiner(
                kind, transport=transport, local_size=basics.local_size(),
                hier=basics._hier_plan(
                    "CommunicationType.hierarchical_gossip"))
        else:
            combine = F.make_combiner(kind, transport=transport)
        return F.compress_combiner(
            combine, self.compression,
            residual=self.communication_type != CommunicationType.allreduce,
            steps_per_comm=self.num_steps_per_communication)

    # -- sharded gossip ------------------------------------------------------
    def _leaves(self):
        """The leaves the specs describe, rank-major over the world:
        ``leaf_shapes`` of the single flat parameter, or the parameters."""
        n = basics.size()
        ps = self.params
        if self.leaf_shapes is not None:
            if len(ps) != 1:
                raise ValueError("leaf_shapes describes the columns of a "
                                 f"single flat parameter; the base "
                                 f"optimizer has {len(ps)}")
            return [SH.Leaf((n,) + s, ps[0].dtype) for s in self.leaf_shapes]
        return [SH.Leaf((n,) + tuple(p.shape[1:]), p.dtype) for p in ps]

    def _shard_plan(self):
        """The sharded-gossip plan (cached by the leaves' shapes and
        dtypes), or None, the replicated path: no specs, or
        ``BLUEFOG_TPU_SHARDED_GOSSIP=0``."""
        from bluefog_tpu_torch.utils import config
        if self.shard_specs is None or not config.get().sharded_gossip:
            return None
        leaves = self._leaves()
        key = tuple((leaf.shape, str(leaf.dtype)) for leaf in leaves)
        plan = self._shard_plan_cache.get(key)
        if plan is None:
            plan = SH.build_plan(leaves, list(self.shard_specs),
                                 n=basics.size(),
                                 n_shards=self.num_shards,
                                 groups=self.shard_groups)
            self._shard_plan_cache[key] = plan
        return plan

    def _group_schedule(self, plan):
        """The plan's merged replica-group schedule, cached on the context
        under the plan's signature."""
        ctx = basics._require_init()
        return ctx.schedule(("opt_sharded", plan.signature),
                            lambda: SH.compile_group_schedules(
                                plan.n, plan.groups))

    def _shard_combiner(self, plan):
        """The sharded leaves' combiner: each rank's own slice over the
        plan's group schedule, compressed as the replicated combine is."""
        gsched, _per_group = self._group_schedule(plan)
        gc = F.make_combiner(CommunicationType.neighbor_allreduce,
                             sched=gsched, transport=basics.process_ranks())
        gc = F.compress_combiner(
            gc, self.compression, residual=True,
            steps_per_comm=self.num_steps_per_communication)
        return F.make_shard_combiner(plan, gc, ranks=basics.owned_ranks())

    def _shard_args(self) -> dict:
        plan = self._shard_plan()
        if plan is None or not plan.any_sharded:
            return {}
        return {"shard_plan": plan, "shard_combine": self._shard_combiner(plan),
                "leaf_shapes": self.leaf_shapes}

    def _check_params(self):
        n = len(basics.owned_ranks())
        for p in self.params:
            if p.dim() == 0 or p.shape[0] != n:
                raise ValueError(f"parameters must be rank-major with leading "
                                 f"dim {n}; got shape {tuple(p.shape)}")

    # An ATC step is ``adapt()`` then ``combine()``; ``step()`` calls them,
    # and a caller that reads the parameters between the halves (the
    # benchmark's consensus spread, the step profile's phase times) calls
    # them itself, so the observed step is the timed one.
    def adapt(self) -> None:
        """The first half of an ATC step: the local base update alone
        (every rank at once)."""
        self._check_params()
        self.base.step()

    def combine(self, weights=None) -> None:
        """The second half of an ATC step: the neighbor combine at the
        current step counter (``weights``: an ``(n, n)`` override), then
        the counter's advance."""
        self._combine_step(lambda combiner, shard: F._tree_combine(
            self.params, combiner, self.step_count,
            self.num_steps_per_communication, self.fusion, weights,
            self.fusion_buckets, self.leaf_sizes, **shard))
        self.step_count += 1

    def _comm_op(self) -> Optional[str]:
        """The eager op a combine of this optimizer is counted as (None:
        no communication)."""
        kind = self.communication_type
        if kind == CommunicationType.empty:
            return None
        if kind in (CommunicationType.neighbor_allreduce,
                    CommunicationType.hierarchical_neighbor_allreduce):
            return ("dynamic_" if self.use_dynamic_topology else "") + \
                kind.name
        return kind.name

    def _combine_step(self, run) -> None:
        """One combine at the current step: ``run(combiner, shard_args)``
        in an ``ENQUEUE`` span (building the combiner) and a
        ``COMMUNICATE`` span (the rounds), and its traffic counted, on the
        steps that communicate."""
        op = self._comm_op()
        if op is None or self.step_count % self.num_steps_per_communication:
            run(self._combiner(), self._shard_args())
            return
        with op_span(op, "ENQUEUE"):
            combiner = self._combiner()
            shard = self._shard_args()
        with op_span(op, "COMMUNICATE"):
            run(combiner, shard)
        if telemetry.enabled():
            self._record_combine(op, shard.get("shard_plan"))

    def _record_combine(self, op: str, plan) -> None:
        """One combine's traffic, at its step (before the counter
        advances): the eager op's counters over this optimizer's schedule,
        and the level bytes of the hierarchical gossip and of sharded
        gossip."""
        ps = self.params
        nbytes = sum(p.numel() * p.element_size() for p in ps)
        sched = None
        if self.communication_type in (
                CommunicationType.neighbor_allreduce,
                CommunicationType.hierarchical_neighbor_allreduce):
            static, dyn = self._schedules()
            sched = static if static is not None else dyn
        telemetry.record_comm_traffic(
            op, nbytes, size=basics.size(),
            sched_stats=None if sched is None
            else C.schedule_wire_stats(sched))
        if self.communication_type == CommunicationType.hierarchical_gossip:
            hier = basics._hier_plan("CommunicationType.hierarchical_gossip")
            ht = hier["ht"]
            basics._record_hier_levels(ht, self.step_count, nbytes,
                                       ht.ici_edges_per_step(),
                                       hier["outer_compression"])
        if plan is not None:
            rep_ici, rep_dcn, grp_edges = self._shard_telemetry_meta(plan)
            SH.record_level_bytes(plan, rep_ici_edges=rep_ici,
                                  rep_dcn_edges=rep_dcn,
                                  grp_edges=grp_edges,
                                  compression=self.compression)

    def _shard_telemetry_meta(self, plan):
        """(replicated in-group, replicated cross-group, in-group) edge
        counts of sharded gossip's level bytes, memoized a topology and
        plan (the JAX package's L242)."""
        ctx = basics._require_init()
        key = (ctx.topology_version, plan.signature,
               self.use_dynamic_topology)
        meta = self._shard_meta_cache.get(key)
        if meta is None:
            sched, dyn = self._schedules()
            rep_ici, rep_dcn = SH.edge_level_counts(
                plan.coords, sched if sched is not None else dyn)
            grp_edges = 0.0
            if plan.any_sharded:
                gsched, _per_group = self._group_schedule(plan)
                grp_edges = float(sum(len(r.pairs) for r in gsched.rounds))
            meta = (rep_ici, rep_dcn, grp_edges)
            self._shard_meta_cache[key] = meta
        return meta

    def step(self, *, self_weight: Optional[float] = None,
             src_weights=None, dst_weights=None) -> None:
        """One optimizer step in this optimizer's order, then the step
        counter's advance.  The weight arguments override the topology's
        weights for this step (``neighbor_allreduce`` only)."""
        t0 = telemetry.start_timer()
        self._step(self_weight, src_weights, dst_weights)
        self._steps_seen += 1
        # The host's time: the device work may still be queued.
        telemetry.observe_since(t0, "bf_optimizer_step_seconds",
                                family="collective")
        pe = profiler.profile_period(self.profile_every)
        if pe and self._steps_seen % pe == 0 and t0 is not None:
            # The synced sample: this step alone waits for the device, so
            # its total is the step's true wall time.
            t_sync = time.perf_counter()
            dev = self.params[0].device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            outer = profiler.active()
            if outer is not None:
                # An enclosing step_profile() records this step and
                # gathers the stragglers, once.
                outer.attribute("host-sync", now - t_sync)
                outer.request_straggler()
            else:
                profiler.record_synced_step(
                    now - t0, phases={"optimizer-update": t_sync - t0,
                                      "host-sync": now - t_sync})
        # It costs a combine: only with the period set explicitly.
        k = telemetry.consensus_every(costs_communication=True)
        if k and self._steps_seen % k == 0 and self.order != \
                "gradient_allreduce":
            self.sample_consensus_distance()

    @torch.no_grad()
    def sample_consensus_distance(self) -> None:
        """Record the consensus-distance gauge: a rank's L2 distance from
        the weighted mean of its neighborhood over the active topology's
        static schedule, over every parameter (the JAX package's
        ``_sample_consensus_distance``, L479).  Reduced on the device a
        column chunk at a time; ``n`` floats cross to the host."""
        ps = self.params
        m = ps[0].shape[0]
        sched = basics._dispatch_static()
        comm = basics.process_ranks()
        sq = torch.zeros(m, dtype=torch.float32, device=ps[0].device)
        for p in ps:
            flat = p.detach().reshape(m, -1)
            for cols in flat.split(F.COMBINE_CHUNK, dim=1):
                x = cols.float()
                mean = C.neighbor_allreduce(x, sched, comm=comm)
                sq += (x - mean).square().sum(1)
        # Counted as the one eager combine it stands for.
        basics._record_dispatch("neighbor_allreduce", ps[0], sched)
        dist = sq.sqrt().cpu()
        telemetry.record_consensus_distance(float(dist.mean()),
                                            float(dist.max()))

    def _step(self, self_weight, src_weights, dst_weights) -> None:
        w = basics._weight_override_matrix(self_weight, src_weights,
                                           dst_weights)
        if self.order == "gradient_allreduce":
            if w is not None:
                raise ValueError(
                    "per-step weight overrides apply to the parameter-"
                    "consensus orders (awc/atc); gradient allreduce "
                    "averages over every rank")
            self._check_params()
            if telemetry.enabled() and (self.step_count + 1) \
                    % self.num_steps_per_communication == 0:
                telemetry.record_comm_traffic(
                    "allreduce", sum(p.numel() * p.element_size()
                                     for p in self.params),
                    size=basics.size())
            self.step_count, self._acc = F.gradient_allreduce_step(
                self.base, self.params, self.step_count, acc=self._acc,
                steps_per_comm=self.num_steps_per_communication,
                compression=self.compression, fuse=self.fusion,
                fusion_buckets=self.fusion_buckets,
                leaf_sizes=self.leaf_sizes,
                transport=basics.process_ranks())
            return
        if self.order == "atc":
            self.adapt()
            self.combine(w)
            return
        self._check_params()
        # F.awc_step's order: the combine, then the base update.
        self._combine_step(lambda combiner, shard: F._tree_combine(
            self.params, combiner, self.step_count,
            self.num_steps_per_communication, self.fusion, w,
            self.fusion_buckets, self.leaf_sizes, **shard))
        self.base.step()
        self.step_count += 1


def DistributedGradientAllreduceOptimizer(
        base, *, num_steps_per_communication: int = 1,
        **kw) -> DistributedOptimizer:
    """Horovod-style synchronous gradient averaging."""
    return DistributedOptimizer(
        base, CommunicationType.allreduce, order="gradient_allreduce",
        num_steps_per_communication=num_steps_per_communication, **kw)


def DistributedAllreduceOptimizer(
        base, *, num_steps_per_communication: int = 1,
        **kw) -> DistributedOptimizer:
    """Synchronous parameter consensus by the global average (AWC)."""
    return DistributedOptimizer(
        base, CommunicationType.allreduce, order="awc",
        num_steps_per_communication=num_steps_per_communication, **kw)


def DistributedNeighborAllreduceOptimizer(
        base, *, num_steps_per_communication: int = 1,
        use_dynamic_topology: bool = False, phases=None,
        **kw) -> DistributedOptimizer:
    """The flagship: AWC neighbor averaging over the active topology."""
    return DistributedOptimizer(
        base, CommunicationType.neighbor_allreduce, order="awc",
        num_steps_per_communication=num_steps_per_communication,
        use_dynamic_topology=use_dynamic_topology, phases=phases, **kw)


def DistributedHierarchicalNeighborAllreduceOptimizer(
        base, *, num_steps_per_communication: int = 1,
        use_dynamic_topology: bool = False, phases=None,
        **kw) -> DistributedOptimizer:
    """Machine-level neighbor averaging (AWC): each machine's local sum
    combined over the machine topology, divided by ``local_size()``
    (reference ``:1352``)."""
    return DistributedOptimizer(
        base, CommunicationType.hierarchical_neighbor_allreduce, order="awc",
        num_steps_per_communication=num_steps_per_communication,
        use_dynamic_topology=use_dynamic_topology, phases=phases, **kw)


def DistributedHierarchicalGossipOptimizer(
        base, *, num_steps_per_communication: int = 1,
        order: str = "awc", **kw) -> DistributedOptimizer:
    """Two-level hierarchical gossip (``BLUEFOG_TPU_HIER=1``): the dense
    combine inside each machine every step, the one-peer exchange between
    machines on its own cadence with its own codec
    (``BLUEFOG_TPU_HIER_OUTER_*``)."""
    return DistributedOptimizer(
        base, CommunicationType.hierarchical_gossip, order=order,
        num_steps_per_communication=num_steps_per_communication, **kw)


def DistributedAdaptWithCombineOptimizer(
        base, communication_type=CommunicationType.neighbor_allreduce,
        *, num_steps_per_communication: int = 1,
        use_dynamic_topology: bool = False, phases=None,
        **kw) -> DistributedOptimizer:
    """AWC with a chosen communication type."""
    return DistributedOptimizer(
        base, communication_type, order="awc",
        num_steps_per_communication=num_steps_per_communication,
        use_dynamic_topology=use_dynamic_topology, phases=phases, **kw)


def DistributedAdaptThenCombineOptimizer(
        base, communication_type=CommunicationType.neighbor_allreduce,
        *, num_steps_per_communication: int = 1,
        use_dynamic_topology: bool = False, phases=None,
        **kw) -> DistributedOptimizer:
    """ATC with a chosen communication type."""
    return DistributedOptimizer(
        base, communication_type, order="atc",
        num_steps_per_communication=num_steps_per_communication,
        use_dynamic_topology=use_dynamic_topology, phases=phases, **kw)
