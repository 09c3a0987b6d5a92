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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bluefog_tpu_torch import basics
from bluefog_tpu_torch import topology as topology_util
from bluefog_tpu_torch.ops import schedule as S
from bluefog_tpu_torch.optim import functional as F
from bluefog_tpu_torch.optim.functional import CommunicationType

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
    """

    def __init__(self, base: torch.optim.Optimizer,
                 communication_type: CommunicationType =
                 CommunicationType.neighbor_allreduce,
                 *, order: str = "awc", num_steps_per_communication: int = 1,
                 use_dynamic_topology: bool = False, phases=None,
                 fusion: bool = True, fusion_buckets: Optional[int] = None,
                 leaf_sizes: Optional[Sequence[int]] = None,
                 compression: str = "none"):
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
        self.leaf_sizes = None if leaf_sizes is None else list(leaf_sizes)
        self.compression = compression
        self.step_count = 0
        self._acc = None   # gradient allreduce's J-step accumulator

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
        F._tree_combine(self.params, self._combiner(), self.step_count,
                        self.num_steps_per_communication, self.fusion,
                        weights, self.fusion_buckets, self.leaf_sizes)
        self.step_count += 1

    def step(self, *, self_weight: Optional[float] = None,
             src_weights=None, dst_weights=None) -> None:
        """One optimizer step in this optimizer's order, then the step
        counter's advance.  The weight arguments override the topology's
        weights for this step (``neighbor_allreduce`` only)."""
        w = basics._weight_override_matrix(self_weight, src_weights,
                                           dst_weights)
        if self.order == "gradient_allreduce":
            if w is not None:
                raise ValueError(
                    "per-step weight overrides apply to the parameter-"
                    "consensus orders (awc/atc); gradient allreduce "
                    "averages over every rank")
            self._check_params()
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
        self.step_count = F.awc_step(
            self.base, self._combiner(), self.params, self.step_count,
            steps_per_comm=self.num_steps_per_communication, fuse=self.fusion,
            weights=w, fusion_buckets=self.fusion_buckets,
            leaf_sizes=self.leaf_sizes)


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
