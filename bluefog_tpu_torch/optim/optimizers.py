"""Distributed optimizer classes — the ``Distributed*Optimizer`` surface.

The port of ``bluefog_tpu/optim/optimizers.py`` for the parameter-consensus
orders.  Where the JAX package wraps an ``optax.GradientTransformation`` and
returns new parameters and state, these wrap a ``torch.optim.Optimizer``
whose parameters are rank-major (leading dim ``size()``), and ``step()``
updates them in place: the base optimizer owns its state, so there is no
separate ``init``.  ``torch.optim.SGD(lr, momentum, dampening=0)`` computes
what ``optax.sgd(lr, momentum)`` does.

Usage::

    rep = RankReplicas(make_model, bf.size(), bf.device(), init=...)
    opt = DistributedAdaptThenCombineOptimizer(
        torch.optim.SGD([rep.flat], lr=0.05), use_dynamic_topology=True)
    ...  # per-rank forward/backward into rep.flat.grad
    opt.step()

The step counter starts at 0 and advances after each combine; the dynamic
phase is ``step % period``.
"""

from __future__ import annotations

import torch

from bluefog_tpu_torch import basics
from bluefog_tpu_torch.optim import functional as F
from bluefog_tpu_torch.optim.functional import CommunicationType

__all__ = ["CommunicationType", "DistributedOptimizer",
           "DistributedNeighborAllreduceOptimizer",
           "DistributedAdaptWithCombineOptimizer",
           "DistributedAdaptThenCombineOptimizer"]


class DistributedOptimizer:
    """Decentralized optimizer wrapper.

    Parameters
    ----------
    base : torch.optim.Optimizer over rank-major parameters.
    communication_type : CommunicationType (``neighbor_allreduce`` or
        ``empty`` in this slice).
    order : "awc" | "atc".
    num_steps_per_communication : communicate every J-th step.
    use_dynamic_topology : cycle the one-peer phase table of the active
        topology (or ``phases`` if given) by step index.
    phases : explicit list of ``topology.DynamicPhase`` for dynamic mode.
    fusion : combine all parameters as one flat buffer.
    """

    def __init__(self, base: torch.optim.Optimizer,
                 communication_type: CommunicationType =
                 CommunicationType.neighbor_allreduce,
                 *, order: str = "awc", num_steps_per_communication: int = 1,
                 use_dynamic_topology: bool = False, phases=None,
                 fusion: bool = True):
        if isinstance(communication_type, str):
            communication_type = CommunicationType(communication_type)
        if order not in ("awc", "atc"):
            raise NotImplementedError(
                f"order {order!r} is not ported yet (ROADMAP.md Queue 1); "
                "expected 'awc' or 'atc'")
        if int(num_steps_per_communication) < 1:
            raise ValueError("num_steps_per_communication must be >= 1")
        self.base = base
        self.communication_type = communication_type
        self.order = order
        self.num_steps_per_communication = int(num_steps_per_communication)
        self.use_dynamic_topology = use_dynamic_topology
        self.phases = phases
        self.fusion = fusion
        self.step_count = 0

    @property
    def params(self):
        return [p for group in self.base.param_groups for p in group["params"]]

    def _combiner(self):
        if self.communication_type != CommunicationType.neighbor_allreduce:
            return F.make_combiner(self.communication_type)
        if self.use_dynamic_topology:
            return F.make_combiner(
                self.communication_type,
                dyn_sched=basics.dynamic_schedule(self.phases))
        return F.make_combiner(self.communication_type,
                               sched=basics.static_schedule())

    def _check_params(self):
        n = basics.size()
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

    def combine(self) -> None:
        """The second half of an ATC step: the neighbor combine at the
        current step counter, then the counter's advance."""
        F._tree_combine(self.params, self._combiner(), self.step_count,
                        self.num_steps_per_communication, self.fusion)
        self.step_count += 1

    def step(self) -> None:
        """One optimizer step: adapt and combine in this optimizer's order,
        then advance the step counter."""
        if self.order == "atc":
            self.adapt()
            self.combine()
            return
        self._check_params()
        self.step_count = F.awc_step(
            self.base, self._combiner(), self.params, self.step_count,
            steps_per_comm=self.num_steps_per_communication, fuse=self.fusion)


def DistributedNeighborAllreduceOptimizer(
        base, *, num_steps_per_communication: int = 1,
        use_dynamic_topology: bool = False, phases=None,
        **kw) -> DistributedOptimizer:
    """The flagship: AWC neighbor averaging over the active topology."""
    return DistributedOptimizer(
        base, CommunicationType.neighbor_allreduce, order="awc",
        num_steps_per_communication=num_steps_per_communication,
        use_dynamic_topology=use_dynamic_topology, phases=phases, **kw)


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
