"""Per-step distributed-optimizer functions (the functional core).

The port of the parameter-consensus orders of ``bluefog_tpu/optim/
functional.py`` over rank-major tensors on one device:

  AWC (adapt-with-combine): ``x_{t+1} = combine(x_t) + base_update(g_t)``
  ATC (adapt-then-combine): ``x_{t+1} = combine(x_t + base_update(g_t))``

``base`` is a ``torch.optim.Optimizer`` over rank-major parameters (leading
dim ``n``): its update is elementwise, so one ``base.step()`` is every
rank's local step.  ``combine`` is static or dynamic neighbor averaging, or
identity ("empty").  The combine updates the parameters in place, over
column chunks of the flat buffer, so its extra memory is a few chunk-sized
temporaries rather than copies of the whole parameter set; the combine is
elementwise across columns, so chunking changes no value.
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional

import torch

from bluefog_tpu_torch.ops import collective as C
from bluefog_tpu_torch.ops.schedule import DynamicSchedule, StaticSchedule

__all__ = ["CommunicationType", "make_combiner", "awc_step", "atc_step"]

# Columns per chunk of the in-place combine: 16M f32 columns is 64 MiB a row.
COMBINE_CHUNK = 1 << 24


class CommunicationType(enum.Enum):
    """The JAX package's communication types; this slice ports
    ``neighbor_allreduce`` and ``empty``."""
    allreduce = "allreduce"
    neighbor_allreduce = "neighbor.allreduce"
    hierarchical_neighbor_allreduce = "hierarchical.neighbor.allreduce"
    hierarchical_gossip = "hierarchical.gossip"
    empty = "empty"


Combiner = Callable[..., torch.Tensor]  # (x, step) -> x


def make_combiner(comm: CommunicationType, *,
                  sched: Optional[StaticSchedule] = None,
                  dyn_sched: Optional[DynamicSchedule] = None) -> Combiner:
    """Build ``combine(x, step)`` for a communication type."""
    if comm == CommunicationType.empty:
        def _empty(x, step=None):
            return x
        _empty.is_identity = True
        return _empty
    if comm == CommunicationType.neighbor_allreduce:
        if dyn_sched is not None:
            def _dyn(x, step):
                return C.dynamic_neighbor_allreduce(x, step, dyn_sched)
            return _dyn
        if sched is None:
            raise ValueError("static neighbor_allreduce needs a schedule")

        def _nbr(x, step=None):
            return C.neighbor_allreduce(x, sched)
        return _nbr
    raise NotImplementedError(
        f"communication type {comm} is not ported yet (ROADMAP.md Queue 1)")


def _fused_apply(fn, params: List[torch.Tensor],
                 chunk: int = COMBINE_CHUNK) -> None:
    """Apply ``fn`` (rank-major ``(n, m)`` -> ``(n, m)``) to the parameters
    as one flat buffer, in place.  A single contiguous rank-major tensor is
    its own buffer; several are raveled into one and written back."""
    n = params[0].shape[0]
    if len(params) == 1 and params[0].is_contiguous():
        flat = params[0].view(n, -1)
    else:
        flat = torch.cat([p.reshape(n, -1) for p in params], dim=1)
    for cols in flat.split(chunk, dim=1):
        cols.copy_(fn(cols))
    if flat.data_ptr() != params[0].data_ptr():
        off = 0
        for p in params:
            size = p[0].numel()
            p.copy_(flat[:, off:off + size].view(p.shape))
            off += size


@torch.no_grad()
def _tree_combine(params: List[torch.Tensor], combine: Combiner, step: int,
                  steps_per_comm: int = 1, fuse: bool = True) -> None:
    """Apply ``combine`` to the rank-major parameters in place, skipping
    steps where ``step % steps_per_comm != 0`` (local aggregation).
    ``fuse=True`` combines one flat buffer, as the JAX package's single
    ravel; ``fuse=False`` combines each tensor on its own."""
    if getattr(combine, "is_identity", False) or step % steps_per_comm:
        return
    fn = lambda x: combine(x, step=step)  # noqa: E731
    if fuse:
        _fused_apply(fn, params)
    else:
        for p in params:
            p.copy_(fn(p))


def awc_step(base: torch.optim.Optimizer, combine: Combiner,
             params: List[torch.Tensor], step: int, *,
             steps_per_comm: int = 1, fuse: bool = True) -> int:
    """Adapt-with-combine: combine the parameters, then apply the base
    update to the combined values.  Returns the next step counter."""
    _tree_combine(params, combine, step, steps_per_comm, fuse)
    base.step()
    return step + 1


def atc_step(base: torch.optim.Optimizer, combine: Combiner,
             params: List[torch.Tensor], step: int, *,
             steps_per_comm: int = 1, fuse: bool = True) -> int:
    """Adapt-then-combine: local base update first, then combine.
    Returns the next step counter."""
    base.step()
    _tree_combine(params, combine, step, steps_per_comm, fuse)
    return step + 1
