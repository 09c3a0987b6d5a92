"""``n`` rank replicas of one model whose parameters share one flat buffer.

The port's counterpart of the JAX package's rank-major parameter pytree and
its single-buffer ravel: every rank's module is a replica whose parameters
are views into row ``r`` of one ``(n, P)`` float32 tensor, and whose
gradients are views into row ``r`` of a second one.  A base optimizer over
the flat tensor updates every rank in one op, and the neighbor combine is one
op on the buffer.  Only parameters are combined: a module's buffers (BN
running statistics) stay rank-local, each replica owning its own on the
device, updated only by that rank's forward and never part of ``flat``,
as the JAX benchmarks keep ``batch_stats`` rank-major and never gossip them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["RankReplicas"]


def _layout(proto: nn.Module, order: Optional[Sequence]) -> list:
    """``[(name, dims), ...]`` from ``order`` (names, or ``(name, dims)``
    pairs), or the module's own parameter order."""
    names = [name for name, _ in proto.named_parameters()]
    if order is None:
        return [(name, None) for name in names]
    layout = [(e, None) if isinstance(e, str) else (e[0], e[1])
              for e in order]
    if sorted(name for name, _ in layout) != sorted(names):
        raise ValueError("order must name every parameter of the module "
                         "once")
    return layout


class RankReplicas:
    """``n`` replicas of ``make_module()`` on ``device``.

    ``flat`` is the rank-major ``(n, P)`` parameter tensor, with ``flat.grad``
    the matching gradient tensor; ``modules[r]`` is rank ``r``'s replica.
    Every rank starts from the same values (``init`` is called on rank 0's
    replica, whose parameters and buffers are then copied to every rank), as
    the JAX benchmark broadcasts one initialization to every rank.  Without
    ``init`` the values are unset until ``load_state_dict``.

    ``order`` lays out ``flat``'s columns: a list of parameter names, each
    optionally paired with a permutation ``dims`` that the parameter's
    column block is stored in (``param.permute(dims)`` is the block's
    row-major layout; the module sees a view in its own layout).
    ``models.convert.jax_ravel_order`` gives the JAX package's ravel.
    Default: the module's parameter order, each in its own layout.
    ``leaf_sizes`` lists each parameter's columns in that order, and
    ``leaf_shapes`` the stored shape of each block (the JAX layout under
    ``jax_ravel_order``): the leaves of sharded gossip's plan."""

    def __init__(self, make_module: Callable[[], nn.Module], n: int,
                 device, init: Callable[[nn.Module], None] = None,
                 order: Optional[Sequence] = None):
        self.n = int(n)
        self.device = torch.device(device)
        with torch.device("meta"):
            self.modules: List[nn.Module] = [make_module()
                                             for _ in range(self.n)]
        proto = self.modules[0]
        layout = _layout(proto, order)
        self.names = [name for name, _ in layout]
        params = dict(proto.named_parameters())
        blocks = []   # (name, stored shape, inverse permutation or None)
        for name, dims in layout:
            shape = params[name].shape
            if dims is None:
                blocks.append((name, shape, None))
            else:
                blocks.append((name, torch.Size(shape[d] for d in dims),
                               tuple(np.argsort(dims).tolist())))
        # Columns of each parameter's block, in flat's order: the leaves
        # that fusion buckets split at.
        self.leaf_sizes = [shape.numel() for _, shape, _ in blocks]
        self.leaf_shapes = [tuple(shape) for _, shape, _ in blocks]
        self.numel = sum(self.leaf_sizes)
        self.flat = torch.empty((self.n, self.numel), dtype=torch.float32,
                                device=self.device)
        self.flat.grad = torch.zeros_like(self.flat)
        for r, mod in enumerate(self.modules):
            off = 0
            for name, shape, inv in blocks:
                size = shape.numel()
                data = self.flat[r, off:off + size].view(shape)
                grad = self.flat.grad[r, off:off + size].view(shape)
                if inv is not None:
                    data, grad = data.permute(inv), grad.permute(inv)
                owner_name, _, leaf = name.rpartition(".")
                param = nn.Parameter(data)
                param.grad = grad
                mod.get_submodule(owner_name)._parameters[leaf] = param
                off += size
            for name, buf in list(mod.named_buffers()):
                owner_name, _, leaf = name.rpartition(".")
                mod.get_submodule(owner_name)._buffers[leaf] = torch.empty(
                    buf.shape, dtype=buf.dtype, device=self.device)
        if init is not None:
            init(self.modules[0])
            self.flat[1:].copy_(self.flat[0])
            self._broadcast_buffers()

    @torch.no_grad()
    def _broadcast_buffers(self) -> None:
        src = dict(self.modules[0].named_buffers())
        for mod in self.modules[1:]:
            for name, buf in mod.named_buffers():
                buf.copy_(src[name])

    @torch.no_grad()
    def load_state_dict(self, state_dict) -> None:
        """Copy one state dict (parameters and buffers) into every rank's
        replica."""
        own = dict(self.modules[0].named_parameters())
        own.update(self.modules[0].named_buffers())
        missing = set(own) - set(state_dict)
        unexpected = set(state_dict) - set(own)
        if missing or unexpected:
            raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                           f"unexpected {sorted(unexpected)}")
        for name, t in own.items():
            t.copy_(torch.as_tensor(state_dict[name]).reshape(t.shape))
        self.flat[1:].copy_(self.flat[0])
        self._broadcast_buffers()

    def zero_grad(self) -> None:
        self.flat.grad.zero_()

    def rank_params(self, r: int) -> dict:
        """Rank ``r``'s parameters by name (views into ``flat``)."""
        return dict(self.modules[r].named_parameters())

    def rank_buffers(self, r: int) -> dict:
        """Rank ``r``'s buffers by name (its own, outside ``flat``)."""
        return dict(self.modules[r].named_buffers())
