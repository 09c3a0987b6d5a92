"""``n`` rank replicas of one model whose parameters share one flat buffer.

The port's counterpart of the JAX package's rank-major parameter pytree and
its single-buffer ravel: every rank's module is a replica whose parameters
are views into row ``r`` of one ``(n, P)`` float32 tensor, and whose
gradients are views into row ``r`` of a second one.  A base optimizer over
the flat tensor updates every rank in one op, and the neighbor combine is one
op on the buffer.  Only parameters are combined; a module with buffers is
refused.
"""

from __future__ import annotations

from typing import Callable, List

import torch
from torch import nn

__all__ = ["RankReplicas"]


class RankReplicas:
    """``n`` replicas of ``make_module()`` on ``device``.

    ``flat`` is the rank-major ``(n, P)`` parameter tensor, with ``flat.grad``
    the matching gradient tensor; ``modules[r]`` is rank ``r``'s replica.
    Every rank starts from the same values (``init`` is called on rank 0's
    parameters, which are then copied to every row), as the JAX benchmark
    broadcasts one initialization to every rank."""

    def __init__(self, make_module: Callable[[], nn.Module], n: int,
                 device, init: Callable[[nn.Module], None] = None):
        self.n = int(n)
        self.device = torch.device(device)
        with torch.device("meta"):
            self.modules: List[nn.Module] = [make_module()
                                             for _ in range(self.n)]
        proto = self.modules[0]
        if any(True for _ in proto.buffers()):
            raise ValueError("RankReplicas combines parameters only; the "
                             "module has buffers")
        self.names = [name for name, _ in proto.named_parameters()]
        shapes = [p.shape for _, p in proto.named_parameters()]
        sizes = [s.numel() for s in shapes]
        self.numel = sum(sizes)
        self.flat = torch.empty((self.n, self.numel), dtype=torch.float32,
                                device=self.device)
        self.flat.grad = torch.zeros_like(self.flat)
        for r, mod in enumerate(self.modules):
            off = 0
            for name, shape, size in zip(self.names, shapes, sizes):
                owner_name, _, leaf = name.rpartition(".")
                owner = mod.get_submodule(owner_name)
                param = nn.Parameter(
                    self.flat[r, off:off + size].view(shape))
                param.grad = self.flat.grad[r, off:off + size].view(shape)
                owner._parameters[leaf] = param
                off += size
        if init is not None:
            init(self.modules[0])
            self.flat[1:].copy_(self.flat[0])

    @torch.no_grad()
    def load_state_dict(self, state_dict) -> None:
        """Copy one state dict into every rank's replica."""
        params = dict(self.modules[0].named_parameters())
        missing = set(params) - set(state_dict)
        unexpected = set(state_dict) - set(params)
        if missing or unexpected:
            raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                           f"unexpected {sorted(unexpected)}")
        for name, p in params.items():
            p.copy_(torch.as_tensor(state_dict[name]).reshape(p.shape))
        self.flat[1:].copy_(self.flat[0])

    def zero_grad(self) -> None:
        self.flat.grad.zero_()

    def rank_params(self, r: int) -> dict:
        """Rank ``r``'s parameters by name (views into ``flat``)."""
        return dict(self.modules[r].named_parameters())
