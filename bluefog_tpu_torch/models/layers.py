"""flax layers as the port's vision models use them.

``Conv`` is flax ``nn.Conv`` over channels_last activations: inputs, kernel
and bias cast to ``dtype``, and flax's ``"SAME"`` padding, which puts the
odd pixel of an odd total at the end (a stride-2 3x3 conv on an even input
pads ``(0, 1)``, where torchvision pads ``(1, 1)``).  ``BatchNorm`` is flax
``nn.BatchNorm``: batch statistics in float32, the output normalized in
float32 and cast to ``dtype``, and running statistics that move by the
*biased* batch variance, ``ra = momentum * ra + (1 - momentum) * batch``.
``dense`` is flax ``nn.Dense(dtype=...)``.  ``flax_init_`` draws flax's
default distributions from an explicit generator.

Images enter the models as ``(B, H, W, C)``, as in the JAX package;
``x.permute(0, 3, 1, 2)`` of that is a channels_last ``(B, C, H, W)`` view,
so no copy is made.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv", "BatchNorm", "dense", "nhwc_to_nchw", "flax_init_",
           "FlaxInit"]

# Standard deviation of a unit normal truncated to [-2, 2]; jax's
# ``truncated_normal`` initializers divide by it to keep the set variance.
_TRUNC_NORMAL_STD = 0.87962566103423978

Padding = Union[str, int, Sequence[Tuple[int, int]]]


def nhwc_to_nchw(images: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C)`` images as a channels_last ``(B, C, H, W)`` view."""
    if images.dim() != 4:
        raise ValueError(f"expected (B, H, W, C) images, got "
                         f"{tuple(images.shape)}")
    return images.permute(0, 3, 1, 2)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME``: output ``ceil(size / s)``, the extra pixel of an
    odd total padding at the end."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` with a ``(out, in, kh, kw)`` weight."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Padding = "SAME",
                 bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.kernel, self.stride, self.dtype = tuple(kernel), stride, dtype
        if isinstance(padding, int):
            padding = [(padding, padding)] * 2
        self.padding = padding

    def _pads(self, hw) -> list:
        if self.padding == "SAME":
            return [_same_pads(n, k, self.stride)
                    for n, k in zip(hw, self.kernel)]
        if self.padding == "VALID":
            return [(0, 0), (0, 0)]
        return [tuple(p) for p in self.padding]

    def forward(self, x):
        (ht, hb), (wl, wr) = self._pads(x.shape[-2:])
        x = x.to(self.dtype)
        if (ht, wl) != (hb, wr):
            x = F.pad(x, (wl, wr, ht, hb))
            ht = wl = 0
        # One pass: the cast writes the kernel channels_last.
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, b, self.stride, (ht, wl))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of ``(B, C, H, W)``.

    In training mode the batch statistics normalize the input and move the
    running ones; torch's own update (by the unbiased variance) is not used.
    In eval mode the running statistics normalize."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.zero_scale = zero_scale

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(self.dtype)
        out, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            var = invstd.pow(-2).sub_(self.eps)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return out.to(self.dtype)


def dense(x, layer: nn.Linear, dtype):
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def _lecun_normal_(p: torch.Tensor, fan_in: int, generator) -> None:
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_NORMAL_STD
    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers on every ``Conv``, ``nn.Linear`` and
    ``BatchNorm`` of ``model``: kernels ``lecun_normal`` (a normal truncated
    at two of its deviations, rescaled to variance 1/fan_in, fan_in = kh *
    kw * in for a conv), biases 0, BN scales 1 (0 where ``zero_scale``),
    running mean 0 and variance 1.  Other parameters are left to the
    caller.  The draws are torch's, so the values differ from flax's."""
    for mod in model.modules():
        if isinstance(mod, (Conv, nn.Linear)):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(0.0 if mod.zero_scale else 1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)


class FlaxInit(nn.Module):
    """A model whose ``reset_parameters`` is ``flax_init_``."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers (``flax_init_``), from ``generator``."""
        flax_init_(self, generator)
