"""ResNet family (v1.5: the stride on the 3x3 conv), the repo's headline
benchmark model.

The port of ``bluefog_tpu/models/resnet.py``: bfloat16 activations over
float32 parameters, BN statistics in float32, a float32 1000-class head, and
channels_last activations (images enter as ``(B, H, W, C)``).  Module names
follow the flax tree (``conv_init``, ``bn_init``, ``BottleneckBlock_{i}``
with ``Conv_{j}``/``BatchNorm_{j}``/``conv_proj``/``norm_proj``,
``Dense_0``), so ``models.convert`` maps one onto the other.  The last BN of
every block starts with a zero scale, so each block starts as the identity.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models.layers import (BatchNorm, Conv, FlaxInit,
                                             nhwc_to_nchw)

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "ResNet18", "ResNet34",
           "ResNet50", "ResNet101", "ResNet152"]


class _Block(nn.Module):
    """The shortcut shared by both blocks: ``conv_proj``/``norm_proj`` where
    the branch changes the shape (a stride or a channel count)."""

    expansion = 1

    def _shortcut(self, cin, cout, stride, dtype):
        if stride != 1 or cin != cout:
            self.conv_proj = Conv(cin, cout, (1, 1), stride, bias=False,
                                  dtype=dtype)
            self.norm_proj = BatchNorm(cout, dtype=dtype)
        else:
            self.conv_proj = None

    def _residual(self, x):
        if self.conv_proj is None:
            return x
        return self.norm_proj(self.conv_proj(x))


class BasicBlock(_Block):
    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, (3, 3), stride, bias=False,
                           dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), bias=False, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype, zero_scale=True)
        self._shortcut(cin, filters, stride, dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        return F.relu(self._residual(x) + y)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, (1, 1), bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), stride, bias=False,
                           dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype)
        self.Conv_2 = Conv(filters, 4 * filters, (1, 1), bias=False,
                           dtype=dtype)
        self.BatchNorm_2 = BatchNorm(4 * filters, dtype=dtype,
                                     zero_scale=True)
        self._shortcut(cin, 4 * filters, stride, dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return F.relu(self._residual(x) + y)


class ResNet(FlaxInit):
    """Logits ``(B, num_classes)`` in float32 for ``(B, H, W, 3)`` images.
    ``train()``/``eval()`` select batch or running BN statistics, as flax's
    ``train`` argument does."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(in_channels, num_filters, (7, 7), 2,
                              padding=3, bias=False, dtype=dtype)
        self.bn_init = BatchNorm(num_filters, dtype=dtype)
        self.block_names = []
        cin = num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                filters = num_filters * 2 ** i
                setattr(self, name, block_cls(cin, filters, stride, dtype))
                self.block_names.append(name)
                cin = filters * block_cls.expansion
        self.Dense_0 = nn.Linear(cin, num_classes)

    def forward(self, images):
        x = self.conv_init(nhwc_to_nchw(images))
        x = F.relu(self.bn_init(x))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # Mean over H, W from bf16 with an f32 sum, back to bf16, then an
        # f32 head.
        x = x.mean((2, 3), dtype=torch.float32).to(self.dtype)
        return F.linear(x.float(), self.Dense_0.weight, self.Dense_0.bias)


def ResNet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def ResNet34(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), BottleneckBlock, **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), BottleneckBlock, **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet((3, 8, 36, 3), BottleneckBlock, **kw)
