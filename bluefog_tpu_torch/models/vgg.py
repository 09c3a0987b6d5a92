"""VGG family: 3x3 convs with a bias, no BN and no dropout.

The port of ``bluefog_tpu/models/vgg.py``: bfloat16 activations over
float32 parameters, explicit padding 1, 2x2 max pools, and a classifier of
two bf16 Dense layers and a float32 head.  The classifier flattens the
``(B, H, W, C)`` activations in flax's NHWC order; torch needs the input
width up front, so ``image_size`` fixes it.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models.layers import (Conv, FlaxInit, dense,
                                             nhwc_to_nchw)

__all__ = ["VGG", "VGG11", "VGG16", "VGG19"]

# Numbers = conv output channels, "M" = 2x2 max pool (torchvision cfgs).
_CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(FlaxInit):
    def __init__(self, cfg: Sequence[Any], num_classes: int = 1000,
                 hidden: int = 4096, dtype=torch.bfloat16,
                 image_size: int = 224, in_channels: int = 3):
        super().__init__()
        self.cfg, self.dtype = tuple(cfg), dtype
        cin, side, i = in_channels, image_size, 0
        for v in self.cfg:
            if v == "M":
                side //= 2
            else:
                setattr(self, f"Conv_{i}", Conv(cin, v, (3, 3), padding=1,
                                                dtype=dtype))
                cin, i = v, i + 1
        self.Dense_0 = nn.Linear(side * side * cin, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, num_classes)

    def forward(self, images):
        x, i = nhwc_to_nchw(images), 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = F.relu(dense(x, self.Dense_0, self.dtype))
        x = F.relu(dense(x, self.Dense_1, self.dtype))
        return dense(x, self.Dense_2, torch.float32)


def VGG11(**kw) -> VGG:
    return VGG(_CFGS[11], **kw)


def VGG16(**kw) -> VGG:
    return VGG(_CFGS[16], **kw)


def VGG19(**kw) -> VGG:
    return VGG(_CFGS[19], **kw)
