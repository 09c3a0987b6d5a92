"""Small models: LeNet-5, MLP, logistic regression, linear model.

The port of ``bluefog_tpu/models/simple.py``.  flax infers a ``Dense``
layer's input width from its first call; torch needs it up front, so the
MLP and the linear models take ``in_features``.  Flattening follows flax's
NHWC order: ``LeNet5`` flattens its ``(B, H, W, C)`` activations, so the
first Dense's rows carry over from flax as they are.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models.layers import (Conv, FlaxInit, dense,
                                             nhwc_to_nchw)

__all__ = ["LeNet5", "MLP", "LogisticRegression", "LinearModel"]


class LeNet5(FlaxInit):
    """Classic LeNet-5 for ``(B, 28, 28, in_channels)`` inputs (MNIST's
    one channel by default; flax infers the channels from the input)."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32,
                 in_channels: int = 1):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(in_channels, 6, (5, 5), padding="SAME",
                           dtype=dtype)
        self.Conv_1 = Conv(6, 16, (5, 5), padding="VALID", dtype=dtype)
        self.Dense_0 = nn.Linear(5 * 5 * 16, 120)
        self.Dense_1 = nn.Linear(120, 84)
        self.Dense_2 = nn.Linear(84, num_classes)

    def forward(self, images):
        x = F.avg_pool2d(F.relu(self.Conv_0(nhwc_to_nchw(images))), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = F.relu(dense(x, self.Dense_0, self.dtype))
        x = F.relu(dense(x, self.Dense_1, self.dtype))
        return dense(x, self.Dense_2, self.dtype).float()


class MLP(FlaxInit):
    def __init__(self, in_features: int, features: Sequence[int] = (256, 256),
                 num_classes: int = 10, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = [in_features, *features, num_classes]
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"Dense_{i}", nn.Linear(a, b))
        self.depth = len(widths) - 1

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.depth):
            x = dense(x, getattr(self, f"Dense_{i}"), self.dtype)
            if i < self.depth - 1:
                x = F.relu(x)
        return x.float()


class LogisticRegression(FlaxInit):
    def __init__(self, in_features: int, num_classes: int = 2):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, num_classes)

    def forward(self, x):
        return self.Dense_0(x.reshape(x.shape[0], -1))


class LinearModel(FlaxInit):
    def __init__(self, in_features: int, out_features: int = 1):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, out_features)

    def forward(self, x):
        return self.Dense_0(x)
