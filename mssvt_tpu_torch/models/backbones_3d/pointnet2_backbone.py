"""PointNet++ modules (torch counterpart of
``mssvt_tpu/models/backbones_3d/pointnet2_backbone.py``).

Only :class:`SharedMLP` is ported so far (the VoxelRCNN head's pooling
MLPs); the set-abstraction and feature-propagation modules and
``PointNet2MSG`` wait for PointRCNN (ROADMAP.md).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..model_utils.layers import BatchNorm, Dense


class SharedMLP(nn.Module):
    """Pointwise Dense (no bias) + BatchNorm (flax's momentum 0.99, eps
    1e-3, over every axis but the last) + ReLU stack, as the reference's
    1x1 Conv2d stacks; submodules ``mlp_i`` / ``bn_i``."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.n = len(channels)
        c_in = in_channels
        for i, c in enumerate(channels):
            self.add_module(f"mlp_{i}", Dense(c_in, c, bias=False,
                                              dtype=dtype))
            self.add_module(f"bn_{i}", BatchNorm(c, 1e-3, dtype=dtype,
                                                 channels_last=True))
            c_in = c
        self.out_channels = c_in

    def forward(self, x):
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"mlp_{i}")(x)))
        return x
