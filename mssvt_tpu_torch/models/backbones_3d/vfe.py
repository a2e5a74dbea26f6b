"""Voxel feature encoder of the MsSVT path (torch counterpart of
``MeanVFE`` in ``mssvt_tpu/models/backbones_3d/vfe.py``)."""

from __future__ import annotations

import torch
from torch import nn


class MeanVFE(nn.Module):
    """Mean of the (zero-padded) points in each voxel."""

    def forward(self, voxels, voxel_num_points):
        # voxels: (V, P, C); voxel_num_points: (V,)
        n = torch.clamp(voxel_num_points.to(voxels.dtype), min=1.0)
        return voxels.sum(dim=1) / n[:, None]
