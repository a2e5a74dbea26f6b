"""Static-capacity sparse voxel tensor (torch counterpart of
``mssvt_tpu/core/sparse.py``).

Rows past the live voxels are padding: features zero, coords -1, valid
False. Geometry (grid, voxel size, range) is plain Python metadata.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch


@dataclass(frozen=True)
class SparseVoxels:
    features: torch.Tensor  # (max_voxels, C)
    coords: torch.Tensor    # (max_voxels, 4) int32 (b, z, y, x), -1 padded
    valid: torch.Tensor     # (max_voxels,) bool
    batch_size: int
    spatial_shape: Tuple[int, int, int]  # (x, y, z)
    voxel_size: Tuple[float, float, float]
    point_cloud_range: Tuple[float, ...]

    @classmethod
    def create(cls, features, coords, valid, batch_size, spatial_shape,
               voxel_size, point_cloud_range) -> "SparseVoxels":
        return cls(features, coords, valid, int(batch_size),
                   tuple(int(s) for s in spatial_shape),
                   tuple(float(v) for v in voxel_size),
                   tuple(float(v) for v in point_cloud_range))

    @property
    def max_voxels(self) -> int:
        return self.features.shape[0]

    def with_features(self, features) -> "SparseVoxels":
        return replace(self, features=features)

    def bev(self) -> torch.Tensor:
        """Direct (B, H, W, D*C) BEV scatter, z-major channels: channel block
        ``d*C:(d+1)*C`` holds depth slice z = d (the JAX package's layout,
        not pcdet's channel-major ``c*D + d``). Padding rows go to a scratch
        batch slot that is sliced off."""
        x_max, y_max, z_max = self.spatial_shape
        c = self.features.shape[1]
        b, z, y, x = (self.coords[:, i].long() for i in range(4))
        b = torch.where(self.valid, b, self.batch_size)
        y = torch.where(self.valid, y, 0)
        x = torch.where(self.valid, x, 0)
        z = torch.where(self.valid, z, 0)
        out = torch.zeros((self.batch_size + 1, y_max, x_max, z_max, c),
                          dtype=self.features.dtype,
                          device=self.features.device)
        out[b, y, x, z] = self.features
        return out[:self.batch_size].reshape(
            self.batch_size, y_max, x_max, z_max * c)
