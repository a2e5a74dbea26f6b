"""Static-capacity sparse voxel tensor (torch counterpart of
``mssvt_tpu/core/sparse.py``).

Rows past the live voxels are padding: features zero, coords -1, valid
False. Geometry (grid, voxel size, range) is plain Python metadata.
``index`` is the sorted-key :class:`~mssvt_tpu_torch.core.index.VoxelIndex`
that the sparse convolutions look neighbours up in, or None.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from .index import VoxelIndex, build_index, _check_key_capacity


@dataclass(frozen=True)
class SparseVoxels:
    features: torch.Tensor  # (max_voxels, C)
    coords: torch.Tensor    # (max_voxels, 4) int32 (b, z, y, x), -1 padded
    valid: torch.Tensor     # (max_voxels,) bool
    batch_size: int
    spatial_shape: Tuple[int, int, int]  # (x, y, z)
    voxel_size: Tuple[float, float, float]
    point_cloud_range: Tuple[float, ...]
    index: Optional[VoxelIndex] = None

    @classmethod
    def create(cls, features, coords, valid, batch_size, spatial_shape,
               voxel_size, point_cloud_range,
               with_index: bool = True) -> "SparseVoxels":
        """``with_index=False`` skips the sorted-key index (one sort over
        the rows) for consumers that use only the dense window tables, the
        MsSVT path; the sparse convolutions need it."""
        spatial_shape = tuple(int(s) for s in spatial_shape)
        index = None
        if with_index:
            _check_key_capacity(int(batch_size), spatial_shape)
            index = build_index(coords, valid, spatial_shape)
        return cls(features, coords, valid, int(batch_size), spatial_shape,
                   tuple(float(v) for v in voxel_size),
                   tuple(float(v) for v in point_cloud_range), index)

    @property
    def max_voxels(self) -> int:
        return self.features.shape[0]

    @property
    def num_features(self) -> int:
        return self.features.shape[1]

    def with_features(self, features) -> "SparseVoxels":
        return replace(self, features=features)

    def metric_centers(self) -> torch.Tensor:
        """(max_voxels, 3) metric x, y, z of each voxel's centre."""
        xyz = self.coords[:, [3, 2, 1]].to(torch.float32)
        # python scalars (cast to f32 in the kernel): no host copy, no sync
        return torch.stack([(xyz[:, i] + 0.5) * self.voxel_size[i]
                            + self.point_cloud_range[i] for i in range(3)],
                           dim=-1)

    def per_sample(self, max_per_sample=None):
        """The flat rows re-laid out per frame: (xyz (B, M, 3) metric
        centres, features (B, M, C), valid (B, M)), M = ``max_per_sample``
        (default max_voxels). Each row goes to its frame at its rank among
        the frame's live rows (any row order, e.g. globally compacted
        sites); rows past M in a frame are dropped."""
        m = max_per_sample or self.max_voxels
        b, v = self.batch_size, self.max_voxels
        dev = self.coords.device
        bidx = torch.where(self.valid, self.coords[:, 0].long(), b)
        onehot = ((bidx[:, None] == torch.arange(b, device=dev)[None, :])
                  & self.valid[:, None]).to(torch.int64)
        excl = torch.cumsum(onehot, dim=0) - onehot
        rank = torch.gather(excl, 1, bidx.clamp(0, b - 1)[:, None])[:, 0]
        ok = self.valid & (rank < m)
        dest = torch.where(ok, bidx * m + rank, b * m)  # b * m: a spare row

        def scatter(x, width, dtype):
            out = torch.zeros((b * m + 1, width), dtype=dtype, device=dev)
            out[dest] = x.reshape(v, width).to(dtype)
            return out[:b * m].reshape(b, m, width)

        xyz = scatter(self.metric_centers(), 3, torch.float32)
        feats = scatter(self.features, self.num_features, self.features.dtype)
        valid = scatter(ok, 1, torch.bool)[..., 0]
        return xyz, feats, valid

    def dense(self, channels_last: bool = True) -> torch.Tensor:
        """A dense (B, D, H, W, C) grid (zeros where empty), or (B, C, D, H,
        W) with ``channels_last=False`` (ref: mssvt_utils.py:50-62)."""
        x_max, y_max, z_max = self.spatial_shape
        b, z, y, x = (self.coords[:, i].long() for i in range(4))
        b = torch.where(self.valid, b, self.batch_size)  # padding: spare slot
        z, y, x = (torch.where(self.valid, t, 0) for t in (z, y, x))
        out = torch.zeros((self.batch_size + 1, z_max, y_max, x_max,
                           self.num_features), dtype=self.features.dtype,
                          device=self.features.device)
        out[b, z, y, x] = self.features
        out = out[:self.batch_size]
        return out if channels_last else out.permute(0, 4, 1, 2, 3)

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
