"""Sparse 3D -> dense BEV (torch counterpart of ``HeightCompression``,
``PointPillarScatter`` and ``Conv2DCollapse`` in
``mssvt_tpu/models/backbones_2d/map_to_bev.py``).

The public layout is NHWC, as in the JAX package; the convolutions run in
NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ..model_utils.layers import BatchNorm, Conv2d


class HeightCompression(nn.Module):
    def __init__(self, num_bev_features: int, compress_layer_nums: int = 3,
                 layer_strides: Sequence[int] = (1, 1, 1),
                 layer_dilations: Sequence[int] = (1, 1, 2),
                 layer_paddings: Sequence[int] = (1, 1, 2),
                 dtype=torch.float32):
        super().__init__()
        self.num_bev_features = num_bev_features
        self.compress_layer_nums = compress_layer_nums
        self.compute_dtype = dtype
        c = num_bev_features
        for i in range(compress_layer_nums):
            s, d, p = layer_strides[i], layer_dilations[i], layer_paddings[i]
            self.add_module(f"compress_conv_{i}", Conv2d(
                c, c, 3, stride=s, padding=p, dilation=d, bias=False,
                dtype=dtype))
            self.add_module(f"compress_bn_{i}", BatchNorm(
                c, 1e-5, momentum=0.9, dtype=dtype))

    def forward(self, sp: SparseVoxels) -> torch.Tensor:
        x = sp.bev()  # (B, H, W, D*C), z-major channels
        if x.shape[-1] != self.num_bev_features:
            raise ValueError(f"BEV feature dim {x.shape[-1]} != "
                             f"NUM_BEV_FEATURES {self.num_bev_features}")
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        for i in range(self.compress_layer_nums):
            x = getattr(self, f"compress_conv_{i}")(x)
            x = torch.relu(getattr(self, f"compress_bn_{i}")(x))
        return x.permute(0, 2, 3, 1).float()  # (B, H, W, C_bev)


class PointPillarScatter(nn.Module):
    """Pillar features onto the (B, ny, nx, C) BEV canvas (ref:
    pointpillar_scatter.py). Padding pillars go to a dump frame at index
    B that is sliced off (JAX's ``mode="drop"``)."""

    def __init__(self, num_bev_features: int, grid_size: Sequence[int]):
        super().__init__()
        self.num_bev_features = int(num_bev_features)
        self.grid_size = tuple(int(g) for g in grid_size)
        if self.grid_size[2] != 1:
            raise ValueError(f"PointPillarScatter needs nz == 1, got grid "
                             f"{self.grid_size}")

    def forward(self, pillar_features, coords, valid, batch_size: int):
        nx, ny, _ = self.grid_size
        b, y, x = (coords[:, i].long() for i in (0, 2, 3))
        b = torch.where(valid, b, batch_size)
        y = torch.where(valid, y, 0)
        x = torch.where(valid, x, 0)
        out = pillar_features.new_zeros((batch_size + 1, ny, nx,
                                         self.num_bev_features))
        out = out.index_put((b, y, x), pillar_features)
        return out[:batch_size]


class Conv2DCollapse(nn.Module):
    """A dense (B, X, Y, Z, C) camera-voxel grid collapsed to the (B, Y, X,
    C_bev) BEV map (ref: map_to_bev/conv2d_collapse.py:7): the channels
    stacked z-major, then c (Z * C of them), then a 1x1 conv, BN and ReLU;
    f32 out."""

    def __init__(self, in_channels: int, num_bev_features: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_bev_features = int(num_bev_features)
        self.compute_dtype = dtype
        self.collapse_conv = Conv2d(in_channels, num_bev_features, 1,
                                    bias=False, dtype=dtype)
        self.collapse_bn = BatchNorm(num_bev_features, 1e-3, momentum=0.99,
                                     dtype=dtype)

    def forward(self, voxel_features):
        b, gx, gy, gz, c = voxel_features.shape
        x = voxel_features.to(self.compute_dtype).permute(0, 3, 4, 2, 1)
        x = x.reshape(b, gz * c, gy, gx)  # NCHW of the (B, Y, X, Z*C) map
        x = torch.relu(self.collapse_bn(self.collapse_conv(x)))
        return x.permute(0, 2, 3, 1).float()
