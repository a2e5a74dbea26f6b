"""Sparse 3D -> dense BEV (torch counterpart of ``HeightCompression`` in
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
