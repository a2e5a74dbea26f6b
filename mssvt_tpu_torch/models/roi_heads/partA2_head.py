"""PartA2 RoI head (torch counterpart of
``mssvt_tpu/models/roi_heads/partA2_head.py``; ref:
pcdet/models/roi_heads/partA2_head.py).

RoI-aware pooling of the first stage's part predictions (average) and the
UNet's point features (max) into each RoI's G^3 grid, merged by dense 3D
convolutions (the pooled grids are dense; the second one strided, as the
reference max-pools the grid once), flattened into shared FC layers and
the class and box outputs.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ...ops.roiaware_pool import roiaware_pool3d
from ..model_utils.layers import BatchNorm, Conv3d, Dense, dropout


class PartA2FCHead(nn.Module):
    def __init__(self, model_cfg: Any, part_channels: int, seg_channels: int,
                 code_size: int = 7, dtype=torch.float32):
        super().__init__()
        self.grid = int(model_cfg.get("ROI_AWARE_POOL", {}).get("POOL_SIZE",
                                                                12))
        self.dp = float(model_cfg.get("DP_RATIO", 0.3))
        self.compute_dtype = dtype
        convs = list(model_cfg.get("CONV_CHANNELS", [64, 64]))
        c_in, g = part_channels + seg_channels, self.grid
        for i, ch in enumerate(convs):
            stride = 2 if i == 1 else 1
            self.add_module(f"conv3d_{i}", Conv3d(c_in, ch, 3, stride,
                                                  bias=False, dtype=dtype))
            self.add_module(f"conv3d_bn_{i}", BatchNorm(
                ch, 1e-3, dtype=dtype, channels_last=True))
            c_in, g = ch, -(-g // stride)
        self.n_conv = len(convs)
        c_in = c_in * g ** 3
        self.n_fc = len(model_cfg.get("SHARED_FC", [256, 256]))
        for i, fc in enumerate(model_cfg.get("SHARED_FC", [256, 256])):
            self.add_module(f"shared_fc_{i}", Dense(c_in, fc, bias=False,
                                                    dtype=dtype))
            self.add_module(f"shared_bn_{i}", BatchNorm(
                fc, 1e-3, dtype=dtype, channels_last=True))
            c_in = fc
        self.cls_out = Dense(c_in, 1, dtype=dtype)
        self.reg_out = Dense(c_in, code_size, dtype=dtype)

    def forward(self, points_xyz, part_feats, seg_feats, points_valid, rois,
                roi_valid, generator=None):
        """points_xyz (B, N, 3); part_feats (B, N, Cp) (sigmoid part and seg
        score); seg_feats (B, N, Cs) UNet features; rois (B, R, 7)."""
        g = self.grid
        part, _ = roiaware_pool3d(points_xyz, part_feats, points_valid, rois,
                                  roi_valid, g, "avg")
        seg, _ = roiaware_pool3d(points_xyz, seg_feats, points_valid, rois,
                                 roi_valid, g, "max")
        b, r = rois.shape[:2]
        x = torch.cat([part, seg], dim=-1).reshape(b * r, g, g, g, -1)
        x = x.to(self.compute_dtype)
        for i in range(self.n_conv):
            x = torch.relu(getattr(self, f"conv3d_bn_{i}")(
                getattr(self, f"conv3d_{i}")(x)))
        x = x.reshape(b, r, -1)
        for i in range(self.n_fc):
            x = getattr(self, f"shared_bn_{i}")(
                getattr(self, f"shared_fc_{i}")(x))
            x = dropout(torch.relu(x), self.dp, self.training, generator)
        m = roi_valid.to(torch.float32)
        return (self.cls_out(x)[..., 0].float() * m,
                self.reg_out(x).float() * m[..., None])
