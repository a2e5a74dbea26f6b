"""PV-RCNN RoI head (torch counterpart of
``mssvt_tpu/models/roi_heads/pvrcnn_head.py``; ref:
pcdet/models/roi_heads/pvrcnn_head.py).

A G^3 grid of points inside each RoI (:func:`roi_grid_points_3d`, also the
VoxelRCNN head's) pools the keypoint features: each grid point's ball
query over the keypoints, (relative xyz, features) through a shared MLP a
radius (``pool_mlp_i``), max over the neighbours; the grids flattened into
shared FC layers (Dense, BatchNorm, ReLU, dropout) and the class and box
outputs. The grid points carry the RoIs' gradient (the relative xyz
subtracts them). The keypoint features are picked through
``sampling.gather_batch_rows``: 128 RoIs x 216 grid points x 16 samples a
frame land on 2 048 keypoints, and an empty grid point picks keypoint 0
sixteen times.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ...ops.pointnet2 import query_and_group
from ..backbones_3d.pointnet2_backbone import SharedMLP, pool_max
from ..model_utils.layers import BatchNorm, Dense, dropout


def roi_grid_points_3d(rois, grid_size: int):
    """(B, R, 7) RoIs -> (B, R, G^3, 3) metric xyz of a G^3 grid of cell
    centres inside each box (x-major, then y, then z)."""
    g = grid_size
    u = (torch.arange(g, dtype=torch.float32, device=rois.device) + 0.5) / g \
        - 0.5
    gx, gy, gz = torch.meshgrid(u, u, u, indexing="ij")
    local = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    p = local * rois[..., None, 3:6]
    c = torch.cos(rois[..., 6])[..., None]
    s = torch.sin(rois[..., 6])[..., None]
    x = p[..., 0] * c - p[..., 1] * s + rois[..., 0:1]
    y = p[..., 0] * s + p[..., 1] * c + rois[..., 1:2]
    z = p[..., 2] + rois[..., 2:3]
    return torch.stack([x, y, z], dim=-1)


class PVRCNNHead(nn.Module):
    """Ref: pvrcnn_head.py PVRCNNHead; ``input_channels`` is the keypoint
    feature width."""

    def __init__(self, model_cfg: Any, input_channels: int,
                 code_size: int = 7, dtype=torch.float32):
        super().__init__()
        self.grid = int(model_cfg.get("GRID_SIZE", 6))
        self.dp = float(model_cfg.get("DP_RATIO", 0.3))
        pool = model_cfg["ROI_GRID_POOL"]
        self.pool = list(zip(pool["POOL_RADIUS"], pool["NSAMPLE"]))
        c_pool = 0
        for i, mlp in enumerate(pool["MLPS"]):
            mod = SharedMLP(3 + input_channels, mlp, dtype=dtype)
            self.add_module(f"pool_mlp_{i}", mod)
            c_pool += mod.out_channels
        c_in = c_pool * self.grid ** 3
        fcs = model_cfg.get("SHARED_FC", [256, 256])
        self.n_fc = len(fcs)
        for i, fc in enumerate(fcs):
            self.add_module(f"shared_fc_{i}", Dense(c_in, fc, bias=False,
                                                    dtype=dtype))
            self.add_module(f"shared_bn_{i}", BatchNorm(
                fc, 1e-3, dtype=dtype, channels_last=True))
            c_in = fc
        self.cls_out = Dense(c_in, 1, dtype=dtype)
        self.reg_out = Dense(c_in, code_size, dtype=dtype)

    def forward(self, keypoints, kp_features, rois, roi_valid,
                generator=None):
        """keypoints (B, K, 3), their features (B, K, C), rois (B, R, 7) ->
        (cls (B, R), reg (B, R, code_size)), zeroed where the RoI is not
        valid."""
        g = self.grid
        b, r = rois.shape[:2]
        grid_pts = roi_grid_points_3d(rois, g).reshape(b, r * g ** 3, 3)
        pooled = []
        for i, (rad, ns) in enumerate(self.pool):
            grouped, empty = query_and_group(float(rad), int(ns), keypoints,
                                             grid_pts, kp_features)
            pooled.append(pool_max(getattr(self, f"pool_mlp_{i}")(grouped),
                                   empty))
        x = torch.cat(pooled, dim=-1).reshape(b, r, -1)
        for i in range(self.n_fc):
            x = getattr(self, f"shared_bn_{i}")(
                getattr(self, f"shared_fc_{i}")(x))
            x = dropout(torch.relu(x), self.dp, self.training, generator)
        m = roi_valid.to(torch.float32)
        return (self.cls_out(x)[..., 0].float() * m,
                self.reg_out(x).float() * m[..., None])
