"""BEV-grid RoI refinement head (torch counterpart of
``mssvt_tpu/models/roi_heads/bev_grid_head.py``; ref:
pcdet/models/roi_heads/second_head.py): bilinear samples of the BEV map at
a G x G grid inside each rotated RoI, flattened, through shared FC layers
into a class logit and box residuals.

The bilinear corners are picked with :func:`ops.sampling.gather_rows`:
the grid points of overlapping RoIs share cells, and its backward sums a
cell's picks deterministically in parallel.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...ops.sampling import gather_rows
from ..model_utils.layers import Dense, dropout


def roi_grid_points_bev(rois, grid_size: int):
    """(..., R, 7) RoIs -> (..., R, G*G, 2) metric xy of a G x G grid of
    cell centres inside each box (x-major)."""
    g = grid_size
    u = (torch.arange(g, dtype=torch.float32, device=rois.device) + 0.5) / g \
        - 0.5
    gx, gy = torch.meshgrid(u, u, indexing="ij")
    local = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    p = local * rois[..., 3:5][..., None, :]
    c = torch.cos(rois[..., 6])[..., None]
    s = torch.sin(rois[..., 6])[..., None]
    x = p[..., 0] * c - p[..., 1] * s + rois[..., 0:1]
    y = p[..., 0] * s + p[..., 1] * c + rois[..., 1:2]
    return torch.stack([x, y], dim=-1)


def bilinear_sample_bev(features, pts_xy, point_cloud_range,
                        bev_stride_metric):
    """(B, H, W, C) NHWC features at (B, P, 2) metric xy -> (B, P, C);
    corners off the map read zeros."""
    b, h, w, c = features.shape
    sx, sy = bev_stride_metric
    fx = (pts_xy[..., 0] - point_cloud_range[0]) / sx - 0.5
    fy = (pts_xy[..., 1] - point_cloud_range[1]) / sy - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    flat = features.reshape(b * h * w, c)
    base = (torch.arange(b, device=features.device) * (h * w))[:, None]

    def corner(yi, xi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi = xi.clamp(0, w - 1).long()
        yi = yi.clamp(0, h - 1).long()
        return gather_rows(flat, base + yi * w + xi) * ok[..., None]

    return (corner(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
            + corner(y0, x0 + 1) * (wx * (1 - wy))[..., None]
            + corner(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
            + corner(y0 + 1, x0 + 1) * (wx * wy)[..., None])


class BEVGridRoIHead(nn.Module):
    """Grid-pooled BEV features a RoI -> ``shared_fc_i`` (+ ReLU, dropout
    ``DP_RATIO``) -> ``cls_out`` (1) and ``reg_out`` (code_size); outputs
    zeroed where the RoI is not valid."""

    def __init__(self, model_cfg: Any, input_channels: int,
                 point_cloud_range: Sequence[float],
                 bev_stride_metric: Sequence[float], code_size: int = 7,
                 dtype=torch.float32):
        super().__init__()
        self.grid = int(model_cfg.get("GRID_SIZE", 6))
        self.dp = float(model_cfg.get("DP_RATIO", 0.3))
        self.point_cloud_range = tuple(point_cloud_range)
        self.bev_stride_metric = tuple(bev_stride_metric)
        self.compute_dtype = dtype
        c_in = self.grid ** 2 * input_channels
        self.n_fc = len(model_cfg.get("SHARED_FC", [256, 256]))
        for i, fc in enumerate(model_cfg.get("SHARED_FC", [256, 256])):
            self.add_module(f"shared_fc_{i}", Dense(c_in, fc, dtype=dtype))
            c_in = fc
        self.cls_out = Dense(c_in, 1, dtype=dtype)
        self.reg_out = Dense(c_in, code_size, dtype=dtype)

    def forward(self, bev_features, rois, roi_valid, generator=None):
        g = self.grid
        b, r = rois.shape[:2]
        pts = roi_grid_points_bev(rois, g).reshape(b, r * g * g, 2)
        x = bilinear_sample_bev(bev_features, pts, self.point_cloud_range,
                                self.bev_stride_metric)
        x = x.reshape(b, r, g * g * bev_features.shape[-1])
        x = x.to(self.compute_dtype)
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f"shared_fc_{i}")(x))
            x = dropout(x, self.dp, self.training, generator)
        m = roi_valid.to(torch.float32)
        cls = self.cls_out(x)[..., 0].float() * m
        reg = self.reg_out(x).float() * m[..., None]
        return cls, reg
