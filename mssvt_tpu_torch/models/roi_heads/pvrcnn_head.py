"""PV-RCNN RoI head pieces (torch counterpart of
``mssvt_tpu/models/roi_heads/pvrcnn_head.py``).

Only :func:`roi_grid_points_3d` is ported so far (the VoxelRCNN head's
grid); ``PVRCNNHead`` waits for PV-RCNN (ROADMAP.md).
"""

from __future__ import annotations

import torch


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
