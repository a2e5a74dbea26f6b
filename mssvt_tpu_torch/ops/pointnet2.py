"""PointNet++ primitives (torch counterpart of ``mssvt_tpu/ops/pointnet2.py``).

Only :func:`points_in_boxes` is ported so far (PartA2's point targets);
``ball_query``, ``query_and_group``, ``roipoint_pool3d`` and
``vector_pool`` wait for PV-RCNN and PointRCNN (ROADMAP.md).
"""

from __future__ import annotations

import torch


def points_in_boxes(points, boxes):
    """(..., N, 3) points x (..., M, 7) boxes -> (..., N, M) bool: inside
    the box, its faces included (ref:
    ops/roiaware_pool3d/src/roiaware_pool3d_kernel.cu:313)."""
    local = points[..., :, None, :] - boxes[..., None, :, 0:3]
    c = torch.cos(-boxes[..., 6])[..., None, :]
    s = torch.sin(-boxes[..., 6])[..., None, :]
    lx = local[..., 0] * c - local[..., 1] * s
    ly = local[..., 0] * s + local[..., 1] * c
    lz = local[..., 2]
    half = boxes[..., None, :, 3:6] / 2
    return ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1])
            & (lz.abs() <= half[..., 2]))
