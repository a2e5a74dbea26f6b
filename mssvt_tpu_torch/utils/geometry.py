"""Numpy geometry helpers shared by the data pipeline and evaluation (the
port's copy of ``mssvt_tpu/utils/geometry.py``; ref pcdet/utils/
common_utils.py and box_utils.py, host-side numpy versions).
"""

from __future__ import annotations

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    """Ref: common_utils.py:21-33."""
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """Rotate (N, 3+) points by per-call scalar angle about +z.

    Ref: common_utils.py:35-63 (batched torch version); this is the host
    single-cloud variant.
    """
    cosa, sina = np.cos(angle), np.sin(angle)
    rot = np.array([[cosa, sina, 0], [-sina, cosa, 0], [0, 0, 1]], points.dtype)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot
    return out


def boxes_to_corners_3d(boxes):
    """(N, 7) → (N, 8, 3) corners (ref: box_utils.py boxes_to_corners_3d)."""
    template = np.array([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ], np.float32) / 2
    corners = boxes[:, None, 3:6] * template[None]  # (N, 8, 3)
    angle = boxes[:, 6]
    cosa, sina = np.cos(angle), np.sin(angle)
    x = corners[..., 0] * cosa[:, None] - corners[..., 1] * sina[:, None]
    y = corners[..., 0] * sina[:, None] + corners[..., 1] * cosa[:, None]
    out = np.stack([x, y, corners[..., 2]], axis=-1)
    return out + boxes[:, None, 0:3]


def points_in_boxes_numpy(points, boxes):
    """(N, 3) x (M, 7) → (N, M) bool membership matrix.

    Host equivalent of ``points_in_boxes_gpu``
    (ref: ops/roiaware_pool3d/src/roiaware_pool3d_kernel.cu:313), used by
    GT-database creation (ref: waymo_dataset.py:363-366).
    """
    if len(boxes) == 0:
        return np.zeros((len(points), 0), bool)
    xyz = points[:, :3]
    local = xyz[:, None, :] - boxes[None, :, 0:3]  # (N, M, 3)
    cosa = np.cos(-boxes[:, 6])
    sina = np.sin(-boxes[:, 6])
    lx = local[..., 0] * cosa[None] - local[..., 1] * sina[None]
    ly = local[..., 0] * sina[None] + local[..., 1] * cosa[None]
    lz = local[..., 2]
    half = boxes[:, 3:6] / 2
    return (
        (np.abs(lx) <= half[None, :, 0])
        & (np.abs(ly) <= half[None, :, 1])
        & (np.abs(lz) <= half[None, :, 2])
    )


def mask_points_in_boxes(points, boxes, margin=0.0):
    """Boolean (N,) mask of points inside any of the (M, 7) boxes.

    Host equivalent of ``points_in_boxes_cpu``
    (ref: ops/roiaware_pool3d/src/roiaware_pool3d.cpp).
    """
    if len(boxes) == 0:
        return np.zeros(len(points), bool)
    xyz = points[:, :3]
    local = xyz[:, None, :] - boxes[None, :, 0:3]  # (N, M, 3)
    cosa = np.cos(-boxes[:, 6])
    sina = np.sin(-boxes[:, 6])
    lx = local[..., 0] * cosa[None] - local[..., 1] * sina[None]
    ly = local[..., 0] * sina[None] + local[..., 1] * cosa[None]
    lz = local[..., 2]
    half = boxes[:, 3:6] / 2 + margin
    inside = (
        (np.abs(lx) <= half[None, :, 0])
        & (np.abs(ly) <= half[None, :, 1])
        & (np.abs(lz) <= half[None, :, 2])
    )
    return inside.any(axis=1)
