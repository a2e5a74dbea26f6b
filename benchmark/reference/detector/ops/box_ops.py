"""Rotated BEV box geometry (torch counterpart of
``mssvt_tpu/ops/box_ops.py``): each quad edge is clipped to the other
quad's four half-planes as a parameter interval and the shoelace sum runs
over the retained sub-segments. Boxes are (x, y, z, dx, dy, dz, heading).
Leading batch dimensions broadcast. The BEV IoU serves NMS and the GT
sampler's collision test, the 3D IoU the eval loop's recall.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def boxes_to_corners_bev(boxes):
    """(..., 7) -> (..., 4, 2) BEV corners, counter-clockwise."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy, heading = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    cos, sin = torch.cos(heading), torch.sin(heading)
    lx = torch.stack([dx, -dx, -dx, dx], dim=-1) / 2
    ly = torch.stack([dy, dy, -dy, -dy], dim=-1) / 2
    cx = lx * cos[..., None] - ly * sin[..., None] + x[..., None]
    cy = lx * sin[..., None] + ly * cos[..., None] + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def _clipped_edge_cross_sum(p0, d, h0, he, bound: float):
    shape = torch.broadcast_shapes(p0.shape, d.shape, h0.shape, he.shape)[:-1]
    t0 = torch.zeros(shape, dtype=d.dtype, device=d.device)
    t1 = torch.ones(shape, dtype=d.dtype, device=d.device)
    dead = torch.zeros(shape, dtype=torch.bool, device=d.device)
    for k in range(4):
        hk = h0[..., k:k + 1, :]
        ek = he[..., k:k + 1, :]
        rel = p0 - hk
        num = ek[..., 0] * rel[..., 1] - ek[..., 1] * rel[..., 0]
        den = ek[..., 0] * d[..., 1] - ek[..., 1] * d[..., 0]
        safe = torch.where(den.abs() < EPS,
                           torch.where(den >= 0, EPS, -EPS), den)
        tc = (bound - num) / safe
        t0 = torch.maximum(t0, torch.where(den > EPS, tc, 0.0))
        t1 = torch.minimum(t1, torch.where(den < -EPS, tc, 1.0))
        kill = (den.abs() <= EPS) & (num < bound)
        if bound > 0:
            collinear = (den.abs() <= EPS) & (num.abs() <= EPS)
            anti = (d[..., 0] * ek[..., 0] + d[..., 1] * ek[..., 1]) < 0
            kill = kill & ~(collinear & anti)
        dead = dead | kill
    t0 = t0.clamp(0.0, 1.0)
    t1 = t1.clamp(0.0, 1.0)
    alive = (~dead) & (t1 > t0)
    p1 = p0 + t0[..., None] * d
    p2 = p0 + t1[..., None] * d
    cr = p1[..., 0] * p2[..., 1] - p1[..., 1] * p2[..., 0]
    return torch.where(alive, cr, 0.0).sum(dim=-1)


def rotated_intersection_area(ca, cb):
    """Intersection area of two batches of convex ccw quads (..., 4, 2).

    Closed interior for the A pass, open for the B pass: a boundary segment
    shared by both quads is counted exactly once.
    """
    da = torch.roll(ca, -1, dims=-2) - ca
    db = torch.roll(cb, -1, dims=-2) - cb
    total = (_clipped_edge_cross_sum(ca, da, cb, db, -EPS)
             + _clipped_edge_cross_sum(cb, db, ca, da, EPS))
    return 0.5 * total.abs()


def _inter_area_pairwise(ca, cb):
    """(..., N, 4, 2) x (..., M, 4, 2) -> (..., N, M) intersection areas."""
    da = torch.roll(ca, -1, dims=-2) - ca
    db = torch.roll(cb, -1, dims=-2) - cb
    ca_, da_ = ca[..., :, None, :, :], da[..., :, None, :, :]
    cb_, db_ = cb[..., None, :, :, :], db[..., None, :, :, :]
    total = (_clipped_edge_cross_sum(ca_, da_, cb_, db_, -EPS)
             + _clipped_edge_cross_sum(cb_, db_, ca_, da_, EPS))
    return 0.5 * total.abs()


def pairwise_iou_bev(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV IoU."""
    inter = _inter_area_pairwise(boxes_to_corners_bev(boxes_a),
                                 boxes_to_corners_bev(boxes_b))
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def pairwise_iou_3d(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) 3D IoU: the rotated BEV intersection times
    the z overlap, over the union of the volumes."""
    inter_bev = _inter_area_pairwise(boxes_to_corners_bev(boxes_a),
                                     boxes_to_corners_bev(boxes_b))
    za0 = boxes_a[..., 2] - boxes_a[..., 5] / 2
    za1 = boxes_a[..., 2] + boxes_a[..., 5] / 2
    zb0 = boxes_b[..., 2] - boxes_b[..., 5] / 2
    zb1 = boxes_b[..., 2] + boxes_b[..., 5] / 2
    zo = torch.clamp(torch.minimum(za1[..., :, None], zb1[..., None, :])
                     - torch.maximum(za0[..., :, None], zb0[..., None, :]),
                     min=0)
    inter = inter_bev * zo
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-6)
