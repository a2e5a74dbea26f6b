"""PointNet++ primitives (torch counterpart of ``mssvt_tpu/ops/pointnet2.py``;
ref: pcdet/ops/pointnet2/ and ops/roipoint_pool3d/), on padded batch
tensors with validity masks. The ball query runs as one hand-written kernel
on the card (``kernels/ball_query.py``, ``csrc/ball_query.cu``) and as its
plain version on the CPU; everything else here is plain PyTorch on both
devices.

- :func:`ball_query`, :func:`group_points`, :func:`query_and_group`: the
  first ``nsample`` support points within a radius of each query, in index
  order, slot 0 replicated into the unfilled slots (ball_query_gpu.cu),
  and their grouped rows. Each ball query is the span ``mssvt.ball_query``.
- :func:`points_in_boxes`, :func:`roipoint_pool3d`: the first
  ``num_sampled_points`` points inside each box, wrapped modulo the count
  where fewer (roipoint_pool3d_kernel.cu:38-103).
- :func:`vector_pool`: PV-RCNN++'s local-grid mean pooling
  (vector_pool_gpu.cu).

The first-k fill of the RoI point pool (and of the ball query's plain
version) is a search, not a scatter (``kernels.ball_query.first_hits``):
every slot is written once, so the result is the same on every run. The
gathers of features go through ``sampling.gather_batch_rows`` (a
deterministic backward, however many picks a row collects: an empty query
picks row 0 ``nsample`` times).
"""

from __future__ import annotations

import torch

from ..kernels import ball_query as _ball_query
from ..kernels.ball_query import first_hits
from ..runtime import tracing
from .sampling import gather_batch_rows


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


def ball_query(radius: float, nsample: int, xyz, new_xyz, xyz_valid=None):
    """(B, N, 3) support points, (B, M, 3) queries -> idx (B, M, nsample)
    int32 (the first ``nsample`` support points with squared distance below
    ``radius ** 2``, in index order; the rest of the slots repeat slot 0,
    0 when none), empty (B, M) bool: ``kernels.ball_query``'s kernel on
    CUDA tensors (f32 only), its plain version on CPU tensors."""
    with tracing.span("ball_query"):
        return _ball_query.ball_query(radius, nsample, xyz, new_xyz,
                                      xyz_valid)


def query_and_group(radius, nsample, xyz, new_xyz, features=None,
                    xyz_valid=None, use_xyz=True):
    """:func:`ball_query` and :func:`group_points`: (grouped, empty)."""
    idx, empty = ball_query(radius, nsample, xyz, new_xyz, xyz_valid)
    return group_points(idx, empty, xyz, new_xyz, features, use_xyz), empty


def group_points(idx, empty, xyz, new_xyz, features=None, use_xyz=True):
    """The grouped (B, M, nsample, 3 [+ C]) rows of a ball query's (B, M,
    nsample) ``idx``: each neighbour's xyz relative to its query, then its
    features; zero for an ``empty`` query."""
    parts = []
    if use_xyz:
        parts.append(gather_batch_rows(xyz, idx) - new_xyz[:, :, None, :])
    if features is not None:
        parts.append(gather_batch_rows(features, idx))
    return torch.cat(parts, dim=-1) * (~empty)[..., None, None]


def roipoint_pool3d(points, point_features, boxes, num_sampled_points: int,
                    points_valid=None):
    """(B, N, 3) points, (B, N, C) features, (B, M, 7) boxes -> pooled (B,
    M, num_sampled_points, 3 + C) (the first points inside each box in
    index order, the slots past the box's count wrapping modulo it; zero
    for an empty box), empty (B, M) bool."""
    k = num_sampled_points
    inside = points_in_boxes(points.detach(), boxes.detach())  # (B, N, M)
    if points_valid is not None:
        inside &= points_valid[:, :, None]
    inside = inside.transpose(1, 2)  # (B, M, N)
    idx = first_hits(inside, k)
    count = torch.clamp(inside.sum(-1, dtype=torch.int32), max=k)
    empty = count == 0
    slot = torch.arange(k, device=idx.device, dtype=torch.int32)
    wrapped = slot % torch.clamp(count[..., None], min=1)
    idx = torch.where(idx >= 0, idx, torch.gather(idx, -1, wrapped.long()))
    idx = torch.clamp(idx, min=0)
    feat = torch.cat([points, point_features.to(points.dtype)], dim=-1)
    pooled = gather_batch_rows(feat, idx)  # (B, M, k, 3 + C)
    return pooled * (~empty)[..., None, None], empty


def vector_pool(queries_xyz, support_xyz, support_feat, support_valid,
                radius: float, nsample: int, grid: int = 2):
    """PV-RCNN++'s vector pool (ref: vector_pool_gpu.cu:19-433): each
    query's ball neighbours (:func:`ball_query`) fall into a ``grid`` ^ 3
    local grid over [-radius, radius] ^ 3; each cell's mean relative xyz
    and mean features, concatenated (zero where the cell is empty) ->
    pooled (B, M, grid ^ 3 * (3 + C)) f32, empty (B, M) bool."""
    idx, empty = ball_query(radius, nsample, support_xyz, queries_xyz,
                            support_valid)
    g = int(grid)
    rel = gather_batch_rows(support_xyz, idx) - queries_xyz[:, :, None, :]
    nb_feat = gather_batch_rows(support_feat, idx)
    # the replicated slots count once: slot j is real iff it is not slot 0's
    real = torch.cat([torch.ones_like(idx[..., :1], dtype=torch.bool),
                      idx[..., 1:] != idx[..., :1]], dim=-1) \
        & (~empty)[..., None]
    u = torch.clamp(((rel / radius + 1.0) * 0.5 * g).to(torch.int32), 0,
                    g - 1)
    cell = (u[..., 0] * g + u[..., 1]) * g + u[..., 2]
    cells = torch.arange(g ** 3, device=idx.device, dtype=torch.int32)
    onehot = ((cell[..., None] == cells) & real[..., None]).to(rel.dtype)
    cnt = onehot.sum(dim=2)  # (B, M, G3)
    inv = 1.0 / torch.clamp(cnt, min=1.0)
    mean_rel = torch.einsum("bmsg,bmsc->bmgc", onehot, rel) * inv[..., None]
    mean_feat = torch.einsum("bmsg,bmsc->bmgc", onehot.to(nb_feat.dtype),
                             nb_feat) * inv[..., None].to(nb_feat.dtype)
    out = torch.cat([mean_rel, mean_feat.to(rel.dtype)], dim=-1) \
        * (cnt > 0)[..., None]
    b, m = queries_xyz.shape[:2]
    return out.reshape(b, m, -1).float(), empty
