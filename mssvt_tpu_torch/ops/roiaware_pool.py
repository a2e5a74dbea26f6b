"""RoI-aware 3D grid pooling (torch counterpart of
``mssvt_tpu/ops/roiaware_pool.py``; ref:
pcdet/ops/roiaware_pool3d/src/roiaware_pool3d_kernel.cu:111-261).

Each (RoI, point) pair finds its cell of the RoI's G^3 grid in the box's
canonical frame (boxes carry their centre z). Where the JAX module
broadcasts every point's features over every RoI and scatters into a dump
cell, this one compacts the pairs that fall inside (``nonzero``) and
reduces them by cell: the max is exact whatever the order, the sum is
:func:`ops.sampling.segment_sum` (a stable sort by cell, then fixed block
sums), so both are deterministic. The backward follows JAX's rules: the average's cotangent
divides by the cell's count; the max's goes to the pairs equal to the
cell's maximum, split evenly among them (the JVP of XLA's scatter-max);
each point sums its pairs' cotangents with ``segment_sum``.
"""

from __future__ import annotations

import torch

from .sampling import segment_sum


def _inside_pairs(points_xyz, points_valid, rois, roi_valid, g: int):
    """(cell (P,) flat over (B, R, G^3), point row (P,) flat over (B, N))
    of the inside pairs."""
    b, n, _ = points_xyz.shape
    r = rois.shape[1]
    local = points_xyz[:, None, :, :] - rois[:, :, None, :3]
    h = rois[..., 6][:, :, None]
    cos, sin = torch.cos(-h), torch.sin(-h)
    lx = local[..., 0] * cos - local[..., 1] * sin
    ly = local[..., 0] * sin + local[..., 1] * cos
    dims = rois[:, :, None, 3:6]
    u = [(lx / dims[..., 0] + 0.5) * g, (ly / dims[..., 1] + 0.5) * g,
         (local[..., 2] / dims[..., 2] + 0.5) * g]
    inside = points_valid[:, None, :] & roi_valid[:, :, None]
    for ua in u:
        inside = inside & (ua >= 0) & (ua < g)
    bi, ri, ni = inside.nonzero(as_tuple=True)
    cx, cy, cz = (ua[bi, ri, ni].to(torch.int64).clamp(0, g - 1) for ua in u)
    cell = ((bi * r + ri) * g ** 3) + (cx * g + cy) * g + cz
    return cell, bi * n + ni


class _RoIAwarePool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, cell, point, n_cells, pool):
        c = feats.shape[1]
        vals = feats[point]
        cnt = torch.zeros(n_cells, dtype=torch.int64, device=feats.device)
        cnt.index_add_(0, cell, torch.ones_like(cell))
        if pool == "max":
            pooled = torch.full((n_cells, c), float("-inf"), dtype=feats.dtype,
                                device=feats.device)
            pooled.scatter_reduce_(0, cell[:, None].expand(-1, c), vals,
                                   "amax")
            pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
            # pairs at their cell's maximum and their number a cell/channel
            at_max = vals == pooled[cell]
            ties = torch.zeros((n_cells, c), dtype=torch.int64,
                               device=feats.device)
            ties.index_add_(0, cell, at_max.long())
            ctx.save_for_backward(cell, point, at_max, ties)
        else:
            pooled = segment_sum(cell, vals, n_cells) / cnt.clamp(
                min=1)[:, None]
            ctx.save_for_backward(cell, point, cnt)
        ctx.meta = (pool, feats.shape[0], feats.dtype)
        return pooled.to(feats.dtype), cnt

    @staticmethod
    def backward(ctx, g, _g_cnt):
        pool, n_points, dtype = ctx.meta
        if pool == "max":
            cell, point, at_max, ties = ctx.saved_tensors
            per = torch.where(at_max, g[cell] / ties[cell].clamp(min=1), 0.0)
        else:
            cell, point, cnt = ctx.saved_tensors
            per = g[cell] / cnt.clamp(min=1)[cell, None]
        return (segment_sum(point, per, n_points).to(dtype), None, None, None,
                None)


def roiaware_pool3d(points_xyz, point_features, points_valid, rois, roi_valid,
                    grid_size: int, pool: str = "max"):
    """Pool (B, N, C) point features into each RoI's G^3 grid.

    Args: points_xyz (B, N, 3); point_features (B, N, C); points_valid
    (B, N) bool; rois (B, R, 7); roi_valid (B, R) bool; pool "max" or
    "avg". Returns (pooled (B, R, G, G, G, C) float32, zeros where empty;
    empty (B, R, G, G, G) bool); the grid axes are the box's (x, y, z)."""
    assert pool in ("max", "avg"), pool
    b, n, c = point_features.shape
    r, g = rois.shape[1], int(grid_size)
    with torch.no_grad():
        cell, point = _inside_pairs(points_xyz.float(), points_valid,
                                    rois.float(), roi_valid, g)
    n_cells = b * r * g ** 3
    pooled, cnt = _RoIAwarePool.apply(point_features.reshape(b * n, c), cell,
                                      point, n_cells, pool)
    empty = (cnt == 0).reshape(b, r, g, g, g)
    pooled = pooled.float().reshape(b, r, g, g, g, c)
    return pooled * (~empty)[..., None], empty
