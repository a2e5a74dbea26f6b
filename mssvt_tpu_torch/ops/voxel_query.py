"""Voxel neighbourhood query (torch counterpart of
``mssvt_tpu/ops/voxel_query.py``; ref:
pcdet/ops/pointnet2/pointnet2_stack/src/voxel_query_gpu.cu:10-90 and
voxel_query_utils.py:10-51).

For every query point: walk the dense z-y-x neighbourhood of its cell
(+-max_range a dimension, z-major as the CUDA triple loop), look each cell
up in the stage's dense cell -> row table, keep the voxels whose centre
lies within ``radius`` of the query, and return the rows of the first
``nsample`` in traversal order; empty slots repeat the first hit, and a
query with no hit takes row 0 (its outputs are zeroed by the caller).

The neighbour keys and the centres' squared distances are built from
per-axis terms broadcast over the offsets (the neighbour voxel's centre is
its cell's, so no (B, Q, K, 3) gather of centres is needed); the first
``nsample`` hits are an exclusive cumsum rank, written to their slots.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.index import build_dense_row_table, lookup_dense


def _neighborhood_offsets(max_range: Sequence[int]) -> np.ndarray:
    """(K, 3) zyx offsets in the CUDA kernel's z-major traversal order."""
    rz, ry, rx = (int(r) for r in max_range)
    return np.asarray([(dz, dy, dx) for dz in range(-rz, rz + 1)
                       for dy in range(-ry, ry + 1)
                       for dx in range(-rx, rx + 1)], np.int32)


def voxel_query(queries_xyz, coords, valid, spatial_shape: Tuple[int, int, int],
                voxel_size: Sequence[float], point_cloud_range: Sequence[float],
                max_range: Sequence[int], radius: float, nsample: int,
                batch_size: int):
    """(B, Q, 3) metric queries against a stage's (V, 4) (b, z, y, x)
    coords -> (idx (B, Q, nsample) int32 global rows, empty (B, Q) bool).
    ``max_range`` is (z, y, x) in cells, ``spatial_shape`` the stage grid
    (x, y, z)."""
    b, q, _ = queries_xyz.shape
    dev = queries_xyz.device
    vs = torch.tensor([float(v) for v in voxel_size], dtype=torch.float32,
                      device=dev)
    mins = torch.tensor([float(v) for v in point_cloud_range[:3]],
                        dtype=torch.float32, device=dev)
    qx = queries_xyz.detach().float()
    cell = torch.floor((qx - mins) / vs).to(torch.int32)  # (B, Q, 3) xyz
    dims = [int(s) for s in spatial_shape]
    radii = [int(r) for r in max_range][::-1]  # xyz
    # per axis (B, Q, 2r+1): neighbour cell, in range, key term, squared
    # distance of the cell's centre to the query
    terms = []
    strides = (dims[1] * dims[2], dims[2], 1)
    for a in range(3):
        off = torch.arange(-radii[a], radii[a] + 1, dtype=torch.int32,
                           device=dev)
        nb = cell[..., a:a + 1] + off
        ok = (nb >= 0) & (nb < dims[a])
        ctr = (nb.float() + 0.5) * vs[a] + mins[a]
        terms.append((ok, nb.long() * strides[a],
                      (ctr - qx[..., a:a + 1]) ** 2))
    (okx, kx, dx), (oky, ky, dy), (okz, kz, dz) = terms
    # broadcast to (B, Q, nz, ny, nx): z-major traversal, x fastest
    xs = lambda t: t[:, :, None, None, :]
    ys = lambda t: t[:, :, None, :, None]
    zs = lambda t: t[:, :, :, None, None]
    base = (torch.arange(b, device=dev).long() * (dims[0] * dims[1] * dims[2]))
    keys = (base[:, None, None, None, None] + xs(kx) + ys(ky) + zs(kz))
    inb = xs(okx) & ys(oky) & zs(okz)
    table = build_dense_row_table(coords, valid, spatial_shape, batch_size)
    rows = lookup_dense(table, torch.where(inb, keys, -1)).reshape(b, q, -1)
    d2 = ((xs(dx) + ys(dy)) + zs(dz)).reshape(b, q, -1)
    hit = (rows >= 0) & (d2 < float(radius) ** 2)
    hit_i = hit.to(torch.int32)
    rank = torch.cumsum(hit_i, dim=-1, dtype=torch.int32) - hit_i
    keep = hit & (rank < nsample)
    dest = torch.where(keep, rank, nsample).long()
    out = torch.full((b, q, nsample + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(2, dest, torch.where(keep, rows, -1))
    idx = out[..., :nsample]
    first = idx[..., :1]
    empty = first[..., 0] < 0
    idx = torch.where(idx >= 0, idx, first.clamp(min=0))
    return idx, empty
