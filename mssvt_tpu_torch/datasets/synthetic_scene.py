"""Synthetic Waymo-scale scene: the recipe of ``make_waymo_scale_scene`` in
the repo's ``bench.py``, copied so the port does not import the JAX side.

~80k occupied voxels per frame with a LiDAR-like radial density falloff
around the grid centre, geometric z occupancy, random point features and
point counts, all from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import numpy as np


def make_waymo_scale_scene(max_voxels, grid, seed=0, batch=1):
    """Returns ({voxels (V, 5, 5) f32, voxel_num_points (V,) f32,
    voxel_coords (V, 4) int32 (b, z, y, x) -1 padded, voxel_valid (V,)
    bool}, number of live voxels); ``max_voxels`` is the all-batch
    capacity and frames are concatenated with their batch index."""
    rng = np.random.default_rng(seed)
    per = max_voxels // batch
    parts = []
    for b in range(batch):
        n_target = 80_000
        r = np.abs(rng.normal(0, 0.35, n_target * 2)) * grid[0] / 2
        theta = rng.uniform(0, 2 * np.pi, n_target * 2)
        x = (grid[0] / 2 + r * np.cos(theta)).astype(np.int64)
        y = (grid[1] / 2 + r * np.sin(theta)).astype(np.int64)
        z = np.clip(rng.geometric(0.25, n_target * 2) - 1, 0, grid[2] - 1)
        ok = (x >= 0) & (x < grid[0]) & (y >= 0) & (y < grid[1])
        coords = np.unique(
            np.stack([np.full_like(x[ok], b), z[ok], y[ok], x[ok]], 1), axis=0
        )[:per].astype(np.int32)
        parts.append(coords)
    coords = np.concatenate(parts, axis=0)
    n = len(coords)
    pad = np.full((max_voxels, 4), -1, np.int32)
    pad[:n] = coords
    valid = np.arange(max_voxels) < n
    voxels = rng.normal(size=(max_voxels, 5, 5)).astype(np.float32) \
        * valid[:, None, None]
    num_points = np.minimum(rng.poisson(3, max_voxels) + 1, 5).astype(
        np.float32) * valid
    return {
        "voxels": voxels,
        "voxel_num_points": num_points,
        "voxel_coords": pad,
        "voxel_valid": valid,
    }, n
