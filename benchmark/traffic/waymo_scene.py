"""Waymo-scale voxel batches: a frozen copy of the port's
``datasets/synthetic_scene.make_waymo_scale_scene`` recipe (itself
``bench.py``'s), so that the yardstick does not move with the program.

Each frame draws ``2 x voxels_target`` voxel sites of a ``grid`` with a
LiDAR-like radial falloff around the grid centre and geometric z
occupancy, and keeps the first ``max_voxels / batch`` distinct ones (at
the Waymo grid and 80 000 target the cap binds: 90 000 a frame), with
random point features (``points_per_voxel`` x ``point_features``) and
point counts. Frames are concatenated with their batch index into one padded
(``voxels_per_frame`` x batch) capacity. Batch ``i`` of a run draws from
``numpy.random.default_rng(SeedSequence([seed, i]))``.
"""

from __future__ import annotations

import numpy as np


def waymo_scale_scene(rng, max_voxels, grid, batch, voxels_target,
                      points_per_voxel, point_features):
    """({voxels, voxel_num_points, voxel_coords (b, z, y, x) -1 padded,
    voxel_valid}, live voxels) of one batch (``bench.py``'s recipe)."""
    per = max_voxels // batch
    parts = []
    for b in range(batch):
        r = np.abs(rng.normal(0, 0.35, voxels_target * 2)) * grid[0] / 2
        theta = rng.uniform(0, 2 * np.pi, voxels_target * 2)
        x = (grid[0] / 2 + r * np.cos(theta)).astype(np.int64)
        y = (grid[1] / 2 + r * np.sin(theta)).astype(np.int64)
        z = np.clip(rng.geometric(0.25, voxels_target * 2) - 1, 0,
                    grid[2] - 1)
        ok = (x >= 0) & (x < grid[0]) & (y >= 0) & (y < grid[1])
        # the recipe's np.unique(axis=0) over (b, z, y, x) rows, as one
        # mixed-radix key (the same order, a 1-D sort)
        key = np.unique((z[ok] * grid[1] + y[ok]) * grid[0] + x[ok])[:per]
        coords = np.stack([np.full_like(key, b), key // (grid[0] * grid[1]),
                           key // grid[0] % grid[1], key % grid[0]],
                          1).astype(np.int32)
        parts.append(coords)
    coords = np.concatenate(parts, axis=0)
    n = len(coords)
    pad = np.full((max_voxels, 4), -1, np.int32)
    pad[:n] = coords
    valid = np.arange(max_voxels) < n
    voxels = rng.normal(size=(max_voxels, points_per_voxel, point_features)
                        ).astype(np.float32) * valid[:, None, None]
    num_points = np.minimum(rng.poisson(3, max_voxels) + 1,
                            points_per_voxel).astype(np.float32) * valid
    return {"voxels": voxels, "voxel_num_points": num_points,
            "voxel_coords": pad, "voxel_valid": valid}, n


def make(params, config, batch, seed):
    """The traffic's distinct batches (host numpy dicts) and the live voxels
    of each frame."""
    data = config["data"]
    grid = tuple(data["grid_size"])
    cap = int(data["max_voxels_per_frame"]) * batch
    batches, live = [], []
    for i in range(int(params["distinct_batches"])):
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), i]))
        scene, n = waymo_scale_scene(
            rng, cap, grid, batch, int(params["voxels_target"]),
            int(data["max_points_per_voxel"]),
            int(data["num_point_features"]))
        batches.append(scene)
        frame = scene["voxel_coords"][:n, 0]
        live += [int((frame == b).sum()) for b in range(batch)]
    return batches, live
