"""KITTI-like LiDAR sweeps with their raw points, for the point-voxel cells
(PV-RCNN++): each frame is ``kitti_scene``'s sweep, voxelised as there
(pcdet's test-time voxel generator), and its raw points as the port's
loader collates them (``datasets/dataset.py``): the points inside the
configuration's ``point_cloud_range`` in scan order, the first
``MODEL.MAX_POINTS`` of them a frame, laid out as ``points`` (batch x
``MAX_POINTS``, 4) rows with ``points_valid``. Batch ``i`` of a run draws
from ``numpy.random.default_rng(SeedSequence([seed, i]))``, as
``kitti_scene``'s does, so its voxels are ``kitti_scene``'s."""

from __future__ import annotations

import numpy as np

from benchmark.traffic.kitti_scene import sweep, voxelize


def in_range(points, pc_range):
    """pcdet's ``mask_points_by_range``, as ``voxelize`` applies it."""
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    xyz = points[:, :3].astype(np.float64)
    return points[((xyz >= lo) & (xyz < hi)).all(1)]


def make(params, config, batch, seed):
    """The traffic's distinct batches (host numpy dicts) and the live voxels
    of each frame."""
    data = config["data"]
    anchors = config["MODEL"]["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]
    per = int(data["max_voxels_per_frame"])
    t = int(data["max_points_per_voxel"])
    c = int(data["num_point_features"])
    rows = int(config["MODEL"]["MAX_POINTS"])
    cap = per * batch
    batches, live = [], []
    for i in range(int(params["distinct_batches"])):
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), i]))
        voxels = np.zeros((cap, t, c), np.float32)
        num = np.zeros(cap, np.float32)
        coords = np.full((cap, 4), -1, np.int32)
        points = np.zeros((batch * rows, c), np.float32)
        points_valid = np.zeros(batch * rows, bool)
        at = 0
        for b in range(batch):
            pts = sweep(rng, params, anchors)
            v, n, zyx = voxelize(pts, data["point_cloud_range"],
                                 data["voxel_size"], data["grid_size"], t,
                                 per)
            k = len(v)
            voxels[at:at + k] = v[..., :c]
            num[at:at + k] = n
            coords[at:at + k, 0] = b
            coords[at:at + k, 1:] = zyx
            at += k
            live.append(k)
            raw = in_range(pts, data["point_cloud_range"])[:rows, :c]
            points[b * rows:b * rows + len(raw)] = raw
            points_valid[b * rows:b * rows + len(raw)] = True
        batches.append({"voxels": voxels, "voxel_num_points": num,
                        "voxel_coords": coords,
                        "voxel_valid": np.arange(cap) < at,
                        "points": points, "points_valid": points_valid})
    return batches, live
