"""KITTI-like LiDAR sweeps, voxelised as OpenPCDet's KITTI test pipeline
does, for the SECOND cells.

Each frame is what a 64-beam sensor ``sensor_height`` metres above a flat
ground returns in KITTI's front field of view: beam elevations in two
blocks (``upper_deg`` and ``lower_deg``, each linear over half the beams,
as the HDL-64E's), azimuths every ``azimuth_step_deg`` over ``fov_deg``
about the x axis (a random phase a frame), each ray returned with
probability ``return_prob`` and its range perturbed by
``range_noise`` metres. The rays end on the ground or on one of
``boxes`` (a range, drawn a frame) upright boxes of the anchor
generator's class sizes (``ANCHOR_GENERATOR_CONFIG``, each size scaled by
up to ``size_jitter``), standing on the ground at distances ``box_range``
inside the field of view, with any heading. Points carry (x, y, z,
intensity in [0, 1]); those outside the configuration's
``point_cloud_range`` are dropped (pcdet's ``mask_points_by_range``) and
the rest are voxelised in scan order: the first ``max_points_per_voxel``
points of a voxel, at most ``max_voxels_per_frame`` voxels in the order
they first appear (pcdet's test-time voxel generator; no shuffle). Frames
are concatenated with their batch index into one padded (``voxels a
frame`` x batch) capacity, as ``waymo_scene.py`` lays them out. Batch
``i`` of a run draws from ``numpy.random.default_rng(SeedSequence([seed,
i]))``.

The sites are surfaces: the ground's rings and the boxes' faces, not
scattered cells, so a strided sparse convolution finds the output sites a
real sweep gives it.
"""

from __future__ import annotations

import numpy as np


def elevations(params):
    """The beams' elevations in radians, the upper block first."""
    n = int(params["beams"]) // 2
    up, lo = params["upper_deg"], params["lower_deg"]
    return np.deg2rad(np.concatenate([np.linspace(up[0], up[1], n),
                                      np.linspace(lo[0], lo[1], n)]))


def draw_boxes(rng, params, anchors):
    """(n, 7) upright boxes (x, y, z centre, dx, dy, dz, heading) standing
    on the ground, of the anchor classes' sizes."""
    n = int(rng.integers(params["boxes"][0], params["boxes"][1] + 1))
    sizes = np.asarray([a["anchor_sizes"][0] for a in anchors], np.float64)
    cls = rng.integers(0, len(sizes), n)
    size = sizes[cls] * (1 + rng.uniform(-1, 1, (n, 3))
                         * float(params["size_jitter"]))
    r = rng.uniform(*params["box_range"], n)
    half = np.deg2rad(float(params["fov_deg"])) / 2
    phi = rng.uniform(-half, half, n) * 0.9
    ground = -float(params["sensor_height"])
    return np.concatenate([
        (r * np.cos(phi))[:, None], (r * np.sin(phi))[:, None],
        (ground + size[:, 2] / 2)[:, None], size,
        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)


def ray_box_hits(dirs, boxes):
    """(R,) the nearest positive distance along each unit ray from the
    origin to any of ``boxes`` (inf where none is hit)."""
    if len(boxes) == 0:
        return np.full(len(dirs), np.inf)
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    # the rays in each box's frame: origin o = R^T (0 - centre), d = R^T dir
    ox = -(c * boxes[:, 0] + s * boxes[:, 1])
    oy = -(-s * boxes[:, 0] + c * boxes[:, 1])
    oz = -boxes[:, 2]
    dx = dirs[:, 0:1] * c + dirs[:, 1:2] * s
    dy = -dirs[:, 0:1] * s + dirs[:, 1:2] * c
    dz = np.broadcast_to(dirs[:, 2:3], dx.shape)
    near = np.full(dx.shape, -np.inf)
    far = np.full(dx.shape, np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for o, d, h in ((ox, dx, boxes[:, 3] / 2), (oy, dy, boxes[:, 4] / 2),
                        (oz, dz, boxes[:, 5] / 2)):
            t1, t2 = (-h - o) / d, (h - o) / d
            lo, hi = np.minimum(t1, t2), np.maximum(t1, t2)
            inside = np.abs(o) <= h  # a ray parallel to the slab
            lo = np.where(d == 0, np.where(inside, -np.inf, np.inf), lo)
            hi = np.where(d == 0, np.where(inside, np.inf, -np.inf), hi)
            near, far = np.maximum(near, lo), np.minimum(far, hi)
    t = np.where((near <= far) & (near > 0), near, np.inf)
    return t.min(axis=1)


def sweep(rng, params, anchors):
    """(P, 4) points (x, y, z, intensity) of one sweep, in scan order (beam,
    then azimuth)."""
    step = np.deg2rad(float(params["azimuth_step_deg"]))
    half = np.deg2rad(float(params["fov_deg"])) / 2
    az = np.arange(-half + rng.uniform(0, step), half, step)
    el = elevations(params)
    e, a = np.meshgrid(el, az, indexing="ij")
    dirs = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                     np.sin(e)], -1).reshape(-1, 3)
    h = float(params["sensor_height"])
    with np.errstate(divide="ignore"):
        t_ground = np.where(dirs[:, 2] < 0, -h / dirs[:, 2], np.inf)
    t = np.minimum(t_ground, ray_box_hits(dirs, draw_boxes(rng, params,
                                                           anchors)))
    keep = np.isfinite(t) & (rng.uniform(size=len(t))
                             < float(params["return_prob"]))
    t = t[keep] + rng.normal(0, float(params["range_noise"]), keep.sum())
    pts = dirs[keep] * t[:, None]
    return np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))],
                          1).astype(np.float32)


def voxelize(points, pc_range, voxel_size, grid, max_points, max_voxels):
    """pcdet's test-time voxel generator on (P, 4) points: (voxels (V, T,
    4), points a voxel (V,), (z, y, x) coords (V, 3)), voxels in the order
    they first appear, the first ``max_points`` points each."""
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    xyz = points[:, :3].astype(np.float64)
    points = points[((xyz >= lo) & (xyz < hi)).all(1)]
    idx = np.floor((points[:, :3] - lo) / np.asarray(voxel_size)).astype(
        np.int64)
    idx = np.minimum(idx, np.asarray(grid) - 1)
    key = (idx[:, 2] * grid[1] + idx[:, 1]) * grid[0] + idx[:, 0]
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    rank_of = np.empty(len(uniq), np.int64)
    rank_of[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    vid = rank_of[inv]  # voxel number in order of first appearance
    order = np.argsort(vid, kind="stable")
    starts = np.searchsorted(vid[order], np.arange(len(uniq)))
    slot = np.empty(len(vid), np.int64)
    slot[order] = np.arange(len(vid)) - starts[vid[order]]
    n = min(len(uniq), max_voxels)
    ok = (slot < max_points) & (vid < n)
    voxels = np.zeros((n, max_points, points.shape[1]), np.float32)
    voxels[vid[ok], slot[ok]] = points[ok]
    num = np.minimum(np.bincount(vid[vid < n], minlength=n), max_points)
    coords = np.empty((n, 3), np.int32)
    coords[vid[vid < n]] = idx[vid < n][:, ::-1]
    return voxels, num.astype(np.float32), coords


def make(params, config, batch, seed):
    """The traffic's distinct batches (host numpy dicts) and the live voxels
    of each frame."""
    data = config["data"]
    anchors = config["MODEL"]["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]
    per = int(data["max_voxels_per_frame"])
    t = int(data["max_points_per_voxel"])
    c = int(data["num_point_features"])
    cap = per * batch
    batches, live = [], []
    for i in range(int(params["distinct_batches"])):
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), i]))
        voxels = np.zeros((cap, t, c), np.float32)
        num = np.zeros(cap, np.float32)
        coords = np.full((cap, 4), -1, np.int32)
        at = 0
        for b in range(batch):
            v, n, zyx = voxelize(sweep(rng, params, anchors),
                                 data["point_cloud_range"],
                                 data["voxel_size"], data["grid_size"], t,
                                 per)
            k = len(v)
            voxels[at:at + k] = v[..., :c]
            num[at:at + k] = n
            coords[at:at + k, 0] = b
            coords[at:at + k, 1:] = zyx
            at += k
            live.append(k)
        batches.append({"voxels": voxels, "voxel_num_points": num,
                        "voxel_coords": coords,
                        "voxel_valid": np.arange(cap) < at})
    return batches, live
