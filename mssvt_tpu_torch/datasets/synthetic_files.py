"""Seeded dataset trees in the on-disk layouts that ``WaymoDataset`` and
``KittiDataset`` read, for the CPU tests and chip_smoke (no Waymo or KITTI
file ships with the repo).

Each frame follows ``SyntheticDataset``'s point recipe (a ground plane,
objects with points planted inside their boxes, a tenth of noise) from
``numpy.random.default_rng(seed * 100003 + frame)``:

- Waymo (``write_waymo_tree``): ``ImageSets/<split>.txt``,
  ``waymo_processed_data/<seq>/<seq>.pkl`` info lists and ``NNNN.npy`` (N, 6)
  f32 frames (x, y, z, intensity, elongation, no-label-zone flag; -1 outside
  the zone). Each frame also labels two ``unknown`` objects and one box
  that holds no point; ``difficulty`` is 0 or 2 and ``num_points_in_gt``
  counts the frame's points outside the zone in each box.
- KITTI (``write_kitti_tree``): ``training/{velodyne,calib,label_2}`` and
  ``ImageSets/{train,val}.txt``; a fixed KITTI calibration, objects in the
  camera's field of view written as camera-frame labels with their image
  boxes, and one ``DontCare`` region a frame.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..utils.geometry import points_in_boxes_numpy
from .kitti import (
    Calibration,
    boxes_camera_to_imageboxes,
    boxes_lidar_to_camera,
)

SIZES = {  # (dx, dy, dz) before a +-15% jitter
    "Vehicle": (4.5, 2.0, 1.7), "Pedestrian": (0.8, 0.8, 1.7),
    "Cyclist": (1.8, 0.8, 1.7), "unknown": (1.0, 1.0, 1.0),
    "Car": (3.9, 1.6, 1.56),
}
WAYMO_PCR = (-76.8, -76.8, -2.0, 76.8, 76.8, 4.0)
WAYMO_CLASSES = ("Vehicle", "Pedestrian", "Cyclist")
KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")
NLZ_SHARE = 0.05  # of a Waymo frame's points in the no-label zone
# KITTI's calibration of training frame 000000 (P2, R0_rect, Tr_velo_to_cam)
KITTI_CALIB = """P2: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03
R0_rect: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01
Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 -4.069766e-03 1.480249e-02 7.280733e-04 -9.998902e-01 -7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 -2.717806e-01
"""
KITTI_IMAGE = (375, 1242)


def _box(rng, name, x, y, ground):
    dx, dy, dz = (s * rng.uniform(0.85, 1.15) for s in SIZES[name])
    return np.array([x, y, ground + dz / 2, dx, dy, dz,
                     rng.uniform(-np.pi, np.pi)])


def _planted(rng, box, m):
    """m points inside ``box`` (within 90% of its half extents)."""
    local = rng.uniform(-0.45, 0.45, (m, 3)) * box[3:6]
    c, s = np.cos(box[6]), np.sin(box[6])
    return np.stack([local[:, 0] * c - local[:, 1] * s + box[0],
                     local[:, 0] * s + local[:, 1] * c + box[1],
                     local[:, 2] + box[2]], 1)


def _scene(rng, n_points, area, ground, boxes, empty=()):
    """(n_points, 3) xyz: ground over ``area`` (x0, y0, x1, y1, z1), 60-250
    points planted in each box (scaled down below 40 000 points a frame,
    at least 6), a tenth of uniform noise; no point is left inside a box of
    ``empty``."""
    x0, y0, x1, y1, z1 = area
    scale = min(1.0, n_points / 40_000)
    planted = [_planted(rng, b, max(6, int(rng.integers(60, 250) * scale)))
               for b in boxes]
    n_noise = n_points // 10
    n_ground = n_points - n_noise - sum(len(p) for p in planted)
    xyz = np.concatenate([np.stack([
        rng.uniform(x0, x1, n_ground), rng.uniform(y0, y1, n_ground),
        rng.normal(ground, 0.05, n_ground)], 1)] + planted + [np.stack([
            rng.uniform(x0, x1, n_noise), rng.uniform(y0, y1, n_noise),
            rng.uniform(ground - 0.2, z1, n_noise)], 1)])
    if len(empty):
        xyz = xyz[~points_in_boxes_numpy(xyz, np.asarray(empty)).any(1)]
    return xyz


def write_waymo_tree(root, splits, frames_per_sequence, points_per_frame,
                     seed=0, pcr=WAYMO_PCR):
    """``splits``: {split: [sequence names]}; every sequence gets
    ``frames_per_sequence`` frames of points over ``pcr`` (x0, y0, z0, x1,
    y1, z1; objects 5 m inside its edges). Returns the number of frames
    written."""
    root = Path(root)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    x0, y0, z0, x1, y1, z1 = pcr
    classes = WAYMO_CLASSES
    ground = z0 + 0.2
    frame = 0
    for split, seqs in splits.items():
        (root / "ImageSets" / f"{split}.txt").write_text(
            "".join(f"{s}.tfrecord\n" for s in seqs))
        for seq in seqs:
            seq_dir = root / "waymo_processed_data" / seq
            seq_dir.mkdir(parents=True, exist_ok=True)
            infos = []
            for i in range(frames_per_sequence):
                rng = np.random.default_rng(seed * 100003 + frame)
                frame += 1
                names = [classes[k] for k in
                         rng.integers(0, len(classes), rng.integers(6, 16))]
                names += ["unknown", "unknown"]
                boxes = [_box(rng, n, rng.uniform(x0 + 5, x1 - 5),
                              rng.uniform(y0 + 5, y1 - 5), ground)
                         for n in names]
                empty = _box(rng, classes[0], rng.uniform(x0 + 5, x1 - 5),
                             rng.uniform(y0 + 5, y1 - 5), ground)
                xyz = _scene(rng, points_per_frame,
                             (x0, y0, x1, y1, z1), ground, boxes, [empty])
                n = len(xyz)
                nlz = np.where(rng.uniform(size=n) < NLZ_SHARE, 1.0, -1.0)
                feats = np.concatenate([
                    xyz, rng.uniform(0, 3, (n, 1)), rng.uniform(0, 1, (n, 1)),
                    nlz[:, None]], 1).astype(np.float32)
                np.save(seq_dir / f"{i:04d}.npy", feats)
                names.append(classes[0])
                boxes = np.stack(boxes + [empty])
                inside = points_in_boxes_numpy(
                    feats[nlz == -1, :3].astype(np.float64), boxes)
                infos.append({
                    "point_cloud": {"num_features": 5, "lidar_sequence": seq,
                                    "sample_idx": i},
                    "frame_id": f"{seq}_{i:03d}",
                    "annos": {
                        "name": np.array(names),
                        "difficulty": rng.choice([0, 0, 0, 2], len(names)),
                        "gt_boxes_lidar": boxes,
                        "num_points_in_gt": inside.sum(0).astype(np.int64),
                    },
                })
            with open(seq_dir / f"{seq}.pkl", "wb") as f:
                pickle.dump(infos, f)
    return frame


def _label_line(name, box, calib, occluded):
    """One camera-frame KITTI label line of a lidar-frame box."""
    cam = boxes_lidar_to_camera(box[None], calib)
    bbox = boxes_camera_to_imageboxes(cam, calib, KITTI_IMAGE)[0]
    x, y, z, l, h, w, ry = cam[0]
    wrap = lambda a: (a + np.pi) % (2 * np.pi) - np.pi  # noqa: E731
    ry, alpha = wrap(ry), wrap(-np.arctan2(-box[1], box[0]) + ry)
    return (f"{name} 0.00 {occluded} {alpha:.2f} "
            f"{bbox[0]:.2f} {bbox[1]:.2f} {bbox[2]:.2f} {bbox[3]:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")


def write_kitti_tree(root, train_ids, val_ids, points_per_frame, seed=0):
    """Frames ``train_ids`` + ``val_ids`` (names like "000003") under
    ``training/``: the points cover a 140.8 x 80 m area around the sensor,
    of which the camera sees about a third; 4-12 objects a frame in its
    field of view (occlusion 0-2), and a DontCare region."""
    root = Path(root)
    for sub in ("velodyne", "calib", "label_2"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    ground = -1.73  # the velodyne's height above the road
    for k, idx in enumerate(list(train_ids) + list(val_ids)):
        rng = np.random.default_rng(seed * 100003 + k)
        # one object of each class 8-20 m ahead (unoccluded: every class
        # has a GT in each difficulty bucket), then 1-9 anywhere in view
        names = list(KITTI_CLASSES) + [KITTI_CLASSES[int(i)] for i in
                                       rng.integers(0, 3, int(rng.integers(1, 10)))]
        near = np.arange(len(names)) < len(KITTI_CLASSES)
        boxes = []
        for name, close in zip(names, near):
            x = rng.uniform(8, 20) if close else rng.uniform(6, 60)
            boxes.append(_box(rng, name, x, rng.uniform(-0.6, 0.6) * x,
                              ground))
        xyz = _scene(rng, points_per_frame, (-70.4, -40, 70.4, 40, 1.0),
                     ground, boxes)
        pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1)
        pts.astype(np.float32).tofile(root / "training" / "velodyne" /
                                      f"{idx}.bin")
        calib_file = root / "training" / "calib" / f"{idx}.txt"
        calib_file.write_text(KITTI_CALIB)
        calib = Calibration(calib_file)
        lines = [_label_line(n, b, calib, 0 if c else int(rng.integers(0, 3)))
                 for n, b, c in zip(names, boxes, near)]
        u, v = rng.uniform(0, 1100), rng.uniform(150, 300)
        lines.append(f"DontCare -1 -1 -10 {u:.2f} {v:.2f} {u + 40:.2f} "
                     f"{v + 30:.2f} -1 -1 -1 -1000 -1000 -1000 -10")
        (root / "training" / "label_2" / f"{idx}.txt").write_text(
            "\n".join(lines) + "\n")
    (root / "ImageSets" / "train.txt").write_text("\n".join(train_ids) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(val_ids) + "\n")
