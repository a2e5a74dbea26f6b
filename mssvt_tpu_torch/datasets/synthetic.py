"""Synthetic LiDAR-like dataset for tests, benchmarking, and CI (the port's
copy of ``mssvt_tpu/datasets/synthetic.py``, same recipe).

Generates deterministic scenes with a ground plane, random "objects" (boxes
with denser points), and noise — enough structure to exercise the whole
pipeline (augmentation, voxelization, target assignment, training) without
real data. The reference has no equivalent (it has no tests at all,
SURVEY.md §4); this fills that gap.
"""

from __future__ import annotations

import numpy as np

from .dataset import DatasetTemplate


class SyntheticDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         seed)
        self.num_frames = int(dataset_cfg.get("NUM_FRAMES", 64))
        self.points_per_frame = int(dataset_cfg.get("POINTS_PER_FRAME", 20000))
        self.seed = int(dataset_cfg.get("SEED", 0))
        self.num_point_features = self.point_feature_encoder.num_point_features

    def __len__(self):
        return self.num_frames

    def _make_scene(self, index):
        rng = np.random.default_rng(self.seed * 100003 + index)
        pcr = self.point_cloud_range
        n_ground = self.points_per_frame // 2
        ground = np.stack([
            rng.uniform(pcr[0], pcr[3], n_ground),
            rng.uniform(pcr[1], pcr[4], n_ground),
            rng.normal(pcr[2] + 0.2, 0.05, n_ground),
        ], axis=1)

        n_obj = rng.integers(3, 12)
        boxes, names, obj_pts = [], [], []
        sizes = {
            name: size for name, size in zip(
                self.class_names,
                [(4.5, 2.0, 1.7), (0.8, 0.8, 1.7), (1.8, 0.8, 1.7)] * 8,
            )
        }
        for _ in range(n_obj):
            name = self.class_names[rng.integers(0, len(self.class_names))]
            dx, dy, dz = sizes[name]
            dx *= rng.uniform(0.85, 1.15)
            dy *= rng.uniform(0.85, 1.15)
            dz *= rng.uniform(0.85, 1.15)
            x = rng.uniform(pcr[0] + 5, pcr[3] - 5)
            y = rng.uniform(pcr[1] + 5, pcr[4] - 5)
            z = pcr[2] + 0.2 + dz / 2
            heading = rng.uniform(-np.pi, np.pi)
            boxes.append([x, y, z, dx, dy, dz, heading])
            names.append(name)
            m = int(rng.integers(60, 250))
            local = rng.uniform(-0.5, 0.5, (m, 3)) * np.array([dx, dy, dz])
            cos, sin = np.cos(heading), np.sin(heading)
            px = local[:, 0] * cos - local[:, 1] * sin + x
            py = local[:, 0] * sin + local[:, 1] * cos + y
            pz = local[:, 2] + z
            obj_pts.append(np.stack([px, py, pz], axis=1))

        n_noise = self.points_per_frame // 10
        noise = np.stack([
            rng.uniform(pcr[0], pcr[3], n_noise),
            rng.uniform(pcr[1], pcr[4], n_noise),
            rng.uniform(pcr[2], pcr[5], n_noise),
        ], axis=1)

        xyz = np.concatenate([ground] + obj_pts + [noise], axis=0)
        extra = rng.uniform(0, 1, (len(xyz), self.num_point_features - 3))
        points = np.concatenate([xyz, extra], axis=1).astype(np.float32)
        return points, np.array(boxes, np.float32), np.array(names)

    def __getitem__(self, index):
        points, gt_boxes, gt_names = self._make_scene(index)
        data_dict = {
            "points": points,
            "gt_boxes": gt_boxes,
            "gt_names": gt_names,
            "frame_id": index,
        }
        return self.prepare_data(data_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        from ..utils.eval_ap import kitti_style_eval

        return kitti_style_eval(det_annos, kwargs["gt_annos"], class_names)
