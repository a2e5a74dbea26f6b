"""Dataset template + static-shape batch collation (the port's copy of
``mssvt_tpu/datasets/dataset.py``).

Rebuild of ref pcdet/datasets/dataset.py:13-229. ``collate_batch`` differs
from the reference as the JAX package's does: where the reference
concatenates dynamic per-sample tensors and pads gt_boxes to the per-batch
max, everything is padded to *static* capacities (one set of shapes for
every step, as the port's kernels and buffers are sized by capacity):

- voxels/coords/num_points: concatenated with a leading batch-index column on
  coords (ref:173-178) and padded to ``batch_size * max_voxels``.
- gt_boxes: zero-padded to a fixed ``max_gt_boxes`` (config
  ``MAX_GT_BOXES``, default 500) instead of the per-batch max (ref:179-184).

The dataset owns the ``numpy.random.RandomState`` (``self.rng``, seeded by
``seed``; None draws a seed from the OS as numpy's unseeded global stream
does) that its augmentor and processors draw from. Collated batches are
numpy arrays; ``runtime.train_utils.batch_to_device`` moves them to the
model's device.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from .augmentor import DataAugmentor
from .processor import DataProcessor, PointFeatureEncoder


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None, seed=None):
        self.rng = np.random.RandomState(seed)
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = list(class_names) if class_names else []
        self.logger = logger
        self.root_path = Path(root_path) if root_path is not None else (
            Path(dataset_cfg["DATA_PATH"]) if dataset_cfg and "DATA_PATH" in dataset_cfg else None
        )
        if self.dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(
            self.dataset_cfg["POINT_CLOUD_RANGE"], dtype=np.float32
        )
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg["POINT_FEATURE_ENCODING"],
            point_cloud_range=self.point_cloud_range,
        )
        self.data_augmentor = DataAugmentor(
            self.root_path, self.dataset_cfg.get("DATA_AUGMENTOR"), self.class_names,
            logger=self.logger, rng=self.rng,
        ) if self.training and self.dataset_cfg.get("DATA_AUGMENTOR") else None
        self.data_processor = DataProcessor(
            self.dataset_cfg["DATA_PROCESSOR"],
            point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features,
            rng=self.rng,
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.max_voxels = self.data_processor.max_voxels
        self.max_points_per_voxel = self.data_processor.max_points_per_voxel
        self.max_gt_boxes = int(self.dataset_cfg.get("MAX_GT_BOXES", 500))
        # raw points are carried through collation only when a model needs
        # them (PV-RCNN / PointRCNN families); 0 disables (default)
        self.max_points = int(self.dataset_cfg.get("MAX_POINTS", 0))
        self.depth_downsample_factor = None

    @property
    def mode(self):
        return "train" if self.training else "test"

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def prepare_data(self, data_dict):
        """Ref: dataset.py:102-158 (augment → filter → encode → process)."""
        if self.training:
            assert "gt_boxes" in data_dict
            if self.data_augmentor is not None:
                gt_boxes_mask = np.array(
                    [n in self.class_names for n in data_dict["gt_names"]], bool
                )
                data_dict = self.data_augmentor.forward(
                    data_dict={**data_dict, "gt_boxes_mask": gt_boxes_mask}
                )

        if data_dict.get("gt_boxes", None) is not None:
            selected = np.array(
                [n in self.class_names for n in data_dict["gt_names"]], bool
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                np.int32,
            )
            data_dict["gt_boxes"] = np.concatenate(
                (data_dict["gt_boxes"].astype(np.float32),
                 gt_classes.reshape(-1, 1).astype(np.float32)),
                axis=1,
            )

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict)

        if self.training and len(data_dict.get("gt_boxes", [])) == 0:
            # resample another frame (ref: dataset.py:152-156)
            new_index = self.rng.randint(len(self))
            return self.__getitem__(new_index)

        data_dict.pop("gt_names", None)
        return data_dict

    def collate_batch(self, batch_list):
        """Static-shape collation (replaces ref: dataset.py:160-229)."""
        batch_size = len(batch_list)
        cap = self.max_voxels * batch_size
        p = self.max_points_per_voxel
        c_pt = batch_list[0]["voxels"].shape[-1]

        voxels = np.zeros((cap, p, c_pt), np.float32)
        coords = np.full((cap, 4), -1, np.int32)
        num_points = np.zeros((cap,), np.int32)
        valid = np.zeros((cap,), bool)
        gt = np.zeros((batch_size, self.max_gt_boxes,
                       batch_list[0]["gt_boxes"].shape[-1]
                       if "gt_boxes" in batch_list[0] else 8), np.float32)

        # fixed per-sample slots: sample i occupies [i*max_voxels, (i+1)*max_voxels).
        # This keeps the flat voxel axis evenly shardable across a data mesh
        # (axis 0 splits at sample boundaries).
        for i, d in enumerate(batch_list):
            n = min(len(d["voxels"]), self.max_voxels)
            lo = i * self.max_voxels
            voxels[lo:lo + n] = d["voxels"][:n]
            coords[lo:lo + n, 0] = i
            coords[lo:lo + n, 1:] = d["voxel_coords"][:n]
            num_points[lo:lo + n] = d["voxel_num_points"][:n]
            valid[lo:lo + n] = True
            if "gt_boxes" in d:
                m = min(len(d["gt_boxes"]), self.max_gt_boxes)
                gt[i, :m] = d["gt_boxes"][:m]

        batch = {
            "voxels": voxels,
            "voxel_coords": coords,
            "voxel_num_points": num_points.astype(np.float32),
            "voxel_valid": valid,
            "gt_boxes": gt,
            "batch_size": batch_size,
        }
        if self.max_points > 0:
            c_feat = batch_list[0]["points"].shape[-1]
            pts = np.zeros((batch_size * self.max_points, c_feat), np.float32)
            pts_valid = np.zeros((batch_size * self.max_points,), bool)
            for i, d in enumerate(batch_list):
                n = min(len(d["points"]), self.max_points)
                lo = i * self.max_points
                pts[lo:lo + n] = d["points"][:n]
                pts_valid[lo:lo + n] = True
            batch["points"] = pts
            batch["points_valid"] = pts_valid
        extras = defaultdict(list)
        for d in batch_list:
            for k in ("frame_id", "metadata"):
                if k in d:
                    extras[k].append(d[k])
        batch.update({k: v for k, v in extras.items()})
        return batch
