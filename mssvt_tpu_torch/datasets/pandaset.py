"""Pandaset dataset (ref: pcdet/datasets/pandaset/pandaset_dataset.py, 489 LoC;
the port's copy of ``mssvt_tpu/datasets/pandaset.py``).

The reference reads sequences through the external ``pandaset-devkit`` SDK
(lazily imported) and converts cuboid annotations from the Pandas-frame
format into lidar-frame 7-DOF boxes. Same contract here: the SDK is gated;
everything after ``get_item`` flows through the shared
``DatasetTemplate.prepare_data`` pipeline.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate

# Pandaset label → canonical detection class (ref: pandaset_dataset.py
# LABEL_TO_CLASS mapping)
DEFAULT_CLASS_MAP = {
    "Car": "Car",
    "Pickup Truck": "Car",
    "Medium-sized Truck": "Car",
    "Semi-truck": "Car",
    "Pedestrian": "Pedestrian",
    "Pedestrian with Object": "Pedestrian",
    "Bicycle": "Cyclist",
    "Motorcycle": "Cyclist",
}


class PandasetDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         seed)
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        self.sequences = dataset_cfg.get("SEQUENCES", {}).get(self.split, [])
        self._sdk_dataset = None
        self.frames = []  # (sequence, frame_idx)
        self._build_frame_list()

    # ------------------------------ SDK ------------------------------- #

    def _sdk(self):
        if self._sdk_dataset is None:
            try:
                from pandaset import DataSet  # external SDK (ref :12)
            except ImportError as e:
                raise ImportError(
                    "pandaset-devkit is required for PandasetDataset; "
                    "install it on the data host"
                ) from e
            self._sdk_dataset = DataSet(str(self.root_path))
        return self._sdk_dataset

    def _build_frame_list(self):
        # info-pkl fast path (pre-extracted, no SDK needed)
        info_path = (self.root_path / f"pandaset_infos_{self.split}.pkl"
                     if self.root_path else None)
        if info_path and info_path.exists():
            with open(info_path, "rb") as f:
                self.infos = pickle.load(f)
            self.frames = [(i["sequence"], i["frame_idx"]) for i in self.infos]
            return
        self.infos = None
        for seq in self.sequences:
            # 80 frames per pandaset sequence
            self.frames.extend((str(seq), i) for i in range(80))

    def __len__(self):
        return len(self.frames)

    @staticmethod
    def cuboids_to_boxes(cuboids, class_map=None):
        """Pandas cuboid frame → (N, 7) lidar boxes + names
        (ref: pandaset_dataset.py cuboid conversion — position.{x,y,z} is the
        box center, yaw about +z)."""
        class_map = class_map or DEFAULT_CLASS_MAP
        boxes, names = [], []
        for _, row in cuboids.iterrows():
            label = class_map.get(str(row["label"]))
            if label is None:
                continue
            boxes.append([
                row["position.x"], row["position.y"], row["position.z"],
                row["dimensions.x"], row["dimensions.y"], row["dimensions.z"],
                row["yaw"],
            ])
            names.append(label)
        if not boxes:
            return np.zeros((0, 7), np.float32), np.zeros((0,), "<U20")
        return np.asarray(boxes, np.float32), np.asarray(names)

    def __getitem__(self, index):
        seq_name, fi = self.frames[index]
        seq = self._sdk()[seq_name]
        seq.load_lidar().load_cuboids()
        pc = seq.lidar[fi].to_numpy()  # x y z i t d
        points = pc[:, :4].astype(np.float32)
        boxes, names = self.cuboids_to_boxes(seq.cuboids[fi])
        input_dict = {
            "points": points,
            "frame_id": f"{seq_name}_{fi:03d}",
            "gt_boxes": boxes,
            "gt_names": names,
        }
        return self.prepare_data(input_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        from ..utils.eval_ap import kitti_style_eval

        return kitti_style_eval(det_annos, kwargs["gt_annos"], class_names)
