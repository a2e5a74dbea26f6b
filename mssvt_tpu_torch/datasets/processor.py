"""Point feature encoding + config-driven data processing queue (the port's
copy of ``mssvt_tpu/datasets/processor.py``).

Rebuild of ref pcdet/datasets/processor/point_feature_encoder.py:4-57 and
data_processor.py:63-211: a queue of named processors dispatched by config
(``getattr(self, cfg.NAME)`` partial pattern), ending in voxelization with
spconv-compatible semantics (ops/voxelize.py). Random draws come from the
``numpy.random.RandomState`` the caller passes (the dataset's), not from
numpy's global stream; ``RandomState(s)`` yields the global legacy stream
after ``np.random.seed(s)``, so both draw the same numbers.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ..ops.voxelize import voxelize_points


class PointFeatureEncoder:
    """Ref: point_feature_encoder.py:4-57 (absolute_coordinates_encoding)."""

    def __init__(self, config, point_cloud_range=None):
        self.point_encoding_config = config
        assert self.point_encoding_config["encoding_type"] in (
            "absolute_coordinates_encoding",
        )
        self.used_feature_list = list(self.point_encoding_config["used_feature_list"])
        self.src_feature_list = list(self.point_encoding_config["src_feature_list"])
        self.point_cloud_range = point_cloud_range

    @property
    def num_point_features(self):
        return len(self.used_feature_list)

    def forward(self, data_dict):
        points = data_dict["points"]
        point_feature_list = [points[:, 0:3]]
        for x in self.used_feature_list:
            if x in ("x", "y", "z"):
                continue
            idx = self.src_feature_list.index(x)
            point_feature_list.append(points[:, idx : idx + 1])
        data_dict["points"] = np.concatenate(point_feature_list, axis=1)
        data_dict["use_lead_xyz"] = True
        return data_dict


class DataProcessor:
    """Ref: data_processor.py:63-211."""

    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features, rng=None):
        self.rng = rng if rng is not None else np.random.RandomState()
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.grid_size = None
        self.voxel_size = None
        self.max_points_per_voxel = None
        self.max_voxels = None

        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            cur_processor = getattr(self, cur_cfg["NAME"])(config=cur_cfg)
            self.data_processor_queue.append(cur_processor)

    # -------------------------- processors ---------------------------- #

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        pts = data_dict["points"]
        pcr = self.point_cloud_range
        mask = (
            (pts[:, 0] >= pcr[0]) & (pts[:, 0] <= pcr[3])
            & (pts[:, 1] >= pcr[1]) & (pts[:, 1] <= pcr[4])
        )
        data_dict["points"] = pts[mask]
        if (
            data_dict.get("gt_boxes", None) is not None
            and config.get("REMOVE_OUTSIDE_BOXES", False)
            and self.training
        ):
            boxes = data_dict["gt_boxes"]
            bmask = (
                (boxes[:, 0] >= pcr[0]) & (boxes[:, 0] <= pcr[3])
                & (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] <= pcr[4])
            )
            data_dict["gt_boxes"] = boxes[bmask]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][bmask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config["SHUFFLE_ENABLED"][self.mode]:
            pts = data_dict["points"]
            perm = self.rng.permutation(pts.shape[0])
            data_dict["points"] = pts[perm]
        return data_dict

    def sample_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.sample_points, config=config)
        num_points = config["NUM_POINTS"][self.mode]
        if num_points == -1:
            return data_dict
        points = data_dict["points"]
        if num_points < len(points):
            choice = self.rng.choice(len(points), num_points, replace=False)
        else:
            choice = np.concatenate([
                np.arange(len(points)),
                self.rng.choice(len(points), num_points - len(points),
                                 replace=len(points) < num_points),
            ])
            self.rng.shuffle(choice)
        data_dict["points"] = points[choice]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        if data_dict is None:
            self.voxel_size = list(config["VOXEL_SIZE"])
            grid_size = (
                self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
            ) / np.array(config["VOXEL_SIZE"])
            self.grid_size = np.round(grid_size).astype(np.int64)
            self.max_points_per_voxel = int(config["MAX_POINTS_PER_VOXEL"])
            self.max_voxels_cfg = dict(config["MAX_NUMBER_OF_VOXELS"])
            self.max_voxels = int(self.max_voxels_cfg[self.mode])
            return partial(self.transform_points_to_voxels, config=config)

        voxels, coords, num_points = voxelize_points(
            data_dict["points"], self.voxel_size, self.point_cloud_range,
            self.max_points_per_voxel, self.max_voxels,
        )
        data_dict["voxels"] = voxels
        data_dict["voxel_coords"] = coords
        data_dict["voxel_num_points"] = num_points
        return data_dict

    def calculate_grid_size(self, data_dict=None, config=None):
        """Config-named grid-size derivation without voxelization (CaDDN
        pipelines voxelize on-device; ref: data_processor.py:177-183)."""
        if data_dict is None:
            grid_size = (
                self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
            ) / np.array(config["VOXEL_SIZE"])
            self.grid_size = np.round(grid_size).astype(np.int64)
            self.voxel_size = list(config["VOXEL_SIZE"])
            return partial(self.calculate_grid_size, config=config)
        return data_dict

    def downsample_depth_map(self, data_dict=None, config=None):
        """Block-mean depth-map downsampling (ref: data_processor.py:185-194,
        skimage.transform.downscale_local_mean semantics: zero-pad to a
        multiple of the factor, then mean over each block)."""
        if data_dict is None:
            self.depth_downsample_factor = int(config["DOWNSAMPLE_FACTOR"])
            return partial(self.downsample_depth_map, config=config)
        depth = np.asarray(data_dict["depth_maps"], np.float64)
        f = self.depth_downsample_factor
        h, w = depth.shape[:2]
        ph, pw = (-h) % f, (-w) % f
        if ph or pw:
            depth = np.pad(depth, ((0, ph), (0, pw)))
        hh, ww = depth.shape[0] // f, depth.shape[1] // f
        data_dict["depth_maps"] = depth.reshape(hh, f, ww, f).mean(axis=(1, 3))
        return data_dict

    def forward(self, data_dict):
        for cur_processor in self.data_processor_queue:
            data_dict = cur_processor(data_dict=data_dict)
        return data_dict
