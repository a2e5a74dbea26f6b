"""Data augmentation queue (ref: pcdet/datasets/augmentor/; the port's copy
of ``mssvt_tpu/datasets/augmentor.py``).

Implements the augmentors MsSVT's pipeline uses: gt_sampling (cut-paste from
a prebuilt GT database, ref: database_sampler.py:13-248), world flip/rotation/
scaling (ref: augmentor_utils.py + data_augmentor.py:43-80), with the same
queue/DISABLE_AUG_LIST dispatch (ref: data_augmentor.py:9-44) and final
heading normalization (ref: data_augmentor.py:220-222).

Every random draw comes from the ``numpy.random.RandomState`` passed as
``rng`` (the dataset's), in the JAX package's order: ``RandomState(s)``
yields numpy's global legacy stream after ``np.random.seed(s)``, which the
JAX package draws from, so both augment alike. The sampler's collision test
runs the port's ``ops.box_ops.pairwise_iou_bev`` on CPU tensors.
"""

from __future__ import annotations

import pickle
from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..ops.box_ops import pairwise_iou_bev
from ..utils.geometry import (
    limit_period,
    mask_points_in_boxes,
    points_in_boxes_numpy,
    rotate_points_along_z,
)


# ------------------------- core transforms ---------------------------- #

def random_flip_along_x(gt_boxes, points, rng):
    """Flip y (ref: augmentor_utils.py random_flip_along_x).

    Boxes may carry velocity columns [vx, vy] at 7:9 (multi-sweep datasets,
    e.g. Lyft): flipping y negates vy (ref: augmentor_utils.py:20-22).
    """
    enable = rng.choice([False, True], p=[0.5, 0.5])
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 8:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points, rng):
    enable = rng.choice([False, True], p=[0.5, 0.5])
    if enable:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            # flipping x negates vx (ref: augmentor_utils.py:37-39)
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rot_range, rng):
    angle = rng.uniform(rot_range[0], rot_range[1])
    points = rotate_points_along_z(points, angle)
    if len(gt_boxes):
        gt_boxes[:, 0:3] = rotate_points_along_z(gt_boxes[:, 0:3], angle)
        gt_boxes[:, 6] += angle
        if gt_boxes.shape[1] > 8:
            # rotate the velocity vector too (ref: augmentor_utils.py:55-59)
            vel3 = np.concatenate(
                [gt_boxes[:, 7:9], np.zeros((len(gt_boxes), 1))], axis=1)
            gt_boxes[:, 7:9] = rotate_points_along_z(vel3, angle)[:, :2]
    return gt_boxes, points


def global_scaling(gt_boxes, points, scale_range, rng):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    scale = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    return gt_boxes, points


def random_world_translation(gt_boxes, points, noise_translate_std, rng):
    """Per-axis gaussian world shift (ref: augmentor_utils.py
    random_translation_along_{x,y,z})."""
    std = np.asarray(noise_translate_std, np.float64).reshape(-1)
    if std.size == 1:
        std = np.repeat(std, 3)
    offset = rng.normal(0, std, 3)
    points[:, :3] += offset
    if len(gt_boxes):
        gt_boxes[:, :3] += offset
    return gt_boxes, points


def _points_in_box_mask(points, box):
    return points_in_boxes_numpy(points[:, :3], box[None, :7])[:, 0]


def random_local_translation(gt_boxes, points, offset_range, rng,
                             axes=("x", "y")):
    """Per-object random shift (ref: augmentor_utils.py
    random_local_translation_along_{x,y,z})."""
    ax_idx = {"x": 0, "y": 1, "z": 2}
    for i, box in enumerate(gt_boxes):
        mask = _points_in_box_mask(points, box)
        for ax in axes:
            off = rng.uniform(offset_range[0], offset_range[1])
            points[mask, ax_idx[ax]] += off
            gt_boxes[i, ax_idx[ax]] += off
    return gt_boxes, points


def random_local_rotation(gt_boxes, points, rot_range, rng):
    """Per-object rotation about its own center (ref: augmentor_utils.py
    local_rotation)."""
    for i, box in enumerate(gt_boxes):
        angle = rng.uniform(rot_range[0], rot_range[1])
        mask = _points_in_box_mask(points, box)
        ctr = box[:3].copy()
        points[mask, :3] = rotate_points_along_z(
            points[mask, :3] - ctr, angle) + ctr
        gt_boxes[i, 6] += angle
    return gt_boxes, points


def random_local_scaling(gt_boxes, points, scale_range, rng):
    """Per-object scaling about its own center (ref: augmentor_utils.py
    local_scaling)."""
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    for i, box in enumerate(gt_boxes):
        scale = rng.uniform(scale_range[0], scale_range[1])
        mask = _points_in_box_mask(points, box)
        ctr = box[:3].copy()
        points[mask, :3] = (points[mask, :3] - ctr) * scale + ctr
        gt_boxes[i, 3:6] *= scale
    return gt_boxes, points


def global_frustum_dropout(gt_boxes, points, intensity_range, rng,
                           direction="top"):
    """Drop points in a world frustum (ref: augmentor_utils.py
    global_frustum_dropout_{top,bottom,left,right})."""
    intensity = rng.uniform(intensity_range[0], intensity_range[1])
    if len(points) == 0 or intensity <= 0:
        return gt_boxes, points
    if direction in ("top", "bottom"):
        vals = points[:, 2]
    else:
        vals = points[:, 1]
    lo, hi = vals.min(), vals.max()
    if direction in ("top", "right"):
        thresh = hi - intensity * (hi - lo)
        keep = vals < thresh
    else:
        thresh = lo + intensity * (hi - lo)
        keep = vals > thresh
    return gt_boxes, points[keep]


def random_local_frustum_dropout(gt_boxes, points, intensity_range, rng,
                                 direction="top"):
    """Per-object frustum dropout (ref: augmentor_utils.py
    local_frustum_dropout_{top,bottom,left,right})."""
    for box in gt_boxes:
        intensity = rng.uniform(intensity_range[0], intensity_range[1])
        mask = _points_in_box_mask(points, box)
        if not mask.any():
            continue
        if direction in ("top", "bottom"):
            vals = points[:, 2]
            lo, hi = box[2] - box[5] / 2, box[2] + box[5] / 2
        else:
            vals = points[:, 1]
            lo, hi = box[1] - box[4] / 2, box[1] + box[4] / 2
        if direction in ("top", "right"):
            drop = mask & (vals > hi - intensity * (hi - lo))
        else:
            drop = mask & (vals < lo + intensity * (hi - lo))
        points = points[~drop]
    return gt_boxes, points


# --------------------------- gt sampling ------------------------------ #

class DataBaseSampler:
    """GT cut-paste augmentation (ref: database_sampler.py:13-248)."""

    def __init__(self, root_path, sampler_cfg, class_names, logger=None,
                 rng=None):
        self.rng = rng if rng is not None else np.random.RandomState()
        self.root_path = Path(root_path) if root_path else None
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger
        self.db_infos = {n: [] for n in class_names}
        for db_info_path in sampler_cfg["DB_INFO_PATH"]:
            path = self.root_path / db_info_path if self.root_path else Path(db_info_path)
            if not path.exists():
                if logger:
                    logger.warning(f"gt database missing: {path} — gt_sampling disabled")
                self.disabled = True
                return
            with open(path, "rb") as f:
                infos = pickle.load(f)
            for n in class_names:
                if n in infos:
                    self.db_infos[n].extend(infos[n])
        self.disabled = False

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        for x in sampler_cfg["SAMPLE_GROUPS"]:
            name, num = x.split(":")
            if name in class_names:
                self.sample_groups[name] = {
                    "num": int(num), "pointer": len(self.db_infos[name]),
                    "indices": np.arange(len(self.db_infos[name])),
                }
        self.num_point_features = int(sampler_cfg.get("NUM_POINT_FEATURES", 5))
        self.limit_whole_scene = bool(sampler_cfg.get("LIMIT_WHOLE_SCENE", False))

    @staticmethod
    def filter_by_difficulty(db_infos, removed_difficulty):
        return {
            k: [x for x in v if x.get("difficulty", 0) not in removed_difficulty]
            for k, v in db_infos.items()
        }

    @staticmethod
    def filter_by_min_points(db_infos, min_gt_points_list):
        for s in min_gt_points_list:
            name, num = s.split(":")
            if name in db_infos:
                db_infos[name] = [
                    x for x in db_infos[name] if x["num_points_in_gt"] >= int(num)
                ]
        return db_infos

    def sample_with_fixed_number(self, class_name, group):
        if group["pointer"] + group["num"] >= len(self.db_infos[class_name]):
            group["indices"] = self.rng.permutation(len(self.db_infos[class_name]))
            group["pointer"] = 0
        samples = [
            self.db_infos[class_name][i]
            for i in group["indices"][group["pointer"]: group["pointer"] + group["num"]]
        ]
        group["pointer"] += group["num"]
        return samples

    def __call__(self, data_dict):
        if getattr(self, "disabled", False):
            return data_dict

        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"]
        points = data_dict["points"]
        existed = gt_boxes.copy()

        sampled_boxes_all, sampled_points_all, sampled_names_all = [], [], []
        for class_name, group in self.sample_groups.items():
            num = group["num"]
            if self.limit_whole_scene:
                num_gt = int((gt_names == class_name).sum())
                num = max(group["num"] - num_gt, 0)
            if num <= 0 or len(self.db_infos[class_name]) == 0:
                continue
            group2 = dict(group, num=num)
            sampled = self.sample_with_fixed_number(class_name, group2)
            group["pointer"] = group2["pointer"]
            group["indices"] = group2["indices"]
            boxes = np.stack([s["box3d_lidar"] for s in sampled]).astype(np.float32)

            # collision filter vs existing + already-sampled boxes (BEV IoU)
            ref = np.concatenate([existed[:, :7]] + (
                [np.stack(sampled_boxes_all)[:, :7]] if sampled_boxes_all else []
            )) if len(existed) or sampled_boxes_all else np.zeros((0, 7), np.float32)
            if len(ref):
                iou = pairwise_iou_bev(
                    torch.as_tensor(boxes[:, :7]),
                    torch.as_tensor(np.asarray(ref, np.float32))).numpy()
                self_iou = pairwise_iou_bev(
                    torch.as_tensor(boxes[:, :7]),
                    torch.as_tensor(boxes[:, :7])).numpy()
                np.fill_diagonal(self_iou, 0)
                ok = (iou.max(1) < 1e-3) & (np.triu(self_iou, 1).max(0) < 1e-3)
            else:
                ok = np.ones(len(boxes), bool)

            use_plane = bool(self.sampler_cfg.get("USE_ROAD_PLANE", False)) \
                and "road_plane" in data_dict
            for s, box, keep in zip(sampled, boxes, ok):
                if not keep:
                    continue
                fn = self.root_path / s["path"] if self.root_path else Path(s["path"])
                if not fn.exists():
                    continue
                obj_points = np.fromfile(fn, np.float32).reshape(
                    -1, self.num_point_features
                )
                if use_plane:
                    # drop the box onto the road plane a*x+b*y+c*z+d=0
                    # (ref: database_sampler.py:137 put_boxes_on_road_planes;
                    # plane given in the lidar frame here — the reference's
                    # calib round-trip collapses to this closed form)
                    a, b, c, d = np.asarray(
                        data_dict["road_plane"], np.float64)
                    z_plane = -(a * box[0] + b * box[1] + d) / c
                    mv_height = box[2] - box[5] / 2 - z_plane
                    box = box.copy()
                    box[2] -= mv_height  # points follow via the += below
                obj_points[:, :3] += box[:3]
                sampled_boxes_all.append(box)
                sampled_points_all.append(obj_points)
                sampled_names_all.append(s["name"])

        if sampled_boxes_all:
            sampled_boxes = np.stack(sampled_boxes_all)
            # remove scene points inside sampled boxes, then merge
            keep = ~mask_points_in_boxes(points, sampled_boxes[:, :7])
            points = np.concatenate(
                [np.concatenate(sampled_points_all), points[keep]], axis=0
            )
            data_dict["points"] = points
            data_dict["gt_boxes"] = np.concatenate(
                [gt_boxes, sampled_boxes[:, : gt_boxes.shape[1]]]
            )
            data_dict["gt_names"] = np.concatenate(
                [gt_names, np.array(sampled_names_all)]
            )
            data_dict["gt_boxes_mask"] = np.concatenate([
                data_dict["gt_boxes_mask"], np.ones(len(sampled_boxes_all), bool)
            ])
        return data_dict


# ------------------------------ queue ---------------------------------- #

class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None,
                 rng=None):
        self.rng = rng if rng is not None else np.random.RandomState()
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.data_augmentor_queue = []
        aug_list = (
            augmentor_configs if isinstance(augmentor_configs, list)
            else augmentor_configs["AUG_CONFIG_LIST"]
        )
        disable = (
            [] if isinstance(augmentor_configs, list)
            else augmentor_configs.get("DISABLE_AUG_LIST", [])
        )
        for cfg in aug_list:
            if cfg["NAME"] in disable:
                continue
            self.data_augmentor_queue.append(getattr(self, cfg["NAME"])(config=cfg))

    def gt_sampling(self, config=None):
        return DataBaseSampler(self.root_path, config, self.class_names,
                               self.logger, self.rng)

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for axis in config["ALONG_AXIS_LIST"]:
            assert axis in ("x", "y")
            fn = random_flip_along_x if axis == "x" else random_flip_along_y
            gt_boxes, points = fn(gt_boxes, points, self.rng)
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config["WORLD_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points = global_rotation(
            data_dict["gt_boxes"], data_dict["points"], rot_range, self.rng
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        gt_boxes, points = global_scaling(
            data_dict["gt_boxes"], data_dict["points"],
            config["WORLD_SCALE_RANGE"], self.rng
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_world_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_translation, config=config)
        gt_boxes, points = random_world_translation(
            data_dict["gt_boxes"], data_dict["points"],
            config["NOISE_TRANSLATE_STD"], self.rng,
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_translation, config=config)
        gt_boxes, points = random_local_translation(
            data_dict["gt_boxes"], data_dict["points"],
            config["LOCAL_TRANSLATION_RANGE"], self.rng,
            axes=tuple(config.get("ALONG_AXIS_LIST", ["x", "y"])),
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_rotation, config=config)
        rot_range = config["LOCAL_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points = random_local_rotation(
            data_dict["gt_boxes"], data_dict["points"], rot_range, self.rng
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_scaling, config=config)
        gt_boxes, points = random_local_scaling(
            data_dict["gt_boxes"], data_dict["points"],
            config["LOCAL_SCALE_RANGE"], self.rng,
        )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_world_frustum_dropout(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_frustum_dropout, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for direction in config.get("DIRECTION", ["top"]):
            gt_boxes, points = global_frustum_dropout(
                gt_boxes, points, config["INTENSITY_RANGE"], self.rng, direction
            )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_frustum_dropout(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_local_frustum_dropout, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for direction in config.get("DIRECTION", ["top"]):
            gt_boxes, points = random_local_frustum_dropout(
                gt_boxes, points, config["INTENSITY_RANGE"], self.rng, direction
            )
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def forward(self, data_dict):
        for aug in self.data_augmentor_queue:
            data_dict = aug(data_dict=data_dict)
        # heading normalization (ref: data_augmentor.py:220-222)
        if "gt_boxes" in data_dict and len(data_dict["gt_boxes"]):
            data_dict["gt_boxes"][:, 6] = limit_period(
                data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
            )
        if "gt_boxes_mask" in data_dict:
            mask = data_dict["gt_boxes_mask"]
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            data_dict["gt_names"] = data_dict["gt_names"][mask]
            data_dict.pop("gt_boxes_mask")
        return data_dict
