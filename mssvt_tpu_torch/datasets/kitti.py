"""KITTI dataset pipeline (ref: pcdet/datasets/kitti/kitti_dataset.py:21-483;
the port's copy of ``mssvt_tpu/datasets/kitti.py``).

Self-contained numpy implementation: calibration parsing
(ref: utils/calibration_kitti.py), label parsing (ref: utils/object3d_kitti.py),
camera→lidar box conversion, .bin point loading, FOV filtering, and the
KITTI-style AP evaluation via utils/eval_ap.py.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate


class Calibration:
    """Ref: pcdet/utils/calibration_kitti.py (P2/R0/Tr_velo_to_cam algebra)."""

    def __init__(self, calib_file):
        lines = Path(calib_file).read_text().strip().splitlines()
        data = {}
        for line in lines:
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            data[key.strip()] = np.array([float(x) for x in val.split()])
        self.P2 = data["P2"].reshape(3, 4)
        self.R0 = data["R0_rect"].reshape(3, 3)
        self.V2C = data["Tr_velo_to_cam"].reshape(3, 4)

    def rect_to_lidar(self, pts_rect):
        pts_ref = pts_rect @ np.linalg.inv(self.R0.T)
        pts_hom = np.hstack([pts_ref, np.ones((len(pts_ref), 1))])
        # invert [R|t]
        rt = np.vstack([self.V2C, [0, 0, 0, 1]])
        return (pts_hom @ np.linalg.inv(rt).T)[:, :3]

    def lidar_to_rect(self, pts_lidar):
        pts_hom = np.hstack([pts_lidar, np.ones((len(pts_lidar), 1))])
        return pts_hom @ self.V2C.T @ self.R0.T

    def rect_to_img(self, pts_rect):
        pts_hom = np.hstack([pts_rect, np.ones((len(pts_rect), 1))])
        pts_2d = pts_hom @ self.P2.T
        depth = pts_2d[:, 2]
        return pts_2d[:, :2] / np.clip(depth[:, None], 1e-6, None), depth


def parse_label_file(label_file):
    """Ref: utils/object3d_kitti.py. Returns list of dicts."""
    objects = []
    for line in Path(label_file).read_text().strip().splitlines():
        p = line.split()
        if len(p) < 15:
            continue
        objects.append({
            "name": p[0],
            "truncated": float(p[1]),
            "occluded": int(float(p[2])),
            "alpha": float(p[3]),
            "bbox": np.array([float(x) for x in p[4:8]]),
            "hwl": np.array([float(x) for x in p[8:11]]),  # h, w, l
            "loc": np.array([float(x) for x in p[11:14]]),  # camera coords
            "ry": float(p[14]),
            "score": float(p[15]) if len(p) > 15 else -1.0,
        })
    return objects


def boxes_camera_to_lidar(objects, calib):
    """Camera-frame labels → lidar (x, y, z, dx, dy, dz, heading)."""
    if not objects:
        return np.zeros((0, 7), np.float32), np.array([], dtype="<U20")
    loc = np.stack([o["loc"] for o in objects])
    hwl = np.stack([o["hwl"] for o in objects])
    ry = np.array([o["ry"] for o in objects])
    names = np.array([o["name"] for o in objects])

    loc_lidar = calib.rect_to_lidar(loc)
    h, w, l = hwl[:, 0], hwl[:, 1], hwl[:, 2]
    loc_lidar[:, 2] += h / 2  # bottom-center → geometric center
    heading = -(np.pi / 2 + ry)
    boxes = np.concatenate(
        [loc_lidar, l[:, None], w[:, None], h[:, None], heading[:, None]], axis=1
    ).astype(np.float32)
    return boxes, names


def boxes_lidar_to_camera(boxes_lidar, calib):
    """(N, 7) lidar boxes → (N, 7) camera-frame [x, y, z, l, h, w, ry]
    (ref: pcdet/utils/box_utils.py ``boxes3d_lidar_to_kitti_camera``)."""
    boxes_lidar = np.asarray(boxes_lidar, np.float64)
    if len(boxes_lidar) == 0:
        return np.zeros((0, 7), np.float64)
    xyz = boxes_lidar[:, :3].copy()
    l, w, h = boxes_lidar[:, 3], boxes_lidar[:, 4], boxes_lidar[:, 5]
    xyz[:, 2] -= h / 2  # geometric center → bottom center
    xyz_cam = calib.lidar_to_rect(xyz)
    r = -boxes_lidar[:, 6] - np.pi / 2
    return np.concatenate(
        [xyz_cam, l[:, None], h[:, None], w[:, None], r[:, None]], axis=1)


def boxes_camera_to_imageboxes(boxes_cam, calib, image_shape=None):
    """Camera boxes → image-plane [u1, v1, u2, v2] via the 8 corners
    (ref: box_utils.py ``boxes3d_kitti_camera_to_imageboxes``)."""
    boxes_cam = np.asarray(boxes_cam, np.float64)
    n = len(boxes_cam)
    if n == 0:
        return np.zeros((0, 4), np.float32)
    l, h, w = boxes_cam[:, 3], boxes_cam[:, 4], boxes_cam[:, 5]
    ry = boxes_cam[:, 6]
    xc = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)[None] * (l[:, None] / 2)
    yc = np.array([0, 0, 0, 0, -1, -1, -1, -1], np.float64)[None] * h[:, None]
    zc = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)[None] * (w[:, None] / 2)
    cosr, sinr = np.cos(ry), np.sin(ry)
    # rotation about the camera y axis
    xr = cosr[:, None] * xc + sinr[:, None] * zc
    zr = -sinr[:, None] * xc + cosr[:, None] * zc
    corners = np.stack([
        xr + boxes_cam[:, 0:1], yc + boxes_cam[:, 1:2], zr + boxes_cam[:, 2:3],
    ], axis=-1)  # (N, 8, 3)
    pts2d, _ = calib.rect_to_img(corners.reshape(-1, 3))
    pts2d = pts2d.reshape(n, 8, 2)
    bbox = np.concatenate(
        [pts2d.min(axis=1), pts2d.max(axis=1)], axis=1).astype(np.float32)
    if image_shape is not None:
        bbox[:, [0, 2]] = np.clip(bbox[:, [0, 2]], 0, image_shape[1] - 1)
        bbox[:, [1, 3]] = np.clip(bbox[:, [1, 3]], 0, image_shape[0] - 1)
    return bbox


def generate_kitti_prediction_dict(boxes_lidar, scores, labels, class_names,
                                   calib=None, image_shape=None):
    """Single-frame prediction → KITTI anno dict with camera fields
    (ref: kitti_dataset.py ``generate_prediction_dicts``): name, score,
    boxes_lidar always; alpha / bbox / location / dimensions / rotation_y
    when a calibration is available (feeds bbox-AP and AOS)."""
    boxes_lidar = np.asarray(boxes_lidar)[:, :7]
    names = np.asarray(class_names)[
        np.clip(np.asarray(labels, np.int64) - 1, 0, len(class_names) - 1)]
    out = {
        "name": names,
        "score": np.asarray(scores, np.float32),
        "scores": np.asarray(scores, np.float32),
        "boxes": boxes_lidar.astype(np.float32),
        "boxes_lidar": boxes_lidar.astype(np.float32),
    }
    if calib is not None and len(boxes_lidar):
        cam = boxes_lidar_to_camera(boxes_lidar, calib)
        out["bbox"] = boxes_camera_to_imageboxes(cam, calib, image_shape)
        out["alpha"] = (-np.arctan2(-boxes_lidar[:, 1], boxes_lidar[:, 0])
                        + cam[:, 6]).astype(np.float32)
        out["location"] = cam[:, :3].astype(np.float32)
        out["dimensions"] = cam[:, 3:6].astype(np.float32)
        out["rotation_y"] = cam[:, 6].astype(np.float32)
    elif len(boxes_lidar) == 0:
        out["bbox"] = np.zeros((0, 4), np.float32)
        out["alpha"] = np.zeros((0,), np.float32)
    return out


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         seed)
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        split_file = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_id_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else []
        )
        self.kitti_dir = self.root_path / (
            "training" if self.split != "test" else "testing"
        )
        self.fov_points_only = bool(dataset_cfg.get("FOV_POINTS_ONLY", True))

    def __len__(self):
        return len(self.sample_id_list)

    def get_lidar(self, idx):
        return np.fromfile(
            self.kitti_dir / "velodyne" / f"{idx}.bin", np.float32
        ).reshape(-1, 4)

    def get_calib(self, idx):
        return Calibration(self.kitti_dir / "calib" / f"{idx}.txt")

    def get_label(self, idx):
        return parse_label_file(self.kitti_dir / "label_2" / f"{idx}.txt")

    def _fov_flag(self, points, calib, img_shape=(375, 1242)):
        pts_rect = calib.lidar_to_rect(points[:, :3])
        pts_img, depth = calib.rect_to_img(pts_rect)
        return (
            (pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
            & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0])
            & (depth >= 0)
        )

    def __getitem__(self, index):
        idx = self.sample_id_list[index]
        points = self.get_lidar(idx)
        calib = self.get_calib(idx)
        if self.fov_points_only:
            points = points[self._fov_flag(points, calib)]

        input_dict = {"points": points, "frame_id": idx}
        label_file = self.kitti_dir / "label_2" / f"{idx}.txt"
        if label_file.exists():
            objects = [o for o in self.get_label(idx) if o["name"] != "DontCare"]
            gt_boxes, gt_names = boxes_camera_to_lidar(objects, calib)
            input_dict.update({"gt_boxes": gt_boxes, "gt_names": gt_names})
        return self.prepare_data(input_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        """EVAL_METRIC 'kitti' → official-protocol R40 AP with difficulty
        buckets + ignored-GT semantics (utils/kitti_eval.py, ref:
        kitti_object_eval_python/eval.py:448,639); anything else → the fast
        proxy."""
        metric = self.dataset_cfg.get("EVAL_METRIC", "kitti")
        if metric == "kitti":
            from ..utils.kitti_eval import kitti_official_eval

            return kitti_official_eval(
                det_annos, kwargs["gt_annos"], class_names)
        from ..utils.eval_ap import kitti_style_eval

        return kitti_style_eval(det_annos, kwargs["gt_annos"], class_names)

    # ------------------------- data preparation ------------------------- #

    def get_infos(self, has_label=True, count_inside_pts=True):
        """Per-frame info dicts (ref: kitti_dataset.py get_infos): calib,
        camera annos (name/truncated/occluded/bbox/dimensions/location/ry),
        lidar boxes, num_points_in_gt."""
        from ..utils.geometry import points_in_boxes_numpy

        infos = []
        for idx in self.sample_id_list:
            info = {
                "point_cloud": {"num_features": 4, "lidar_idx": idx},
                "image": {"image_idx": idx},
            }
            calib = self.get_calib(idx)
            info["calib"] = {"P2": calib.P2, "R0_rect": calib.R0,
                             "Tr_velo_to_cam": calib.V2C}
            if has_label:
                objects = self.get_label(idx)
                annos = {
                    "name": np.array([o["name"] for o in objects]),
                    "truncated": np.array([o["truncated"] for o in objects]),
                    "occluded": np.array([o["occluded"] for o in objects]),
                    "alpha": np.array([o["alpha"] for o in objects]),
                    "bbox": (np.stack([o["bbox"] for o in objects])
                             if objects else np.zeros((0, 4))),
                }
                care = [o for o in objects if o["name"] != "DontCare"]
                gt_boxes, _ = boxes_camera_to_lidar(care, calib)
                annos["gt_boxes_lidar"] = gt_boxes
                if count_inside_pts:
                    pts = self.get_lidar(idx)
                    inb = points_in_boxes_numpy(pts[:, :3], gt_boxes)
                    n_in = inb.sum(0)
                    # DontCare rows get -1, care rows their counts (ref)
                    counts = np.full(len(objects), -1, np.int64)
                    ci = 0
                    for oi, o in enumerate(objects):
                        if o["name"] != "DontCare":
                            counts[oi] = int(n_in[ci]) if len(gt_boxes) else 0
                            ci += 1
                    annos["num_points_in_gt"] = counts
                info["annos"] = annos
            infos.append(info)
        return infos

    def create_groundtruth_database(self, infos, used_classes=None,
                                    split="train"):
        """Per-object point crops + dbinfos pkl for gt_sampling (ref:
        kitti_dataset.py create_groundtruth_database)."""
        import pickle

        from ..utils.geometry import points_in_boxes_numpy

        db_path = self.root_path / f"gt_database_{split}"
        db_info_path = self.root_path / f"kitti_dbinfos_{split}.pkl"
        db_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        for info in infos:
            idx = info["point_cloud"]["lidar_idx"]
            points = self.get_lidar(idx)
            annos = info["annos"]
            care = annos["name"] != "DontCare"
            names = annos["name"][care]
            gt_boxes = annos["gt_boxes_lidar"]
            if len(gt_boxes) == 0:
                continue
            inb = points_in_boxes_numpy(points[:, :3], gt_boxes)
            for i in range(len(gt_boxes)):
                if used_classes is not None and names[i] not in used_classes:
                    continue
                filename = f"{idx}_{names[i]}_{i}.bin"
                gt_points = points[inb[:, i]].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.astype(np.float32).tofile(db_path / filename)
                all_db_infos.setdefault(names[i], []).append({
                    "name": names[i],
                    "path": str((db_path / filename).relative_to(self.root_path)),
                    "image_idx": idx, "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": int(inb[:, i].sum()),
                    "difficulty": 0,
                })
        with open(db_info_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return db_info_path


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path):
    """CLI pipeline (ref: kitti_dataset.py create_kitti_infos): info pkls
    for train/val/trainval + GT database for the train split.

    CLI: python -m mssvt_tpu_torch.datasets.kitti --cfg_file <dataset yaml>
    """
    import pickle

    splits = {"train": "train", "val": "val"}
    infos_by_split = {}
    for split, name in splits.items():
        cfg = dict(dataset_cfg)
        cfg["DATA_SPLIT"] = {"train": name, "test": name}
        ds = KittiDataset(
            dataset_cfg=type(dataset_cfg)(cfg), class_names=class_names,
            training=False, root_path=Path(data_path),
        )
        ds.split = name
        infos = ds.get_infos()
        infos_by_split[split] = infos
        out = Path(save_path) / f"kitti_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"kitti info {split} saved to {out} ({len(infos)} frames)")
    with open(Path(save_path) / "kitti_infos_trainval.pkl", "wb") as f:
        pickle.dump(infos_by_split["train"] + infos_by_split["val"], f)

    cfg = dict(dataset_cfg)
    cfg["DATA_SPLIT"] = {"train": "train", "test": "train"}
    ds = KittiDataset(
        dataset_cfg=type(dataset_cfg)(cfg), class_names=class_names,
        training=False, root_path=Path(data_path),
    )
    ds.create_groundtruth_database(
        infos_by_split["train"], used_classes=list(class_names))
    print("---------------Data preparation Done---------------")


if __name__ == "__main__":
    import argparse

    import yaml

    from ..utils.edict import EasyDict

    parser = argparse.ArgumentParser(description="KITTI data preparation")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--func", type=str, default="create_kitti_infos")
    parser.add_argument("--data_path", type=str, default=None)
    args = parser.parse_args()
    assert args.func == "create_kitti_infos", args.func
    cfg = EasyDict(yaml.safe_load(open(args.cfg_file)))
    data_path = args.data_path or cfg.DATA_PATH
    create_kitti_infos(
        dataset_cfg=cfg, class_names=["Car", "Pedestrian", "Cyclist"],
        data_path=data_path, save_path=data_path,
    )
