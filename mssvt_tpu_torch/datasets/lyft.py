"""Lyft Level-5 dataset (ref: pcdet/datasets/lyft/lyft_dataset.py, 345 LoC
+ lyft_utils.py, lyft_mAP_eval/lyft_eval.py; the port's copy of
``mssvt_tpu/datasets/lyft.py``).

Reads pre-extracted info pkls (the reference builds them with the external
``lyft_dataset_sdk``, lazily imported here for raw access); boxes are stored
lidar-frame 7-DOF + velocity like the reference's ``gt_boxes``. Evaluation:
the Lyft mAP protocol (mean AP over IoU thresholds 0.5:0.05:0.95 — the
Kaggle metric, ref lyft_eval.py get_average_precisions) implemented in
numpy on BEV IoU.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate


class LyftDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         seed)
        self.infos = []
        info_paths = dataset_cfg.get("INFO_PATH", {}).get(self.mode, [])
        for p in info_paths:
            path = self.root_path / p if self.root_path else Path(p)
            if not path.exists():
                if logger:
                    logger.warning(f"lyft info missing: {path}")
                continue
            with open(path, "rb") as f:
                self.infos.extend(pickle.load(f))
        self.max_sweeps = int(dataset_cfg.get("MAX_SWEEPS", 1))

    def __len__(self):
        return len(self.infos)

    def get_lidar_with_sweeps(self, info):
        """Aggregate the keyframe + up to MAX_SWEEPS-1 previous sweeps with
        per-sweep time-lag channel (ref: lyft_dataset.py:95-140)."""
        path = self.root_path / info["lidar_path"]
        points = np.fromfile(path, np.float32).reshape(-1, 5)[:, :4]
        sweeps = [np.concatenate(
            [points, np.zeros((len(points), 1), np.float32)], axis=1)]
        for sweep in info.get("sweeps", [])[: self.max_sweeps - 1]:
            sp = np.fromfile(
                self.root_path / sweep["lidar_path"], np.float32
            ).reshape(-1, 5)[:, :4]
            if "transform_matrix" in sweep and sweep["transform_matrix"] is not None:
                tm = np.asarray(sweep["transform_matrix"])
                xyz1 = np.concatenate(
                    [sp[:, :3], np.ones((len(sp), 1), np.float32)], axis=1)
                sp[:, :3] = (xyz1 @ tm.T)[:, :3]
            lag = np.full((len(sp), 1), sweep.get("time_lag", 0.0), np.float32)
            sweeps.append(np.concatenate([sp, lag], axis=1))
        return np.concatenate(sweeps, axis=0)

    def __getitem__(self, index):
        info = self.infos[index]
        points = self.get_lidar_with_sweeps(info)
        input_dict = {
            "points": points,
            "frame_id": info.get("token", str(index)),
        }
        if "gt_boxes" in info:
            input_dict["gt_boxes"] = np.asarray(
                info["gt_boxes"], np.float32)[:, :7]
            input_dict["gt_names"] = np.asarray(info["gt_names"])
        return self.prepare_data(input_dict)

    # ------------------------------ eval ------------------------------ #

    @staticmethod
    def lyft_map_eval(det_frames, gt_frames, class_names,
                      iou_thresholds=None):
        """Kaggle Lyft mAP: mean AP over BEV-IoU thresholds 0.5..0.95
        (ref: lyft_mAP_eval/lyft_eval.py get_average_precisions)."""
        from ..utils.eval_ap import eval_class_ap

        iou_thresholds = iou_thresholds or np.arange(0.5, 1.0, 0.05)
        results = {}
        for cls_i, cls in enumerate(class_names):
            aps = []
            for thr in iou_thresholds:
                ap, _ = eval_class_ap(
                    det_frames, gt_frames, cls_i + 1, iou_thresh=float(thr),
                    metric="bev",
                )
                aps.append(ap)
            results[f"{cls}/mAP"] = float(np.mean(aps))
        results["mAP"] = float(np.mean(list(results.values())))
        return results

    def evaluation(self, det_annos, class_names, **kwargs):
        metric = self.dataset_cfg.get("EVAL_METRIC", "lyft")
        if metric == "lyft":
            res = self.lyft_map_eval(det_annos, kwargs["gt_annos"], class_names)
            report = "Lyft mAP (IoU 0.5:0.05:0.95):\n" + "\n".join(
                f"  {k}: {v:.4f}" for k, v in sorted(res.items()))
            return report, res
        from ..utils.eval_ap import kitti_style_eval

        return kitti_style_eval(det_annos, kwargs["gt_annos"], class_names)
