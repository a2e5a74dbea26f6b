"""Official-protocol Waymo detection metrics: AP / APH, LEVEL_1 / LEVEL_2
(the port's copy of ``mssvt_tpu/datasets/waymo_eval.py``).

Rebuild of ref pcdet/datasets/waymo/waymo_eval.py:23-246
(``OpenPCDetWaymoDetectionMetricsEstimator``). Two backends:

1. When the ``waymo_open_dataset`` package is importable, the official TF
   metric ops run (exactly the reference path, ref :110-146).
2. Otherwise a self-contained numpy implementation of the same protocol:
     - class-specific IoU thresholds: Vehicle 0.7, Pedestrian 0.5,
       Cyclist 0.5 (ref :95-99);
     - 7-DOF 3D IoU (rotated BEV intersection x z-overlap), the port's
       ``ops.box_ops.pairwise_iou_3d`` on CPU tensors (host-side metric
       code, never on a card);
     - per-frame Hungarian matching maximizing total IoU over
       threshold-gated pairs (scipy linear_sum_assignment — the official
       matcher is TYPE_HUNGARIAN, ref :100);
     - difficulty re-bucketing: GT with <= 5 points -> LEVEL_2 when the
       annotated difficulty is 0 (ref :44-48);
     - LEVEL_1 metric ignores LEVEL_2 ground truths (matches to them are
       discarded, they are never false negatives); LEVEL_2 counts all;
     - P/R curve over score cutoffs, AP = integral of the
       monotone-decreasing precision envelope over recall; APH weights
       every true positive by its heading accuracy
       max(0, 1 - |delta_heading|/pi).

Returned keys mirror the official strings, e.g.
``OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.box_ops import pairwise_iou_3d

# Waymo class ids (label.proto): 1 vehicle, 2 pedestrian, 3 sign, 4 cyclist
WAYMO_CLASSES = {
    "unknown": 0, "Vehicle": 1, "Pedestrian": 2, "Sign": 3, "Cyclist": 4,
    # KITTI-style aliases accepted for convenience
    "Car": 1, "Truck": 1,
}
IOU_THRESH = {1: 0.7, 2: 0.5, 3: 0.5, 4: 0.5}
TYPE_NAME = {1: "VEHICLE", 2: "PEDESTRIAN", 3: "SIGN", 4: "CYCLIST"}


def _boxes_iou3d_numpy(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) 3D IoU on the host (f32 CPU tensors)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    return pairwise_iou_3d(
        torch.as_tensor(np.asarray(boxes_a, np.float32)),
        torch.as_tensor(np.asarray(boxes_b, np.float32))).numpy()


def generate_waymo_type_results(infos, class_names, is_gt=False,
                                fake_gt_infos=True):
    """Annos → flat arrays (ref: waymo_eval.py:26-84).

    Returns frame_id, boxes3d (N, 7), type (N,), score (N,), overlap_nlz (N,),
    difficulty (N,).
    """
    frame_id, boxes3d, obj_type, score, overlap_nlz, difficulty = (
        [], [], [], [], [], [])
    for fid, info in enumerate(infos):
        if is_gt:
            box_mask = np.isin(info["name"], list(class_names))
            if "num_points_in_gt" in info:
                zero_diff = info["difficulty"] == 0 if "difficulty" in info \
                    else np.ones(len(info["name"]), bool)
                num_pts = info["num_points_in_gt"]
                nonzero_mask = num_pts > 0
                box_mask = box_mask & nonzero_mask
                diff = np.asarray(
                    info.get("difficulty", np.zeros(len(info["name"]))),
                    np.int64).copy()
                # difficulty 0 → re-bucket by point count (ref :44-48)
                diff[zero_diff & (num_pts <= 5)] = 2
                diff[zero_diff & (num_pts > 5)] = 1
            else:
                diff = np.ones(len(info["name"]), np.int64)
                if not fake_gt_infos:
                    raise ValueError("num_points_in_gt missing from gt infos")
            boxes = np.asarray(info["gt_boxes_lidar"])[box_mask]
            names = np.asarray(info["name"])[box_mask]
            diff = diff[box_mask]
            scores = np.ones(len(boxes), np.float32)
        else:
            boxes = np.asarray(info["boxes_lidar"]
                               if "boxes_lidar" in info else info["boxes"])
            names = np.asarray(info["name"])
            scores = np.asarray(info["score"], np.float32)
            diff = np.zeros(len(boxes), np.int64)

        frame_id.append(np.full(len(boxes), fid, np.int64))
        boxes3d.append(boxes[:, :7].astype(np.float64)
                       if len(boxes) else np.zeros((0, 7)))
        obj_type.append(np.asarray(
            [WAYMO_CLASSES.get(str(n), 0) for n in names], np.int64))
        score.append(scores)
        overlap_nlz.append(np.zeros(len(boxes), bool))
        difficulty.append(diff)

    cat = lambda xs, d=None: (np.concatenate(xs) if xs else np.zeros(0))
    return (cat(frame_id), np.concatenate(boxes3d) if boxes3d else
            np.zeros((0, 7)), cat(obj_type), cat(score), cat(overlap_nlz),
            cat(difficulty))


def _match_frame(pred_boxes, gt_boxes, iou_thresh):
    """Hungarian matching maximizing total IoU over gated pairs.

    Returns (pred_idx, gt_idx, iou) arrays for matched pairs.
    """
    iou = _boxes_iou3d_numpy(pred_boxes, gt_boxes)
    gated = np.where(iou >= iou_thresh, iou, 0.0)
    if gated.size == 0 or not np.any(gated > 0):
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    from scipy.optimize import linear_sum_assignment

    pi, gi = linear_sum_assignment(-gated)
    ok = gated[pi, gi] > 0
    return pi[ok], gi[ok], iou[pi[ok], gi[ok]]


def _heading_accuracy(pred_h, gt_h):
    d = np.abs(pred_h - gt_h) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return np.maximum(0.0, 1.0 - d / np.pi)


def _pr_to_ap(recall, precision):
    """AP = area under the monotone-decreasing precision envelope."""
    order = np.argsort(recall)
    r = np.concatenate([[0.0], recall[order], [recall[order][-1]]]) \
        if len(recall) else np.array([0.0, 0.0])
    p = np.concatenate([[1.0], precision[order], [0.0]]) \
        if len(precision) else np.array([0.0, 0.0])
    # monotone envelope from the right
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


def compute_waymo_metrics(prediction_infos, gt_infos, class_names,
                          num_cutoffs: int = 100,
                          fake_gt_infos: bool = True):
    """Numpy AP/APH L1/L2 (protocol per ref waymo_eval.py:86-146).

    Args:
        prediction_infos: list of per-frame dicts with name/score/boxes_lidar.
        gt_infos: list of per-frame dicts with name/difficulty/
            num_points_in_gt/gt_boxes_lidar (the reference passes the annos
            of the dataset infos, ref waymo_dataset.py:296-303).

    Returns:
        dict of "OBJECT_TYPE_TYPE_<CLS>_LEVEL_<L>/AP|APH" → float.
    """
    assert len(prediction_infos) == len(gt_infos), \
        (len(prediction_infos), len(gt_infos))
    pd = generate_waymo_type_results(prediction_infos, class_names, is_gt=False)
    gt = generate_waymo_type_results(gt_infos, class_names, is_gt=True,
                                     fake_gt_infos=fake_gt_infos)
    pd_fid, pd_box, pd_type, pd_score, _, _ = pd
    gt_fid, gt_box, gt_type, _, _, gt_diff = gt

    n_frames = len(prediction_infos)
    results = {}
    for cls_name in class_names:
        ctype = WAYMO_CLASSES[str(cls_name)]
        thr = IOU_THRESH[ctype]

        # per-frame matches, collected once, reused for every cutoff
        # each pred: (score, matched, heading_acc, gt_difficulty)
        rows = []
        n_gt_l1 = 0
        n_gt_l2 = 0
        for f in range(n_frames):
            pm = (pd_fid == f) & (pd_type == ctype)
            gm = (gt_fid == f) & (gt_type == ctype)
            pb, ps = pd_box[pm], pd_score[pm]
            gb, gd = gt_box[gm], gt_diff[gm]
            n_gt_l1 += int((gd == 1).sum())
            n_gt_l2 += len(gb)
            order = np.argsort(-ps)
            pb, ps = pb[order], ps[order]
            pi, gi, _ = _match_frame(pb, gb, thr)
            matched = np.zeros(len(pb), bool)
            hacc = np.zeros(len(pb))
            mdiff = np.zeros(len(pb), np.int64)
            matched[pi] = True
            if len(pi):
                hacc[pi] = _heading_accuracy(pb[pi, 6], gb[gi, 6])
                mdiff[pi] = gd[gi]
            rows.append(np.stack([
                ps, matched.astype(np.float64), hacc, mdiff.astype(np.float64)
            ], axis=1) if len(pb) else np.zeros((0, 4)))
        allp = np.concatenate(rows) if rows else np.zeros((0, 4))

        for level, n_gt in ((1, n_gt_l1), (2, n_gt_l2)):
            if level == 1:
                # L2-only GT are "ignore": drop preds matched to them
                keep = ~((allp[:, 1] > 0) & (allp[:, 3] == 2))
                p = allp[keep]
            else:
                p = allp
            # EXACT rank-based PR curve: every distinct score is a cutoff
            # (cumulative tp over the descending-score ordering). The
            # official op subsamples ~num_cutoffs score quantiles
            # (ref: waymo_eval.py:95-104 desired_score_cutoffs); the exact
            # curve is its num_cutoffs→∞ limit — no score quantization
            # drift in the headline number.
            if len(p) == 0 or n_gt == 0:
                rec = prec = prec_h = np.zeros(0)
            else:
                order = np.argsort(-p[:, 0], kind="stable")
                ps = p[order]
                tp_c = np.cumsum(ps[:, 1])
                tph_c = np.cumsum(ps[:, 1] * ps[:, 2])
                ranks = np.arange(1, len(ps) + 1, dtype=np.float64)
                # collapse ties: evaluate only at the LAST index of each
                # distinct score (>= cutoff includes all tied preds)
                last = np.ones(len(ps), bool)
                last[:-1] = ps[:-1, 0] != ps[1:, 0]
                prec = tp_c[last] / ranks[last]
                prec_h = tph_c[last] / ranks[last]
                rec = tp_c[last] / n_gt
            key = f"OBJECT_TYPE_TYPE_{TYPE_NAME[ctype]}_LEVEL_{level}"
            results[key + "/AP"] = _pr_to_ap(np.asarray(rec), np.asarray(prec))
            results[key + "/APH"] = _pr_to_ap(np.asarray(rec), np.asarray(prec_h))
    return results


class OpenPCDetWaymoDetectionMetricsEstimator:
    """API-compatible estimator (ref: waymo_eval.py:23-246)."""

    def waymo_evaluation(self, prediction_infos, gt_infos, class_name,
                         distance_thresh=100, fake_gt_infos=True):
        try:
            return self._official_tf_eval(
                prediction_infos, gt_infos, class_name, distance_thresh,
                fake_gt_infos,
            )
        except ImportError:
            return compute_waymo_metrics(
                prediction_infos, gt_infos, class_name,
                fake_gt_infos=fake_gt_infos,
            )

    # ---------------- official TF backend (optional) ---------------- #

    def _official_tf_eval(self, prediction_infos, gt_infos, class_name,
                          distance_thresh, fake_gt_infos):
        """Exact reference path (ref :86-146); needs waymo-open-dataset.
        Its absence raises before tensorflow is imported."""
        from waymo_open_dataset import dataset_pb2  # noqa: F401
        from waymo_open_dataset.metrics.python import detection_metrics
        from waymo_open_dataset.protos import metrics_pb2
        import tensorflow as tf

        pd = generate_waymo_type_results(prediction_infos, class_name, False)
        gt = generate_waymo_type_results(gt_infos, class_name, True,
                                         fake_gt_infos)
        pd_fid, pd_box, pd_type, pd_score, pd_nlz, _ = pd
        gt_fid, gt_box, gt_type, _, gt_nlz, gt_diff = gt

        config = metrics_pb2.Config()
        config_text = """
        breakdown_generator_ids: OBJECT_TYPE
        difficulties { levels: 1 levels: 2 }
        matcher_type: TYPE_HUNGARIAN
        iou_thresholds: 0.0
        iou_thresholds: 0.7
        iou_thresholds: 0.5
        iou_thresholds: 0.5
        iou_thresholds: 0.5
        box_type: TYPE_3D
        """
        for x in range(0, 100):
            config_text += f"\n        score_cutoffs: {x * 0.01:.2f}"
        from google.protobuf import text_format

        text_format.Merge(config_text, config)

        dist_ok = np.linalg.norm(pd_box[:, :2], axis=-1) < distance_thresh
        gt_ok = np.linalg.norm(gt_box[:, :2], axis=-1) < distance_thresh
        metrics = detection_metrics.get_detection_metric_ops(
            config,
            prediction_frame_id=tf.constant(pd_fid[dist_ok]),
            prediction_bbox=tf.constant(pd_box[dist_ok]),
            prediction_type=tf.constant(pd_type[dist_ok]),
            prediction_score=tf.constant(pd_score[dist_ok]),
            prediction_overlap_nlz=tf.constant(pd_nlz[dist_ok]),
            ground_truth_frame_id=tf.constant(gt_fid[gt_ok]),
            ground_truth_bbox=tf.constant(gt_box[gt_ok]),
            ground_truth_type=tf.constant(gt_type[gt_ok]),
            ground_truth_difficulty=tf.constant(gt_diff[gt_ok]),
            ground_truth_speed=None,
        )
        return {k: float(v[0]) for k, v in metrics.items()}


def format_waymo_results(results: dict) -> str:
    lines = ["Waymo official-protocol detection metrics:"]
    for k in sorted(results):
        lines.append(f"  {k}: {results[k]:.4f}")
    return "\n".join(lines)
