"""Average-precision evaluation (numpy, host-side; the port's copy of
``mssvt_tpu/utils/eval_ap.py``).

Fast-proxy evaluator in the spirit of the reference's KITTI-style AP path
(ref: pcdet/datasets/kitti/kitti_object_eval_python/eval.py:448,639 — used as
the fast Waymo metric, waymo_dataset.py:272-292): the rotated BEV/3D IoU in
numpy (24-candidate polygon areas), greedy score-ordered matching, 40
recall points.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

N_RECALL_POINTS = 40


def _corners_bev_np(boxes):
    x, y = boxes[:, 0], boxes[:, 1]
    dx, dy, h = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    c, s = np.cos(h), np.sin(h)
    lx = np.stack([dx, -dx, -dx, dx], -1) / 2
    ly = np.stack([dy, dy, -dy, -dy], -1) / 2
    cx = lx * c[:, None] - ly * s[:, None] + x[:, None]
    cy = lx * s[:, None] + ly * c[:, None] + y[:, None]
    return np.stack([cx, cy], -1)


def _poly_area_np(ca, cb):
    """Intersection area of convex ccw quads via the 24-candidate method
    (pure host math; ops/box_ops.rotated_intersection_area computes the
    same area with an edge-clip/Green's-theorem formulation)."""
    eps = 1e-8

    def pts_in_quad(pts, quad):
        a = quad
        b = np.roll(quad, -1, axis=-2)
        e = (b - a)[..., :, None, :]
        ap = pts[..., None, :, :] - a[..., :, None, :]
        cr = e[..., 0] * ap[..., 1] - e[..., 1] * ap[..., 0]
        return np.all(cr >= -eps, axis=-2)

    a0, a1 = ca, np.roll(ca, -1, -2)
    b0, b1 = cb, np.roll(cb, -1, -2)
    p = a0[..., :, None, :]
    r = (a1 - a0)[..., :, None, :]
    q = b0[..., None, :, :]
    s_ = (b1 - b0)[..., None, :, :]
    rxs = r[..., 0] * s_[..., 1] - r[..., 1] * s_[..., 0]
    safe = np.where(np.abs(rxs) < eps, 1.0, rxs)
    qp = q - p
    t = (qp[..., 0] * s_[..., 1] - qp[..., 1] * s_[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    ivalid = (np.abs(rxs) >= eps) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    ipts = p + t[..., None] * r
    lead = ipts.shape[:-3]
    ipts = ipts.reshape(lead + (16, 2))
    ivalid = ivalid.reshape(lead + (16,))

    pts = np.concatenate([ipts, ca, cb], axis=-2)
    valid = np.concatenate([ivalid, pts_in_quad(ca, cb), pts_in_quad(cb, ca)], -1)
    count = valid.sum(-1)
    centroid = (pts * valid[..., None]).sum(-2) / np.clip(count, 1, None)[..., None]
    rel = pts - centroid[..., None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    key = np.where(valid, ang, 1e9)
    order = np.argsort(key, axis=-1)
    srel = np.take_along_axis(rel, order[..., None], axis=-2)
    n_c = pts.shape[-2]
    idx = np.arange(n_c)
    nxt = np.where(idx[None] + 1 < count[..., None], idx + 1, 0)
    p_n = np.take_along_axis(srel, nxt[..., None], axis=-2)
    cross = srel[..., 0] * p_n[..., 1] - srel[..., 1] * p_n[..., 0]
    term = idx[None] < count[..., None]
    area = 0.5 * np.abs(np.where(term, cross, 0.0).sum(-1))
    return np.where(count >= 3, area, 0.0)


def _frame_iou(det_boxes, gt_boxes, metric="bev"):
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(det_boxes), len(gt_boxes)), np.float32)
    ca = _corners_bev_np(det_boxes[:, :7].astype(np.float64))
    cb = _corners_bev_np(gt_boxes[:, :7].astype(np.float64))
    n, m = len(det_boxes), len(gt_boxes)
    inter = _poly_area_np(
        np.broadcast_to(ca[:, None], (n, m, 4, 2)),
        np.broadcast_to(cb[None, :], (n, m, 4, 2)),
    )
    if metric == "3d":
        za0 = det_boxes[:, 2] - det_boxes[:, 5] / 2
        za1 = det_boxes[:, 2] + det_boxes[:, 5] / 2
        zb0 = gt_boxes[:, 2] - gt_boxes[:, 5] / 2
        zb1 = gt_boxes[:, 2] + gt_boxes[:, 5] / 2
        zo = np.clip(
            np.minimum(za1[:, None], zb1[None]) - np.maximum(za0[:, None], zb0[None]),
            0, None,
        )
        inter = inter * zo
        va = (det_boxes[:, 3] * det_boxes[:, 4] * det_boxes[:, 5])[:, None]
        vb = (gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5])[None]
        return (inter / np.clip(va + vb - inter, 1e-6, None)).astype(np.float32)
    aa = (det_boxes[:, 3] * det_boxes[:, 4])[:, None]
    ab = (gt_boxes[:, 3] * gt_boxes[:, 4])[None]
    return (inter / np.clip(aa + ab - inter, 1e-6, None)).astype(np.float32)


def eval_class_ap(
    det_frames: List[Dict], gt_frames: List[Dict], class_id: int,
    iou_thresh: float, metric: str = "bev",
):
    """AP for one class over a list of frames.

    det_frames[i]: {'boxes' (N,7), 'scores' (N,), 'labels' (N,) 1-based}
    gt_frames[i]:  {'boxes' (M,7), 'labels' (M,) 1-based}
    """
    all_scores, all_tp = [], []
    total_gt = 0
    for det, gt in zip(det_frames, gt_frames):
        dmask = det["labels"] == class_id
        gmask = gt["labels"] == class_id
        dboxes, dscores = det["boxes"][dmask], det["scores"][dmask]
        gboxes = gt["boxes"][gmask]
        total_gt += len(gboxes)

        order = np.argsort(-dscores)
        dboxes, dscores = dboxes[order], dscores[order]
        iou = _frame_iou(dboxes, gboxes, metric)
        matched = np.zeros(len(gboxes), bool)
        tp = np.zeros(len(dboxes), bool)
        for i in range(len(dboxes)):
            if len(gboxes) == 0:
                break
            j = int(np.argmax(np.where(matched, -1.0, iou[i])))
            if not matched[j] and iou[i, j] >= iou_thresh:
                matched[j] = True
                tp[i] = True
        all_scores.append(dscores)
        all_tp.append(tp)

    if total_gt == 0:
        return float("nan"), {}
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tps = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    order = np.argsort(-scores)
    tps = tps[order]
    cum_tp = np.cumsum(tps)
    cum_fp = np.cumsum(~tps)
    recall = cum_tp / total_gt
    precision = cum_tp / np.clip(cum_tp + cum_fp, 1, None)

    # interpolated AP over 40 recall points (KITTI R40 protocol)
    ap = 0.0
    for r in np.linspace(1.0 / N_RECALL_POINTS, 1.0, N_RECALL_POINTS):
        prec = precision[recall >= r]
        ap += (prec.max() if len(prec) else 0.0) / N_RECALL_POINTS
    max_recall = float(recall[-1]) if len(recall) else 0.0
    return float(ap), {"max_recall": max_recall, "num_gt": total_gt}


def kitti_style_eval(
    det_frames: List[Dict], gt_frames: List[Dict], class_names: Sequence[str],
    iou_thresholds=None, metric: str = "bev",
):
    """Per-class AP table. Default IoU thresholds follow the Waymo protocol
    (Vehicle 0.7, others 0.5 — ref: waymo_eval.py:95-99)."""
    if iou_thresholds is None:
        iou_thresholds = [
            0.7 if n.lower() in ("vehicle", "car") else 0.5 for n in class_names
        ]
    result = {}
    lines = []
    for ci, (name, th) in enumerate(zip(class_names, iou_thresholds)):
        ap, extra = eval_class_ap(det_frames, gt_frames, ci + 1, th, metric)
        result[f"{name}_ap_{metric}_{th}"] = ap
        result.update({f"{name}_{k}": v for k, v in extra.items()})
        lines.append(f"{name:12s} AP@{th:.1f} ({metric}): {ap * 100:.2f}")
    result["mAP"] = float(np.nanmean([
        result[f"{n}_ap_{metric}_{t}"] for n, t in zip(class_names, iou_thresholds)
    ]))
    return "\n".join(lines) + f"\nmAP: {result['mAP'] * 100:.2f}", result
