"""Official-protocol KITTI 3D/BEV AP evaluator (numpy, host-side; the
port's copy of ``mssvt_tpu/utils/kitti_eval.py``).

Rebuild of ref pcdet/datasets/kitti/kitti_object_eval_python/eval.py
(:448 ``eval_class``, :639 ``get_official_eval_result``) minus the numba/CUDA
machinery. Matches the official semantics:

- difficulty buckets easy/moderate/hard by 2D bbox height, occlusion and
  truncation (MIN_HEIGHT [40, 25, 25] px, MAX_OCCLUSION [0, 1, 2],
  MAX_TRUNCATION [0.15, 0.30, 0.50]) when those annotations are present;
  lidar-only annos (no camera fields) fall into every bucket;
- "ignored" ground truth: boxes of a harder difficulty, neighbor classes
  (Van↔Car, Person_sitting↔Pedestrian) and DontCare regions neither count
  as false negatives nor penalize detections matched to them;
- score thresholds sampled at 41 recall points from the sorted
  true-positive scores (``get_thresholds``, ref eval.py:27-44), AP_R40 =
  mean precision over thresholds 1..40;
- metrics: BEV AP (rotated BEV IoU) and 3D AP (BEV x z-overlap), per class
  per difficulty; IoU thresholds 0.7 (Car) / 0.5 (Ped, Cyc).

- image-plane 2D AP ("bbox" metric, axis-aligned image IoU) and AOS
  (orientation similarity (1+cos Δalpha)/2 accumulated over TPs, reported as
  a precision-style curve — ref eval.py:290 ``compute_statistics_jit``
  with compute_aos) when the annos carry camera ``bbox``/``alpha`` fields;
  detections whose image-box height falls under the difficulty's MIN_HEIGHT
  are "ignored detections" — they may take a GT (which then counts neither
  TP nor FN) and never count as FP, mirroring the official matcher.
"""

from __future__ import annotations

import numpy as np

from .eval_ap import _frame_iou


def _bbox_iou_2d(det, gt):
    """Axis-aligned image-plane IoU (ref: eval.py ``image_box_overlap``)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    x1 = np.maximum(det[:, None, 0], gt[None, :, 0])
    y1 = np.maximum(det[:, None, 1], gt[None, :, 1])
    x2 = np.minimum(det[:, None, 2], gt[None, :, 2])
    y2 = np.minimum(det[:, None, 3], gt[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a_det = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    a_gt = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    return inter / np.maximum(a_det[:, None] + a_gt[None] - inter, 1e-9)

MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.30, 0.50]
NEIGHBOR_CLASSES = {
    "Car": ["Van"],
    "Pedestrian": ["Person_sitting"],
    "Cyclist": [],
}
IOU_THRESH = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
N_SAMPLE_PTS = 41


def clean_data(gt_names, gt_anno, current_class, difficulty):
    """Per-frame GT triage (ref: eval.py ``clean_data``:47-111).

    Returns (care (G,) bool, ignored (G,) bool) — ignored boxes are matched
    but never counted; everything else is either care-FG or irrelevant.
    """
    g = len(gt_names)
    care = np.zeros(g, bool)
    ignored = np.zeros(g, bool)
    neighbors = NEIGHBOR_CLASSES.get(str(current_class), [])
    heights = gt_anno.get("bbox")
    occl = gt_anno.get("occluded")
    trunc = gt_anno.get("truncated")
    for i in range(g):
        name = str(gt_names[i])
        if name == "DontCare":
            ignored[i] = True
            continue
        same = name == str(current_class)
        neighbor = name in neighbors
        if not (same or neighbor):
            continue
        too_hard = False
        if heights is not None and occl is not None and trunc is not None:
            h = heights[i][3] - heights[i][1]
            too_hard = (
                h <= MIN_HEIGHT[difficulty]
                or occl[i] > MAX_OCCLUSION[difficulty]
                or trunc[i] > MAX_TRUNCATION[difficulty]
            )
        if same and not too_hard:
            care[i] = True
        else:  # harder-bucket same-class or neighbor class → ignore
            ignored[i] = True
    return care, ignored


def get_thresholds(tp_scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    """Score thresholds at evenly spaced recall points (ref: eval.py:27-44)."""
    scores = np.sort(np.asarray(tp_scores))[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1)
    return np.asarray(thresholds)


def _eval_class(det_frames, gt_frames, current_class, difficulty, metric,
                compute_aos=False):
    """metric in {"bbox", "bev", "3d"}; compute_aos only with "bbox".

    Returns (ap, recall, precision, aos) — aos is NaN unless computed.
    """
    thr_iou = IOU_THRESH.get(str(current_class), 0.5)
    if metric == "bbox" and str(current_class) != "Car":
        thr_iou = 0.5  # official image-plane thresholds: 0.7 Car / 0.5 rest
    n = len(det_frames)

    frames = []
    total_gt = 0
    all_tp_scores = []
    for f in range(n):
        det, gt = det_frames[f], gt_frames[f]
        dn = np.asarray(det["name"]) if "name" in det else None
        nd_all = len(det["boxes"]) if "boxes" in det else len(det["bbox"])
        dmask = (dn == current_class) if dn is not None else \
            np.ones(nd_all, bool)
        dscores = np.asarray(det["scores"])[dmask]
        gnames = np.asarray(gt["name"]) if "name" in gt else np.asarray(
            [str(current_class)] * len(gt["boxes"]))
        care, ign = clean_data(gnames, gt, current_class, difficulty)
        total_gt += int(care.sum())

        if metric == "bbox":
            dboxes2d = np.asarray(det["bbox"])[dmask]
            gboxes2d = np.asarray(gt["bbox"])
            iou = _bbox_iou_2d(dboxes2d, gboxes2d)
        else:
            dboxes = np.asarray(det["boxes"])[dmask][:, :7]
            gboxes = np.asarray(gt["boxes"])[:, :7]
            iou = _frame_iou(dboxes, gboxes, metric=metric) if (
                len(dboxes) and len(gboxes)) else np.zeros(
                (len(dboxes), len(gboxes)))

        # small-image-box detections are "ignored detections" for this
        # difficulty (ref: eval.py clean_data det triage) — only when camera
        # bboxes exist; lidar-only annos have no height to judge
        if "bbox" in det and len(np.asarray(det["bbox"])):
            dh = np.asarray(det["bbox"])[dmask]
            ign_det = (dh[:, 3] - dh[:, 1]) < MIN_HEIGHT[difficulty]
        else:
            ign_det = np.zeros(len(dscores), bool)

        if compute_aos:
            dalpha = np.asarray(det["alpha"])[dmask]
            galpha = np.asarray(gt["alpha"])
        else:
            dalpha = galpha = None
        frames.append((dscores, iou, care, ign, ign_det, dalpha, galpha))

        # greedy high-score-first matching to find TP scores (stage 1,
        # compute_statistics with thresh=0, ref eval.py:121-200); ignored
        # dets contribute no thresholds
        order = np.argsort(-dscores)
        taken = np.zeros(iou.shape[1], bool)
        for di in order:
            if ign_det[di]:
                continue
            best, best_iou = -1, thr_iou
            for gi in range(iou.shape[1]):
                if taken[gi] or not care[gi]:
                    continue
                if iou[di, gi] >= best_iou:
                    best_iou = iou[di, gi]
                    best = gi
            if best >= 0:
                taken[best] = True
                all_tp_scores.append(dscores[di])

    nan4 = (float("nan"), np.zeros(0), np.zeros(0), float("nan"))
    if total_gt == 0:
        return nan4
    thresholds = get_thresholds(all_tp_scores, total_gt)
    if len(thresholds) == 0:
        return (0.0, np.zeros(0), np.zeros(0), 0.0 if compute_aos else
                float("nan"))

    tp = np.zeros(len(thresholds))
    fp = np.zeros(len(thresholds))
    fn = np.zeros(len(thresholds))
    sim = np.zeros(len(thresholds))
    for dscores, iou, care, ign, ign_det, dalpha, galpha in frames:
        for ti, thr in enumerate(thresholds):
            sel = dscores >= thr
            order = np.argsort(-dscores[sel])
            idxs = np.where(sel)[0][order]
            taken = np.zeros(iou.shape[1], bool)
            assigned_ign = np.zeros(len(dscores), bool)
            t = 0
            taken_care = 0
            for di in idxs:
                best, best_iou = -1, thr_iou
                for gi in range(iou.shape[1]):
                    if taken[gi] or not care[gi]:
                        continue
                    if iou[di, gi] >= best_iou:
                        best_iou = iou[di, gi]
                        best = gi
                if best >= 0:
                    taken[best] = True
                    taken_care += 1
                    if not ign_det[di]:  # ignored det takes the GT but
                        t += 1           # counts neither TP nor FP
                        if dalpha is not None:
                            sim[ti] += (
                                1.0 + np.cos(galpha[best] - dalpha[di])) / 2.0
                else:
                    # ignored/DontCare absorption: not an FP
                    for gi in range(iou.shape[1]):
                        if ign[gi] and iou[di, gi] >= thr_iou:
                            assigned_ign[di] = True
                            break
            n_det = int((sel & ~ign_det).sum())
            tp[ti] += t
            fp[ti] += n_det - t - int(assigned_ign[sel & ~ign_det].sum())
            fn[ti] += int(care.sum()) - taken_care

    recall = tp / np.maximum(tp + fn, 1)
    precision = tp / np.maximum(tp + fp, 1)
    aos_curve = sim / np.maximum(tp + fp, 1)
    # monotone precision envelope (ref eval.py:418-421)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
        aos_curve[i] = max(aos_curve[i], aos_curve[i + 1])
    # AP_R40: mean over thresholds 1..40 (ref eval.py get_mAP_R40)
    def _r40(curve):
        return float(curve[1:].mean() * 100) if len(curve) > 1 else \
            float(curve.mean() * 100)
    ap = _r40(precision)
    aos = _r40(aos_curve) if compute_aos else float("nan")
    return ap, recall, precision, aos


def kitti_official_eval(det_frames, gt_frames, class_names, metrics=None):
    """Full official grid: {class} x {easy, moderate, hard} x metrics.

    Metrics default to the reference's four — bbox / bev / 3d / aos
    (ref: eval.py:290 ``do_eval`` computes all four) — with bbox+aos
    included only when both det and gt frames carry camera ``bbox`` (and
    ``alpha`` for aos) fields.

    det_frames: per-frame {boxes (N, 7), scores (N,), name (N,) or labels,
        optional bbox (N, 4) + alpha (N,)}.
    gt_frames: per-frame {boxes (G, 7), name (G,), optional bbox/occluded/
        truncated/alpha for camera-based difficulty + bbox/aos metrics}.

    Returns (report str, {"Car_3d/moderate_R40": ap, ...}).
    """
    # allow labels instead of names
    for d in det_frames:
        if "name" not in d and "labels" in d:
            names = np.asarray(class_names)
            d["name"] = names[np.clip(np.asarray(d["labels"]) - 1, 0,
                                      len(names) - 1)]
    for g in gt_frames:
        if "name" not in g and "labels" in g:
            names = np.asarray(class_names)
            g["name"] = names[np.clip(np.asarray(g["labels"]) - 1, 0,
                                      len(names) - 1)]

    if metrics is None:
        has_bbox = (all("bbox" in d for d in det_frames)
                    and all("bbox" in g for g in gt_frames))
        has_alpha = has_bbox and (
            all("alpha" in d for d in det_frames)
            and all("alpha" in g for g in gt_frames))
        metrics = (("bbox",) if has_bbox else ()) + ("bev", "3d") + (
            ("aos",) if has_alpha else ())

    results = {}
    lines = ["KITTI official-protocol AP_R40:"]
    diff_names = ["easy", "moderate", "hard"]
    for cls in class_names:
        for metric in metrics:
            eval_metric = "bbox" if metric in ("bbox", "aos") else metric
            aps = []
            for d in range(3):
                ap, _, _, aos = _eval_class(
                    det_frames, gt_frames, cls, d, eval_metric,
                    compute_aos=(metric == "aos"))
                val = aos if metric == "aos" else ap
                results[f"{cls}_{metric}/{diff_names[d]}_R40"] = val
                aps.append(val)
            lines.append(
                f"  {cls} AP_{metric} R40: "
                + " / ".join(f"{a:.2f}" for a in aps)
                + "  (easy/moderate/hard)"
            )
    return "\n".join(lines), results
