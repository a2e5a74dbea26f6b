"""Evaluation loop (torch counterpart of ``mssvt_tpu/runtime/eval_utils.py``;
ref: tools/eval_utils/eval_utils.py:22-121).

Runs the model in eval mode under ``torch.inference_mode()`` over the eval
split, strips the padding on the host, accumulates per-frame predictions
and GT, computes seconds per example (the forward between two device
synchronisations) and the dataset metric. In a process group (an entry
point's ``--launcher`` other than ``none``, any world size) each rank
evaluates its shard of the split (the loader's ``idx[rank::world]``) and
pickles ``part_<rank>.pkl`` into ``result_dir/tmp_merge``; after a barrier
rank 0 merges the parts (``merge_result_parts``, the reference's
``merge_results_dist`` scheme) and computes the metrics.
"""

from __future__ import annotations

import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.box_ops import pairwise_iou_3d
from ..parallel.dist import barrier, initialized, rank_and_world
from ..utils.eval_ap import kitti_style_eval
from . import tracing
from .train_utils import batch_to_device, model_device, synchronize


def _frame_recall(pred_boxes, gt_boxes, thresh_list):
    """Recalled-GT counts at each IoU threshold for one frame
    (ref: detector3d_template.py:286-328 generate_recall_record)."""
    n_gt = len(gt_boxes)
    counts = {t: 0 for t in thresh_list}
    if n_gt == 0:
        return counts, 0
    if len(pred_boxes) == 0:
        return counts, n_gt
    iou = pairwise_iou_3d(
        torch.as_tensor(np.asarray(pred_boxes[:, :7], np.float32)),
        torch.as_tensor(np.asarray(gt_boxes[:, :7], np.float32))).numpy()
    best = iou.max(axis=0)  # per-GT best IoU
    for t in thresh_list:
        counts[t] = int((best > t).sum())
    return counts, n_gt


def merge_result_parts(tmp_dir, recall_thresh_list):
    """Merge per-process ``part_<rank>.pkl`` eval dumps from a shared dir.

    The analog of ref ``common_utils.merge_results_dist``
    (common_utils.py:199-220): each process pickles its per-frame results;
    rank 0 concatenates them in rank order (by the integer rank, so that
    ``part_10`` follows ``part_9``). Returns
    (det_frames, gt_frames, recall_acc, gt_total, n_frames, t_total) —
    t_total is the MAX across ranks (processes evaluate concurrently).
    """
    det_frames, gt_frames = [], []
    recall_acc = {t: 0 for t in recall_thresh_list}
    gt_total = n_frames = 0
    t_total = 0.0
    parts = sorted(Path(tmp_dir).glob("part_*.pkl"),
                   key=lambda p: int(p.stem.split("_")[1]))
    for part in parts:
        with open(part, "rb") as f:
            d = pickle.load(f)
        det_frames += d["det"]
        gt_frames += d["gt"]
        for t in recall_thresh_list:
            recall_acc[t] += d["recall"][t]
        gt_total += d["gt_total"]
        n_frames += d["n"]
        t_total = max(t_total, d["t"])
    return det_frames, gt_frames, recall_acc, gt_total, n_frames, t_total


def eval_step(model, batch):
    """One request: the eval-mode forward of a batch already on the model's
    device; returns the detections' ``final_*`` tensors (boxes, scores,
    labels, mask), still on the device. The forward is the span
    ``mssvt.request``."""
    with torch.inference_mode(), tracing.span("request"):
        out = model(batch)
    return (out["final_boxes"], out["final_scores"], out["final_labels"],
            out["final_mask"])


def eval_one_epoch(model, loader, class_names, logger=None, result_dir=None,
                   recall_thresh_list=(0.3, 0.5, 0.7), world_size=1):
    """Evaluate ``model`` (on its device; built for ``loader.batch_size``)
    over ``loader``; writes ``result.pkl`` (the per-frame detections) into
    ``result_dir`` and returns ``(metrics, det_frames)``. In a process
    group of ``world_size`` ranks (``loader`` holds this rank's shard) rank
    0 returns the merged result and the other ranks ``({}, [])``."""
    rank, world = rank_and_world()
    if world_size != world:
        raise ValueError(f"eval_one_epoch: world_size {world_size}, but the "
                         f"process group holds {world} ranks")
    merge = initialized()
    if merge and result_dir is None:
        raise ValueError("eval_one_epoch: the ranks merge their parts "
                         "through result_dir, which is None")
    model.eval()
    device = model_device(model)
    batch_size = loader.batch_size

    det_frames, gt_frames = [], []
    recall_acc = {t: 0 for t in recall_thresh_list}
    gt_total = 0
    n_frames = 0
    t_total = 0.0
    for batch in loader:
        dev_batch = batch_to_device(batch, device)
        synchronize(device)
        t0 = time.perf_counter()
        outs = eval_step(model, dev_batch)
        synchronize(device)
        t_total += time.perf_counter() - t0

        boxes, scores, labels, mask = (o.cpu().numpy() for o in outs)
        gt = batch["gt_boxes"]
        n_real = int(batch.get("n_real", batch_size))
        for b in range(n_real):
            m = mask[b]
            det_frames.append({
                "boxes": boxes[b][m][:, :7],
                "scores": scores[b][m],
                "labels": labels[b][m].astype(np.int64),
            })
            gvalid = gt[b][:, -1] > 0
            gt_frames.append({
                "boxes": gt[b][gvalid][:, :7],
                "labels": gt[b][gvalid][:, -1].astype(np.int64),
            })
            counts, n_gt = _frame_recall(
                det_frames[-1]["boxes"], gt_frames[-1]["boxes"],
                recall_thresh_list,
            )
            for t in recall_thresh_list:
                recall_acc[t] += counts[t]
            gt_total += n_gt
            n_frames += 1

    if merge:
        tmp = Path(result_dir) / "tmp_merge"
        if rank == 0:  # no parts of an earlier run
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
        barrier()
        with open(tmp / f"part_{rank}.pkl", "wb") as f:
            pickle.dump({"det": det_frames, "gt": gt_frames,
                         "recall": recall_acc, "gt_total": gt_total,
                         "n": n_frames, "t": t_total}, f)
        barrier()
        if rank != 0:
            return {}, []
        (det_frames, gt_frames, recall_acc, gt_total, n_frames,
         t_total) = merge_result_parts(tmp, recall_thresh_list)
        shutil.rmtree(tmp)

    sec_per_example = t_total / max(n_frames, 1)
    if logger:
        logger.info(
            f"eval: {n_frames} frames, {sec_per_example * 1000:.1f} ms/frame "
            f"({1.0 / max(sec_per_example, 1e-9):.1f} fps) on {device}"
        )

    if result_dir is not None:
        result_dir = Path(result_dir)
        result_dir.mkdir(parents=True, exist_ok=True)
        with open(result_dir / "result.pkl", "wb") as f:
            pickle.dump(det_frames, f)

    report, metrics = kitti_style_eval(det_frames, gt_frames, class_names)
    metrics["sec_per_example"] = sec_per_example
    for t in recall_thresh_list:
        r = recall_acc[t] / max(gt_total, 1)
        metrics[f"recall/rcnn_{t}"] = r
        if logger:
            logger.info(f"recall_rcnn_{t}: {r:.4f} "
                        f"({recall_acc[t]}/{gt_total})")
    if logger:
        logger.info("\n" + report)
    return metrics, det_frames
