"""Greedy NMS with static shapes, batched over samples (torch counterpart of
``mssvt_tpu/ops/nms.py``, which vmaps the same per-sample logic).

Candidates are the ``pre_max`` top scores (a stable descending sort, so
equal scores keep their input order, as ``lax.top_k`` does); a box is kept
when no kept higher-scoring box suppresses it. The (B, K, K) suppression
matrix is built here; the scan over it is ``kernels/nms.py``'s (one kernel
on the card, the loop on the CPU). Outputs are (selected (B, post_max)
int32 indices into the input, -1 padded, num_selected (B,)).
"""

from __future__ import annotations

import torch

from ..kernels import nms as nms_kernel
from .box_ops import pairwise_iou_bev


def _candidates(boxes, scores, valid, pre_max):
    s = torch.where(valid, scores, float("-inf"))
    k = min(pre_max, boxes.shape[1])
    top, order = torch.sort(s, dim=1, descending=True, stable=True)
    # contiguous where pre_max cuts the rows: the scan kernel takes it so
    top, order = top[:, :k], order[:, :k].contiguous()
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1,
                                                          boxes.shape[-1]))
    return cand, torch.isfinite(top), order


# candidate pairs a block of the pairwise IoU: its largest temporaries are
# (B, rows, K, 4, 2) f32, 256 MiB at this many pairs (a whole 4 x 4096^2
# matrix at once would take ~2 GiB each)
IOU_BLOCK_PAIRS = 1 << 23


def _overlaps(c7, thresh: float):
    """(B, K, K) ``pairwise_iou_bev(c7, c7) > thresh``, computed in row
    blocks of at most ``IOU_BLOCK_PAIRS`` pairs (each element's IoU is
    the same whatever the block)."""
    b, k = c7.shape[:2]
    rows = max(1, IOU_BLOCK_PAIRS // max(1, b * k))
    if rows >= k:
        return pairwise_iou_bev(c7, c7) > thresh
    return torch.cat([pairwise_iou_bev(c7[:, i:i + rows], c7) > thresh
                      for i in range(0, k, rows)], dim=1)


def nms_bev(boxes, scores, valid, thresh: float, pre_max: int,
            post_max: int):
    """Rotated-IoU greedy NMS over (B, N, 7+) boxes."""
    cand, cand_valid, order = _candidates(boxes, scores, valid, pre_max)
    return nms_kernel.nms_greedy(_overlaps(cand[..., :7], thresh), cand_valid,
                                 order, post_max)


def circle_nms(boxes, scores, valid, min_radius: float, pre_max: int,
               post_max: int):
    """Centre-distance greedy suppression: a candidate is dropped when its
    centre lies within ``min_radius`` of a kept higher-scoring box."""
    cand, cand_valid, order = _candidates(boxes, scores, valid, pre_max)
    c = cand[..., :2]
    d2 = ((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    return nms_kernel.nms_greedy(d2 < float(min_radius) ** 2, cand_valid,
                                 order, post_max)
