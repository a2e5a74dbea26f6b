"""Greedy NMS with static shapes, batched over samples (torch counterpart of
``mssvt_tpu/ops/nms.py``, which vmaps the same per-sample logic).

Candidates are the ``pre_max`` top scores (a stable descending sort, so
equal scores keep their input order, as ``lax.top_k`` does); a box is kept
when no kept higher-scoring box suppresses it. The scan is
``kernels/nms.py``'s (one kernel on the card, the loop on the CPU). The
rotated-IoU suppression of :func:`nms_bev` is, on the card,
``kernels/nms_iou.py``'s kernel, which writes the scan's packed rows (two
launches in all); on the CPU, the (B, K, K) bool matrix in row blocks
(``kernels/nms_iou.overlaps``, the kernel's plain version), scanned by the
loop. Outputs are (selected (B, post_max) int32 indices into the input, -1
padded, num_selected (B,)).
Both open the span ``mssvt.nms`` (``runtime/tracing.py``).
"""

from __future__ import annotations

import torch

from ..kernels import nms as nms_kernel
from ..kernels import nms_iou
from ..runtime import tracing


def _candidates(boxes, scores, valid, pre_max):
    s = torch.where(valid, scores, float("-inf"))
    k = min(pre_max, boxes.shape[1])
    top, order = torch.sort(s, dim=1, descending=True, stable=True)
    # contiguous where pre_max cuts the rows: the scan kernel takes it so
    top, order = top[:, :k], order[:, :k].contiguous()
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1,
                                                          boxes.shape[-1]))
    return cand, torch.isfinite(top), order


def nms_bev(boxes, scores, valid, thresh: float, pre_max: int,
            post_max: int):
    """Rotated-IoU greedy NMS over (B, N, 7+) boxes."""
    with tracing.span("nms"):
        cand, cand_valid, order = _candidates(boxes, scores, valid, pre_max)
        if cand.is_cuda:
            words = nms_iou.nms_iou_mask(cand, thresh)
            return nms_kernel.nms_greedy_packed(words, cand_valid, order,
                                                post_max)
        return nms_kernel.nms_greedy(nms_iou.overlaps(cand[..., :7], thresh),
                                     cand_valid, order, post_max)


def circle_nms(boxes, scores, valid, min_radius: float, pre_max: int,
               post_max: int):
    """Centre-distance greedy suppression: a candidate is dropped when its
    centre lies within ``min_radius`` of a kept higher-scoring box."""
    with tracing.span("nms"):
        cand, cand_valid, order = _candidates(boxes, scores, valid, pre_max)
        c = cand[..., :2]
        d2 = ((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
        return nms_kernel.nms_greedy(d2 < float(min_radius) ** 2, cand_valid,
                                     order, post_max)
