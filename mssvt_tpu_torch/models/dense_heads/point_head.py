"""Point-wise head pieces (torch counterpart of
``mssvt_tpu/models/dense_heads/point_head.py``; ref:
pcdet/models/dense_heads/point_head_template.py).

Only :func:`assign_point_targets` is ported so far (PartA2's
segmentation and part targets); ``PointHeadSimple`` and ``PointHeadBox``
wait for PV-RCNN and PointRCNN (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ...ops.pointnet2 import points_in_boxes


def assign_point_targets(points_xyz, points_valid, gt_boxes,
                         extra_width=(0.2, 0.2, 0.2)):
    """Per-point labels (B, N) int32 (-1 ignored: a padding point, or
    inside a GT box enlarged by ``extra_width`` a side but not inside the
    box; 0 background; else the GT's class) and the matched GT (B, N, 8)
    (the first box holding the point; box 0 where none does) (ref:
    assign_stack_targets)."""
    gt_valid = (gt_boxes[..., -1] > 0)[:, None, :]
    inside = points_in_boxes(points_xyz, gt_boxes[..., :7]) & gt_valid
    grow = torch.tensor([w * 2 for w in extra_width], dtype=gt_boxes.dtype,
                        device=gt_boxes.device)
    enlarged = torch.cat([gt_boxes[..., :3], gt_boxes[..., 3:6] + grow,
                          gt_boxes[..., 6:7]], dim=-1)
    inside_ext = points_in_boxes(points_xyz, enlarged) & gt_valid
    box_idx = torch.argmax(inside.to(torch.uint8), dim=2)  # first box
    is_fg = inside.any(dim=2)
    is_ignore = inside_ext.any(dim=2) & ~is_fg
    rows = torch.arange(gt_boxes.shape[0], device=gt_boxes.device)[:, None]
    gt_of = gt_boxes[rows, box_idx]
    cls = gt_of[..., -1].to(torch.int32)
    labels = torch.where(is_fg, cls, 0)
    labels = torch.where(is_ignore, -1, labels)
    return torch.where(points_valid, labels, -1).to(torch.int32), gt_of
