"""Intra-object part location head (torch counterpart of
``mssvt_tpu/models/dense_heads/point_intra_part_head.py``; ref:
pcdet/models/dense_heads/point_intra_part_head.py).

PartA2's first stage: per-voxel foreground segmentation and the
intra-object part location of each foreground voxel (where inside its box
it sits, as [0, 1]^3 coordinates in the box's canonical frame).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..losses import sigmoid_focal_cls_loss
from ..model_utils.layers import BatchNorm, Dense
from .point_head import assign_point_targets


def intra_part_targets(points_xyz, gt_of_points, labels):
    """(B, N, 3) canonical part coordinates in [0, 1] of the foreground
    points, 0 elsewhere (ref: assign_stack_targets ``ret_part_labels``)."""
    local = points_xyz - gt_of_points[..., :3]
    h = gt_of_points[..., 6]
    c, s = torch.cos(-h), torch.sin(-h)
    lx = local[..., 0] * c - local[..., 1] * s
    ly = local[..., 0] * s + local[..., 1] * c
    dims = torch.clamp(gt_of_points[..., 3:6], min=1e-3)
    part = torch.stack([lx / dims[..., 0] + 0.5, ly / dims[..., 1] + 0.5,
                        local[..., 2] / dims[..., 2] + 0.5], dim=-1)
    return torch.clamp(part, 0.0, 1.0) * (labels > 0)[..., None]


class PointIntraPartOffsetHead(nn.Module):
    """Segmentation (``seg_fc_i``/``seg_bn_i``/``seg_out``) and part
    (``part_*``) towers over the UNet's per-voxel features."""

    def __init__(self, model_cfg: Any, input_channels: int, num_class: int,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.towers = {}
        for name, fcs, out in (("seg", model_cfg.get("CLS_FC", [128, 128]),
                                num_class),
                               ("part", model_cfg.get("PART_FC", [128, 128]),
                                3)):
            c_in = input_channels
            for i, ch in enumerate(fcs):
                self.add_module(f"{name}_fc_{i}", Dense(c_in, ch, bias=False,
                                                        dtype=dtype))
                self.add_module(f"{name}_bn_{i}", BatchNorm(
                    ch, 1e-3, dtype=dtype, channels_last=True))
                c_in = ch
            self.add_module(f"{name}_out", Dense(c_in, out, dtype=dtype))
            self.towers[name] = len(fcs)

    def _tower(self, x, name):
        for i in range(self.towers[name]):
            x = torch.relu(getattr(self, f"{name}_bn_{i}")(
                getattr(self, f"{name}_fc_{i}")(x)))
        return getattr(self, f"{name}_out")(x).float()

    def forward(self, point_features):
        x = point_features.to(self.compute_dtype)
        return self._tower(x, "seg"), self._tower(x, "part")

    @staticmethod
    def get_loss(seg_logits, part_preds, points_xyz, points_valid, gt_boxes):
        """(focal segmentation loss, part BCE over the foreground, labels),
        each loss normalised by the batch's foreground count."""
        labels, gt_of = assign_point_targets(points_xyz, points_valid,
                                             gt_boxes)
        cared, pos = labels >= 0, labels > 0
        n_pos = torch.clamp(pos.sum(), min=1.0)
        w = cared.to(torch.float32) / n_pos
        seg_loss = sigmoid_focal_cls_loss(
            seg_logits, pos[..., None].to(torch.float32), w).sum()
        part_t = intra_part_targets(points_xyz, gt_of, labels)
        p = torch.sigmoid(part_preds)
        bce = -(part_t * torch.log(torch.clamp(p, min=1e-7))
                + (1 - part_t) * torch.log(torch.clamp(1 - p, min=1e-7)))
        part_loss = (bce.mean(-1) * pos).sum() / n_pos
        return seg_loss, part_loss, labels
