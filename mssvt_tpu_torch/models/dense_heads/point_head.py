"""Point-wise heads (torch counterpart of
``mssvt_tpu/models/dense_heads/point_head.py``; ref:
pcdet/models/dense_heads/point_head_{simple,box,template}.py).

- :func:`assign_point_targets`: a point is foreground inside a GT box,
  ignored in the box enlarged but outside it (PartA2's, PV-RCNN's and
  PointRCNN's point targets).
- :class:`PointHeadSimple`: a foreground logit a point (PV-RCNN's keypoint
  weighting), with its focal loss.
- :class:`PointHeadBox`: class logits and a ``PointResidualCoder``-style
  box a point (PointRCNN's first stage), with the encoding, the decoding
  and the losses.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.pointnet2 import points_in_boxes
from ...utils.box_coder import decode_point_residual, encode_point_residual
from ..losses import sigmoid_focal_cls_loss, weighted_smooth_l1
from ..model_utils.layers import BatchNorm, Dense


def assign_point_targets(points_xyz, points_valid, gt_boxes,
                         extra_width=(0.2, 0.2, 0.2)):
    """Per-point labels (B, N) int32 (-1 ignored: a padding point, or
    inside a GT box enlarged by ``extra_width`` a side but not inside the
    box; 0 background; else the GT's class) and the matched GT (B, N, 8)
    (the first box holding the point; box 0 where none does) (ref:
    assign_stack_targets)."""
    gt_valid = (gt_boxes[..., -1] > 0)[:, None, :]
    inside = points_in_boxes(points_xyz, gt_boxes[..., :7]) & gt_valid
    grow = [gt_boxes[..., 3 + i:4 + i] + w * 2  # scalars: no host copy
            for i, w in enumerate(extra_width)]
    enlarged = torch.cat([gt_boxes[..., :3], *grow, gt_boxes[..., 6:7]],
                         dim=-1)
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


def _add_tower(owner: nn.Module, name: str, c_in: int, fcs: Sequence[int],
               out: int, dtype):
    """``{name}_fc_i`` (no bias), ``{name}_bn_i`` (flax momentum 0.99, eps
    1e-3) and ``{name}_out`` on ``owner`` (flat flax names); returns the
    number of hidden layers."""
    for i, c in enumerate(fcs):
        owner.add_module(f"{name}_fc_{i}", Dense(c_in, c, bias=False,
                                                 dtype=dtype))
        owner.add_module(f"{name}_bn_{i}", BatchNorm(c, 1e-3, dtype=dtype,
                                                     channels_last=True))
        c_in = c
    owner.add_module(f"{name}_out", Dense(c_in, out, dtype=dtype))
    return len(fcs)


def _run_tower(owner: nn.Module, name: str, n: int, x):
    for i in range(n):
        x = torch.relu(getattr(owner, f"{name}_bn_{i}")(
            getattr(owner, f"{name}_fc_{i}")(x)))
    return getattr(owner, f"{name}_out")(x).float()


class PointHeadSimple(nn.Module):
    """(B, K, C) point features -> (B, K, num_class) foreground logits
    (ref: point_head_simple.py)."""

    def __init__(self, model_cfg: Any, input_channels: int,
                 num_class: int = 1, dtype=torch.float32):
        super().__init__()
        self.n_cls = _add_tower(self, "cls", input_channels,
                                model_cfg.get("CLS_FC", [256, 256]),
                                num_class, dtype)
        self.compute_dtype = dtype

    def forward(self, point_features):
        return _run_tower(self, "cls", self.n_cls,
                          point_features.to(self.compute_dtype))

    @staticmethod
    def get_loss(cls_logits, labels):
        """Class-agnostic focal loss over the cared points (labels of
        :func:`assign_point_targets`), over the foreground count."""
        cared, pos = labels >= 0, labels > 0
        weights = cared.float() / torch.clamp(pos.sum(), min=1.0)
        return sigmoid_focal_cls_loss(cls_logits, pos[..., None].float(),
                                      weights).sum()


class PointHeadBox(nn.Module):
    """(B, N, C) point features -> class logits (B, N, num_class) and box
    codes (B, N, 8): offset (3), log dims (3), cos, sin (ref:
    point_head_box.py)."""

    def __init__(self, model_cfg: Any, input_channels: int, num_class: int,
                 code_size: int = 8, dtype=torch.float32):
        super().__init__()
        self.n_cls = _add_tower(self, "cls", input_channels,
                                model_cfg.get("CLS_FC", [256, 256]),
                                num_class, dtype)
        self.n_reg = _add_tower(self, "reg", input_channels,
                                model_cfg.get("REG_FC", [256, 256]),
                                code_size, dtype)
        self.compute_dtype = dtype

    def forward(self, point_features):
        x = point_features.to(self.compute_dtype)
        return (_run_tower(self, "cls", self.n_cls, x),
                _run_tower(self, "reg", self.n_reg, x))

    @staticmethod
    def _size_anchor(labels, mean_sizes, like):
        """Each label's (1-based) mean size; ``mean_sizes`` a (K, 3) list or
        tensor (a tensor on ``like``'s device costs no host copy)."""
        ms = torch.as_tensor(mean_sizes, dtype=torch.float32,
                             device=like.device)
        return ms[torch.clamp(labels.long() - 1, min=0)]

    @staticmethod
    def encode_point_targets(points_xyz, gt_of_points, labels, mean_sizes):
        """``PointResidualCoder``'s encoding of each point's GT box against
        its class's mean size (floored at 1e-5 in the log dims), zero for
        non-foreground points (ref: box_coder_utils.py:144-222)."""
        a = PointHeadBox._size_anchor(labels, mean_sizes, points_xyz)
        t = encode_point_residual(gt_of_points[..., :7], points_xyz, a,
                                  min_anchor=1e-5)
        return t * (labels > 0)[..., None]

    @staticmethod
    def decode_point_boxes(points_xyz, preds, labels, mean_sizes):
        """(B, N, 8) codes at their points -> (B, N, 7) boxes, the sizes
        from the class ``labels`` (1-based) mean sizes, the log dims
        clipped to [-8, 8]."""
        a = PointHeadBox._size_anchor(labels, mean_sizes, points_xyz)
        return decode_point_residual(preds[..., :8], points_xyz, a,
                                     max_log_dim=8.0)

    @staticmethod
    def get_loss(cls_logits, box_preds, labels, box_targets, num_class,
                 code_weights=None):
        """(focal class loss over the cared points, smooth-L1 box loss over
        the foreground points), each over the foreground count."""
        cared, pos = labels >= 0, labels > 0
        n_pos = torch.clamp(pos.sum(), min=1.0)
        one_hot = F.one_hot(torch.clamp(labels.long(), min=0),
                            num_class + 1)[..., 1:].float()
        cls_loss = sigmoid_focal_cls_loss(cls_logits, one_hot,
                                          cared.float() / n_pos).sum()
        reg_loss = weighted_smooth_l1(box_preds, box_targets, pos.float(),
                                      code_weights=code_weights).sum() / n_pos
        return cls_loss, reg_loss
