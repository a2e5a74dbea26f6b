"""Anchor-based dense head (torch counterpart of
``mssvt_tpu/models/dense_heads/anchor_head.py``; ref:
pcdet/models/dense_heads/anchor_head_single.py + anchor_head_template.py +
target_assigner/{anchor_generator, axis_aligned_target_assigner}.py).

Anchors are a host-computed constant (num_anchors, 7) in the
location-major layout of the conv maps; target assignment is vectorised
over the batch (argmax matching with per-class IoU thresholds, then each
GT's best anchor forced positive); the losses are masked sums over the
static anchor set.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.box_coder import ResidualCoder
from ..losses import (
    sigmoid_focal_cls_loss,
    weighted_cross_entropy,
    weighted_smooth_l1,
)
from ..model_utils.layers import Conv2d

CLS_PRIOR_BIAS = -float(np.log((1 - 0.01) / 0.01))  # sigmoid 0.01
BOX_INIT_STD = 0.001


def generate_anchors(anchor_configs, grid_size, point_cloud_range,
                     feature_map_stride):
    """Dense anchor grid (ref: anchor_generator.py:4-79): (num_anchors, 7)
    float32 and the anchors a location of each class.

    Location-major: for each BEV cell (y, x), row-major, the block
    [class][height][size][rotation], so that the (B, H, W, apl * code)
    prediction maps reshape to (B, H * W * apl, code)."""
    per_class, counts = [], []
    pcr = np.asarray(point_cloud_range, np.float64)
    nx = grid_size[0] // feature_map_stride
    ny = grid_size[1] // feature_map_stride
    for cfg in anchor_configs:
        sizes = np.asarray(cfg["anchor_sizes"], np.float64)
        rotations = np.asarray(cfg["anchor_rotations"], np.float64)
        heights = np.asarray(cfg["anchor_bottom_heights"], np.float64)
        if bool(cfg.get("align_center", False)):
            x_stride = (pcr[3] - pcr[0]) / nx
            y_stride = (pcr[4] - pcr[1]) / ny
            x_offset, y_offset = x_stride / 2, y_stride / 2
        else:
            x_stride = (pcr[3] - pcr[0]) / (nx - 1)
            y_stride = (pcr[4] - pcr[1]) / (ny - 1)
            x_offset = y_offset = 0.0
        xs = np.arange(nx) * x_stride + pcr[0] + x_offset
        ys = np.arange(ny) * y_stride + pcr[1] + y_offset
        gx, gy = np.meshgrid(xs, ys)  # (ny, nx)
        anchors_k = []
        for h in heights:
            for s in sizes:
                for r in rotations:
                    full = lambda v: np.full(gx.shape, v)
                    anchors_k.append(np.stack([
                        gx, gy, full(h + s[2] / 2), full(s[0]), full(s[1]),
                        full(s[2]), full(r)], axis=-1))
        per_class.append(np.stack(anchors_k, axis=2))  # (ny, nx, k_c, 7)
        counts.append(len(anchors_k))
    all_a = np.concatenate(per_class, axis=2)
    return all_a.reshape(-1, 7).astype(np.float32), counts


def _nearest_bev_iou(boxes_a, boxes_b):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) axis-aligned 'nearest BEV'
    IoU (ref: box_utils.boxes3d_nearest_bev_iou): each box becomes its
    axis-aligned envelope, (dx, dy) swapped when nearer 90 degrees."""

    def to_aa(b):
        rot = torch.abs(torch.remainder(b[..., 6], math.pi))
        swap = (rot > math.pi / 4) & (rot < 3 * math.pi / 4)
        dx = torch.where(swap, b[..., 4], b[..., 3])
        dy = torch.where(swap, b[..., 3], b[..., 4])
        return torch.stack([b[..., 0] - dx / 2, b[..., 1] - dy / 2,
                            b[..., 0] + dx / 2, b[..., 1] + dy / 2], dim=-1)

    aa, bb = to_aa(boxes_a), to_aa(boxes_b)
    lt = torch.maximum(aa[..., :, None, :2], bb[..., None, :, :2])
    rb = torch.minimum(aa[..., :, None, 2:], bb[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (aa[..., 2] - aa[..., 0]) * (aa[..., 3] - aa[..., 1])
    area_b = (bb[..., 2] - bb[..., 0]) * (bb[..., 3] - bb[..., 1])
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-6)


def assign_anchor_targets(anchors, anchor_class_ids, gt_boxes,
                          matched_thresholds, unmatched_thresholds,
                          box_coder, num_classes):
    """Axis-aligned target assignment (ref:
    axis_aligned_target_assigner.py:8-210) for (B, M, 8) GT boxes (last
    column the 1-based class, 0 for padding) against (N, 7) anchors with
    per-anchor class ids and thresholds. Returns (labels (B, N) int32: -1
    ignore, 0 background, 1..C the class; reg_targets (B, N, code);
    reg_weights (B, N)).

    Each valid GT claims its best anchor (force-match). Where two GTs
    share a best anchor the JAX module's scatter leaves the order of the
    two writes to XLA; here the GT of the larger index wins."""
    n, m = anchors.shape[0], gt_boxes.shape[1]
    dev = anchors.device
    gt_valid = gt_boxes[..., -1] > 0  # (B, M)
    gt_cls = gt_boxes[..., -1].to(torch.int32)
    iou = _nearest_bev_iou(anchors, gt_boxes[..., :7])  # (B, N, M)
    cls_ok = anchor_class_ids[None, :, None] == (gt_cls[:, None, :] - 1)
    iou = torch.where(cls_ok & gt_valid[:, None, :], iou,
                      torch.full((), -1.0, dtype=iou.dtype, device=dev))

    best_iou, best_gt = iou.max(dim=2)  # (B, N), first maximum
    labels = torch.where(best_iou < unmatched_thresholds, 0, -1)
    pos = best_iou >= matched_thresholds
    labels = torch.where(pos, torch.gather(gt_cls, 1, best_gt), labels)

    gt_best_iou, gt_best_anchor = iou.max(dim=1)  # (B, M)
    force = gt_valid & (gt_best_iou > 1e-6)
    # the winning GT of each anchor (the largest index), -1 if none forces
    dest = torch.where(force, gt_best_anchor, n)
    winner = torch.full((gt_boxes.shape[0], n + 1), -1, dtype=torch.int64,
                        device=dev)
    winner.scatter_reduce_(1, dest, torch.arange(m, device=dev).expand_as(
        dest).contiguous(), "amax")
    winner = winner[:, :n]
    forced = winner >= 0
    w_safe = winner.clamp(min=0)
    labels = torch.where(forced, torch.gather(gt_cls, 1, w_safe), labels)
    best_gt = torch.where(forced, w_safe, best_gt)

    fg = labels > 0
    tgt = torch.gather(gt_boxes, 1, best_gt[..., None].expand(
        -1, -1, gt_boxes.shape[-1]))
    reg_targets = box_coder.encode(tgt[..., :7], anchors) * fg[..., None]
    num_fg = torch.clamp(fg.sum(dim=1, keepdim=True), min=1)
    reg_weights = fg.to(torch.float32) / num_fg
    return labels.to(torch.int32), reg_targets, reg_weights


class AnchorHeadSingle(nn.Module):
    """Ref: anchor_head_single.py:7-80 + the template's losses
    (:136-260). Input and maps are NHWC at the public boundary."""

    def __init__(self, model_cfg: Any, input_channels: int, num_class: int,
                 class_names: Sequence[str], grid_size, point_cloud_range,
                 dtype=torch.float32):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.compute_dtype = dtype
        self.use_dir = bool(model_cfg.get("USE_DIRECTION_CLASSIFIER", False))
        anchor_cfgs = model_cfg["ANCHOR_GENERATOR_CONFIG"]
        stride = int(anchor_cfgs[0].get("feature_map_stride", 8))
        anchors, counts = generate_anchors(anchor_cfgs, grid_size,
                                           point_cloud_range, stride)
        loc_cls, loc_m, loc_u = [], [], []
        for ci, (acfg, k_c) in enumerate(zip(anchor_cfgs, counts)):
            loc_cls += [ci] * k_c
            loc_m += [float(acfg["matched_threshold"])] * k_c
            loc_u += [float(acfg["unmatched_threshold"])] * k_c
        n_loc = anchors.shape[0] // len(loc_cls)
        tile = lambda v, dt: torch.as_tensor(np.tile(np.array(v, dt), n_loc))
        self.register_buffer("anchors", torch.as_tensor(anchors),
                             persistent=False)
        self.register_buffer("anchor_class_ids", tile(loc_cls, np.int32),
                             persistent=False)
        self.register_buffer("matched_th", tile(loc_m, np.float32),
                             persistent=False)
        self.register_buffer("unmatched_th", tile(loc_u, np.float32),
                             persistent=False)
        self.anchors_per_loc = int(sum(counts))
        self.box_coder = ResidualCoder(
            code_size=7,
            encode_angle_by_sincos=model_cfg.get("TARGET_ASSIGNER_CONFIG", {})
            .get("BOX_CODER_CONFIG", {}).get("encode_angle_by_sincos", False))
        apl = self.anchors_per_loc
        self.conv_cls = Conv2d(input_channels, apl * num_class, 1, dtype=dtype)
        self.conv_box = Conv2d(input_channels, apl * self.box_coder.code_size,
                               1, dtype=dtype)
        if self.use_dir:
            self.num_dir_bins = int(model_cfg.get("NUM_DIR_BINS", 2))
            self.conv_dir = Conv2d(input_channels, apl * self.num_dir_bins, 1,
                                   dtype=dtype)

    def flax_init(self, generator):
        """flax's initialisers that differ from the port's defaults: the
        classification bias at the prior -4.595 and the box kernel drawn
        with standard deviation 0.001."""
        with torch.no_grad():
            self.conv_cls.bias.fill_(CLS_PRIOR_BIAS)
            self.conv_box.weight.copy_(torch.randn(
                self.conv_box.weight.shape, generator=generator)
                * BOX_INIT_STD)

    def forward(self, spatial_features_2d):
        x = spatial_features_2d.to(self.compute_dtype).permute(0, 3, 1, 2)
        b = x.shape[0]

        def nhwc(conv, width):
            return conv(x).float().permute(0, 2, 3, 1).reshape(b, -1, width)

        out = {"cls_preds": nhwc(self.conv_cls, self.num_class),
               "box_preds": nhwc(self.conv_box, self.box_coder.code_size)}
        if self.use_dir:
            out["dir_cls_preds"] = nhwc(self.conv_dir, self.num_dir_bins)
        return out

    # ------------------------------------------------- targets / loss
    def assign_targets(self, gt_boxes):
        labels, reg_targets, reg_weights = assign_anchor_targets(
            self.anchors, self.anchor_class_ids, gt_boxes, self.matched_th,
            self.unmatched_th, self.box_coder, self.num_class)
        return {"box_cls_labels": labels, "box_reg_targets": reg_targets,
                "reg_weights": reg_weights}

    @staticmethod
    def add_sin_difference(boxes1, boxes2, dim=6):
        """sin(a - b) on the heading channel (ref: template :171-178)."""
        s1, c1 = (f(boxes1[..., dim:dim + 1]) for f in (torch.sin, torch.cos))
        s2, c2 = (f(boxes2[..., dim:dim + 1]) for f in (torch.sin, torch.cos))
        b1 = torch.cat([boxes1[..., :dim], s1 * c2, boxes1[..., dim + 1:]], -1)
        b2 = torch.cat([boxes2[..., :dim], c1 * s2, boxes2[..., dim + 1:]], -1)
        return b1, b2

    def get_direction_target(self, reg_targets, dir_offset):
        """Heading-bin targets from the encoded residuals (ref: template
        :181-196)."""
        rot_gt = reg_targets[..., 6] + self.anchors[None, :, 6]
        period = 2 * np.pi / self.num_dir_bins
        offset_rot = torch.remainder(rot_gt - dir_offset, 2 * np.pi)
        return torch.clamp(torch.floor(offset_rot / period).to(torch.int64),
                           0, self.num_dir_bins - 1)

    def get_loss(self, preds, targets):
        """Focal classification, smooth-L1 regression (sin-difference on
        the heading) and the direction classifier's cross-entropy, each
        summed and divided by the batch size (ref:
        anchor_head_template.py:136-260)."""
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        labels = targets["box_cls_labels"]
        bsz = labels.shape[0]
        cared = labels >= 0
        positives = labels > 0
        negatives = labels == 0
        cls_weights = (negatives.float() + positives.float()) * cared
        pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).float(),
                               min=1.0)
        cls_weights = cls_weights / pos_norm
        one_hot = F.one_hot(torch.clamp(labels, min=0).long(),
                            self.num_class + 1).float()[..., 1:]
        cls_loss = sigmoid_focal_cls_loss(
            preds["cls_preds"], one_hot, cls_weights).sum() / bsz \
            * float(lw["cls_weight"])

        box_preds, reg_targets = preds["box_preds"], targets["box_reg_targets"]
        bp, rt = box_preds, reg_targets
        if self.box_coder.code_size == 7 and \
                not self.box_coder.encode_angle_by_sincos:
            bp, rt = self.add_sin_difference(box_preds, reg_targets)
        loc_loss = weighted_smooth_l1(
            bp, rt, targets["reg_weights"],
            code_weights=lw.get("code_weights")).sum() / bsz \
            * float(lw["loc_weight"])
        total = cls_loss + loc_loss
        tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
        if self.use_dir and "dir_cls_preds" in preds:
            dir_offset = float(self.model_cfg.get("DIR_OFFSET", 0.78539))
            dir_targets = self.get_direction_target(reg_targets, dir_offset)
            dir_onehot = F.one_hot(dir_targets, self.num_dir_bins).float()
            dir_w = positives.float()
            dir_w = dir_w / torch.clamp(dir_w.sum(dim=-1, keepdim=True),
                                        min=1.0)
            dir_loss = weighted_cross_entropy(
                preds["dir_cls_preds"], dir_onehot, dir_w).sum() / bsz \
                * float(lw.get("dir_weight", 0.2))
            total = total + dir_loss
            tb["rpn_loss_dir"] = dir_loss
        tb["rpn_loss"] = total
        return total, tb

    def generate_predicted_boxes(self, preds):
        """(B, N, 7) decoded boxes and (B, N, C) class scores."""
        boxes = self.box_coder.decode(preds["box_preds"], self.anchors[None])
        scores = torch.sigmoid(preds["cls_preds"])
        if self.use_dir and "dir_cls_preds" in preds:
            dir_offset = float(self.model_cfg.get("DIR_OFFSET", 0.78539))
            dir_limit = float(self.model_cfg.get("DIR_LIMIT_OFFSET", 0.0))
            dir_labels = preds["dir_cls_preds"].argmax(dim=-1)
            period = 2 * np.pi / self.num_dir_bins
            rot = boxes[..., 6] - dir_offset
            rot = rot - torch.floor(rot / period + dir_limit) * period
            rot = rot + dir_offset + period * dir_labels.to(boxes.dtype)
            boxes = torch.cat([boxes[..., :6], rot[..., None], boxes[..., 7:]],
                              dim=-1)
        return boxes, scores
