"""Multi-group anchor head and the ATSS target assigner (torch counterpart
of ``mssvt_tpu/models/dense_heads/anchor_head_multi.py``; ref:
pcdet/models/dense_heads/anchor_head_multi.py:9-151 and
target_assigner/atss_target_assigner.py:7-120).

A shared 3x3 conv, BN and ReLU, then one head per ``RPN_HEAD_CFGS`` group
(class, box and direction 1x1 convs over the anchors of its own classes,
location-major as ``AnchorHeadSingle``'s). Targets come from the
axis-aligned assigner or from ATSS: per GT the ``TOPK`` anchors nearest its
centre are the candidates, the IoU threshold is their IoU's mean plus its
standard deviation, and a positive must hold the GT's centre.
"""

from __future__ import annotations

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
from ..model_utils.layers import BatchNorm, Conv2d
from .anchor_head import (
    BOX_INIT_STD,
    CLS_PRIOR_BIAS,
    AnchorHeadSingle,
    _nearest_bev_iou,
    assign_anchor_targets,
    generate_anchors,
)


def assign_atss_targets(anchors, gt_boxes, box_coder, topk: int = 9):
    """ATSS assignment of ONE frame's (M, 8) GT boxes (last column the
    1-based class, 0 for padding) to (N, 7) anchors: (labels (N,) int32,
    reg_targets (N, code), reg_weights (N,)). Candidates are ranked by
    centre distance with equal distances in anchor order (as ``lax.top_k``);
    an anchor picked by several GTs takes the one of the highest IoU (the
    first on a tie)."""
    n, m = anchors.shape[0], gt_boxes.shape[0]
    gt_valid = gt_boxes[:, -1] > 0
    gt_cls = gt_boxes[:, -1].to(torch.int32)
    iou = _nearest_bev_iou(anchors, gt_boxes[:, :7])  # (N, M)
    iou = torch.where(gt_valid[None, :], iou, 0.0)

    d2 = ((anchors[:, None, :3] - gt_boxes[None, :, :3]) ** 2).sum(-1)
    d2 = torch.where(gt_valid[None, :], d2, torch.inf)
    k = min(topk, n)
    cand = torch.sort(-d2.T, dim=1, descending=True, stable=True)[1][:, :k]
    cand_iou = torch.gather(iou.T, 1, cand)  # (M, k)
    thr = cand_iou.mean(dim=1) + cand_iou.std(dim=1, correction=0)

    ax = anchors[:, 0][cand] - gt_boxes[:, None, 0]
    ay = anchors[:, 1][cand] - gt_boxes[:, None, 1]
    c, s = torch.cos(-gt_boxes[:, 6:7]), torch.sin(-gt_boxes[:, 6:7])
    lx = ax * c - ay * s
    ly = ax * s + ay * c
    inside = (torch.abs(lx) < gt_boxes[:, None, 3] / 2) & \
             (torch.abs(ly) < gt_boxes[:, None, 4] / 2)
    pos_cand = (cand_iou >= thr[:, None]) & inside & gt_valid[:, None]

    flat = cand.reshape(-1) * m + torch.arange(
        m, device=anchors.device).repeat_interleave(k)
    sel_iou = torch.zeros(n * m, dtype=iou.dtype, device=iou.device)
    sel_iou = sel_iou.scatter_reduce(
        0, flat, torch.where(pos_cand, cand_iou, 0.0).reshape(-1),
        "amax").view(n, m)
    best_iou, best_gt = sel_iou.max(dim=1)
    pos = best_iou > 0

    labels = torch.where(pos, gt_cls[best_gt], 0)
    tgt = gt_boxes[best_gt]
    reg_targets = box_coder.encode(tgt[:, :7], anchors) * pos[:, None]
    reg_weights = pos.to(torch.float32) / torch.clamp(pos.sum(), min=1)
    return labels.to(torch.int32), reg_targets, reg_weights


class AnchorHeadMulti(nn.Module):
    """Grouped RPN heads over a shared conv (ref: anchor_head_multi.py:151).
    NHWC at the public boundary; ``forward`` returns one prediction dict a
    group, ``generate_predicted_boxes`` all groups' boxes with scores over
    the global classes."""

    def __init__(self, model_cfg: Any, input_channels: int, num_class: int,
                 class_names: Sequence[str], grid_size, point_cloud_range,
                 dtype=torch.float32):
        super().__init__()
        cfg = self.model_cfg = model_cfg
        self.class_names = tuple(class_names)
        self.compute_dtype = dtype
        self.use_dir = bool(cfg.get("USE_DIRECTION_CLASSIFIER", False))
        self.num_dir_bins = int(cfg.get("NUM_DIR_BINS", 2))
        shared_ch = int(cfg.get("SHARED_CONV_NUM_FILTER", 64))
        tac = cfg.get("TARGET_ASSIGNER_CONFIG", {})
        self.use_atss = str(tac.get("NAME", "AxisAlignedTargetAssigner")) \
            == "ATSSTargetAssigner"
        self.atss_topk = int(tac.get("TOPK", 9))
        anchor_cfgs = cfg["ANCHOR_GENERATOR_CONFIG"]
        stride = int(anchor_cfgs[0].get("feature_map_stride", 8))
        self.box_coder = ResidualCoder(code_size=7)
        code = self.box_coder.code_size

        self.shared_conv = Conv2d(input_channels, shared_ch, 3, padding="SAME",
                                  bias=False, dtype=dtype)
        self.shared_bn = BatchNorm(shared_ch, 1e-3, momentum=0.99, dtype=dtype)
        self.metas = []
        for hi, hcfg in enumerate(cfg["RPN_HEAD_CFGS"]):
            head_names = list(hcfg["HEAD_CLS_NAME"])
            sub_cfgs = [c for c in anchor_cfgs if c["class_name"] in head_names]
            anchors, counts = generate_anchors(sub_cfgs, grid_size,
                                               point_cloud_range, stride)
            loc_cls, loc_m, loc_u = [], [], []
            for acfg, k_c in zip(sub_cfgs, counts):
                loc_cls += [self.class_names.index(acfg["class_name"])] * k_c
                loc_m += [float(acfg["matched_threshold"])] * k_c
                loc_u += [float(acfg["unmatched_threshold"])] * k_c
            n_loc = anchors.shape[0] // len(loc_cls)
            tile = lambda v, dt: torch.as_tensor(  # noqa: E731
                np.tile(np.array(v, dt), n_loc))
            for key, val in (("anchors", torch.as_tensor(anchors)),
                             ("global_cls", tile(loc_cls, np.int32)),
                             ("matched", tile(loc_m, np.float32)),
                             ("unmatched", tile(loc_u, np.float32))):
                self.register_buffer(f"{key}{hi}", val, persistent=False)
            apl = int(sum(counts))
            self.metas.append({"apl": apl, "ncls": len(head_names),
                               "head_names": head_names})
            self.add_module(f"head{hi}_cls", Conv2d(
                shared_ch, apl * len(head_names), 1, dtype=dtype))
            self.add_module(f"head{hi}_box", Conv2d(shared_ch, apl * code, 1,
                                                    dtype=dtype))
            if self.use_dir:
                self.add_module(f"head{hi}_dir", Conv2d(
                    shared_ch, apl * self.num_dir_bins, 1, dtype=dtype))

    def meta(self, hi, key):
        """Group ``hi``'s (N, ...) anchor buffer ``key`` (``anchors``,
        ``global_cls``, ``matched``, ``unmatched``)."""
        return getattr(self, f"{key}{hi}")

    def flax_init(self, generator):
        """flax's initialisers that differ from the port's defaults: every
        group's classification bias at the prior -4.595, its box kernel
        drawn with standard deviation 0.001."""
        with torch.no_grad():
            for hi in range(len(self.metas)):
                getattr(self, f"head{hi}_cls").bias.fill_(CLS_PRIOR_BIAS)
                box = getattr(self, f"head{hi}_box").weight
                box.copy_(torch.randn(box.shape, generator=generator)
                          * BOX_INIT_STD)

    def forward(self, spatial_features_2d):
        x = spatial_features_2d.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.shared_bn(self.shared_conv(x)))
        b = x.shape[0]

        def nhwc(conv, width):
            return conv(x).float().permute(0, 2, 3, 1).reshape(b, -1, width)

        out = []
        for hi, meta in enumerate(self.metas):
            o = {"cls_preds": nhwc(getattr(self, f"head{hi}_cls"), meta["ncls"]),
                 "box_preds": nhwc(getattr(self, f"head{hi}_box"),
                                   self.box_coder.code_size)}
            if self.use_dir:
                o["dir_cls_preds"] = nhwc(getattr(self, f"head{hi}_dir"),
                                          self.num_dir_bins)
            out.append(o)
        return out

    # ------------------------------------------------- targets / loss
    def assign_targets(self, gt_boxes):
        """One target dict a group: ATSS per frame, or the axis-aligned
        assigner over the group's anchors, per the config."""
        ret = []
        for hi in range(len(self.metas)):
            anchors = self.meta(hi, "anchors")
            if self.use_atss:
                per = [assign_atss_targets(anchors, g, self.box_coder,
                                           topk=self.atss_topk)
                       for g in gt_boxes]
                labels, reg_t, reg_w = (torch.stack(t) for t in zip(*per))
            else:
                labels, reg_t, reg_w = assign_anchor_targets(
                    anchors, self.meta(hi, "global_cls"), gt_boxes,
                    self.meta(hi, "matched"), self.meta(hi, "unmatched"),
                    self.box_coder, len(self.class_names))
            ret.append({"box_cls_labels": labels, "box_reg_targets": reg_t,
                        "reg_weights": reg_w})
        return ret

    def get_loss(self, preds_list, targets_list):
        """Each group's focal classification over its own classes,
        smooth-L1 regression (sin-difference on the heading) and direction
        cross-entropy, each summed and divided by the batch size; the
        groups' losses summed."""
        total = 0.0
        tb = {}
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        for hi, (preds, targets, meta) in enumerate(
                zip(preds_list, targets_list, self.metas)):
            labels = targets["box_cls_labels"]
            bsz = labels.shape[0]
            cared = labels >= 0
            positives = labels > 0
            cls_w = cared.float() / torch.clamp(
                positives.sum(dim=1, keepdim=True).float(), min=1.0)
            lut = np.zeros((len(self.class_names) + 1,), np.int64)
            for li, name in enumerate(meta["head_names"]):
                lut[self.class_names.index(name) + 1] = li + 1
            local = torch.as_tensor(lut, device=labels.device)[
                torch.clamp(labels, min=0).long()]
            one_hot = F.one_hot(local, meta["ncls"] + 1).float()[..., 1:]
            cls_loss = sigmoid_focal_cls_loss(
                preds["cls_preds"], one_hot, cls_w).sum() / bsz \
                * float(lw["cls_weight"])

            box_p, reg_t = AnchorHeadSingle.add_sin_difference(
                preds["box_preds"], targets["box_reg_targets"])
            loc_loss = weighted_smooth_l1(
                box_p, reg_t, targets["reg_weights"],
                code_weights=lw.get("code_weights")).sum() / bsz \
                * float(lw["loc_weight"])
            head_loss = cls_loss + loc_loss

            if self.use_dir and "dir_cls_preds" in preds:
                dir_offset = float(self.model_cfg.get("DIR_OFFSET", 0.78539))
                rot_gt = (targets["box_reg_targets"][..., 6]
                          + self.meta(hi, "anchors")[None, :, 6])
                period = 2 * np.pi / self.num_dir_bins
                dir_t = torch.clamp(torch.floor(
                    torch.remainder(rot_gt - dir_offset, 2 * np.pi) / period
                ).to(torch.int64), 0, self.num_dir_bins - 1)
                dw = positives.float()
                dw = dw / torch.clamp(dw.sum(dim=-1, keepdim=True), min=1.0)
                dir_loss = weighted_cross_entropy(
                    preds["dir_cls_preds"],
                    F.one_hot(dir_t, self.num_dir_bins).float(), dw
                ).sum() / bsz * float(lw.get("dir_weight", 0.2))
                head_loss = head_loss + dir_loss

            total = total + head_loss
            tb[f"rpn_head{hi}_loss"] = head_loss
        tb["rpn_loss"] = total
        return total, tb

    def generate_predicted_boxes(self, preds_list):
        """All groups' decoded (B, N, 7) boxes and (B, N, C) scores over
        the global classes (zero for the classes of other groups)."""
        boxes_all, scores_all = [], []
        for hi, (preds, meta) in enumerate(zip(preds_list, self.metas)):
            boxes = self.box_coder.decode(preds["box_preds"],
                                          self.meta(hi, "anchors")[None])
            local = torch.sigmoid(preds["cls_preds"])  # (B, N, nc_h)
            glob = local.new_zeros(local.shape[:2] + (len(self.class_names),))
            for li, name in enumerate(meta["head_names"]):
                glob[..., self.class_names.index(name)] = local[..., li]
            if self.use_dir and "dir_cls_preds" in preds:
                dir_offset = float(self.model_cfg.get("DIR_OFFSET", 0.78539))
                dir_labels = preds["dir_cls_preds"].argmax(dim=-1)
                period = 2 * np.pi / self.num_dir_bins
                rot = boxes[..., 6] - dir_offset
                rot = rot - torch.floor(rot / period) * period
                rot = rot + dir_offset + period * dir_labels.to(boxes.dtype)
                boxes = torch.cat([boxes[..., :6], rot[..., None],
                                   boxes[..., 7:]], dim=-1)
            boxes_all.append(boxes)
            scores_all.append(glob)
        return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)
