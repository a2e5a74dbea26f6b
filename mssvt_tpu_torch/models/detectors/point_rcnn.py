"""PointRCNN (torch counterpart of ``mssvt_tpu/models/detectors/point_rcnn.py``;
ref: pcdet/models/detectors/point_rcnn.py and roi_heads/pointrcnn_head.py).

``PointNet2MSG`` over the raw points (its FPS levels on K2c, and on K2b
where a level's input has at most 256 points) -> ``PointHeadBox`` (a class
and a box a point) -> the proposal NMS (the module ``proposals``) -> the
RoI head. Where ``ROI_HEAD`` holds no ``SA_CONFIG`` that is the JAX
package's ``PointRCNNRoIHead``: the points pooled inside each RoI
(``roipoint_pool3d``) in the RoI's canonical frame, a shared MLP, max over
the points, shared FC layers, the class and box outputs; the gradient flows
through the RoIs (the decoded point boxes) into the first stage, as in
JAX. With ``SA_CONFIG`` it is pcdet's ``PointRCNNHead``
(``roi_heads/pointrcnn_head.py``), which also pools each point's class
score (the sigmoid of its class-max logit) and depth, and runs a PointNet++
inside every RoI. Outputs as PV-RCNN's.

The eval request opens ``mssvt.backbone_3d`` (the points by frame and
``PointNet2MSG``, whose levels open ``mssvt.sa`` and ``mssvt.fp``),
``mssvt.head`` (``PointHeadBox``) and ``mssvt.post`` (the decode, the
proposals with their ``mssvt.nms``, and ``mssvt.roi_head``), in order.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...ops.pointnet2 import roipoint_pool3d
from ...runtime import tracing
from ..backbones_3d.pointnet2_backbone import SharedMLP
from ..builders import build_backbone_3d
from ..dense_heads.point_head import PointHeadBox, assign_point_targets
from ..model_utils.layers import BatchNorm, Dense
from ..roi_heads.pointrcnn_head import PointRCNNHead
from ..roi_heads.roi_head_template import (
    assign_proposal_targets,
    corner_weight_from_cfg,
    Proposals,
    head_valid,
    nms_kwargs,
    proposal_layer,
    roi_box_loss,
    roi_cls_loss,
)
from .detector3d_template import Detector3DTemplate
from .generic_post import per_sample_points

MEAN_SIZES_DEFAULT = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]


class PointRCNNRoIHead(nn.Module):
    """Canonical-frame point pooling and a PointNet encoder (ref:
    pointrcnn_head.py): ``up_i`` shared MLPs, ``shared_fc_i`` /
    ``shared_bn_i``, ``cls_out`` and ``reg_out``."""

    def __init__(self, model_cfg: Any, point_channels: int,
                 num_sampled_points: int = 128, code_size: int = 7,
                 dtype=torch.float32):
        super().__init__()
        self.num_sampled_points = int(num_sampled_points)
        c_in = 3 + point_channels
        ups = model_cfg.get("XYZ_UP_LAYER", [[64, 64]])
        self.n_up = len(ups)
        for i, m in enumerate(ups):
            mod = SharedMLP(c_in, m, dtype=dtype)
            self.add_module(f"up_{i}", mod)
            c_in = mod.out_channels
        fcs = model_cfg.get("SHARED_FC", [256, 256])
        self.n_fc = len(fcs)
        for i, fc in enumerate(fcs):
            self.add_module(f"shared_fc_{i}", Dense(c_in, fc, bias=False,
                                                    dtype=dtype))
            self.add_module(f"shared_bn_{i}", BatchNorm(
                fc, 1e-3, dtype=dtype, channels_last=True))
            c_in = fc
        self.cls_out = Dense(c_in, 1, dtype=dtype)
        self.reg_out = Dense(c_in, code_size, dtype=dtype)

    def forward(self, points_xyz, point_features, points_valid, rois,
                roi_valid, point_scores=None):
        """points (B, N, 3), features (B, N, C), valid (B, N), rois (B, R,
        7) -> (cls (B, R), reg (B, R, code_size)), zeroed where the RoI is
        not valid. ``point_scores`` is not read (pcdet's head pools it)."""
        pooled, _ = roipoint_pool3d(points_xyz, point_features, rois,
                                    self.num_sampled_points, points_valid)
        xyz = pooled[..., :3] - rois[..., None, :3]
        h = rois[..., 6][..., None]
        c, s = torch.cos(-h), torch.sin(-h)
        canon = torch.stack([xyz[..., 0] * c - xyz[..., 1] * s,
                             xyz[..., 0] * s + xyz[..., 1] * c, xyz[..., 2]],
                            dim=-1)
        x = torch.cat([canon, pooled[..., 3:]], dim=-1)
        for i in range(self.n_up):
            x = getattr(self, f"up_{i}")(x)
        x = x.amax(dim=2)  # ties share the cotangent, as jnp.max
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f"shared_bn_{i}")(
                getattr(self, f"shared_fc_{i}")(x)))
        m = roi_valid.to(torch.float32)
        return (self.cls_out(x)[..., 0].float() * m,
                self.reg_out(x).float() * m[..., None])


def propose_points(boxes, scores, valid, labels, roi_cfg, train: bool):
    """The point head's decoded boxes through :func:`proposal_layer` with
    ``roi_cfg``'s TRAIN or TEST NMS (the module ``proposals``)."""
    return proposal_layer(boxes, scores, valid, labels=labels,
                          **nms_kwargs(roi_cfg, train))


class PointRCNN(Detector3DTemplate):
    def __init__(self, model_cfg: Any, num_class: int,
                 class_names: Sequence[str], grid_size, voxel_size,
                 point_cloud_range, batch_size: int, max_voxels: int,
                 max_points_per_voxel: int, num_point_features: int = 4,
                 max_points: int = 16384, dtype=torch.float32):
        super().__init__(model_cfg, num_class, class_names, grid_size,
                         voxel_size, point_cloud_range, batch_size,
                         max_voxels, max_points_per_voxel, num_point_features,
                         dtype)
        self.max_points = int(max_points)

    def build_networks(self):
        cfg, ctx = self.model_cfg, self.ctx
        self.backbone_3d = build_backbone_3d(cfg["BACKBONE_3D"], ctx)
        c_pt = self.backbone_3d.num_point_features
        self.point_head = PointHeadBox(cfg["POINT_HEAD"], c_pt,
                                       num_class=ctx.num_class,
                                       dtype=ctx.dtype)
        self.roi_cfg = cfg["ROI_HEAD"]
        if "SA_CONFIG" in self.roi_cfg:
            self.roi_head = PointRCNNHead(self.roi_cfg, c_pt, dtype=ctx.dtype)
        else:
            self.roi_head = PointRCNNRoIHead(
                self.roi_cfg, c_pt,
                int(self.roi_cfg.get("NUM_SAMPLED_POINTS", 128)),
                dtype=ctx.dtype)
        self.proposals = Proposals(self.roi_cfg, propose_points)
        # the class mean sizes live on the model's device (no host copy a
        # forward); not a parameter, not in the state dict
        self.register_buffer("mean_sizes", torch.tensor(
            cfg["POINT_HEAD"].get("MEAN_SIZES",
                                  MEAN_SIZES_DEFAULT[:ctx.num_class]),
            dtype=torch.float32), persistent=False)

    def run_roi_head(self, rin, rois, roi_valid, generator=None):
        return self.roi_head(rin["xyz"], rin["point_features"], rin["valid"],
                             rois, roi_valid, rin["point_scores"])

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` (the refined RoIs); train: ``loss`` and
        ``tb_dict`` (``point_loss_cls``, ``point_loss_box``,
        ``rcnn_loss_cls``, ``rcnn_loss_reg``, ``rpn_loss``: the total, as
        JAX's). ``generator`` is unused (no dropout)."""
        with tracing.span("backbone_3d"):
            xyz, feat, valid = per_sample_points(batch, self.batch_size,
                                                 self.max_points)
            point_features = self.backbone_3d(xyz, feat, valid)
        with tracing.span("head"):
            cls_logits, box_preds = self.point_head(point_features)
        with tracing.span("post"):
            return self._post(batch, xyz, valid, point_features, cls_logits,
                              box_preds, return_intermediates)

    def _post(self, batch, xyz, valid, point_features, cls_logits,
              box_preds, return_intermediates):
        """The decode, the proposals and the RoI head (span
        ``mssvt.post``)."""
        labels_pred = cls_logits.argmax(dim=-1).to(torch.int32) + 1
        scores = torch.sigmoid(cls_logits).amax(dim=-1) * valid
        boxes = PointHeadBox.decode_point_boxes(xyz, box_preds, labels_pred,
                                                self.mean_sizes)
        rois, roi_scores, roi_labels, roi_valid = self.proposals(
            boxes, scores, valid, labels_pred)
        rin = {"xyz": xyz, "point_features": point_features, "valid": valid,
               "point_scores": scores}
        out = {}
        if return_intermediates:
            out.update(rois=rois, roi_valid=roi_valid,
                       point_features=point_features)
        if self.training:
            gt = batch["gt_boxes"]
            pt_labels, gt_of_points = assign_point_targets(xyz, valid, gt)
            box_targets = PointHeadBox.encode_point_targets(
                xyz, gt_of_points, pt_labels, self.mean_sizes)
            p_cls, p_reg = PointHeadBox.get_loss(
                cls_logits, box_preds, pt_labels, box_targets, self.num_class)
            targets = assign_proposal_targets(
                rois, roi_valid, gt, roi_per_image=int(
                    self.roi_cfg["TARGET_CONFIG"].get("ROI_PER_IMAGE", 128)))
            with tracing.span("roi_head"):
                r_cls, r_reg = self.run_roi_head(rin, targets["rois"],
                                                 head_valid(targets))
            rcnn_cls = roi_cls_loss(r_cls, targets["cls_labels"])
            rcnn_reg = roi_box_loss(
                r_reg, targets["gt_of_rois"], targets["rois"],
                targets["reg_valid"],
                corner_loss_weight=corner_weight_from_cfg(self.roi_cfg))
            loss = p_cls + p_reg + rcnn_cls + rcnn_reg
            out["loss"] = loss
            out["tb_dict"] = {"point_loss_cls": p_cls, "point_loss_box": p_reg,
                              "rcnn_loss_cls": rcnn_cls,
                              "rcnn_loss_reg": rcnn_reg, "rpn_loss": loss}
            if return_intermediates:
                out["targets"] = targets
            return out
        out.update(self.roi_detections(rin, rois, roi_scores, roi_labels,
                                       roi_valid))
        return out
