"""Part-A2 (torch counterpart of ``mssvt_tpu/models/detectors/part_a2.py``;
ref: pcdet/models/detectors/PartA2_net.py).

Stage 1: MeanVFE -> UNetV2 (its encoder feeds the BEV map and the anchor
head, its decoder the stride-1 voxel features) ->
``PointIntraPartOffsetHead`` (foreground segmentation and intra-object
part locations a voxel). Stage 2: the proposal NMS -> ``PartA2FCHead``
(RoI-aware pooled part and feature grids). The "points" of the part and
pooling machinery are the stride-1 voxel centres, each frame's rows the
frame's block of the flat voxel rows (the JAX module's reshape).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ..builders import (
    build_backbone_2d,
    build_backbone_3d,
    build_ctx,
    build_dense_head,
    build_vfe,
)
from ..dense_heads.point_intra_part_head import PointIntraPartOffsetHead
from ..roi_heads.partA2_head import PartA2FCHead
from ..roi_heads.roi_head_template import (
    assign_proposal_targets,
    head_valid,
    propose,
    refine_boxes,
    target_kwargs,
    two_stage_loss,
)
from .generic_post import apply_vfe


class PartA2Net(nn.Module):
    def __init__(self, model_cfg: Any, num_class: int,
                 class_names: Sequence[str], grid_size, voxel_size,
                 point_cloud_range, batch_size: int, max_voxels: int,
                 max_points_per_voxel: int, num_point_features: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.model_cfg = model_cfg
        ctx = build_ctx(num_class, class_names, grid_size, voxel_size,
                        point_cloud_range, batch_size, max_voxels,
                        max_points_per_voxel, num_point_features, dtype)
        self.grid_size, self.voxel_size = ctx.grid_size, ctx.voxel_size
        self.point_cloud_range = ctx.point_cloud_range
        self.batch_size = ctx.batch_size
        self.vfe = build_vfe(model_cfg["VFE"], ctx)
        self.backbone_3d = build_backbone_3d(model_cfg["BACKBONE_3D"], ctx)
        self.backbone_2d = build_backbone_2d(
            model_cfg["BACKBONE_2D"], ctx, self.backbone_3d.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg["DENSE_HEAD"], ctx, self.backbone_2d.num_bev_features)
        c_point = int(model_cfg["BACKBONE_3D"].get("NUM_FILTERS", [16])[0])
        self.point_head = PointIntraPartOffsetHead(
            model_cfg["POINT_HEAD"], c_point, num_class=1, dtype=dtype)
        self.roi_cfg = model_cfg["ROI_HEAD"]
        self.roi_head = PartA2FCHead(self.roi_cfg, part_channels=4,
                                     seg_channels=c_point, dtype=dtype)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """As ``SECONDNetIoU.forward``; the intermediates also hold the
        stride-1 voxels, the segmentation logits and part predictions."""
        b = self.batch_size
        sp = SparseVoxels.create(
            apply_vfe(self.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], b, self.grid_size, self.voxel_size,
            self.point_cloud_range)
        encoded, sp_points = self.backbone_3d(sp)
        spatial_2d = self.backbone_2d(encoded.bev())
        preds = self.dense_head(spatial_2d)
        seg_logits, part_preds = self.point_head(sp_points.features)
        rois, _, roi_labels, roi_valid = propose(
            self.dense_head, preds, self.roi_cfg, self.training)

        pts = sp_points.metric_centers().reshape(b, -1, 3)
        n = pts.shape[1]
        pvalid = sp_points.valid.reshape(b, n)
        part_feats = torch.cat([torch.sigmoid(part_preds),
                                torch.sigmoid(seg_logits)], -1).reshape(b, n, -1)
        seg_feats = sp_points.features.reshape(b, n, -1)
        out = {"pred_dicts": preds}
        if return_intermediates:
            out.update(points=sp_points, seg_logits=seg_logits,
                       part_preds=part_preds, spatial_features_2d=spatial_2d,
                       rois=rois, roi_valid=roi_valid)
        if self.training:
            targets = assign_proposal_targets(
                rois, roi_valid, batch["gt_boxes"],
                **target_kwargs(self.roi_cfg))
            cls, reg = self.roi_head(pts, part_feats, seg_feats, pvalid,
                                     targets["rois"], head_valid(targets),
                                     generator)
            loss, tb = two_stage_loss(self.dense_head, preds,
                                      batch["gt_boxes"], cls, reg, targets,
                                      self.roi_cfg)
            seg_loss, part_loss, _ = PointIntraPartOffsetHead.get_loss(
                seg_logits.reshape(b, n, -1), part_preds.reshape(b, n, -1),
                pts, pvalid, batch["gt_boxes"])
            tb.update({"point_loss_seg": seg_loss,
                       "point_loss_part": part_loss})
            out["loss"] = loss + seg_loss + part_loss
            out["tb_dict"] = tb
            if return_intermediates:
                out["targets"] = targets
            return out
        cls, reg = self.roi_head(pts, part_feats, seg_feats, pvalid, rois,
                                 roi_valid)
        out.update(final_boxes=refine_boxes(rois, reg) * roi_valid[..., None],
                   final_scores=torch.sigmoid(cls) * roi_valid,
                   final_labels=roi_labels, final_mask=roi_valid)
        return out
