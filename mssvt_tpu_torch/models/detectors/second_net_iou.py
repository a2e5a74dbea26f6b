"""SECOND-IoU (torch counterpart of
``mssvt_tpu/models/detectors/second_net_iou.py``; ref:
pcdet/models/detectors/second_net_iou.py): SECOND's first stage
(MeanVFE -> VoxelBackBone8x -> the BEV map -> BaseBEVBackbone ->
AnchorHeadSingle), the proposal NMS, and the BEV-grid RoI head
(``BEVGridRoIHead``) refining each RoI from the 2D backbone's map.

Train: the anchor loss plus the RoI losses on the sampled RoIs. Eval: the
refined RoIs with score sigmoid(RoI logit) x the RoI's first-stage score,
and the RoIs' labels and mask, with no further NMS (as the JAX module).
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
from ..roi_heads.bev_grid_head import BEVGridRoIHead
from ..roi_heads.roi_head_template import (
    assign_proposal_targets,
    head_valid,
    propose,
    refine_boxes,
    target_kwargs,
    two_stage_loss,
)
from .generic_post import apply_vfe


class SECONDNetIoU(nn.Module):
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
        c2d = self.backbone_2d.num_bev_features
        self.dense_head = build_dense_head(model_cfg["DENSE_HEAD"], ctx, c2d)
        self.roi_cfg = model_cfg["ROI_HEAD"]
        stride = int(self.roi_cfg.get("BEV_STRIDE", 8))
        self.roi_head = BEVGridRoIHead(
            self.roi_cfg, c2d, ctx.point_cloud_range,
            (ctx.voxel_size[0] * stride, ctx.voxel_size[1] * stride),
            dtype=dtype)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` (refined RoIs); train: ``loss``, ``tb_dict``.
        With ``return_intermediates`` also the RoIs (and, in training,
        the sampled targets) and the 2D backbone's map."""
        sp = SparseVoxels.create(
            apply_vfe(self.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], self.batch_size, self.grid_size,
            self.voxel_size, self.point_cloud_range)
        spatial_2d = self.backbone_2d(self.backbone_3d(sp).bev())
        preds = self.dense_head(spatial_2d)
        rois, roi_scores, roi_labels, roi_valid = propose(
            self.dense_head, preds, self.roi_cfg, self.training)
        out = {"pred_dicts": preds}
        if return_intermediates:
            out.update(spatial_features_2d=spatial_2d, rois=rois,
                       roi_valid=roi_valid)
        if self.training:
            targets = assign_proposal_targets(
                rois, roi_valid, batch["gt_boxes"],
                **target_kwargs(self.roi_cfg))
            cls, reg = self.roi_head(spatial_2d, targets["rois"],
                                     head_valid(targets), generator)
            out["loss"], out["tb_dict"] = two_stage_loss(
                self.dense_head, preds, batch["gt_boxes"], cls, reg, targets,
                self.roi_cfg, code_weights=self.roi_cfg.get(
                    "LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {}).get(
                    "code_weights"))
            if return_intermediates:
                out["targets"] = targets
            return out
        cls, reg = self.roi_head(spatial_2d, rois, roi_valid)
        out.update(final_boxes=refine_boxes(rois, reg) * roi_valid[..., None],
                   final_scores=torch.sigmoid(cls) * roi_scores * roi_valid,
                   final_labels=roi_labels, final_mask=roi_valid)
        return out
