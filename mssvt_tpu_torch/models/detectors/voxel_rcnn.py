"""VoxelRCNN (torch counterpart of
``mssvt_tpu/models/detectors/voxel_rcnn.py``; ref:
pcdet/models/detectors/voxel_rcnn.py): SECOND's first stage on
``VoxelBackBone8x(return_stages=True)``, the proposal NMS, and the
``VoxelRCNNHead`` pooling the sparse stages' voxel features at a grid of
points inside each RoI. Outputs as ``SECONDNetIoU``'s, the final score
sigmoid(RoI logit) alone.
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
from ..roi_heads.roi_head_template import (
    assign_proposal_targets,
    head_valid,
    propose,
    refine_boxes,
    target_kwargs,
    two_stage_loss,
)
from ..roi_heads.voxelrcnn_head import VoxelRCNNHead
from .generic_post import apply_vfe


class VoxelRCNN(nn.Module):
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
        self.backbone_3d = build_backbone_3d(
            {**dict(model_cfg["BACKBONE_3D"]), "RETURN_STAGES": True}, ctx)
        self.backbone_2d = build_backbone_2d(
            model_cfg["BACKBONE_2D"], ctx, self.backbone_3d.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg["DENSE_HEAD"], ctx, self.backbone_2d.num_bev_features)
        self.roi_cfg = model_cfg["ROI_HEAD"]
        self.roi_head = VoxelRCNNHead(
            self.roi_cfg, self.backbone_3d.stage_channels, dtype=dtype)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """As ``SECONDNetIoU.forward``; the intermediates also hold the
        sparse stages."""
        sp = SparseVoxels.create(
            apply_vfe(self.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], self.batch_size, self.grid_size,
            self.voxel_size, self.point_cloud_range)
        sp_out, stages = self.backbone_3d(sp)
        spatial_2d = self.backbone_2d(sp_out.bev())
        preds = self.dense_head(spatial_2d)
        rois, _, roi_labels, roi_valid = propose(
            self.dense_head, preds, self.roi_cfg, self.training)
        out = {"pred_dicts": preds}
        if return_intermediates:
            out.update(stages=stages, spatial_features_2d=spatial_2d,
                       rois=rois, roi_valid=roi_valid)
        if self.training:
            targets = assign_proposal_targets(
                rois, roi_valid, batch["gt_boxes"],
                **target_kwargs(self.roi_cfg))
            cls, reg = self.roi_head(stages, targets["rois"],
                                     head_valid(targets), self.batch_size,
                                     generator)
            out["loss"], out["tb_dict"] = two_stage_loss(
                self.dense_head, preds, batch["gt_boxes"], cls, reg, targets,
                self.roi_cfg)
            if return_intermediates:
                out["targets"] = targets
            return out
        cls, reg = self.roi_head(stages, rois, roi_valid, self.batch_size)
        out.update(final_boxes=refine_boxes(rois, reg) * roi_valid[..., None],
                   final_scores=torch.sigmoid(cls) * roi_valid,
                   final_labels=roi_labels, final_mask=roi_valid)
        return out
