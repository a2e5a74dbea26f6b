"""PV-RCNN and PV-RCNN++ (torch counterpart of
``mssvt_tpu/models/detectors/pv_rcnn.py``; ref:
pcdet/models/detectors/pv_rcnn.py and pv_rcnn_plusplus.py).

SECOND's first stage (MeanVFE -> VoxelBackBone8x -> BEV -> AnchorHeadSingle)
and the proposal NMS; ``VoxelSetAbstraction`` keypoints from the raw
points (FPS on K2c, or PV-RCNN++'s SPC sampling with the vector pool,
chosen by the PFE config) over the raw points, the final sparse stage and
the BEV map; ``PointHeadSimple`` weights the keypoint features by their
foreground probability; ``PVRCNNHead`` refines the RoIs. The raw points
come as ``MAX_POINTS`` rows a frame (``points``, ``points_valid``).
Outputs as the two-stage voxel family's: the refined RoIs with no further
NMS, scored by sigmoid(RoI logit).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ..backbones_3d.pfe import VoxelSetAbstraction
from ..builders import (
    build_backbone_2d,
    build_backbone_3d,
    build_ctx,
    build_dense_head,
    build_vfe,
)
from ..dense_heads.point_head import PointHeadSimple, assign_point_targets
from ..roi_heads.pvrcnn_head import PVRCNNHead
from ..roi_heads.roi_head_template import (
    assign_proposal_targets,
    head_valid,
    propose,
    refine_boxes,
    target_kwargs,
    two_stage_loss,
)
from .generic_post import apply_vfe, per_sample_points


class PVRCNN(nn.Module):
    def __init__(self, model_cfg: Any, num_class: int,
                 class_names: Sequence[str], grid_size, voxel_size,
                 point_cloud_range, batch_size: int, max_voxels: int,
                 max_points_per_voxel: int, num_point_features: int = 4,
                 max_points: int = 16384, dtype=torch.float32):
        super().__init__()
        self.model_cfg = model_cfg
        ctx = build_ctx(num_class, class_names, grid_size, voxel_size,
                        point_cloud_range, batch_size, max_voxels,
                        max_points_per_voxel, num_point_features, dtype)
        self.grid_size, self.voxel_size = ctx.grid_size, ctx.voxel_size
        self.point_cloud_range = ctx.point_cloud_range
        self.batch_size, self.max_points = ctx.batch_size, int(max_points)
        self.vfe = build_vfe(model_cfg["VFE"], ctx)
        self.backbone_3d = build_backbone_3d(model_cfg["BACKBONE_3D"], ctx)
        self.backbone_2d = build_backbone_2d(
            model_cfg["BACKBONE_2D"], ctx, self.backbone_3d.num_bev_features)
        c2d = self.backbone_2d.num_bev_features
        self.dense_head = build_dense_head(model_cfg["DENSE_HEAD"], ctx, c2d)
        pfe = model_cfg["PFE"]
        c_kp = int(pfe["NUM_OUTPUT_FEATURES"])
        self.pfe = VoxelSetAbstraction(
            pfe, ctx.voxel_size, ctx.point_cloud_range,
            int(pfe.get("NUM_KEYPOINTS", 2048)),
            point_channels=ctx.num_point_features - 3,
            source_channels={"x_conv_out": int(
                model_cfg["BACKBONE_3D"].get("OUT_CHANNELS", 128))},
            bev_channels=c2d, dtype=dtype)
        self.point_head = PointHeadSimple(model_cfg["POINT_HEAD"], c_kp,
                                          dtype=dtype)
        self.roi_cfg = model_cfg["ROI_HEAD"]
        self.roi_head = PVRCNNHead(self.roi_cfg, c_kp, dtype=dtype)

    def keypoint_features(self, batch, sp_out, spatial_2d, rois, roi_valid):
        """The PFE's keypoints (B, K, 3) and their features weighted by the
        point head, with the point head's logits (B, K, 1)."""
        xyz, feat, pvalid = per_sample_points(batch, self.batch_size,
                                              self.max_points)
        # the downsampled sites are compacted over the batch: per_sample
        # lays them out by frame (a reshape would mix frames)
        keypoints, kp_feat, _ = self.pfe(
            xyz, feat, pvalid, sources={"x_conv_out": sp_out.per_sample()},
            bev_features=spatial_2d, bev_stride=8, rois=rois,
            roi_valid=roi_valid)
        kp_cls = self.point_head(kp_feat)
        return keypoints, kp_feat * torch.sigmoid(kp_cls), kp_cls

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` (the refined RoIs); train: ``loss`` and
        ``tb_dict`` (the anchor head's terms, ``rcnn_loss_cls``,
        ``rcnn_loss_reg``, ``point_loss_cls``). With
        ``return_intermediates`` also the RoIs, the keypoints and their
        weighted features (and, in training, the sampled targets)."""
        sp = SparseVoxels.create(
            apply_vfe(self.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], self.batch_size, self.grid_size,
            self.voxel_size, self.point_cloud_range)
        sp_out = self.backbone_3d(sp)
        spatial_2d = self.backbone_2d(sp_out.bev())
        preds = self.dense_head(spatial_2d)
        rois, _, roi_labels, roi_valid = propose(
            self.dense_head, preds, self.roi_cfg, self.training)
        keypoints, kp_feat, kp_cls = self.keypoint_features(
            batch, sp_out, spatial_2d, rois, roi_valid)
        out = {"pred_dicts": preds}
        if return_intermediates:
            out.update(rois=rois, roi_valid=roi_valid, keypoints=keypoints,
                       kp_features=kp_feat)
        if self.training:
            targets = assign_proposal_targets(
                rois, roi_valid, batch["gt_boxes"],
                **target_kwargs(self.roi_cfg))
            cls, reg = self.roi_head(keypoints, kp_feat, targets["rois"],
                                     head_valid(targets), generator)
            loss, tb = two_stage_loss(self.dense_head, preds,
                                      batch["gt_boxes"], cls, reg, targets,
                                      self.roi_cfg)
            pt_labels, _ = assign_point_targets(
                keypoints, torch.ones(keypoints.shape[:2], dtype=torch.bool,
                                      device=keypoints.device),
                batch["gt_boxes"])
            pt_loss = PointHeadSimple.get_loss(kp_cls, pt_labels)
            tb["point_loss_cls"] = pt_loss
            out["loss"], out["tb_dict"] = loss + pt_loss, tb
            if return_intermediates:
                out["targets"] = targets
            return out
        cls, reg = self.roi_head(keypoints, kp_feat, rois, roi_valid)
        out.update(final_boxes=refine_boxes(rois, reg) * roi_valid[..., None],
                   final_scores=torch.sigmoid(cls) * roi_valid,
                   final_labels=roi_labels, final_mask=roi_valid)
        return out
