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

from ...runtime import tracing
from ..backbones_3d.pfe import VoxelSetAbstraction
from ..dense_heads.point_head import PointHeadSimple, assign_point_targets
from ..roi_heads.pvrcnn_head import PVRCNNHead
from .detector3d_template import Detector3DTemplate
from .generic_post import per_sample_points


class PVRCNN(Detector3DTemplate):
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
        super().build_networks()
        cfg, ctx = self.model_cfg, self.ctx
        pfe = cfg["PFE"]
        c_kp = int(pfe["NUM_OUTPUT_FEATURES"])
        self.pfe = VoxelSetAbstraction(
            pfe, ctx.voxel_size, ctx.point_cloud_range,
            int(pfe.get("NUM_KEYPOINTS", 2048)),
            point_channels=ctx.num_point_features - 3,
            source_channels={"x_conv_out": int(
                cfg["BACKBONE_3D"].get("OUT_CHANNELS", 128))},
            bev_channels=self.backbone_2d.num_bev_features, dtype=ctx.dtype)
        self.point_head = PointHeadSimple(cfg["POINT_HEAD"], c_kp,
                                          dtype=ctx.dtype)
        self.build_proposals(cfg["ROI_HEAD"])
        self.roi_head = PVRCNNHead(self.roi_cfg, c_kp, dtype=ctx.dtype)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` (the refined RoIs); train: ``loss`` and
        ``tb_dict`` (the anchor head's terms, ``rcnn_loss_cls``,
        ``rcnn_loss_reg``, ``point_loss_cls``). With
        ``return_intermediates`` also the RoIs, the keypoints and their
        weighted features (and, in training, the sampled targets)."""
        return self.two_stage(batch, self.first_stage(batch, generator),
                              return_intermediates, generator)

    def roi_inputs(self, batch, first, rois, roi_valid):
        """The PFE's keypoints (B, K, 3) and their features weighted by the
        point head, with the point head's logits (B, K, 1). The raw points
        by frame and the keypoint picks (the RoI mask and the sector FPS
        for SPC) are the span ``mssvt.keypoints``; the keypoints' features
        from every source, their fusion and the point head ``mssvt.pfe``."""
        sp_out, _, spatial_2d = first
        with tracing.span("keypoints"):
            xyz, feat, pvalid = per_sample_points(batch, self.batch_size,
                                                  self.max_points)
            picks = self.pfe.sample_keypoints(xyz, pvalid, rois, roi_valid)
        with tracing.span("pfe"):
            # the downsampled sites are compacted over the batch: per_sample
            # lays them out by frame (a reshape would mix frames)
            keypoints, kp_feat, _ = self.pfe(
                xyz, feat, pvalid, {"x_conv_out": sp_out.per_sample()}, picks,
                bev_features=spatial_2d, bev_stride=8)
            kp_cls = self.point_head(kp_feat)
            kp_feat = kp_feat * torch.sigmoid(kp_cls)
        return ({"keypoints": keypoints, "kp_features": kp_feat,
                 "kp_cls": kp_cls},
                {"keypoints": keypoints, "kp_features": kp_feat})

    def run_roi_head(self, rin, rois, roi_valid, generator=None):
        return self.roi_head(rin["keypoints"], rin["kp_features"], rois,
                             roi_valid, generator)

    def roi_loss(self, batch, preds, rin, cls, reg, targets):
        loss, tb = super().roi_loss(batch, preds, rin, cls, reg, targets)
        keypoints = rin["keypoints"]
        pt_labels, _ = assign_point_targets(
            keypoints, torch.ones(keypoints.shape[:2], dtype=torch.bool,
                                  device=keypoints.device), batch["gt_boxes"])
        pt_loss = PointHeadSimple.get_loss(rin["kp_cls"], pt_labels)
        tb["point_loss_cls"] = pt_loss
        return loss + pt_loss, tb
