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

import torch

from ..roi_heads.bev_grid_head import BEVGridRoIHead
from ..roi_heads.roi_head_template import two_stage_loss
from .detector3d_template import Detector3DTemplate


class SECONDNetIoU(Detector3DTemplate):
    def build_networks(self):
        super().build_networks()
        self.build_proposals(self.model_cfg["ROI_HEAD"])
        stride = int(self.roi_cfg.get("BEV_STRIDE", 8))
        self.roi_head = BEVGridRoIHead(
            self.roi_cfg, self.backbone_2d.num_bev_features,
            self.point_cloud_range,
            (self.voxel_size[0] * stride, self.voxel_size[1] * stride),
            dtype=self.ctx.dtype)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` (refined RoIs); train: ``loss``, ``tb_dict``.
        With ``return_intermediates`` also the RoIs (and, in training,
        the sampled targets) and the 2D backbone's map."""
        return self.two_stage(batch, self.first_stage(batch, generator),
                              return_intermediates, generator)

    def roi_inputs(self, batch, first, rois, roi_valid):
        return {"bev": first[2]}, {"spatial_features_2d": first[2]}

    def run_roi_head(self, rin, rois, roi_valid, generator=None):
        return self.roi_head(rin["bev"], rois, roi_valid, generator)

    def roi_loss(self, batch, preds, rin, cls, reg, targets):
        return two_stage_loss(
            self.dense_head, preds, batch["gt_boxes"], cls, reg, targets,
            self.roi_cfg, code_weights=self.roi_cfg.get(
                "LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {}).get("code_weights"))

    def final_scores(self, cls, roi_scores, roi_labels, roi_valid):
        """sigmoid(RoI logit) x the RoI's first-stage score."""
        return torch.sigmoid(cls) * roi_scores * roi_valid, roi_valid
