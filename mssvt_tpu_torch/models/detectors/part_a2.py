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

import torch

from ..dense_heads.point_intra_part_head import PointIntraPartOffsetHead
from ..roi_heads.partA2_head import PartA2FCHead
from .detector3d_template import Detector3DTemplate


class PartA2Net(Detector3DTemplate):
    def build_networks(self):
        super().build_networks()
        cfg, dtype = self.model_cfg, self.ctx.dtype
        c_point = int(cfg["BACKBONE_3D"].get("NUM_FILTERS", [16])[0])
        self.point_head = PointIntraPartOffsetHead(
            cfg["POINT_HEAD"], c_point, num_class=1, dtype=dtype)
        self.build_proposals(cfg["ROI_HEAD"])
        self.roi_head = PartA2FCHead(self.roi_cfg, part_channels=4,
                                     seg_channels=c_point, dtype=dtype)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """As ``SECONDNetIoU.forward``; the intermediates also hold the
        stride-1 voxels, the segmentation logits and part predictions."""
        return self.two_stage(batch, self.first_stage(batch, generator),
                              return_intermediates, generator)

    def roi_inputs(self, batch, first, rois, roi_valid):
        """The stride-1 voxels as points a frame, their part and
        segmentation features, and the point head's outputs."""
        (_, sp_points), _, spatial_2d = first
        b = self.batch_size
        seg_logits, part_preds = self.point_head(sp_points.features)
        pts = sp_points.metric_centers().reshape(b, -1, 3)
        n = pts.shape[1]
        part_feats = torch.cat([torch.sigmoid(part_preds),
                                torch.sigmoid(seg_logits)], -1).reshape(b, n, -1)
        rin = {"pts": pts, "part_feats": part_feats,
               "seg_feats": sp_points.features.reshape(b, n, -1),
               "pvalid": sp_points.valid.reshape(b, n),
               "seg_logits": seg_logits.reshape(b, n, -1),
               "part_preds": part_preds.reshape(b, n, -1)}
        return rin, {"points": sp_points, "seg_logits": seg_logits,
                     "part_preds": part_preds,
                     "spatial_features_2d": spatial_2d}

    def run_roi_head(self, rin, rois, roi_valid, generator=None):
        return self.roi_head(rin["pts"], rin["part_feats"], rin["seg_feats"],
                             rin["pvalid"], rois, roi_valid, generator)

    def roi_loss(self, batch, preds, rin, cls, reg, targets):
        loss, tb = super().roi_loss(batch, preds, rin, cls, reg, targets)
        seg_loss, part_loss, _ = PointIntraPartOffsetHead.get_loss(
            rin["seg_logits"], rin["part_preds"], rin["pts"], rin["pvalid"],
            batch["gt_boxes"])
        tb.update({"point_loss_seg": seg_loss, "point_loss_part": part_loss})
        return loss + seg_loss + part_loss, tb
