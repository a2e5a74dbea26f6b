"""VoxelRCNN (torch counterpart of
``mssvt_tpu/models/detectors/voxel_rcnn.py``; ref:
pcdet/models/detectors/voxel_rcnn.py): SECOND's first stage on
``VoxelBackBone8x(return_stages=True)``, the proposal NMS, and the
``VoxelRCNNHead`` pooling the sparse stages' voxel features at a grid of
points inside each RoI. Outputs as ``SECONDNetIoU``'s, the final score
sigmoid(RoI logit) alone.
"""

from __future__ import annotations

from ..roi_heads.voxelrcnn_head import VoxelRCNNHead
from .detector3d_template import Detector3DTemplate


class VoxelRCNN(Detector3DTemplate):
    def build_networks(self):
        super().build_networks(
            {**dict(self.model_cfg["BACKBONE_3D"]), "RETURN_STAGES": True})
        self.build_proposals(self.model_cfg["ROI_HEAD"])
        self.roi_head = VoxelRCNNHead(
            self.roi_cfg, self.backbone_3d.stage_channels,
            dtype=self.ctx.dtype)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """As ``SECONDNetIoU.forward``; the intermediates also hold the
        sparse stages."""
        return self.two_stage(batch, self.first_stage(batch, generator),
                              return_intermediates, generator)

    def roi_inputs(self, batch, first, rois, roi_valid):
        (_, stages), _, spatial_2d = first
        return {"stages": stages}, {"stages": stages,
                                    "spatial_features_2d": spatial_2d}

    def run_roi_head(self, rin, rois, roi_valid, generator=None):
        return self.roi_head(rin["stages"], rois, roi_valid, self.batch_size,
                             generator)
