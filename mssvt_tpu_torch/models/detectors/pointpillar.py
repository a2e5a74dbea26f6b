"""PointPillars (torch counterpart of
``mssvt_tpu/models/detectors/pointpillar.py``; ref:
pcdet/models/detectors/pointpillar.py:4-55): PillarVFE ->
PointPillarScatter -> BaseBEVBackbone -> AnchorHeadSingle.

``MAP_TO_BEV`` defaults to ``PointPillarScatter`` with
``NUM_BEV_FEATURES`` the last VFE filter; the padding pillars' features
are zeroed before the scatter.
"""

from __future__ import annotations

from ..builders import (
    build_backbone_2d,
    build_dense_head,
    build_map_to_bev,
    build_vfe,
)
from .detector3d_template import Detector3DTemplate
from .generic_post import apply_vfe, run_dense_head


class PointPillar(Detector3DTemplate):
    def build_networks(self):
        cfg, ctx = self.model_cfg, self.ctx
        self.vfe = build_vfe(cfg["VFE"], ctx)
        m2b = dict(cfg.get("MAP_TO_BEV", {"NAME": "PointPillarScatter"}))
        m2b.setdefault("NUM_BEV_FEATURES",
                       int(cfg["VFE"].get("NUM_FILTERS", [64])[-1]))
        self.map_to_bev = build_map_to_bev(m2b, ctx)
        self.backbone_2d = build_backbone_2d(
            cfg["BACKBONE_2D"], ctx, self.map_to_bev.num_bev_features)
        self.dense_head = build_dense_head(
            cfg["DENSE_HEAD"], ctx, self.backbone_2d.num_bev_features)

    def to_bev(self, x, batch):
        return self.map_to_bev(x, batch["voxel_coords"], batch["voxel_valid"],
                               self.batch_size)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` detections; train: ``loss`` and ``tb_dict``.
        With ``return_intermediates`` also the pillar features and the BEV
        maps."""
        pillar_features = apply_vfe(self.vfe, batch) \
            * batch["voxel_valid"][:, None]
        spatial_features, spatial_features_2d = self.bev_stages(
            pillar_features, batch)
        out = run_dense_head(self.dense_head, spatial_features_2d, batch,
                             train=self.training,
                             post_cfg=self.model_cfg.get("POST_PROCESSING"))
        if return_intermediates:
            out.update(pillar_features=pillar_features,
                       spatial_features=spatial_features,
                       spatial_features_2d=spatial_features_2d)
        return out
