"""PointPillars (torch counterpart of
``mssvt_tpu/models/detectors/pointpillar.py``; ref:
pcdet/models/detectors/pointpillar.py:4-55): PillarVFE ->
PointPillarScatter -> BaseBEVBackbone -> AnchorHeadSingle.

``MAP_TO_BEV`` defaults to ``PointPillarScatter`` with
``NUM_BEV_FEATURES`` the last VFE filter; the padding pillars' features
are zeroed before the scatter.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..builders import (
    build_backbone_2d,
    build_ctx,
    build_dense_head,
    build_map_to_bev,
    build_vfe,
)
from .generic_post import apply_vfe, run_dense_head


class PointPillar(nn.Module):
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
        self.grid_size, self.batch_size = ctx.grid_size, ctx.batch_size
        self.vfe = build_vfe(model_cfg["VFE"], ctx)
        m2b = dict(model_cfg.get("MAP_TO_BEV", {"NAME": "PointPillarScatter"}))
        m2b.setdefault("NUM_BEV_FEATURES",
                       int(model_cfg["VFE"].get("NUM_FILTERS", [64])[-1]))
        self.map_to_bev = build_map_to_bev(m2b, ctx)
        self.backbone_2d = build_backbone_2d(
            model_cfg["BACKBONE_2D"], ctx, self.map_to_bev.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg["DENSE_HEAD"], ctx, self.backbone_2d.num_bev_features)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` detections; train: ``loss`` and ``tb_dict``.
        With ``return_intermediates`` also the pillar features and the BEV
        maps."""
        valid = batch["voxel_valid"]
        pillar_features = apply_vfe(self.vfe, batch) * valid[:, None]
        spatial_features = self.map_to_bev(
            pillar_features, batch["voxel_coords"], valid, self.batch_size)
        spatial_features_2d = self.backbone_2d(spatial_features)
        out = run_dense_head(self.dense_head, spatial_features_2d, batch,
                             train=self.training,
                             post_cfg=self.model_cfg.get("POST_PROCESSING"))
        if return_intermediates:
            out.update(pillar_features=pillar_features,
                       spatial_features=spatial_features,
                       spatial_features_2d=spatial_features_2d)
        return out
