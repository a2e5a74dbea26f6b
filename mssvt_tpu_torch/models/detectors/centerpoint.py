"""CenterPoint detector shell (torch counterpart of
``mssvt_tpu/models/detectors/centerpoint.py``): MeanVFE ->
MixedScaleSparseTransformer -> HeightCompression -> BaseBEVBackbone ->
CenterHead, inference.

Inputs (padded to static capacities, on the model's device):
    voxels (max_voxels, max_points, C_pt), voxel_num_points (max_voxels,),
    voxel_coords (max_voxels, 4) int32 (b, z, y, x), voxel_valid (max_voxels,).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ..builders import (
    BuildCtx,
    build_backbone_2d,
    build_backbone_3d,
    build_dense_head,
    build_map_to_bev,
    build_vfe,
)
from .generic_post import apply_vfe, run_dense_head


class CenterPoint(nn.Module):
    def __init__(self, model_cfg: Any, num_class: int,
                 class_names: Sequence[str], grid_size, voxel_size,
                 point_cloud_range, batch_size: int, max_voxels: int,
                 max_points_per_voxel: int, num_point_features: int = 5,
                 dtype=torch.float32):
        super().__init__()
        self.model_cfg = model_cfg
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.batch_size = int(batch_size)
        ctx = BuildCtx(num_class, tuple(class_names), self.grid_size,
                       self.voxel_size, self.point_cloud_range,
                       self.batch_size, int(max_voxels),
                       int(max_points_per_voxel), int(num_point_features),
                       dtype)
        self.vfe = build_vfe(model_cfg["VFE"], ctx)
        self.backbone_3d = build_backbone_3d(model_cfg["BACKBONE_3D"], ctx)
        self.map_to_bev = build_map_to_bev(model_cfg["MAP_TO_BEV"], ctx)
        self.backbone_2d = build_backbone_2d(
            model_cfg["BACKBONE_2D"], ctx, self.map_to_bev.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg["DENSE_HEAD"], ctx, self.backbone_2d.num_bev_features)

    def forward(self, batch, return_intermediates: bool = False):
        """Detections as fixed-size padded tensors (``final_*``); with
        ``return_intermediates`` also the backbone voxels and BEV maps."""
        if self.training:
            raise NotImplementedError("training comes with the training slice "
                                      "(ROADMAP.md)")
        sp = SparseVoxels.create(
            apply_vfe(self.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], self.batch_size, self.grid_size,
            self.voxel_size, self.point_cloud_range)
        sp = self.backbone_3d(sp)
        spatial_features = self.map_to_bev(sp)
        spatial_features_2d = self.backbone_2d(spatial_features)
        out = run_dense_head(self.dense_head, spatial_features_2d)
        if return_intermediates:
            out.update(backbone_voxels=sp, spatial_features=spatial_features,
                       spatial_features_2d=spatial_features_2d)
        return out
