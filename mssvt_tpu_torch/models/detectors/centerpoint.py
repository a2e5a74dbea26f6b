"""CenterPoint (torch counterpart of
``mssvt_tpu/models/detectors/centerpoint.py``): MeanVFE ->
MixedScaleSparseTransformer -> HeightCompression -> BaseBEVBackbone ->
CenterHead. In eval mode it returns detections; in train mode (after
``model.train()``) the loss of the batch's ``gt_boxes``.

Inputs (padded to static capacities, on the model's device):
    voxels (max_voxels, max_points, C_pt), voxel_num_points (max_voxels,),
    voxel_coords (max_voxels, 4) int32 (b, z, y, x), voxel_valid (max_voxels,),
    gt_boxes (batch, max_gt, 8) f32, last column the 1-based class (training).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..builders import build_map_to_bev
from .detector3d_template import Detector3DTemplate


class CenterPoint(Detector3DTemplate):
    def __init__(self, model_cfg: Any, num_class: int,
                 class_names: Sequence[str], grid_size, voxel_size,
                 point_cloud_range, batch_size: int, max_voxels: int,
                 max_points_per_voxel: int, num_point_features: int = 5,
                 dtype=torch.float32):
        super().__init__(model_cfg, num_class, class_names, grid_size,
                         voxel_size, point_cloud_range, batch_size,
                         max_voxels, max_points_per_voxel, num_point_features,
                         dtype)

    def build_map_to_bev(self) -> int:
        self.map_to_bev = build_map_to_bev(self.model_cfg["MAP_TO_BEV"],
                                           self.ctx)
        return self.map_to_bev.num_bev_features

    def to_bev(self, x, batch):
        return self.map_to_bev(x)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: detections as fixed-size padded tensors (``final_*``).
        Train: ``loss`` and ``tb_dict`` (DropPath draws from ``generator``,
        a ``torch.Generator`` on the model's device). With
        ``return_intermediates`` also the backbone voxels and BEV maps."""
        first = self.first_stage(batch, generator)
        out = self.one_stage(batch, first, return_intermediates)
        out["feature_map_size"] = tuple(first[2].shape[1:3])
        return out
