"""SECOND (torch counterpart of ``mssvt_tpu/models/detectors/second_net.py``;
ref: pcdet/models/detectors/second_net.py:4-55): MeanVFE ->
VoxelBackBone8x (the sparse-conv engine) -> the z-major BEV map of its
output -> BaseBEVBackbone -> AnchorHeadSingle.

As in the JAX module, ``MAP_TO_BEV`` is not built: the BEV map is the
backbone output's ``SparseVoxels.bev()`` and the 2D backbone takes the
width that map has (output depth x OUT_CHANNELS), not the config's
``NUM_BEV_FEATURES``. The JAX backbone's grid is ``grid_size`` as given,
where the reference's is one cell deeper in z, so at KITTI's grid the
map has 128 channels where ``second.yaml`` says 256; ``BACKBONE_3D``'s
``PCDET_SPARSE_SHAPE: True`` builds the sites on the reference's grid
(2 x 128 = 256 channels, z-major).

The stages are the spans ``mssvt.vfe``, ``mssvt.backbone_3d`` (which
builds the sorted-key index on its own grid), ``mssvt.map_to_bev``,
``mssvt.backbone_2d``, ``mssvt.head`` and ``mssvt.post``.

Inputs as ``CenterPoint``'s (padded to static capacities, on the model's
device); in eval mode it returns detections, in train mode the loss of
the batch's ``gt_boxes``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ...runtime import tracing
from ..builders import (
    build_backbone_2d,
    build_backbone_3d,
    build_ctx,
    build_dense_head,
    build_vfe,
)
from .generic_post import apply_backbone_3d, apply_vfe, run_dense_head


class SECONDNet(nn.Module):
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
        self.backbone_3d = build_backbone_3d(model_cfg["BACKBONE_3D"], ctx)
        self.backbone_2d = build_backbone_2d(
            model_cfg["BACKBONE_2D"], ctx, self.backbone_3d.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg["DENSE_HEAD"], ctx, self.backbone_2d.num_bev_features)

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` detections; train: ``loss`` and ``tb_dict``.
        With ``return_intermediates`` also the backbone voxels and the BEV
        maps."""
        sp = SparseVoxels.create(
            apply_vfe(self.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], self.batch_size, self.grid_size,
            self.voxel_size, self.point_cloud_range, with_index=False)
        sp = apply_backbone_3d(self.backbone_3d, sp, generator)
        with tracing.span("map_to_bev"):
            spatial_features = sp.bev()  # (B, H, W, D*C) at stride 8
        with tracing.span("backbone_2d"):
            spatial_features_2d = self.backbone_2d(spatial_features)
        out = run_dense_head(self.dense_head, spatial_features_2d, batch,
                             train=self.training,
                             post_cfg=self.model_cfg.get("POST_PROCESSING"))
        if return_intermediates:
            out.update(backbone_voxels=sp, spatial_features=spatial_features,
                       spatial_features_2d=spatial_features_2d)
        return out
