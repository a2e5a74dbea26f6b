"""VoxelRCNN head (torch counterpart of
``mssvt_tpu/models/roi_heads/voxelrcnn_head.py``; ref:
pcdet/models/roi_heads/voxelrcnn_head.py and
pointnet2_stack/voxel_pool_modules.py:8 NeighborVoxelSAModuleMSG).

A G^3 grid of points inside each RoI pools the sparse backbone's voxel
features of several stages: each point's :func:`ops.voxel_query`
neighbourhood, (relative centre, features) through a per-scale shared MLP,
max over the neighbours; the grids flattened into shared FC layers
(Dense, BatchNorm, ReLU, dropout) and the class and box outputs.

The neighbour features are picked with :func:`ops.sampling.gather_rows`:
at KITTI's widths a voxel is a neighbour of thousands of grid points
(128 overlapping RoIs x 216 points, 16 picks each), and an empty point
picks row 0 sixteen times; those picks are live in the backward (the
MLP's BatchNorm counts every (point, slot) entry), and ``gather_rows``
sums them deterministically in parallel.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...ops.sampling import gather_rows
from ...ops.voxel_query import voxel_query
from ..backbones_3d.pointnet2_backbone import SharedMLP
from ..model_utils.layers import BatchNorm, Dense, dropout
from .pvrcnn_head import roi_grid_points_3d


class NeighborVoxelSA(nn.Module):
    """One scale of neighbour-voxel set abstraction (ref:
    voxel_pool_modules.py:8-115): (B, G, 3) metric grid points against a
    stage's ``SparseVoxels`` -> (B, G, mlps[-1])."""

    def __init__(self, in_channels: int, mlps: Sequence[int],
                 max_range: Sequence[int], radius: float, nsample: int,
                 dtype=torch.float32):
        super().__init__()
        self.max_range = tuple(int(r) for r in max_range)  # (z, y, x)
        self.radius, self.nsample = float(radius), int(nsample)
        self.mlp = SharedMLP(in_channels + 3, mlps, dtype=dtype)

    def forward(self, grid_pts, sp, batch_size: int):
        idx, empty = voxel_query(
            grid_pts, sp.coords, sp.valid, sp.spatial_shape, sp.voxel_size,
            sp.point_cloud_range, self.max_range, self.radius, self.nsample,
            batch_size)
        feats = gather_rows(sp.features, idx)  # (B, G, S, C)
        nb_xyz = sp.metric_centers()[idx.long()]  # (B, G, S, 3), no gradient
        live = (~empty)[..., None, None]
        rel = (nb_xyz - grid_pts[:, :, None, :]) * live
        x = self.mlp(torch.cat([rel.to(feats.dtype), feats], dim=-1))
        return x.amax(dim=2) * (~empty)[..., None]  # ties share, as jnp.max


class VoxelRCNNHead(nn.Module):
    """Ref: voxelrcnn_head.py VoxelRCNNHead. ``stage_channels`` maps each
    FEATURES_SOURCE stage to its feature width."""

    def __init__(self, model_cfg: Any, stage_channels: Dict[str, int],
                 code_size: int = 7, dtype=torch.float32):
        super().__init__()
        self.grid = int(model_cfg.get("GRID_SIZE", 6))
        self.dp = float(model_cfg.get("DP_RATIO", 0.3))
        pool = model_cfg["ROI_GRID_POOL"]
        self.sources = list(pool["FEATURES_SOURCE"])
        self.sa_names = []
        c_pool = 0
        for name in self.sources:
            scfg = pool["POOL_LAYERS"][name]
            for i, (rad, ns, mlp) in enumerate(zip(
                    scfg["QUERY_RANGES"], scfg["NSAMPLE"], scfg["MLPS"])):
                sa = NeighborVoxelSA(stage_channels[name], tuple(mlp),
                                     tuple(rad[::-1]),
                                     float(scfg["POOL_RADIUS"][i]), int(ns),
                                     dtype=dtype)
                self.add_module(f"{name}_sa_{i}", sa)
                self.sa_names.append((name, f"{name}_sa_{i}"))
                c_pool += sa.mlp.out_channels
        c_in = c_pool * self.grid ** 3
        self.n_fc = len(model_cfg.get("SHARED_FC", [256, 256]))
        for i, fc in enumerate(model_cfg.get("SHARED_FC", [256, 256])):
            self.add_module(f"shared_fc_{i}", Dense(c_in, fc, bias=False,
                                                    dtype=dtype))
            self.add_module(f"shared_bn_{i}", BatchNorm(
                fc, 1e-3, dtype=dtype, channels_last=True))
            c_in = fc
        self.cls_out = Dense(c_in, 1, dtype=dtype)
        self.reg_out = Dense(c_in, code_size, dtype=dtype)

    def forward(self, stages, rois, roi_valid, batch_size: int,
                generator=None):
        """stages: {name: SparseVoxels}; rois (B, R, 7) -> (cls (B, R),
        reg (B, R, code_size)), zeroed where the RoI is not valid."""
        g = self.grid
        b, r = rois.shape[:2]
        grid_pts = roi_grid_points_3d(rois, g).reshape(b, r * g ** 3, 3)
        pooled = [getattr(self, sa)(grid_pts, stages[name], batch_size)
                  for name, sa in self.sa_names]
        x = torch.cat(pooled, dim=-1).reshape(b, r, -1)
        for i in range(self.n_fc):
            x = getattr(self, f"shared_bn_{i}")(
                getattr(self, f"shared_fc_{i}")(x))
            x = dropout(torch.relu(x), self.dp, self.training, generator)
        m = roi_valid.to(torch.float32)
        return (self.cls_out(x)[..., 0].float() * m,
                self.reg_out(x).float() * m[..., None])
