"""PointRCNN's RoI head as OpenPCDet ships it (ref:
pcdet/models/roi_heads/pointrcnn_head.py, ``PointRCNNHead``), beside the
JAX package's head (``detectors/point_rcnn.PointRCNNRoIHead``, which
PointRCNN builds when ``ROI_HEAD`` holds no ``SA_CONFIG``).

- :class:`RoIPointPool` (``roipool3d_gpu``): each point's [class score,
  depth / ``DEPTH_NORMALIZER`` - 0.5, features] pooled with its xyz inside
  each RoI (``ROI_POINT_POOL``: the first ``NUM_SAMPLED_POINTS`` in index
  order, wrapped modulo the count; ``POOL_EXTRA_WIDTH`` 0, as pcdet's
  config), the xyz moved into the RoI's canonical frame, an empty RoI's
  rows zero.
- :class:`PointRCNNHead`: ``xyz_up`` over the five prefix channels (xyz,
  score, depth), ``merge_down`` over [those, the pooled features], the
  ``SA_CONFIG`` set abstractions inside every RoI (FPS on K2c/K2b on the
  card, ball queries; the last one groups all the points), then the class
  and box towers (``CLS_FC``, ``REG_FC``: Dense, BatchNorm, ReLU, as
  pcdet's ``make_fc_layers``; ``DP_RATIO`` 0). ``USE_BN`` False: the
  shared MLPs carry biases and no BatchNorm.

As in pcdet, the pooling and the canonical transform take no gradient
(``torch.no_grad``), and the point scores come detached.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ...ops.pointnet2 import roipoint_pool3d
from ..backbones_3d.pointnet2_backbone import SAModuleMSG, SharedMLP
from ..dense_heads.point_head import _add_tower, _run_tower

PREFIX_CHANNELS = 5  # xyz, class score, depth


class RoIPointPool(nn.Module):
    """pcdet's ``roipool3d_gpu`` without parameters: (B, N, 3) points, (B,
    N, C) features, (B, N) valid, (B, N) class scores, (B, R, 7) RoIs ->
    (pooled (B, R, K, 5 + C) f32: canonical xyz, score, depth, features;
    empty (B, R))."""

    def __init__(self, num_sampled_points: int,
                 depth_normalizer: float = 70.0):
        super().__init__()
        self.num_sampled_points = int(num_sampled_points)
        self.depth_normalizer = float(depth_normalizer)

    def forward(self, xyz, point_features, valid, point_scores, rois):
        x, y, z = xyz.unbind(-1)
        depth = torch.sqrt(x * x + y * y + z * z) / self.depth_normalizer \
            - 0.5
        feats = torch.cat([point_scores[..., None].float(), depth[..., None],
                           point_features.float()], dim=-1)
        pooled, empty = roipoint_pool3d(xyz, feats, rois[..., :7],
                                        self.num_sampled_points, valid)
        local = pooled[..., :3] - rois[..., None, :3]
        h = rois[..., 6][..., None]
        c, s = torch.cos(-h), torch.sin(-h)
        canon = torch.stack([local[..., 0] * c - local[..., 1] * s,
                             local[..., 0] * s + local[..., 1] * c,
                             local[..., 2]], dim=-1)
        out = torch.cat([canon, pooled[..., 3:]], dim=-1)
        return out * (~empty)[..., None, None], empty


class PointRCNNHead(nn.Module):
    """pcdet's ``PointRCNNHead`` on the port's layout: submodules ``pool``,
    ``xyz_up``, ``merge_down``, ``sa_k``, ``cls_fc_i`` / ``cls_bn_i`` /
    ``cls_out`` and ``reg_fc_i`` / ``reg_bn_i`` / ``reg_out``;
    ``point_channels`` is the point features' width."""

    def __init__(self, model_cfg: Any, point_channels: int,
                 code_size: int = 7, dtype=torch.float32):
        super().__init__()
        pool = model_cfg["ROI_POINT_POOL"]
        if any(float(w) for w in pool.get("POOL_EXTRA_WIDTH", ())):
            raise ValueError("PointRCNNHead: POOL_EXTRA_WIDTH must be 0 "
                             "(pcdet's PointRCNN; the pool takes the RoIs "
                             "as they are)")
        self.pool = RoIPointPool(int(pool["NUM_SAMPLED_POINTS"]),
                                 float(pool.get("DEPTH_NORMALIZER", 70.0)))
        use_bn = bool(model_cfg.get("USE_BN", False))
        up = [int(c) for c in model_cfg["XYZ_UP_LAYER"]]
        self.xyz_up = SharedMLP(PREFIX_CHANNELS, up, dtype=dtype,
                                use_bn=use_bn)
        self.merge_down = SharedMLP(up[-1] + point_channels, [up[-1]],
                                    dtype=dtype, use_bn=use_bn)
        sa = model_cfg["SA_CONFIG"]
        c_in = up[-1]
        self.n_sa = len(sa["NPOINTS"])
        for k, npoint in enumerate(sa["NPOINTS"]):
            mod = SAModuleMSG(npoint, [sa["RADIUS"][k]], [sa["NSAMPLE"][k]],
                              [sa["MLPS"][k]], c_in, dtype=dtype,
                              use_bn=use_bn)
            self.add_module(f"sa_{k}", mod)
            c_in = mod.out_channels
        self.n_cls = _add_tower(self, "cls", c_in, model_cfg["CLS_FC"], 1,
                                dtype)
        self.n_reg = _add_tower(self, "reg", c_in, model_cfg["REG_FC"],
                                code_size, dtype)

    def forward(self, points_xyz, point_features, points_valid, rois,
                roi_valid, point_scores):
        """points (B, N, 3), features (B, N, C), valid (B, N), rois (B, R,
        7), RoI valid (B, R), class scores (B, N) -> (cls (B, R), reg (B,
        R, code_size)), zeroed where the RoI is not valid; the arguments
        of the JAX-matching head's, which does not read the scores."""
        with torch.no_grad():
            pooled, _ = self.pool(points_xyz, point_features, points_valid,
                                  point_scores.detach(), rois)
        b, r, k, _ = pooled.shape
        pooled = pooled.reshape(b * r, k, -1)
        x = self.xyz_up(pooled[..., :PREFIX_CHANNELS])
        x = self.merge_down(torch.cat(
            [x, pooled[..., PREFIX_CHANNELS:].to(x.dtype)], dim=-1))
        xyz = pooled[..., :3]
        for i in range(self.n_sa):
            xyz, x, _ = getattr(self, f"sa_{i}")(xyz, x)
        x = x[:, 0]
        m = roi_valid.to(torch.float32)
        cls = _run_tower(self, "cls", self.n_cls, x).reshape(b, r)
        reg = _run_tower(self, "reg", self.n_reg, x).reshape(b, r, -1)
        return cls * m, reg * m[..., None]
