"""VoxelSetAbstraction, PV-RCNN's keypoint branch (torch counterpart of
``mssvt_tpu/models/backbones_3d/pfe.py``; ref:
pcdet/models/backbones_3d/pfe/voxel_set_abstraction.py:124-411).

Keypoints are sampled from the raw points (``SAMPLE_METHOD`` FPS: K2c on
the card over every point row, padding included, as in JAX; SPC: the
sectorised, proposal-centred masked FPS, the masked FPS kernel on the
card), then
each keypoint gathers features from several sources, concatenated and
fused by ``vsa_point_fc`` + ``vsa_bn`` + ReLU:

- the BEV map, bilinearly at the keypoint (``bilinear_sample_bev``);
- the raw points, a ball query and shared MLP a radius (``raw_mlp_i``);
- each sparse stage given in ``sources``: a ball query and shared MLP a
  radius (``{src}_mlp_i``), or with ``NAME: VectorPool...`` PV-RCNN++'s
  vector pool, a Dense and a BatchNorm (``{src}_vp_fc_i``,
  ``{src}_vp_bn_i``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...ops.pointnet2 import query_and_group, vector_pool
from ...ops.sampling import (
    farthest_point_sample,
    gather_batch_rows,
    sample_points_with_roi,
    sector_fps,
)
from ..model_utils.layers import BatchNorm, Dense
from ..roi_heads.bev_grid_head import bilinear_sample_bev
from .pointnet2_backbone import SharedMLP, pool_max


def _layers(scfg):
    return list(zip(scfg["POOL_RADIUS"], scfg["NSAMPLE"], scfg["MLPS"]))


class VoxelSetAbstraction(nn.Module):
    """``source_channels`` maps each sparse source of ``SA_LAYER`` to its
    feature width; ``point_channels`` is the raw points' feature width
    (past xyz) and ``bev_channels`` the BEV map's (0: no BEV source)."""

    def __init__(self, model_cfg: Any, voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float], num_keypoints: int,
                 point_channels: int, source_channels: Dict[str, int],
                 bev_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.num_keypoints = int(num_keypoints)
        self.method = str(model_cfg.get("SAMPLE_METHOD", "FPS")).upper()
        sa = model_cfg["SA_LAYER"]
        c = bev_channels
        self.raw = "raw_points" in dict(sa)
        if self.raw:
            for i, (_, _, mlp) in enumerate(_layers(sa["raw_points"])):
                mod = SharedMLP(3 + point_channels, mlp, dtype=dtype)
                self.add_module(f"raw_mlp_{i}", mod)
                c += mod.out_channels
        self.vector_pool = {}
        for name, cs in source_channels.items():
            scfg = sa[name]
            vp = str(scfg.get("NAME", "")).startswith("VectorPool")
            self.vector_pool[name] = vp
            g3 = int(scfg.get("GRID_SIZE", 2)) ** 3
            for i, (_, _, mlp) in enumerate(_layers(scfg)):
                out = int(mlp[-1])
                if vp:
                    self.add_module(f"{name}_vp_fc_{i}", Dense(
                        g3 * (3 + cs), out, bias=False, dtype=dtype))
                    self.add_module(f"{name}_vp_bn_{i}", BatchNorm(
                        out, 1e-3, dtype=dtype, channels_last=True))
                else:
                    self.add_module(f"{name}_mlp_{i}",
                                    SharedMLP(3 + cs, mlp, dtype=dtype))
                c += out
        self.num_keypoint_features = c
        out_c = int(model_cfg["NUM_OUTPUT_FEATURES"])
        self.vsa_point_fc = Dense(c, out_c, bias=False, dtype=dtype)
        self.vsa_bn = BatchNorm(out_c, 1e-3, dtype=dtype, channels_last=True)
        self.compute_dtype = dtype

    def sample_keypoints(self, points_xyz, points_valid, rois=None,
                         roi_valid=None):
        """(B, K) int32 keypoint picks of the configured SAMPLE_METHOD."""
        if self.method == "SPC":
            spc = self.cfg.get("SPC_SAMPLING", {})
            valid = points_valid
            if rois is not None:
                valid = sample_points_with_roi(
                    points_xyz, valid, rois[..., :7].detach(), roi_valid,
                    float(spc.get("SAMPLE_RADIUS_WITH_ROI", 1.6)))
            return sector_fps(points_xyz, valid, self.num_keypoints,
                              int(spc.get("NUM_SECTORS", 6)))
        return farthest_point_sample(points_xyz, self.num_keypoints)

    def forward(self, points_xyz, points_feat, points_valid, sources: Dict,
                picks, bev_features=None, bev_stride: int = 8):
        """points (B, N, 3) (padded at the origin), their features (B, N,
        C) or None, valid (B, N); ``sources`` {name: (xyz (B, M, 3),
        features (B, M, C), valid (B, M))}; the keypoint ``picks`` (B, K)
        of :meth:`sample_keypoints`; the BEV map (B, H, W, C) NHWC.
        Returns keypoints (B, K, 3), fused features (B, K,
        NUM_OUTPUT_FEATURES) f32, the concatenated source features (B, K,
        C) f32."""
        keypoints = gather_batch_rows(points_xyz, picks)
        sa = self.cfg["SA_LAYER"]
        feats = []
        if bev_features is not None:
            feats.append(bilinear_sample_bev(
                bev_features, keypoints[..., :2], self.point_cloud_range,
                (self.voxel_size[0] * bev_stride,
                 self.voxel_size[1] * bev_stride)))
        if self.raw:
            outs = []
            for i, (r, ns, _) in enumerate(_layers(sa["raw_points"])):
                grouped, empty = query_and_group(
                    float(r), int(ns), points_xyz, keypoints, points_feat,
                    points_valid)
                outs.append(pool_max(getattr(self, f"raw_mlp_{i}")(grouped),
                                     empty))
            feats.append(torch.cat(outs, dim=-1))
        for name, (sx, sf, sv) in sources.items():
            scfg, outs = sa[name], []
            for i, (r, ns, _) in enumerate(_layers(scfg)):
                if self.vector_pool[name]:
                    pooled, empty = vector_pool(
                        keypoints, sx, sf, sv, float(r), int(ns),
                        grid=int(scfg.get("GRID_SIZE", 2)))
                    h = getattr(self, f"{name}_vp_bn_{i}")(
                        getattr(self, f"{name}_vp_fc_{i}")(pooled))
                    outs.append(torch.relu(h) * (~empty)[..., None])
                    continue
                grouped, empty = query_and_group(float(r), int(ns), sx,
                                                 keypoints, sf, sv)
                outs.append(pool_max(getattr(self, f"{name}_mlp_{i}")(grouped),
                                     empty))
            feats.append(torch.cat(outs, dim=-1))
        kp_feat = torch.cat([f.to(self.compute_dtype) for f in feats], dim=-1)
        fused = torch.relu(self.vsa_bn(self.vsa_point_fc(kp_feat)))
        return keypoints, fused.float(), kp_feat.float()
