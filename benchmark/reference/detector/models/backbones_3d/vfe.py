"""Voxel feature encoders (torch counterpart of
``mssvt_tpu/models/backbones_3d/vfe.py``).

- :class:`MeanVFE`: per-voxel mean of the points (MsSVT, SECOND).
- :class:`PillarVFE`: PointPillars' PFN (ref: vfe/pillar_vfe.py:52-194).
- :class:`HardVFE`: mmdet3d's hard-voxelization VFE (ref: hard_vfe.py).
- :class:`DynamicVFE`: dynamic voxelization, every point scattered into
  its voxel (ref: dynamic_vfe.py:13-137).

Static shapes: voxels come as (V, P, C) with a point count a voxel, and
padding voxels and points are zero. The PFN BatchNorm layers reduce over
(V, P), padding included, as flax's BatchNorm does over all leading axes.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..model_utils.layers import BatchNorm, Dense


class MeanVFE(nn.Module):
    """Mean of the (zero-padded) points in each voxel."""

    def forward(self, voxels, voxel_num_points):
        # voxels: (V, P, C); voxel_num_points: (V,)
        n = torch.clamp(voxel_num_points.to(voxels.dtype), min=1.0)
        return voxels.sum(dim=1) / n[:, None]


def _voxel_centers(coords, dtype, voxel_size, point_cloud_range):
    """(V, 3) metric x, y, z of each voxel's centre from (b, z, y, x)."""
    vx, vy, vz = voxel_size
    x0, y0, z0 = point_cloud_range[:3]
    return torch.stack([
        coords[:, 3].to(dtype) * vx + (vx / 2 + x0),
        coords[:, 2].to(dtype) * vy + (vy / 2 + y0),
        coords[:, 1].to(dtype) * vz + (vz / 2 + z0)], dim=-1)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _add_point_layers(mod, c_in, widths, use_norm, prefix, bn_prefix):
    """The Dense (+ BatchNorm) layers of a PFN/VFE stack on ``mod``, named
    ``prefix_i`` / ``bn_prefix_i`` as the flax module names them; each
    layer but the last feeds twice its width on (itself ++ its max, or
    ++ its voxel mean)."""
    mod.layer_names = []
    for i, units in enumerate(widths):
        mod.add_module(f"{prefix}_{i}", Dense(c_in, units, bias=not use_norm))
        if use_norm:
            mod.add_module(f"{bn_prefix}_{i}", BatchNorm(
                units, 1e-3, momentum=0.99, channels_last=True))
        mod.layer_names.append((f"{prefix}_{i}",
                                f"{bn_prefix}_{i}" if use_norm else None))
        c_in = 2 * units


def _point_layer(mod, i, x):
    dense, bn = mod.layer_names[i]
    x = getattr(mod, dense)(x)
    return getattr(mod, bn)(x) if bn else x


def _pfn_widths(num_filters):
    """Non-final layers emit nf // 2 and concatenate their max back (ref
    pillar_vfe.py PFNLayer: out_channels //= 2 when not last)."""
    n = len(num_filters)
    return [nf if i == n - 1 else nf // 2 for i, nf in enumerate(num_filters)]


class PillarVFE(nn.Module):
    """PointPillars pillar feature net: each point gains its offset from
    the pillar's point mean and from the pillar centre, then PFN
    Dense+BN+ReLU layers with a max over the points."""

    def __init__(self, num_point_features: int, num_filters: Sequence[int],
                 voxel_size, point_cloud_range, use_norm=True,
                 use_absolute_xyz=True, with_distance=False):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        c_in = (num_point_features if use_absolute_xyz
                else num_point_features - 3) + 6 + int(with_distance)
        _add_point_layers(self, c_in, _pfn_widths(num_filters), use_norm,
                          "pfn", "pfn_bn")

    def forward(self, voxels, voxel_num_points, coords):
        v, p, _ = voxels.shape
        count = torch.clamp(voxel_num_points.to(voxels.dtype), min=1)
        xyz = voxels[..., :3]
        f_cluster = xyz - xyz.sum(1, keepdim=True) / count[:, None, None]
        f_center = xyz - _voxel_centers(coords, voxels.dtype, self.voxel_size,
                                        self.point_cloud_range)[:, None, :]
        feats = [voxels if self.use_absolute_xyz else voxels[..., 3:],
                 f_cluster, f_center]
        if self.with_distance:
            feats.append(_norm(xyz))
        x = torch.cat(feats, dim=-1)
        pt_mask = (torch.arange(p, device=voxels.device)[None, :]
                   < voxel_num_points[:, None])[..., None]
        x = x * pt_mask.to(x.dtype)
        n = len(self.num_filters)
        for i in range(n):
            x = torch.relu(_point_layer(self, i, x))
            x_max = x.max(dim=1, keepdim=True).values
            if i == n - 1:
                return x_max[:, 0, :]
            x = torch.cat([x, x_max.expand_as(x)], dim=-1)
        return x


class HardVFE(nn.Module):
    """mmdet3d-style hard-voxelization VFE: PillarVFE's augmentation for
    3D voxels and a stack of VFE layers, padding points masked after each
    ReLU; non-final layers concatenate their max back onto every point."""

    def __init__(self, num_point_features: int, num_filters: Sequence[int],
                 voxel_size, point_cloud_range, use_norm=True,
                 with_cluster_center=True, with_voxel_center=True,
                 with_distance=False):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.with_distance = with_distance
        c_in = (num_point_features + 3 * int(with_cluster_center)
                + 3 * int(with_voxel_center) + int(with_distance))
        _add_point_layers(self, c_in, _pfn_widths(num_filters), use_norm,
                          "vfe", "vfe_bn")

    def forward(self, voxels, voxel_num_points, coords):
        v, p, _ = voxels.shape
        count = torch.clamp(voxel_num_points.to(voxels.dtype), min=1)
        xyz = voxels[..., :3]
        feats = [voxels]
        if self.with_cluster_center:
            feats.append(xyz - xyz.sum(1, keepdim=True)
                         / count[:, None, None])
        if self.with_voxel_center:
            feats.append(xyz - _voxel_centers(
                coords, voxels.dtype, self.voxel_size,
                self.point_cloud_range)[:, None, :])
        if self.with_distance:
            feats.append(_norm(xyz))
        x = torch.cat(feats, dim=-1)
        pt_mask = (torch.arange(p, device=voxels.device)[None, :]
                   < voxel_num_points[:, None])[..., None].to(x.dtype)
        x = x * pt_mask
        n = len(self.num_filters)
        for i in range(n):
            x = torch.relu(_point_layer(self, i, x)) * pt_mask
            x_max = x.max(dim=1, keepdim=True).values
            if i == n - 1:
                return x_max[:, 0, :]
            x = torch.cat([x, x_max.expand_as(x)], dim=-1)
        return x


class DynamicVFE(nn.Module):
    """Dynamic-voxelization VFE: each point carries its voxel's row ((P,)
    int32, -1 for a dropped point); per layer a point MLP, a scatter-mean
    to the voxels, and (but for the last) the voxel mean gathered back and
    concatenated. The scatters sum with ``index_add_`` into a buffer with
    a dump row for the dropped points."""

    def __init__(self, num_point_features: int, num_filters: Sequence[int],
                 voxel_size, point_cloud_range, num_voxels: int,
                 use_norm=True):
        super().__init__()
        self.num_filters = tuple(num_filters)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.num_voxels = int(num_voxels)
        _add_point_layers(self, num_point_features + 6, self.num_filters,
                          use_norm, "dvfe", "dvfe_bn")

    def forward(self, points, point_voxel_rows, voxel_coords):
        v = self.num_voxels
        ok = point_voxel_rows >= 0
        rows = torch.where(ok, point_voxel_rows.long(), v)
        okf = ok[:, None]
        safe = rows.clamp(0, v - 1)

        def scatter_mean(x):
            s = x.new_zeros((v + 1, x.shape[-1])).index_add(0, rows, x * okf)
            n = x.new_zeros((v + 1,)).index_add(0, rows, ok.to(x.dtype))
            return s[:v] / torch.clamp(n[:v], min=1)[:, None]

        xyz = points[:, :3]
        f_cluster = xyz - scatter_mean(xyz)[safe]
        f_center = xyz - _voxel_centers(voxel_coords[safe], points.dtype,
                                        self.voxel_size,
                                        self.point_cloud_range)
        x = torch.cat([points, f_cluster, f_center], dim=-1) * okf
        n = len(self.num_filters)
        for i in range(n):
            x = torch.relu(_point_layer(self, i, x)) * okf
            voxel_feat = scatter_mean(x)
            if i == n - 1:
                return voxel_feat
            x = torch.cat([x, voxel_feat[safe]], dim=-1) * okf
        return voxel_feat
