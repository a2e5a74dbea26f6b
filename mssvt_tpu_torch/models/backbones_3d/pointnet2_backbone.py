"""PointNet++ modules and the point-based backbone (torch counterpart of
``mssvt_tpu/models/backbones_3d/pointnet2_backbone.py``; ref:
pcdet/models/backbones_3d/pointnet2_backbone.py:9-206 and
ops/pointnet2/pointnet2_batch/pointnet2_modules.py).

- :class:`SharedMLP`: the pointwise Dense + BatchNorm + ReLU stack (the
  reference's 1x1 Conv2d stacks), or Dense with a bias + ReLU without
  BatchNorm.
- :class:`BallQuery`: :func:`ops.pointnet2.ball_query` as a module without
  parameters, so that a forward hook sees each query's neighbours.
- :class:`SAModuleMSG`: multi-scale-grouping set abstraction: FPS centres
  (K2b/K2c on the card), a ball query and a shared MLP a radius, max over
  the neighbours; or, without ``npoint``, one group of all the points.
- :class:`FPModule`: feature propagation: 3-NN inverse-distance
  interpolation, then a shared MLP.
- :class:`PointNet2MSG`: the encoder-decoder over padded per-frame points,
  each set abstraction in the span ``mssvt.sa``, each feature propagation
  in ``mssvt.fp``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...ops.pointnet2 import ball_query, group_points
from ...runtime import tracing
from ...ops.sampling import (
    farthest_point_sample,
    gather_batch_rows,
    three_interpolate,
    three_nn,
)
from ..model_utils.layers import BatchNorm, Dense


class SharedMLP(nn.Module):
    """Pointwise Dense (no bias) + BatchNorm (flax's momentum 0.99, eps
    1e-3, over every axis but the last) + ReLU stack, as the reference's
    1x1 Conv2d stacks; submodules ``mlp_i`` / ``bn_i``. Without ``use_bn``
    (pcdet's ``bn=False``) each ``mlp_i`` has a bias and no BatchNorm
    follows it."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 dtype=torch.float32, use_bn: bool = True):
        super().__init__()
        self.n, self.use_bn = len(channels), use_bn
        c_in = in_channels
        for i, c in enumerate(channels):
            self.add_module(f"mlp_{i}", Dense(c_in, c, bias=not use_bn,
                                              dtype=dtype))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(
                    c, 1e-3, dtype=dtype, channels_last=True))
            c_in = c
        self.out_channels = c_in

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"mlp_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = torch.relu(x)
        return x


class BallQuery(nn.Module):
    """:func:`ops.pointnet2.ball_query` of one radius, no parameters:
    (B, N, 3) support points, (B, M, 3) queries -> (idx (B, M, nsample)
    int32, empty (B, M))."""

    def __init__(self, radius: float, nsample: int):
        super().__init__()
        self.radius, self.nsample = float(radius), int(nsample)

    def forward(self, xyz, new_xyz, xyz_valid=None):
        return ball_query(self.radius, self.nsample, xyz, new_xyz, xyz_valid)


def pool_max(h, empty):
    """Max over the neighbour axis (2), zero for an empty query. ``amax``
    splits a tied maximum's cotangent evenly, as ``jnp.max`` does (the
    replicated slots tie)."""
    return h.amax(dim=2) * (~empty)[..., None]


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (pointnet2_modules.py:10-100);
    submodules ``mlp_g{j}`` and ``query_{j}`` (:class:`BallQuery`), one a
    radius. An ``npoint`` of None or below 0 is pcdet's ``GroupAll``: one
    group of every point, its xyz as it is, and one ``mlp_g0``."""

    def __init__(self, npoint, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_channels: int, use_xyz: bool = True, dtype=torch.float32,
                 use_bn: bool = True):
        super().__init__()
        self.npoint = None if npoint is None or int(npoint) < 0 \
            else int(npoint)
        self.use_xyz = use_xyz
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        c_in = in_channels + (3 if use_xyz else 0)
        for j, mlp in enumerate(mlps):
            self.add_module(f"mlp_g{j}", SharedMLP(c_in, mlp, dtype=dtype,
                                                   use_bn=use_bn))
            if self.npoint is not None:
                self.add_module(f"query_{j}", BallQuery(self.radii[j],
                                                        self.nsamples[j]))
        self.n_groups = len(mlps)
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, features=None, xyz_valid=None):
        """(B, N, 3), (B, N, C) -> new_xyz (B, npoint, 3), features (B,
        npoint, sum of the MLPs' last widths), the FPS picks (B, npoint).
        The padding rows (at the origin) take part in the FPS, as in JAX.
        Grouping all: (None, features (B, 1, C_out), None)."""
        if self.npoint is None:
            parts = [xyz] if self.use_xyz else []
            if features is not None:
                parts.append(features.to(xyz.dtype))
            h = self.mlp_g0(torch.cat(parts, dim=-1)[:, None])
            return None, h.amax(dim=2), None
        fps_idx = farthest_point_sample(xyz, self.npoint)
        new_xyz = gather_batch_rows(xyz, fps_idx)
        outs = []
        for j in range(self.n_groups):
            idx, empty = getattr(self, f"query_{j}")(xyz, new_xyz, xyz_valid)
            grouped = group_points(idx, empty, xyz, new_xyz, features,
                                   self.use_xyz)
            outs.append(pool_max(getattr(self, f"mlp_g{j}")(grouped), empty))
        return new_xyz, torch.cat(outs, dim=-1), fps_idx


class FPModule(nn.Module):
    """Feature propagation (pointnet2_modules.py): the known features at
    each unknown point by inverse-distance weights 1 / (sqrt(d2) + 1e-8)
    over its 3 nearest known points, its own features appended, then the
    shared MLP ``mlp``."""

    def __init__(self, in_channels: int, mlp: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, dtype=dtype)
        self.out_channels = self.mlp.out_channels

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        d2, idx = three_nn(unknown_xyz, known_xyz)
        w = 1.0 / (torch.sqrt(d2) + 1e-8)
        w = w / w.sum(-1, keepdim=True)
        x = three_interpolate(known_feats, idx, w)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats.to(x.dtype)], dim=-1)
        return self.mlp(x)


class PointNet2MSG(nn.Module):
    """Point-based encoder-decoder (ref: pointnet2_backbone.py:9-95):
    ``SA_CONFIG`` (NPOINTS, RADIUS, NSAMPLE, MLPS) levels ``sa_i``, then
    ``FP_MLPS`` levels ``fp_i`` from the coarsest back to the input.
    (B, N, 3) points with (B, N, C) features -> (B, N, FP_MLPS[0][-1])."""

    def __init__(self, model_cfg: Any, input_channels: int,
                 dtype=torch.float32):
        super().__init__()
        sa = model_cfg["SA_CONFIG"]
        fp_mlps = [list(m) for m in model_cfg["FP_MLPS"]]
        widths = [int(input_channels)]
        self.n_sa = len(sa["NPOINTS"])
        for i, npoint in enumerate(sa["NPOINTS"]):
            mod = SAModuleMSG(npoint, sa["RADIUS"][i], sa["NSAMPLE"][i],
                              sa["MLPS"][i], widths[-1], dtype=dtype)
            self.add_module(f"sa_{i}", mod)
            widths.append(mod.out_channels)
        self.n_fp = len(fp_mlps)
        up = widths[self.n_fp]
        for i in range(self.n_fp - 1, -1, -1):
            mod = FPModule(up + widths[i], fp_mlps[i], dtype=dtype)
            self.add_module(f"fp_{i}", mod)
            up = mod.out_channels
        self.num_point_features = up

    def forward(self, xyz, features=None, xyz_valid=None):
        xyz_list, feat_list, valid = [xyz], [features], xyz_valid
        for i in range(self.n_sa):
            with tracing.span("sa"):
                new_xyz, new_feat, _ = getattr(self, f"sa_{i}")(
                    xyz_list[-1], feat_list[-1], valid)
            xyz_list.append(new_xyz)
            feat_list.append(new_feat)
            valid = None
        for i in range(self.n_fp - 1, -1, -1):
            with tracing.span("fp"):
                feat_list[i] = getattr(self, f"fp_{i}")(
                    xyz_list[i], xyz_list[i + 1], feat_list[i],
                    feat_list[i + 1])
        return feat_list[0]
