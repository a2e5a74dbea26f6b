"""SECOND's sparse backbone (pcdet's ``VoxelBackBone8x``,
spconv_backbone.py:69-146) as dense convolutions, in float32: a plain
reference that shares nothing with the port's sparse-conv engine (no
sorted-key index, no neighbour table, no capacity).

- A submanifold convolution is a dense ``conv3d`` over the zero-filled
  grid (zero padding), read back at the input sites.
- A strided convolution is a dense strided ``conv3d``, kept at the output
  sites where a ``max_pool3d`` of the occupancy (the same kernel, stride
  and padding) is non-zero: spconv's output-site rule, every site kept.
- Each is computed a frame at a time, in slabs of output z that keep a
  dense grid under :data:`SLAB_ELEMENTS` (one frame's first-stage grid is
  ~5.9 GB at KITTI's size).

Sites are rows: (N, C) features and (N, 4) (b, z, y, x) coordinates of the
live sites only, in the key order ``((b * X + x) * Y + y) * Z + z``. A
kernel is a (K, Cin, Cout) leaf over the offsets (z, y, x) row-major, the
program's name and layout, so that both sides take the same weights. The
sites live on pcdet's grid, ``grid_size`` one cell deeper in z
(spconv_backbone.py:97); the BEV map stacks the output's z slices
z-major (channel ``z * C + c``, the port's order, where pcdet's
``HeightCompression`` is channel-major)."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.detector.models.model_utils.layers import (
    Dense,
    MaskedBatchNorm,
)

# a dense grid's elements (channels x z x y x x) a slab at most
SLAB_ELEMENTS = 1 << 28


@dataclass(frozen=True)
class Sites:
    features: torch.Tensor  # (N, C)
    coords: torch.Tensor    # (N, 4) int32 (b, z, y, x)
    valid: torch.Tensor     # (N,) bool, all set
    batch_size: int
    spatial_shape: Tuple[int, int, int]  # (x, y, z)

    def with_features(self, features):
        return replace(self, features=features)

    def keys(self):
        return site_keys(self.coords, self.spatial_shape)

    def bev(self):
        """(B, Y, X, Z * C), the output's z slices stacked z-major."""
        x, y, z = self.spatial_shape
        c = self.features.shape[1]
        dense = self.features.new_zeros(self.batch_size, y, x, z, c)
        i = self.coords.long()
        dense[i[:, 0], i[:, 2], i[:, 3], i[:, 1]] = self.features
        return dense.reshape(self.batch_size, y, x, z * c)


def site_keys(coords, shape):
    """int64 keys ``((b * X + x) * Y + y) * Z + z`` of (N, 4) coords."""
    x, y, z = shape
    c = coords.long()
    return ((c[:, 0] * x + c[:, 3]) * y + c[:, 2]) * z + c[:, 1]


def sites_of(features, coords, valid, batch_size, shape):
    """The live rows of a padded (features, coords, valid) as :class:`Sites`
    in key order."""
    f, c = features[valid].float(), coords[valid].to(torch.int32)
    order = torch.argsort(site_keys(c, shape))
    return Sites(f[order], c[order], torch.ones(len(c), dtype=torch.bool,
                                                device=c.device),
                 int(batch_size), tuple(int(s) for s in shape))


def out_shape(shape, kernel, stride, padding):
    return tuple((int(d) + 2 * padding[i] - kernel[i]) // stride[i] + 1
                 for i, d in enumerate(shape))


def strided_sites(coords, batch_size, shape, kernel, stride, padding):
    """(M, 4) output sites of a strided sparse conv (every site where the
    occupancy's max-pool is set), in key order, and their grid."""
    oshape = out_shape(shape, kernel, stride, padding)
    x, y, z = shape
    rev = lambda t: (t[2], t[1], t[0])  # noqa: E731  (x, y, z) -> (z, y, x)
    found = []
    c = coords.long()
    for b in range(batch_size):
        occ = torch.zeros((1, 1, z, y, x), device=coords.device)
        cb = c[c[:, 0] == b]
        occ[0, 0, cb[:, 1], cb[:, 2], cb[:, 3]] = 1.0
        hit = F.max_pool3d(occ, rev(kernel), rev(stride), rev(padding))[0, 0]
        zyx = torch.nonzero(hit > 0)
        found.append(torch.cat([torch.full_like(zyx[:, :1], b), zyx], 1))
    out = torch.cat(found).to(torch.int32)
    return out[torch.argsort(site_keys(out, oshape))], oshape


def conv_at(sites, weight, kernel, stride, padding, out_coords, oshape):
    """(M, Cout): the dense convolution of ``sites`` on the zero-filled grid
    (zero padding), read at ``out_coords`` of the output grid ``oshape``.
    ``weight``: (K, Cin, Cout) over the offsets (z, y, x) row-major."""
    (kx, ky, kz), (sx, sy, sz), (px, py, pz) = kernel, stride, padding
    x, y, _ = sites.spatial_shape
    k, cin, cout = weight.shape
    w = weight.reshape(kz, ky, kx, cin, cout).permute(4, 3, 0, 1, 2)
    feats, c = sites.features, sites.coords.long()
    oc = out_coords.long()
    out = feats.new_zeros(len(oc), cout)
    zo = oshape[2]
    per_z = max(cin, cout) * y * x * sz
    step = max(1, min(zo, SLAB_ELEMENTS // per_z))
    for b in range(sites.batch_size):
        fb, ob = c[:, 0] == b, oc[:, 0] == b
        for z0 in range(0, zo, step):
            z1 = min(zo, z0 + step)
            lo, hi = z0 * sz - pz, (z1 - 1) * sz - pz + kz  # input z [lo, hi)
            pick = fb & (c[:, 1] >= lo) & (c[:, 1] < hi)
            dense = feats.new_zeros(cin, hi - lo, y, x)
            ci = c[pick]
            dense[:, ci[:, 1] - lo, ci[:, 2], ci[:, 3]] = feats[pick].t()
            res = F.conv3d(dense[None], w, stride=(sz, sy, sx),
                           padding=(0, py, px))[0]
            take = ob & (oc[:, 1] >= z0) & (oc[:, 1] < z1)
            o = oc[take]
            out[take] = res[:, o[:, 1] - z0, o[:, 2], o[:, 3]].t()
    return out


class SparseKernel(Dense):
    """A sparse-conv kernel leaf, ``weight`` (K, Cin, Cout) as the
    program's, drawn by the benchmark's weights like a ``Dense`` (no
    bias)."""

    def __init__(self, kernel_size, in_channels, out_channels):
        super().__init__(1, 1, bias=False)
        self.kernel_size = tuple(kernel_size)
        self.weight = nn.Parameter(torch.zeros(
            math.prod(kernel_size), in_channels, out_channels))


class SubMConv(SparseKernel):
    """SubMConv3d (3^3) + BatchNorm over the sites + ReLU (where
    ``use_relu``)."""

    def __init__(self, in_channels, out_channels, use_relu=True):
        super().__init__((3, 3, 3), in_channels, out_channels)
        self.bn = MaskedBatchNorm(out_channels)
        self.use_relu = use_relu

    def forward(self, sp):
        x = conv_at(sp, self.weight, self.kernel_size, (1, 1, 1), (1, 1, 1),
                    sp.coords, sp.spatial_shape)
        x = self.bn(x, sp.valid)
        return sp.with_features(torch.relu(x) if self.use_relu else x)


class SubMStage(nn.Module):
    """Submanifold convs in a row (``subm_<i>``)."""

    def __init__(self, in_channels, channels):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"subm_{i}", SubMConv(in_channels, c))
            in_channels = c

    def forward(self, sp):
        for i in range(self.n):
            sp = getattr(self, f"subm_{i}")(sp)
        return sp


class DownConv(SparseKernel):
    """Strided SparseConv3d + BatchNorm over the new sites + ReLU."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding):
        super().__init__(kernel_size, in_channels, out_channels)
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, sp):
        geo = (self.kernel_size, self.stride, self.padding)
        oc, oshape = strided_sites(sp.coords, sp.batch_size,
                                   sp.spatial_shape, *geo)
        x = conv_at(sp, self.weight, *geo, oc, oshape)
        valid = torch.ones(len(oc), dtype=torch.bool, device=oc.device)
        x = torch.relu(self.bn(x, valid))
        return Sites(x, oc, valid, sp.batch_size, oshape)


class VoxelBackBone8x(nn.Module):
    """pcdet's ``VoxelBackBone8x`` (plain, not residual): conv_input and
    conv1 (submanifold), conv2-4 (a strided conv, then two submanifold),
    conv_out (1 x 1 x 3, stride 2 in z), under the program's names.
    ``stages`` are the (name, modules) the judge holds one at a time."""

    def __init__(self, in_channels, grid_size, num_filters=(16, 32, 64, 64),
                 out_channels=128):
        super().__init__()
        f = tuple(num_filters)
        x, y, z = (int(g) for g in grid_size)
        self.sparse_shape = (x, y, z + 1)
        self.conv_input = SubMStage(in_channels, (f[0],))
        self.conv1 = SubMStage(f[0], (f[0],))
        for i, c in enumerate(f[1:], start=2):
            pad = (1, 1, 1) if i < 4 else (1, 1, 0)
            self.add_module(f"conv{i}_down", DownConv(
                f[i - 2], c, (3, 3, 3), (2, 2, 2), pad))
            self.add_module(f"conv{i}_subm", SubMStage(c, (c, c)))
        self.conv_out = DownConv(f[3], out_channels, (1, 1, 3), (1, 1, 2),
                                 (0, 0, 0))
        shape = self.sparse_shape
        for m in (self.conv2_down, self.conv3_down, self.conv4_down,
                  self.conv_out):
            shape = out_shape(shape, m.kernel_size, m.stride, m.padding)
        self.out_spatial_shape = shape
        self.stages = (("conv1", ("conv_input", "conv1")),
                       ("conv2_subm", ("conv2_down", "conv2_subm")),
                       ("conv3_subm", ("conv3_down", "conv3_subm")),
                       ("conv4_subm", ("conv4_down", "conv4_subm")),
                       ("conv_out", ("conv_out",)))

    def stage(self, name, sp):
        for m in dict(self.stages)[name]:
            sp = getattr(self, m)(sp)
        return sp

    def forward(self, sp):
        for name, _ in self.stages:
            sp = self.stage(name, sp)
        return sp
