"""UNetV2 sparse-conv UNet (torch counterpart of
``mssvt_tpu/models/backbones_3d/spconv_unet.py``; ref:
pcdet/models/backbones_3d/spconv_unet.py:49-212).

The encoder is ``VoxelBackBone8x``'s stage stack (and its ``conv_out`` for
the BEV path); the decoder walks back up through the encoder's own site
sets. Per level (the reference's ``UR_block_forward``): a submanifold conv
of the lateral skip, concatenated with the bottom features, a merging
submanifold conv plus the concatenation's channel reduction, then the
inverse conv onto the finer level's sites (LayerNorm, ReLU).

The inverse conv reads the coarse features through the inverse table
(``build_inverse_neighbor_table``) with :func:`ops.sparse_conv.sparse_conv`,
whose backward gathers over the transposed table: the strided neighbour
table of that level's down layer (coarse site c reads fine site
``c * s - p + k`` through offset k exactly when that fine site reads c
through k), so no coarse row collects the absent pairs.

Returns (the stride-8 ``SparseVoxels`` after ``conv_out``, the stride-1
``SparseVoxels`` with ``num_filters[0]`` point features).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ...ops.sparse_conv import (
    build_inverse_neighbor_table,
    build_strided_neighbor_table,
    build_subm_neighbor_table,
    sparse_conv,
)
from ..model_utils.layers import Dense, LayerNorm
from .spconv_backbone import (
    CAPACITY_FRACTIONS,
    SparseConvDownLayer,
    SubMConvLayer,
    _SubMStage,
    on_grid,
)


class UNetV2(nn.Module):
    def __init__(self, in_channels: int, input_capacity: int,
                 grid_size: Sequence[int],
                 num_filters: Sequence[int] = (16, 32, 64, 64),
                 out_channels: int = 128, dtype=torch.float32):
        super().__init__()
        caps = [max(int(input_capacity * f), 64) for f in CAPACITY_FRACTIONS]
        f = tuple(num_filters)
        self.compute_dtype = dtype
        self.conv_input = _SubMStage(in_channels, (f[0],), dtype=dtype)
        self.conv1 = _SubMStage(f[0], (f[0],), dtype=dtype)
        shape = self.sparse_shape = tuple(int(g) for g in grid_size)
        self.geometry = []  # (kernel, stride, padding) a down level
        c_in = f[0]
        for i, (c, cap) in enumerate(zip(f[1:], caps[1:4]), start=2):
            pad = (1, 1, 1) if i < 4 else (1, 1, 0)
            down = SparseConvDownLayer(c_in, c, stride=(2, 2, 2), padding=pad,
                                       max_out=cap, dtype=dtype)
            shape = down.out_shape(shape)
            self.add_module(f"conv{i}_down", down)
            self.add_module(f"conv{i}_subm", _SubMStage(c, (c, c),
                                                        dtype=dtype))
            self.geometry.append(((3, 3, 3), (2, 2, 2), pad))
            c_in = c
        self.conv_out = SparseConvDownLayer(
            c_in, out_channels, kernel_size=(1, 1, 3), stride=(1, 1, 2),
            padding=(0, 0, 0), max_out=caps[4], dtype=dtype)
        # the width of the BEV map of the encoded output (z-major D*C)
        self.num_bev_features = self.conv_out.out_shape(shape)[2] * out_channels
        widths = [f[0]] + list(f[1:])  # stage 0 (conv1) .. 3 (conv4)
        for lvl in range(len(widths) - 1, 0, -1):
            c_here, c_out = widths[lvl], widths[lvl - 1]
            self.add_module(f"up{lvl}_t", SubMConvLayer(c_here, c_here,
                                                        dtype=dtype))
            self.add_module(f"up{lvl}_m", SubMConvLayer(2 * c_here, c_here,
                                                        dtype=dtype))
            k = int(np.prod(self.geometry[lvl - 1][0]))
            self.register_parameter(f"up{lvl}_inv_kernel", nn.Parameter(
                torch.zeros(k, c_here, c_out)))
            self.add_module(f"up{lvl}_ln", LayerNorm(c_out, dtype=dtype))
        self.levels = len(widths) - 1
        self.conv5_out = Dense(f[0], f[0], dtype=dtype)

    def flax_init(self, generator):
        """The inverse kernels as flax draws them (``variance_scaling(1,
        fan_in)`` over (K, Cin, Cout): fan_in K * Cin), LeCun normal here
        like the sparse-conv kernels."""
        with torch.no_grad():
            for lvl in range(1, self.levels + 1):
                w = getattr(self, f"up{lvl}_inv_kernel")
                w.copy_(torch.randn(w.shape, generator=generator)
                        / np.sqrt(w.shape[0] * w.shape[1]))

    def forward(self, sp: SparseVoxels, generator=None):
        # the backbone that reads the index builds it, on its own grid
        sp = self.conv1(self.conv_input(on_grid(sp, self.sparse_shape)))
        stages = [sp]
        for i in range(2, 2 + self.levels):
            sp = getattr(self, f"conv{i}_subm")(
                getattr(self, f"conv{i}_down")(sp))
            stages.append(sp)
        encoded = self.conv_out(sp)

        dt = self.compute_dtype
        x = stages[-1]
        for lvl in range(self.levels, 0, -1):
            lateral, finer = stages[lvl], stages[lvl - 1]
            c_here = lateral.features.shape[-1]
            rows = build_subm_neighbor_table(lateral.coords, lateral.valid,
                                             lateral.index,
                                             lateral.spatial_shape)
            x_trans = getattr(self, f"up{lvl}_t")(lateral, rows).features
            cat = torch.cat([x.features, x_trans], dim=-1)
            x_m = getattr(self, f"up{lvl}_m")(lateral.with_features(cat),
                                              rows).features
            # the reference's channel_reduction (view + sum) as a residual
            red = cat.reshape(cat.shape[0], c_here, -1).sum(-1)
            merged = x_m + red
            geo = self.geometry[lvl - 1]
            inv_rows = build_inverse_neighbor_table(
                finer.coords, finer.valid, lateral.index,
                lateral.spatial_shape, *geo)
            up = sparse_conv(
                merged.to(dt), inv_rows,
                getattr(self, f"up{lvl}_inv_kernel").to(dt),
                lambda f=finer, c=lateral, g=geo: build_strided_neighbor_table(
                    f.coords, f.valid, f.index, f.spatial_shape, c.coords,
                    c.valid, *g)).to(dt)
            up = torch.relu(getattr(self, f"up{lvl}_ln")(up)) \
                * finer.valid[:, None]
            x = finer.with_features(up)
        point_features = self.conv5_out(x.features).float() * x.valid[:, None]
        return encoded, x.with_features(point_features)
