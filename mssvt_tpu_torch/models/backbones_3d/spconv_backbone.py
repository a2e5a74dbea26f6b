"""Sparse CNN backbones (torch counterpart of
``mssvt_tpu/models/backbones_3d/spconv_backbone.py``; ref:
pcdet/models/backbones_3d/spconv_backbone.py:69-284).

``VoxelBackBone8x`` / ``VoxelResBackBone8x``: SECOND's 4-stage 8x sparse
CNN on the port's sparse-conv engine (``ops/sparse_conv.py``). Stage
capacities are static: each downsampling layer keeps
``max(int(input_capacity * f), 64)`` output sites, ``f`` from
:data:`CAPACITY_FRACTIONS`. The input width of every layer is fixed at
construction (flax infers it): ``in_channels`` is the VFE's output width.

The sites live on ``grid_size`` as given, as the JAX module's do; with
``pcdet_sparse_shape`` on pcdet's ``grid_size[::-1] + [1, 0, 0]``
(spconv_backbone.py:97), one cell deeper in z, which at KITTI's 40 cells
gives z 41 -> 21 -> 11 -> 5 -> 2 and a 2 x 128-channel BEV map.

The tables depend on the sites alone, never on the features, so a forward
builds them all up front (:meth:`_Encoder8x.rules`, one span
``mssvt.spconv_rules``: the input's index on the grid, each submanifold
stage's neighbour table, each strided layer's output sites, table and
index; spconv's indice keys), then runs the layers on them
(:meth:`_Encoder8x.layers`). At inference on the card (eval, no autograd,
no generator) each half replays a CUDA graph of itself
(``runtime/graphs.ForwardGraph``, span ``mssvt.spconv_graph``): the rules
inside ``mssvt.spconv_rules``, then the convolutions reading the rules'
static tables in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ...ops.sparse_conv import (
    build_inverse_neighbor_table,
    build_strided_neighbor_table,
    build_subm_neighbor_table,
    downsample_output_sites,
    sparse_conv,
)
from ...runtime import graphs, tracing
from ..model_utils.layers import MaskedBatchNorm

# each stage's output sites as a fraction of the input capacity: conv_input
# and conv1, conv2-4's strided layers, conv_out
CAPACITY_FRACTIONS = (1.0, 0.8, 0.6, 0.4, 0.3)
# (kernel, stride, padding), each (x, y, z), of conv2-4's strided layers and
# conv_out; ref conv4 zero-pads z only
DOWN_LAYERS = (((3, 3, 3), (2, 2, 2), (1, 1, 1)),
               ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
               ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
               ((1, 1, 3), (1, 1, 2), (0, 0, 0)))
# the 8x encoder's layers in their order: submanifold stages (``_SubMStage``)
# and strided layers (``SparseConvDownLayer``)
ENCODER = ("conv_input", "conv1", "conv2_down", "conv2_subm", "conv3_down",
           "conv3_subm", "conv4_down", "conv4_subm", "conv_out")
# the layers that end a stage: their outputs are ``VoxelBackBone8x``'s
# stages and output, and plain forward hooks on them survive a replay
STAGE_ENDS = ("conv1", "conv2_subm", "conv3_subm", "conv4_subm", "conv_out")


def down_shape(spatial_shape, kernel_size, stride, padding):
    """The output grid of a strided sparse conv over ``spatial_shape``."""
    return tuple((int(d) + 2 * padding[i] - kernel_size[i]) // stride[i] + 1
                 for i, d in enumerate(spatial_shape))


def sparse_shape_8x(grid_size, pcdet_sparse_shape: bool = False):
    """The grid the 8x backbones' input sites live on: ``grid_size``, or
    with ``pcdet_sparse_shape`` pcdet's, one cell deeper in z."""
    x, y, z = (int(g) for g in grid_size)
    return (x, y, z + 1) if pcdet_sparse_shape else (x, y, z)


def out_spatial_shape_8x(grid_size, pcdet_sparse_shape: bool = False):
    """The 8x backbones' output grid (no module built)."""
    shape = sparse_shape_8x(grid_size, pcdet_sparse_shape)
    for geo in DOWN_LAYERS:
        shape = down_shape(shape, *geo)
    return shape


class SparseConvKernel(nn.Module):
    """A (K, Cin, Cout) sparse-conv kernel (flax's ``kernel`` leaf, same
    layout) computing in ``dtype``."""

    def __init__(self, kernel_size, in_channels, out_channels,
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        k = int(np.prod(kernel_size))
        self.weight = nn.Parameter(torch.zeros(k, in_channels, out_channels))
        self.compute_dtype = dtype

    def conv(self, features, rows, rows_t_fn):
        dt = self.compute_dtype
        return sparse_conv(features.to(dt), rows, self.weight.to(dt),
                           rows_t_fn)


class SubMConvLayer(SparseConvKernel):
    """SubMConv3d + masked BN + ReLU, on a shared neighbour table."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3),
                 use_relu=True, use_norm=True, dtype=torch.float32):
        super().__init__(kernel_size, in_channels, out_channels, dtype)
        self.use_relu = use_relu
        if use_norm:
            self.bn = MaskedBatchNorm(out_channels)
        self.use_norm = use_norm

    def forward(self, sp: SparseVoxels, rows) -> SparseVoxels:
        # the transposed table of a centred odd kernel: row i reads j
        # through offset k exactly when j reads i through offset K-1-k
        x = self.conv(sp.features, rows, lambda: rows.flip(1))
        if self.use_norm:
            x = self.bn(x, sp.valid)
        if self.use_relu:
            x = torch.relu(x)
        return sp.with_features(x * sp.valid[:, None])


class SparseConvDownLayer(SparseConvKernel):
    """Strided SparseConv3d + masked BN + ReLU onto a new site set of
    ``max_out`` rows."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1), max_out: int = 0,
                 dtype=torch.float32):
        super().__init__(kernel_size, in_channels, out_channels, dtype)
        if max_out <= 0:
            raise ValueError("SparseConvDownLayer needs max_out > 0")
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.max_out = max_out
        self.bn = MaskedBatchNorm(out_channels)

    def out_shape(self, spatial_shape) -> Tuple[int, int, int]:
        return down_shape(spatial_shape, self.kernel_size, self.stride,
                          self.padding)

    def rules(self, sp: SparseVoxels):
        """(the output sites, indexed and without features; the (V_out, K)
        neighbour rows into ``sp``'s rows)."""
        geo = (self.kernel_size, self.stride, self.padding)
        out_coords, out_valid, out_shape = downsample_output_sites(
            sp.coords, sp.valid, sp.spatial_shape, *geo, self.max_out)
        rows = build_strided_neighbor_table(
            sp.coords, sp.valid, sp.index, sp.spatial_shape, out_coords,
            out_valid, *geo)
        out = SparseVoxels.create(
            features=None, coords=out_coords, valid=out_valid,
            batch_size=sp.batch_size, spatial_shape=out_shape,
            voxel_size=tuple(sp.voxel_size[i] * self.stride[i]
                             for i in range(3)),
            point_cloud_range=sp.point_cloud_range)
        return out, rows

    def forward(self, sp: SparseVoxels, rule) -> SparseVoxels:
        """``rule``: :meth:`rules` of ``sp``."""
        out, rows = rule
        geo = (self.kernel_size, self.stride, self.padding)
        x = self.conv(sp.features, rows, lambda: build_inverse_neighbor_table(
            sp.coords, sp.valid, out.index, out.spatial_shape, *geo))
        x = torch.relu(self.bn(x, out.valid)) * out.valid[:, None]
        return out.with_features(x)


class _SubMStage(nn.Module):
    """Submanifold convs sharing one neighbour table; ``residual`` pairs
    them into SparseBasicBlocks (ref: spconv_backbone.py:10-66)."""

    def __init__(self, in_channels, channels: Sequence[int],
                 residual=False, dtype=torch.float32):
        super().__init__()
        self.residual = residual
        self.n = len(channels)
        c_in = in_channels
        if not residual:
            for i, c in enumerate(channels):
                self.add_module(f"subm_{i}", SubMConvLayer(c_in, c,
                                                           dtype=dtype))
                c_in = c
            return
        for i in range(0, len(channels), 2):
            c = channels[i]
            self.add_module(f"res{i}_a", SubMConvLayer(c_in, c, dtype=dtype))
            self.add_module(f"res{i}_b", SubMConvLayer(c, c, use_relu=False,
                                                       dtype=dtype))
            c_in = c

    @staticmethod
    def rules(sp: SparseVoxels):
        """The stage's (V, K) neighbour rows on ``sp``'s sites."""
        return build_subm_neighbor_table(sp.coords, sp.valid, sp.index,
                                         sp.spatial_shape)

    def forward(self, sp: SparseVoxels, rows) -> SparseVoxels:
        """``rows``: :meth:`rules` of ``sp``."""
        if not self.residual:
            for i in range(self.n):
                sp = getattr(self, f"subm_{i}")(sp, rows)
            return sp
        for i in range(0, self.n, 2):
            identity = sp.features
            sp = getattr(self, f"res{i}_a")(sp, rows)
            sp = getattr(self, f"res{i}_b")(sp, rows)
            sp = sp.with_features(torch.relu(sp.features + identity)
                                  * sp.valid[:, None])
        return sp


@dataclass(frozen=True)
class Rulebook:
    """Every table of one forward of the 8x encoder, built from the input's
    sites alone: ``sites``, those sites on the encoder's grid with their
    sorted-key index (no features); ``tables[name]``, the table of the
    layer ``name`` of :data:`ENCODER` (``rules`` of that layer on its input's
    sites)."""

    sites: SparseVoxels
    tables: Dict[str, object]


class _Encoder8x(nn.Module):
    """The :data:`ENCODER` stack's forward over a :class:`Rulebook`, for a
    module holding those layers and ``sparse_shape``."""

    def rules(self, sp: SparseVoxels) -> Rulebook:
        """The rulebook of ``sp``'s sites, in the span
        ``mssvt.spconv_rules``. The sites take an index on
        ``sparse_shape`` where theirs is missing or on another grid: the
        sparse-conv backbone that reads the index builds it."""
        with tracing.span("spconv_rules"):
            if sp.index is not None and \
                    tuple(sp.spatial_shape) == tuple(self.sparse_shape):
                sites = sp.with_features(None)
            else:
                sites = SparseVoxels.create(
                    None, sp.coords, sp.valid, sp.batch_size,
                    self.sparse_shape, sp.voxel_size, sp.point_cloud_range)
            tables, cur = {}, sites
            for name in ENCODER:
                layer = getattr(self, name)
                tables[name] = layer.rules(cur)
                if isinstance(layer, SparseConvDownLayer):
                    cur = tables[name][0]
        return Rulebook(sites, tables)

    def layers(self, sp: SparseVoxels, rules: Rulebook, hooks=True):
        """The output of each :data:`ENCODER` layer on ``sp``'s features,
        in order. With ``hooks`` False the layers' ``forward`` runs without
        their hooks (a capture: its tensors hold nothing until a
        replay)."""
        x, outs = rules.sites.with_features(sp.features), []
        for name in ENCODER:
            layer = getattr(self, name)
            x = (layer if hooks else layer.forward)(x, rules.tables[name])
            outs.append(x)
        return outs


class VoxelBackBone8x(_Encoder8x):
    """Ref: spconv_backbone.py:69-146. Returns the stride-8 SparseVoxels
    after ``conv_out``'s z compression (and, with ``return_stages``, the
    ``x_conv1``..``x_conv4`` stages). The input's sites are taken onto
    ``sparse_shape`` (re-indexed where its grid or index differs).

    Where :func:`runtime.graphs.graphable` allows (plain forward hooks on
    the :data:`STAGE_ENDS` layers only), the forward replays two CUDA
    graphs, the rules' and the layers', and returns clones; hooks on
    those layers then run on clones of each one's input and output, with
    the replay's own table, which the next replay overwrites."""

    def __init__(self, in_channels: int, input_capacity: int,
                 grid_size: Sequence[int],
                 num_filters: Sequence[int] = (16, 32, 64, 64),
                 out_channels: int = 128, residual: bool = False,
                 return_stages: bool = False,
                 pcdet_sparse_shape: bool = False, dtype=torch.float32):
        super().__init__()
        self.return_stages = return_stages
        caps = [max(int(input_capacity * f), 64) for f in CAPACITY_FRACTIONS]
        f = tuple(num_filters)
        self.conv_input = _SubMStage(in_channels, (f[0],), dtype=dtype)
        self.conv1 = _SubMStage(f[0], (f[0],) * (2 if residual else 1),
                                residual=residual, dtype=dtype)
        self.sparse_shape = sparse_shape_8x(grid_size, pcdet_sparse_shape)
        c_in = f[0]
        # the width of each returned stage (the VoxelRCNN head's inputs)
        self.stage_channels = {f"x_conv{i + 1}": c for i, c in enumerate(f)}
        for i, (c, cap, geo) in enumerate(zip(f[1:], caps[1:4], DOWN_LAYERS),
                                          start=2):
            self.add_module(f"conv{i}_down", SparseConvDownLayer(
                c_in, c, *geo, max_out=cap, dtype=dtype))
            self.add_module(f"conv{i}_subm", _SubMStage(
                c, (c, c), residual=residual, dtype=dtype))
            c_in = c
        self.conv_out = SparseConvDownLayer(
            c_in, out_channels, *DOWN_LAYERS[3], max_out=caps[4],
            dtype=dtype)
        self.out_spatial_shape = out_spatial_shape_8x(grid_size,
                                                      pcdet_sparse_shape)
        # the width of the BEV map of the output (z-major D*C channels)
        self.num_bev_features = self.out_spatial_shape[2] * out_channels
        self.graph = graphs.ForwardGraph("spconv_graph",
                                         "sparse-conv backbone")

    def train(self, mode: bool = True):
        if mode:  # training never replays: free the graphs' memory
            self.graph.clear()
        return super().train(mode)

    def forward(self, sp: SparseVoxels, generator=None):
        if not self._graphed(sp, generator):
            return self._result(dict(zip(ENCODER,
                                         self.layers(sp, self.rules(sp)))))
        hooked = [n for n in STAGE_ENDS if getattr(self, n)._forward_hooks]
        names = (ENCODER if hooked else
                 STAGE_ENDS if self.return_stages else ENCODER[-1:])
        outs, statics = self.graph.run(
            self, sp, (("spconv_rules", lambda s, _: self.rules(s)),
                       (None, lambda s, r: self.layers(s, r, hooks=False))),
            lambda s: self.layers(s, self.rules(s)),
            lambda outs: [o for n, o in zip(ENCODER, outs) if n in names])
        got = dict(zip(names, outs))
        if statics is not None and hooked:
            tables = statics[0].tables
            graphs.run_forward_hooks(
                (getattr(self, n), (got[ENCODER[ENCODER.index(n) - 1]],
                                    tables[n]), got[n]) for n in hooked)
        return self._result(got)

    def _graphed(self, sp, generator) -> bool:
        """Whether the call takes the CUDA graphs
        (``runtime/graphs.graphable``); plain forward hooks on the
        :data:`STAGE_ENDS` layers run after a replay."""
        return graphs.graphable(self, sp, generator,
                                [getattr(self, n) for n in STAGE_ENDS])

    def _result(self, got):
        out = got["conv_out"]
        if not self.return_stages:
            return out
        return out, {f"x_conv{i + 1}": got[n]
                     for i, n in enumerate(STAGE_ENDS[:4])}


class VoxelResBackBone8x(VoxelBackBone8x):
    """Residual variant: SparseBasicBlock pairs in place of plain subm
    convs."""

    def __init__(self, *args, **kw):
        kw["residual"] = True
        super().__init__(*args, **kw)
