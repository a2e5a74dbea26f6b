"""Per-family module registries (torch counterpart of
``mssvt_tpu/models/builders.py``), holding every name of the JAX package's
registries: the MsSVT CenterPoint path (MeanVFE -> MixedScaleSparseTransformer
-> HeightCompression -> BaseBEVBackbone -> CenterHead), the SECOND and
PointPillar families (the Pillar/Hard/Dynamic VFEs, the sparse-conv
backbones, PointPillarScatter, AnchorHeadSingle), AnchorHeadMulti, the
two-stage voxel family's UNetV2, PointRCNN's PointNet2MSG and CaDDN's
Conv2DCollapse (the PFE, the RoI and point heads and CaDDN's ImageVFE are
built by their detectors, as in the JAX package). Any other name raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

from .backbones_2d.base_bev_backbone import BaseBEVBackbone
from .backbones_2d.map_to_bev import (
    Conv2DCollapse,
    HeightCompression,
    PointPillarScatter,
)
from .backbones_3d.mssvt import MixedScaleSparseTransformer
from .backbones_3d.pointnet2_backbone import PointNet2MSG
from .backbones_3d.spconv_backbone import VoxelBackBone8x, VoxelResBackBone8x
from .backbones_3d.spconv_unet import UNetV2
from .backbones_3d.vfe import DynamicVFE, HardVFE, MeanVFE, PillarVFE
from .dense_heads.anchor_head import AnchorHeadSingle
from .dense_heads.anchor_head_multi import AnchorHeadMulti
from .dense_heads.center_head import CenterHead


@dataclass(frozen=True)
class BuildCtx:
    num_class: int
    class_names: Sequence[str]
    grid_size: Sequence[int]
    voxel_size: Sequence[float]
    point_cloud_range: Sequence[float]
    batch_size: int
    max_voxels: int
    max_points_per_voxel: int
    num_point_features: int = 5
    dtype: Any = torch.float32


def build_ctx(num_class, class_names, grid_size, voxel_size,
              point_cloud_range, batch_size, max_voxels, max_points_per_voxel,
              num_point_features, dtype) -> BuildCtx:
    """A detector's constructor arguments as the builders' context."""
    return BuildCtx(int(num_class), tuple(class_names),
                    tuple(int(g) for g in grid_size),
                    tuple(float(v) for v in voxel_size),
                    tuple(float(v) for v in point_cloud_range),
                    int(batch_size), int(max_voxels),
                    int(max_points_per_voxel), int(num_point_features), dtype)


def _lookup(registry, family, cfg):
    name = cfg["NAME"]
    if name not in registry:
        raise NotImplementedError(
            f"unknown {family} '{name}' (known: {', '.join(sorted(registry))})")
    return registry[name]


def _pillar_kwargs(cfg, ctx):
    return dict(
        num_point_features=ctx.num_point_features,
        num_filters=tuple(cfg.get("NUM_FILTERS", [64])),
        voxel_size=tuple(ctx.voxel_size),
        point_cloud_range=tuple(ctx.point_cloud_range),
        use_norm=bool(cfg.get("USE_NORM", True)))


VFE = {
    "MeanVFE": lambda cfg, ctx: MeanVFE(),
    "PillarVFE": lambda cfg, ctx: PillarVFE(
        use_absolute_xyz=bool(cfg.get("USE_ABSLOTE_XYZ",
                                      cfg.get("USE_ABSOLUTE_XYZ", True))),
        with_distance=bool(cfg.get("WITH_DISTANCE", False)),
        **_pillar_kwargs(cfg, ctx)),
    "HardVFE": lambda cfg, ctx: HardVFE(
        with_cluster_center=bool(cfg.get("WITH_CLUSTER_CENTER", True)),
        with_voxel_center=bool(cfg.get("WITH_VOXEL_CENTER", True)),
        with_distance=bool(cfg.get("WITH_DISTANCE", False)),
        **_pillar_kwargs(cfg, ctx)),
}
VFE["DynVFE"] = VFE["DynamicVFE"] = lambda cfg, ctx: DynamicVFE(
    num_voxels=ctx.max_voxels * ctx.batch_size, **_pillar_kwargs(cfg, ctx))


def _spconv8x(cls):
    """The sparse-conv backbone on the MeanVFE's point features, with the
    JAX builder's input capacity ``max_voxels * batch_size``; with
    ``PCDET_SPARSE_SHAPE`` its sites on pcdet's grid, one cell deeper in z
    (the JAX builder's grid without it)."""
    return lambda cfg, ctx: cls(
        in_channels=ctx.num_point_features,
        input_capacity=ctx.max_voxels * ctx.batch_size,
        grid_size=tuple(ctx.grid_size),
        num_filters=tuple(cfg.get("NUM_FILTERS", [16, 32, 64, 64])),
        out_channels=int(cfg.get("OUT_CHANNELS", 128)),
        return_stages=bool(cfg.get("RETURN_STAGES", False)),
        pcdet_sparse_shape=bool(cfg.get("PCDET_SPARSE_SHAPE", False)),
        dtype=ctx.dtype)


BACKBONE_3D = {
    "MixedScaleSparseTransformer": lambda cfg, ctx: MixedScaleSparseTransformer(
        params_cfg=[dict(p) for p in cfg["PARAMS"]],
        in_features=ctx.num_point_features, dtype=ctx.dtype),
    "VoxelBackBone8x": _spconv8x(VoxelBackBone8x),
    "VoxelResBackBone8x": _spconv8x(VoxelResBackBone8x),
    "UNetV2": lambda cfg, ctx: UNetV2(
        in_channels=ctx.num_point_features,
        input_capacity=ctx.max_voxels * ctx.batch_size,
        grid_size=tuple(ctx.grid_size),
        num_filters=tuple(cfg.get("NUM_FILTERS", [16, 32, 64, 64])),
        out_channels=int(cfg.get("OUT_CHANNELS", 128)), dtype=ctx.dtype),
}
# the raw points' features past xyz feed the first set abstraction
BACKBONE_3D["PointNet2MSG"] = BACKBONE_3D["PointNet2Backbone"] = \
    lambda cfg, ctx: PointNet2MSG(
        model_cfg=cfg, input_channels=ctx.num_point_features - 3,
        dtype=ctx.dtype)

MAP_TO_BEV = {
    "HeightCompression": lambda cfg, ctx, c_in: HeightCompression(
        num_bev_features=int(cfg["NUM_BEV_FEATURES"]),
        compress_layer_nums=int(cfg.get("COMPRESS_LAYER_NUMS", 0) or 0),
        layer_strides=tuple(cfg.get("LAYER_STRIDES", [1, 1, 1])),
        layer_dilations=tuple(cfg.get("LAYER_DIALATIONS", [1, 1, 2])),
        layer_paddings=tuple(cfg.get("LAYER_PADDINGS", [1, 2, 2])),
        dtype=ctx.dtype),
    "PointPillarScatter": lambda cfg, ctx, c_in: PointPillarScatter(
        num_bev_features=int(cfg["NUM_BEV_FEATURES"]),
        grid_size=tuple(ctx.grid_size)),
    # the camera grid's Z * C stacked channels (flax infers them)
    "Conv2DCollapse": lambda cfg, ctx, c_in: Conv2DCollapse(
        c_in, int(cfg["NUM_BEV_FEATURES"]), dtype=ctx.dtype),
}

BACKBONE_2D = {
    "BaseBEVBackbone": lambda cfg, ctx, c_in: BaseBEVBackbone(
        in_channels=c_in, layer_nums=tuple(cfg["LAYER_NUMS"]),
        layer_strides=tuple(cfg["LAYER_STRIDES"]),
        num_filters=tuple(cfg["NUM_FILTERS"]),
        upsample_strides=tuple(cfg.get("UPSAMPLE_STRIDES", [])),
        num_upsample_filters=tuple(cfg.get("NUM_UPSAMPLE_FILTERS", [])),
        dtype=ctx.dtype),
}

DENSE_HEAD = {
    "CenterHead": lambda cfg, ctx, c_in: CenterHead(
        model_cfg=cfg, input_channels=c_in, num_class=ctx.num_class,
        class_names=tuple(ctx.class_names), grid_size=tuple(ctx.grid_size),
        point_cloud_range=tuple(ctx.point_cloud_range),
        voxel_size=tuple(ctx.voxel_size), dtype=ctx.dtype),
    "AnchorHeadSingle": lambda cfg, ctx, c_in: AnchorHeadSingle(
        model_cfg=cfg, input_channels=c_in, num_class=ctx.num_class,
        class_names=tuple(ctx.class_names), grid_size=tuple(ctx.grid_size),
        point_cloud_range=tuple(ctx.point_cloud_range), dtype=ctx.dtype),
    "AnchorHeadMulti": lambda cfg, ctx, c_in: AnchorHeadMulti(
        model_cfg=cfg, input_channels=c_in, num_class=ctx.num_class,
        class_names=tuple(ctx.class_names), grid_size=tuple(ctx.grid_size),
        point_cloud_range=tuple(ctx.point_cloud_range), dtype=ctx.dtype),
}


def build_vfe(cfg, ctx):
    return _lookup(VFE, "VFE", cfg)(cfg, ctx)


def build_backbone_3d(cfg, ctx):
    return _lookup(BACKBONE_3D, "BACKBONE_3D", cfg)(cfg, ctx)


def build_map_to_bev(cfg, ctx, input_channels=None):
    """``input_channels``: the input's channels where the module has
    weights over them (``Conv2DCollapse``)."""
    return _lookup(MAP_TO_BEV, "MAP_TO_BEV", cfg)(cfg, ctx, input_channels)


def build_backbone_2d(cfg, ctx, input_channels: int):
    return _lookup(BACKBONE_2D, "BACKBONE_2D", cfg)(cfg, ctx, input_channels)


def build_dense_head(cfg, ctx, input_channels: int):
    return _lookup(DENSE_HEAD, "DENSE_HEAD", cfg)(cfg, ctx, input_channels)
