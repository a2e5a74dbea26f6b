"""Builders of the benchmarked detector's stages from its config (frozen
copy of the port's ``models/builders.py``, cut to MeanVFE, the MsSVT
backbone, HeightCompression, BaseBEVBackbone and CenterHead)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

from .backbones_2d.base_bev_backbone import BaseBEVBackbone
from .backbones_2d.map_to_bev import HeightCompression
from .backbones_3d.mssvt import MixedScaleSparseTransformer
from .backbones_3d.vfe import MeanVFE
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


VFE = {"MeanVFE": lambda cfg, ctx: MeanVFE()}


BACKBONE_3D = {
    "MixedScaleSparseTransformer": lambda cfg, ctx: MixedScaleSparseTransformer(
        params_cfg=[dict(p) for p in cfg["PARAMS"]],
        in_features=ctx.num_point_features, dtype=ctx.dtype),
}

MAP_TO_BEV = {
    "HeightCompression": lambda cfg, ctx, c_in: HeightCompression(
        num_bev_features=int(cfg["NUM_BEV_FEATURES"]),
        compress_layer_nums=int(cfg.get("COMPRESS_LAYER_NUMS", 0) or 0),
        layer_strides=tuple(cfg.get("LAYER_STRIDES", [1, 1, 1])),
        layer_dilations=tuple(cfg.get("LAYER_DIALATIONS", [1, 1, 2])),
        layer_paddings=tuple(cfg.get("LAYER_PADDINGS", [1, 2, 2])),
        dtype=ctx.dtype),
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
