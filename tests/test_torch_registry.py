"""Every name of the JAX package's registries builds in the port: the
detectors (from the shipped yaml of each, SECONDNetIoU from ``second.yaml``
with chip_smoke's BEV-grid RoI head, the ``SECOND`` alias from
``second.yaml`` renamed), ``VFE``, ``MAP_TO_BEV`` and ``DENSE_HEAD``. The
names are read from ``mssvt_tpu``, never from the port; the models are
built on the CPU at the yamls' widths and not run. Each detector is built
on the port's shell and registers its first stage first."""

from pathlib import Path

import pytest
import torch
import yaml

from mssvt_tpu.models import builders as j_builders
from mssvt_tpu.models import detectors as j_detectors
from mssvt_tpu_torch.config import cfg_from_yaml_file
from mssvt_tpu_torch.models import build_network
from mssvt_tpu_torch.models import builders as t_builders
from mssvt_tpu_torch.models.detectors import __all__ as t_detectors
from mssvt_tpu_torch.models.detectors.detector3d_template import (
    Detector3DTemplate,
)
from mssvt_tpu_torch.utils.edict import EasyDict
from test_model_forward import tiny_model_cfg
from test_second_pointpillar import anchor_head_cfg
from test_torch_anchor_multi import multi_head_cfg

ROOT = Path(__file__).resolve().parent.parent
FIRST_STAGE = ("vfe", "backbone_3d", "map_to_bev", "backbone_2d", "dense_head")
YAMLS = sorted((ROOT / "tools" / "cfgs").glob("*_models/*.yaml"))


def _model_names():
    return {yaml.safe_load(p.read_text())["MODEL"]["NAME"]: p for p in YAMLS}


def _build_kw(path):
    """The yaml's config and ``build_network``'s arguments (grid from its
    range and voxel size, its train voxel cap, batch 1)."""
    cfg = cfg_from_yaml_file(str(path), EasyDict())
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vox = [p for p in dc.DATA_PROCESSOR
           if p.NAME == "transform_points_to_voxels"][0]
    vs = tuple(vox.VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    cap = vox.MAX_NUMBER_OF_VOXELS
    return cfg, dict(num_class=len(cfg.CLASS_NAMES),
                     class_names=cfg.CLASS_NAMES, grid_size=grid,
                     voxel_size=vs, point_cloud_range=pcr, batch_size=1,
                     max_voxels=cap["train"] if isinstance(cap, dict) else cap,
                     max_points_per_voxel=vox.MAX_POINTS_PER_VOXEL,
                     num_point_features=len(
                         dc.POINT_FEATURE_ENCODING.used_feature_list))


@pytest.mark.parametrize("name", sorted(j_detectors.__all__))
def test_every_jax_detector_builds_in_the_port(name):
    import chip_smoke

    names = _model_names()
    if name == "SECONDNetIoU":
        path = names["SECONDNet"]
        model_cfg = chip_smoke.two_stage_cfg("second_iou").MODEL
    else:
        path = names["SECONDNet" if name == "SECOND" else name]
        model_cfg = None
    cfg, kw = _build_kw(path)
    model_cfg = model_cfg or cfg.MODEL
    model_cfg.NAME = name
    model = build_network(model_cfg, **kw, device="cpu")
    assert type(model) is t_detectors[name]
    assert isinstance(model, Detector3DTemplate)
    assert type(model).__name__ == j_detectors.__all__[name].__name__
    assert not model.training and sum(p.numel() for p in model.parameters())
    # the shell registers the first stage first, in this order (the seeded
    # weights draw in named_modules() order)
    top = [n for n, _ in model.named_children()]
    first = [n for n in FIRST_STAGE if n in top]
    assert first and top[:len(first)] == first


def _ctx(grid=(16, 16, 4)):
    return t_builders.BuildCtx(2, ("Car", "Pedestrian"), grid, (0.8, 0.8, 1.0),
                               (0.0, -6.4, -2.0, 12.8, 6.4, 2.0), 1, 64, 5, 4)


@pytest.mark.parametrize("name", sorted(j_builders.VFE))
def test_every_jax_vfe_builds_in_the_port(name):
    vfe = t_builders.build_vfe({"NAME": name, "NUM_FILTERS": [16]}, _ctx())
    assert isinstance(vfe, torch.nn.Module)


@pytest.mark.parametrize("name", sorted(j_builders.MAP_TO_BEV))
def test_every_jax_map_to_bev_builds_in_the_port(name):
    grid = (16, 16, 1) if name == "PointPillarScatter" else (16, 16, 4)
    m = t_builders.build_map_to_bev({"NAME": name, "NUM_BEV_FEATURES": 16},
                                    _ctx(grid), input_channels=4 * 8)
    assert m.num_bev_features == 16


@pytest.mark.parametrize("name", sorted(j_builders.DENSE_HEAD))
def test_every_jax_dense_head_builds_in_the_port(name):
    cfg = {"CenterHead": tiny_model_cfg()["DENSE_HEAD"],
           "AnchorHeadSingle": anchor_head_cfg(),
           "AnchorHeadMulti": multi_head_cfg(stride=2)}[name]
    head = t_builders.build_dense_head(dict(cfg, NAME=name), _ctx(), 16)
    assert type(head).__name__ == name
