"""Whole-detector parity: the port's CenterPoint against the JAX package.

The flax model is initialised, its variables (with random BatchNorm
statistics) are carried into the port with ``bridge.load_flax_variables``,
and both run the same batch on the CPU (JAX with ``MSSVT_PALLAS=xla_fill``,
the port with ``device="cpu"``, i.e. the kernels' plain versions). Backbone
features, BEV maps and head maps agree to 1e-4 (f32 through ~20 layers,
summed in another order); the final detections are compared as sets of
valid boxes.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml
from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.models import build_network as j_build
from mssvt_tpu.models.detectors.generic_post import apply_vfe
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.bridge import load_flax_variables
from mssvt_tpu_torch.config import cfg_from_yaml_file as t_cfg_from_yaml
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_model_forward import (
    BATCH,
    GRID,
    MAX_PTS,
    MAX_VOXELS,
    PC_RANGE,
    VOXEL_SIZE,
    synthetic_batch,
    tiny_model_cfg,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = ROOT / "tools/cfgs/synthetic_models/mssvt_tiny.yaml"
KEYS = ("voxels", "voxel_num_points", "voxel_coords", "voxel_valid")


def _stages(m, batch):
    """The JAX detector's forward, keeping the intermediates."""
    sp = JSV.create(features=apply_vfe(m.vfe, batch),
                    coords=batch["voxel_coords"], valid=batch["voxel_valid"],
                    batch_size=m.batch_size, spatial_shape=m.grid_size,
                    voxel_size=m.voxel_size,
                    point_cloud_range=m.point_cloud_range, with_index=False)
    sp = m.backbone_3d(sp, deterministic=True)
    bev = m.map_to_bev(sp)
    f2 = m.backbone_2d(bev)
    preds = m.dense_head(f2)
    fb, fs, fl, fm = m.dense_head.generate_predicted_boxes(preds)
    return dict(features=sp.features, bev=bev, bev_2d=f2, preds=preds,
                boxes=fb, scores=fs, labels=fl, mask=fm)


def _run_pair(model_cfg_j, model_cfg_t, batch, build_kw, num_point_features):
    jm = j_build(model_cfg=model_cfg_j, **build_kw)
    variables = jax.jit(lambda k, b: jm.init({"params": k, "dropout": k}, b,
                                             train=False))(
        jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(0)
    variables = {**variables, "batch_stats": jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])}
    want = jax.jit(lambda v, b: jm.apply(v, b, method=_stages))(variables,
                                                                batch)
    tm = t_build(model_cfg=model_cfg_t, **build_kw,
                 num_point_features=num_point_features, device="cpu")
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = tm({k: torch.as_tensor(np.array(batch[k])) for k in KEYS},
                 return_intermediates=True)
    return want, got


def _assert_close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4, err_msg=name)


def _assert_same_box_sets(got, want):
    for b in range(want["mask"].shape[0]):
        wm = np.asarray(want["mask"][b])
        gm = got["final_mask"][b].numpy()
        assert wm.sum() == gm.sum()
        rows = []
        for boxes, scores, labels, m in (
                (np.asarray(want["boxes"][b]), np.asarray(want["scores"][b]),
                 np.asarray(want["labels"][b]), wm),
                (got["final_boxes"][b].numpy(), got["final_scores"][b].numpy(),
                 got["final_labels"][b].numpy(), gm)):
            r = np.concatenate([boxes[m], scores[m][:, None],
                                labels[m][:, None].astype(np.float32)], 1)
            rows.append(r[np.lexsort(r.T[::-1])])
        np.testing.assert_allclose(rows[1], rows[0], atol=1e-4, rtol=1e-4)


def _check(want, got):
    _assert_close(got["backbone_voxels"].features, want["features"],
                  "backbone features")
    _assert_close(got["spatial_features"], want["bev"], "bev")
    _assert_close(got["spatial_features_2d"], want["bev_2d"], "bev 2d")
    for wp, gp in zip(want["preds"], got["pred_dicts"]):
        for k in wp:
            _assert_close(gp[k], wp[k], f"head map {k}")
    assert int(np.asarray(want["mask"]).sum()) > 0
    _assert_same_box_sets(got, want)


@pytest.fixture(scope="module", autouse=True)
def _xla_fill():
    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_PALLAS", "xla_fill")
    yield
    mp.undo()


def test_tiny_centerpoint_matches_jax():
    batch = synthetic_batch(np.random.default_rng(1))
    build_kw = dict(num_class=2, class_names=["Car", "Ped"], grid_size=GRID,
                    voxel_size=VOXEL_SIZE, point_cloud_range=PC_RANGE,
                    batch_size=BATCH, max_voxels=MAX_VOXELS,
                    max_points_per_voxel=MAX_PTS)
    want, got = _run_pair(tiny_model_cfg(), TDict(tiny_model_cfg()), batch,
                          build_kw, 5)
    _check(want, got)


def test_mssvt_tiny_yaml_matches_jax():
    """``mssvt_tiny.yaml`` through both YAML loaders: three MsSVT blocks
    (odd and even query patterns), two compress blocks' worth of
    downsampling, a stride-2 BEV level; 4-feature points."""
    cfg_t = t_cfg_from_yaml(str(TINY_YAML), TDict())
    cfg_j = j_cfg_from_yaml(str(TINY_YAML), JDict())
    assert cfg_t == cfg_j
    dc = cfg_t.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vs = tuple(dc.DATA_PROCESSOR[-1].VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    n_feat = len(dc.POINT_FEATURE_ENCODING.used_feature_list)
    rng = np.random.default_rng(3)
    bsz, max_vox, n = 2, 1024, 1100
    coords = np.unique(np.stack([
        rng.integers(0, bsz, n), rng.integers(0, grid[2], n),
        rng.integers(0, grid[1], n), rng.integers(0, grid[0], n)], 1),
        axis=0).astype(np.int32)[:max_vox]
    pad = np.full((max_vox, 4), -1, np.int32)
    pad[:len(coords)] = coords
    valid = np.arange(max_vox) < len(coords)
    batch = {
        "voxels": jnp.asarray(rng.normal(size=(max_vox, 5, n_feat)).astype(
            np.float32) * valid[:, None, None]),
        "voxel_num_points": jnp.asarray(
            rng.integers(1, 6, max_vox).astype(np.float32) * valid),
        "voxel_coords": jnp.asarray(pad), "voxel_valid": jnp.asarray(valid)}
    build_kw = dict(num_class=3, class_names=list(cfg_t.CLASS_NAMES),
                    grid_size=grid, voxel_size=vs, point_cloud_range=pcr,
                    batch_size=bsz, max_voxels=max_vox,
                    max_points_per_voxel=5)
    want, got = _run_pair(cfg_j.MODEL, cfg_t.MODEL, batch, build_kw, n_feat)
    _check(want, got)
