"""SECOND and PointPillar: the port's detectors against the JAX package's,
on the CPU, and through the port's entry points.

Tiny models (the JAX suite's ``test_second_pointpillar.py`` sizes: grid
32^3, 256 voxels a frame, batch 2, filters (8, 16, 16, 16); SECOND with
the direction classifier on) are initialised by flax, their variables
(with random BatchNorm statistics and a zero classification bias, so that
boxes pass the score threshold) carried into the port by ``bridge.py``,
and both run the same numpy-seeded batch. Tolerances:

- eval: each stage's output and the head maps to 1e-4, the detections as
  equal sets of boxes (1e-4);
- train: the loss to rtol 1e-5, the updated BatchNorm statistics to
  1e-5, the whole model's gradients to 1e-3 of their global norm; stage
  by stage (each stage fed JAX's input and output cotangent), each stage's
  output and input cotangent to 1e-4 of their largest magnitude and each
  parameter leaf to 1e-3 of its norm (f32 through ReLUs whose inputs may
  sit within rounding of zero; ROADMAP.md Queue 3).

JAX runs jitted, each function compiled once in a module-scoped fixture.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.models import build_network as j_build
from mssvt_tpu.models.detectors.generic_post import apply_vfe as j_apply_vfe
from mssvt_tpu.models.detectors.generic_post import (
    run_dense_head as j_run_head,
)
from mssvt_tpu.ops import sparse_conv as j_sc
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.core.sparse import SparseVoxels
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.models.detectors.generic_post import (
    apply_vfe,
    run_dense_head,
)
from mssvt_tpu_torch.runtime.train_utils import forward_backward
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_second_pointpillar import (
    BATCH,
    GRID,
    MAX_VOXELS,
    PC_RANGE,
    make_batch,
    pillar_cfg,
    second_cfg,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
STAGES = {"second": ("backbone_3d", "backbone_2d", "dense_head"),
          "pillar": ("vfe", "backbone_2d", "dense_head")}


def _cfg(which):
    cfg = second_cfg() if which == "second" else pillar_cfg()
    cfg = json.loads(json.dumps(cfg))  # plain dicts
    if which == "second":
        cfg["DENSE_HEAD"].update(USE_DIRECTION_CLASSIFIER=True,
                                 DIR_OFFSET=0.78539, DIR_LIMIT_OFFSET=0.0,
                                 NUM_DIR_BINS=2)
        cfg["DENSE_HEAD"]["LOSS_CONFIG"]["LOSS_WEIGHTS"]["dir_weight"] = 0.2
    return cfg


def _build_kw(which):
    pillar = which == "pillar"
    return dict(num_class=1, class_names=["Car"],
                grid_size=(GRID[0], GRID[1], 1) if pillar else GRID,
                voxel_size=(0.4, 0.4, 4.0) if pillar else (0.4, 0.4, 0.5),
                point_cloud_range=PC_RANGE, batch_size=BATCH,
                max_voxels=MAX_VOXELS, max_points_per_voxel=4)


def _j_eval(m, b):
    """The JAX detector's eval forward, keeping each stage's output."""
    if hasattr(m, "backbone_3d"):
        sp = JSV.create(features=j_apply_vfe(m.vfe, b),
                        coords=b["voxel_coords"], valid=b["voxel_valid"],
                        batch_size=m.batch_size, spatial_shape=m.grid_size,
                        voxel_size=m.voxel_size,
                        point_cloud_range=m.point_cloud_range)
        sp = m.backbone_3d(sp)
        first = sp.features
        spatial = sp.bev()
    else:
        first = j_apply_vfe(m.vfe, b) * b["voxel_valid"][:, None]
        spatial = m.map_to_bev(first, b["voxel_coords"], b["voxel_valid"],
                               m.batch_size)
    f2 = m.backbone_2d(spatial)
    out = j_run_head(m.dense_head, f2, b, m.model_cfg.get("POST_PROCESSING"))
    return dict(first=first, spatial=spatial, spatial_2d=f2,
                preds=out["pred_dicts"], boxes=out["final_boxes"],
                scores=out["final_scores"], labels=out["final_labels"],
                mask=out["final_mask"])


def _j_train_stages(jm, variables, jb, which):
    """JAX's train-mode forward as three stages chained with ``jax.vjp``:
    each stage's (input, output), its parameter and input cotangents, and
    the BatchNorm statistics it updates."""
    stats = variables["batch_stats"]
    valid = jb["voxel_valid"]

    def sp_of(m, b):
        sp = JSV.create(features=j_apply_vfe(m.vfe, b, train=True),
                        coords=b["voxel_coords"], valid=b["voxel_valid"],
                        batch_size=m.batch_size, spatial_shape=m.grid_size,
                        voxel_size=m.voxel_size,
                        point_cloud_range=m.point_cloud_range)
        return m.backbone_3d(sp, train=True)

    if which == "second":
        sp, _ = jax.jit(lambda v: jm.apply(v, jb, method=sp_of,
                                           mutable=["batch_stats"]))(variables)
        fns = {"backbone_3d": lambda m, _: sp_of(m, jb).features,
               "backbone_2d": lambda m, f: m.backbone_2d(
                   sp.with_features(f).bev(), train=True)}
    else:
        fns = {"vfe": lambda m, _: j_apply_vfe(m.vfe, jb, train=True)
               * valid[:, None],
               "backbone_2d": lambda m, f: m.backbone_2d(
                   m.map_to_bev(f, jb["voxel_coords"], valid, m.batch_size),
                   train=True)}
    fns["dense_head"] = lambda m, x: j_run_head(m.dense_head, x, jb, None,
                                                train=True)["loss"]
    outs, vjps, new_stats, x = {}, {}, {}, jnp.zeros(())
    for name in STAGES[which]:
        def f(p, xin, _fn=fns[name]):
            y, upd = jm.apply({"params": p, "batch_stats": stats}, xin,
                              method=_fn, mutable=["batch_stats"])
            return y, upd.get("batch_stats", {})

        y, vjps[name], upd = jax.vjp(jax.jit(f), variables["params"], x,
                                     has_aux=True)
        if name in upd:  # the stage's own module (upd holds them all)
            new_stats[name] = upd[name]
        outs[name] = (x, y)
        x = y
    ct, grads = jnp.ones(()), {}
    for name in reversed(STAGES[which]):
        gp, gx = vjps[name](ct)
        grads[name] = (gp.get(name, {}), ct, gx)
        ct = gx
    return outs, grads, new_stats


@pytest.fixture(scope="module", params=["second", "pillar"])
def pair(request):
    """(kind, JAX's eval and train results, the port's model on the same
    variables, the batch as tensors)."""
    which = request.param
    cfg = _cfg(which)
    jm = j_build(model_cfg=JDict(cfg), **_build_kw(which))
    batch = make_batch(np.random.default_rng(0), pillar=which == "pillar")
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = jax.jit(lambda k, b: jm.init({"params": k, "dropout": k}, b,
                                             train=False))(
        jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(np.array, variables)  # writable
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    variables["params"]["dense_head"]["conv_cls"]["bias"][:] = 0.0
    evals = jax.jit(lambda v, b: jm.apply(v, b, method=_j_eval))(variables, jb)
    train = _j_train_stages(jm, variables, jb, which)
    tm = t_build(TDict(cfg), **_build_kw(which), num_point_features=4,
                 device="cpu")
    load_flax_variables(tm, variables)
    yield which, evals, train, tm, {k: torch.as_tensor(v)
                                    for k, v in batch.items()}


def _near(got, want, name, tol=1e-4):
    """Within ``tol`` of the largest magnitude of ``want``."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (name, err, np.abs(want).max())


def _box_rows(boxes, scores, labels, m):
    r = np.concatenate([np.asarray(boxes)[m], np.asarray(scores)[m][:, None],
                        np.asarray(labels)[m][:, None].astype(np.float32)], 1)
    return r[np.lexsort(r.T[::-1])]


def test_eval_matches_jax(pair):
    which, want, _, tm, batch = pair
    with torch.no_grad():
        got = tm(batch, return_intermediates=True)
    first = (got["backbone_voxels"].features if which == "second"
             else got["pillar_features"])
    _near(first, want["first"], "3D backbone / VFE output")
    _near(got["spatial_features"], want["spatial"], "BEV map")
    _near(got["spatial_features_2d"], want["spatial_2d"], "2D backbone")
    assert set(got["pred_dicts"]) == set(want["preds"])
    for k, w in want["preds"].items():
        _near(got["pred_dicts"][k], w, k)
    for b in range(BATCH):
        wm, gm = np.asarray(want["mask"][b]), got["final_mask"][b].numpy()
        assert wm.sum() == gm.sum() > 0
        np.testing.assert_allclose(
            _box_rows(got["final_boxes"][b].numpy(),
                      got["final_scores"][b].numpy(),
                      got["final_labels"][b].numpy(), gm),
            _box_rows(want["boxes"][b], want["scores"][b], want["labels"][b],
                      wm), rtol=1e-4, atol=1e-4)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_loss_stats_and_gradients_match_jax(pair):
    """One train-mode forward/backward of the whole model (loss, updated
    statistics, every gradient to 1e-3 of the global norm)."""
    which, _, (outs, grads, stats), tm, batch = pair
    model = copy.deepcopy(tm)
    model.zero_grad()
    loss, tb = forward_backward(model, batch)
    want_loss = float(outs["dense_head"][1])
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert set(tb) == ({"rpn_loss_cls", "rpn_loss_loc", "rpn_loss"}
                       | ({"rpn_loss_dir"} if which == "second" else set()))
    got_s = _leaves(to_flax_tree(model, "batch_stats"))
    want_s = _leaves(stats)
    assert set(got_s) == set(want_s) and want_s
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    got_g = _leaves(to_flax_tree(model, "params", grads=True))
    want_g = _leaves({n: g[0] for n, g in grads.items() if g[0]})
    assert set(got_g) == set(want_g)
    diff = np.sqrt(sum(((got_g[k] - w) ** 2).sum() for k, w in want_g.items()))
    norm = np.sqrt(sum((w ** 2).sum() for w in want_g.values()))
    assert diff <= 1e-3 * norm, (diff, norm)
    assert sum(np.abs(w).sum() > 0 for w in want_g.values()) > 0.9 * len(want_g)


def test_gradients_stage_by_stage_match_jax(pair):
    """Each stage fed JAX's stage input and output cotangent: its output and
    input cotangent to 1e-4 of their largest magnitude, every parameter leaf
    to 1e-3 of the leaf's norm."""
    which, _, (outs, grads, _), tm, batch = pair
    model = copy.deepcopy(tm).train()
    model.zero_grad()
    valid, coords = batch["voxel_valid"], batch["voxel_coords"]
    sp = None
    if which == "second":
        sp = model.backbone_3d(SparseVoxels.create(
            apply_vfe(model.vfe, batch), coords, valid, model.batch_size,
            model.grid_size, model.voxel_size, model.point_cloud_range))
    fns = {
        "backbone_3d": lambda _: model.backbone_3d(SparseVoxels.create(
            apply_vfe(model.vfe, batch), coords, valid, model.batch_size,
            model.grid_size, model.voxel_size,
            model.point_cloud_range)).features,
        "vfe": lambda _: apply_vfe(model.vfe, batch) * valid[:, None],
        "backbone_2d": (lambda f: model.backbone_2d(
            sp.with_features(f).bev())) if which == "second" else (
            lambda f: model.backbone_2d(model.map_to_bev(
                f, coords, valid, model.batch_size))),
        "dense_head": lambda x: run_dense_head(model.dense_head, x, batch,
                                               train=True)["loss"],
    }
    for i, name in enumerate(STAGES[which]):
        x_j, y_j = outs[name]
        x = torch.as_tensor(np.array(x_j)).requires_grad_(i > 0)
        y = fns[name](x)
        _near(y, y_j, f"{name} output")
        gp_j, ct_j, gx_j = grads[name]
        y.backward(torch.as_tensor(np.array(ct_j)))
        if i > 0:
            _near(x.grad, gx_j, f"{name} input cotangent")
        got = _leaves(to_flax_tree(getattr(model, name), "params",
                                   grads=True))
        want = _leaves(gp_j)
        assert set(got) == set(want), name
        for k, w in want.items():
            err = np.sqrt(((got[k] - w) ** 2).sum())
            assert err <= 1e-3 * np.sqrt((w ** 2).sum()), (name, k, err)


# ------------------------------------------------- the KITTI configs
@pytest.mark.parametrize("name,bev,bev_in", [("second", 128, 128),
                                             ("pointpillar", 64, 64)])
def test_kitti_configs_build_on_cuda_by_default(name, bev, bev_in,
                                                monkeypatch):
    """``second.yaml`` and ``pointpillar.yaml`` at their published widths:
    ``build_network`` raises without a card unless ``device="cpu"``. The
    BEV map SECOND hands its 2D backbone is the JAX package's: KITTI's grid
    as given, z 40 -> 20 -> 10 -> 4 -> 1 (JAX's own shape arithmetic), so
    1 x 128 channels where the config's NUM_BEV_FEATURES says 256."""
    from mssvt_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(ROOT / f"tools/cfgs/kitti_models/{name}.yaml"),
                             TDict())
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vox = dc.DATA_PROCESSOR[-1]
    vs = tuple(vox.VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    kw = dict(model_cfg=cfg.MODEL, num_class=3, class_names=cfg.CLASS_NAMES,
              grid_size=grid, voxel_size=vs, point_cloud_range=pcr,
              batch_size=4, max_voxels=vox.MAX_NUMBER_OF_VOXELS["train"],
              max_points_per_voxel=vox.MAX_POINTS_PER_VOXEL,
              num_point_features=len(
                  dc.POINT_FEATURE_ENCODING.used_feature_list))
    assert kw["num_point_features"] == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_build(**kw)
    model = t_build(**kw, device="cpu")
    assert type(model).__name__ == {"second": "SECONDNet",
                                    "pointpillar": "PointPillar"}[name]
    if name == "second":
        assert grid == (1408, 1600, 40)
        coords = jnp.asarray([[0, 5, 7, 9]], jnp.int32)
        shape = grid
        for ks, st, pd in [((3, 3, 3), (2, 2, 2), (1, 1, 1))] * 2 + [
                ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
                ((1, 1, 3), (1, 1, 2), (0, 0, 0))]:
            shape = j_sc.downsample_output_sites(
                coords, jnp.ones(1, bool), shape, ks, st, pd, 8)[2]
        assert model.backbone_3d.out_spatial_shape == tuple(shape) \
            == (176, 200, 1)
        assert model.backbone_3d.num_bev_features == bev
        assert cfg.MODEL.MAP_TO_BEV.NUM_BEV_FEATURES == 2 * bev
    else:
        assert grid == (440, 500, 1)
        assert model.map_to_bev.num_bev_features == bev
    assert model.backbone_2d.block0_conv0.in_channels == bev_in
    nx = grid[0] // 8 if name == "second" else grid[0] // 2
    ny = grid[1] // 8 if name == "second" else grid[1] // 2
    assert model.dense_head.anchors.shape == (nx * ny * 6, 7)


def _tiny_kitti_cfg(root, name):
    """``kitti_models/<name>.yaml`` loaded with its KITTI dataset config
    (4 point features, the ``kitti`` metric, train/test voxel caps), then
    cut to the CPU: ``SyntheticDataset`` frames, gt_sampling off, a 12.8 m
    range and 32 x 32 (x 32) cells, narrow widths."""
    from mssvt_tpu_torch.config import cfg_from_yaml_file

    cfg = json.loads(json.dumps(cfg_from_yaml_file(
        str(ROOT / f"tools/cfgs/kitti_models/{name}.yaml"), TDict())))
    dc, m = cfg["DATA_CONFIG"], cfg["MODEL"]
    assert dc["POINT_FEATURE_ENCODING"]["used_feature_list"] == [
        "x", "y", "z", "intensity"]
    assert m["POST_PROCESSING"]["EVAL_METRIC"] == "kitti"
    dc.update(DATASET="SyntheticDataset", NUM_FRAMES=4, POINTS_PER_FRAME=3000,
              POINT_CLOUD_RANGE=[0.0, -6.4, -3.0, 12.8, 6.4, 1.0])
    dc["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = ["gt_sampling"]
    vox = dc["DATA_PROCESSOR"][-1]
    assert vox["MAX_NUMBER_OF_VOXELS"] == {"train": 16000, "test": 40000}
    vox["MAX_NUMBER_OF_VOXELS"] = {"train": 600, "test": 800}
    if name == "second":
        vox["VOXEL_SIZE"] = [0.4, 0.4, 0.125]
        m["BACKBONE_3D"].update(NUM_FILTERS=[8, 16, 16, 16], OUT_CHANNELS=16)
    else:
        vox["VOXEL_SIZE"] = [0.4, 0.4, 4.0]
        m["VFE"]["NUM_FILTERS"] = [16]
        m["MAP_TO_BEV"]["NUM_BEV_FEATURES"] = 16
    m["BACKBONE_2D"].update(LAYER_NUMS=[1, 1], NUM_FILTERS=[16, 16],
                            UPSAMPLE_STRIDES=[1, 2],
                            NUM_UPSAMPLE_FILTERS=[16, 16])
    m["POST_PROCESSING"]["NMS_CONFIG"].update(NMS_PRE_MAXSIZE=256,
                                              NMS_POST_MAXSIZE=32)
    cfg["OPTIMIZATION"]["NUM_EPOCHS"] = 1
    p = root / "cfgs" / "kitti_models" / f"tiny_{name}.yaml"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(yaml.safe_dump(cfg))
    return p


@pytest.mark.parametrize("name", ["second", "pointpillar"])
def test_entry_points_train_and_evaluate(name, tmp_path, monkeypatch):
    """``tools/train_torch.py`` for one epoch (2 steps at batch 2) and
    ``tools/test_torch.py`` on its checkpoint, in-process on the CPU."""
    from test_torch_cli import _tool

    monkeypatch.setenv("MSSVT_OUTPUT_ROOT", str(tmp_path / "output"))
    cfg = _tiny_kitti_cfg(tmp_path, name)
    common = ["--cfg_file", str(cfg), "--batch_size", "2", "--workers", "0",
              "--extra_tag", "ci", "--device", "cpu"]
    run = _tool("train_torch").main(common + ["--fix_random_seed",
                                              "--epochs", "1"])
    assert [h["it"] for h in run["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in run["history"])
    metrics = _tool("test_torch").main(common + ["--ckpt", "1"])[1]
    assert {"mAP", "sec_per_example", "recall/rcnn_0.3"} <= set(metrics)
    assert (run["output_dir"] / "eval" / "epoch_1" / "result.pkl").exists()
