"""VoxelRCNN: ``voxel_query``, the neighbour-voxel pooling and the detector,
the port against the JAX package on the CPU.

- ``voxel_query`` against the JAX suite's brute-force CUDA-semantics oracle
  (``test_voxel_rcnn.oracle_voxel_query``) and against JAX, exactly, at
  the tiny sizes and at VoxelRCNN's (4, 4, 4) neighbourhood;
- ``roi_grid_points_3d`` and ``SharedMLP`` to 1e-5;
- ``NeighborVoxelSA`` in training (values, parameter and feature
  cotangents to 1e-5; its BatchNorm counts the padding slots and the empty
  queries' row-0 picks, so those picks are live in the backward);
- the tiny detector (``test_voxel_rcnn.voxelrcnn_cfg``, DP_RATIO 0) through
  ``test_torch_roi``'s harness: eval as sets, loss, statistics, gradients,
  the RoI stage alone, the bridge's round trip;
- ``voxel_rcnn_car.yaml`` at its published width builds on the card by
  default and on the CPU when asked.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.models.backbones_3d.pointnet2_backbone import (
    SharedMLP as JSharedMLP,
)
from mssvt_tpu.models.roi_heads.pvrcnn_head import (
    roi_grid_points_3d as j_grid_3d,
)
from mssvt_tpu.models.roi_heads.voxelrcnn_head import (
    NeighborVoxelSA as JNeighborVoxelSA,
)
from mssvt_tpu.ops.voxel_query import voxel_query as j_voxel_query
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.core.sparse import SparseVoxels
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.models.backbones_3d.pointnet2_backbone import SharedMLP
from mssvt_tpu_torch.models.roi_heads import roi_head_template as t_rt
from mssvt_tpu_torch.models.roi_heads.pvrcnn_head import roi_grid_points_3d
from mssvt_tpu_torch.models.roi_heads.voxelrcnn_head import NeighborVoxelSA
from mssvt_tpu_torch.ops.voxel_query import (
    _neighborhood_offsets,
    voxel_query,
)
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_torch_roi import (
    BATCH,
    GRID,
    PC_RANGE,
    VOXEL_SIZE,
    _t,
    check_eval,
    check_round_trip,
    check_roi_stage,
    check_train,
    leaves,
    make_pair,
    near,
)
from test_voxel_rcnn import oracle_voxel_query, voxelrcnn_cfg

from mssvt_tpu.ops.voxel_query import _neighborhood_offsets as j_offsets

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _sites(rng, n=80, cap=128, grid=GRID, both_frames=False):
    coords = np.unique(np.stack([
        rng.integers(0, BATCH, n * 2), rng.integers(0, grid[2], n * 2),
        rng.integers(0, grid[1], n * 2), rng.integers(0, grid[0], n * 2)], 1),
        axis=0)
    if both_frames:  # unique() sorts by frame
        coords = coords[rng.permutation(len(coords))]
    coords = coords[:n]
    pad = np.full((cap, 4), -1, np.int32)
    pad[:len(coords)] = coords
    return pad, np.arange(cap) < len(coords)


def _queries(rng, q=16, margin=0.0):
    return np.stack([
        rng.uniform(PC_RANGE[0] - margin, PC_RANGE[3] + margin, (BATCH, q)),
        rng.uniform(PC_RANGE[1] - margin, PC_RANGE[4] + margin, (BATCH, q)),
        rng.uniform(PC_RANGE[2] - margin, PC_RANGE[5] + margin, (BATCH, q)),
    ], axis=-1).astype(np.float32)


def test_neighborhood_offsets_match_jax():
    for r in ((2, 2, 2), (4, 4, 4), (1, 2, 3)):
        np.testing.assert_array_equal(_neighborhood_offsets(r), j_offsets(r))


def test_voxel_query_matches_oracle(rng):
    """The JAX suite's oracle test on the port."""
    pad, valid = _sites(rng)
    queries = _queries(rng)
    max_range, radius, nsample = (2, 2, 2), 1.5, 8
    idx, empty = voxel_query(_t(queries), _t(pad), _t(valid), GRID,
                             VOXEL_SIZE, PC_RANGE, max_range, radius, nsample,
                             BATCH)
    o_idx, o_empty = oracle_voxel_query(queries, pad, valid, GRID, VOXEL_SIZE,
                                        PC_RANGE, max_range, radius, nsample)
    np.testing.assert_array_equal(empty.numpy(), o_empty)
    np.testing.assert_array_equal(idx.numpy(), np.where(o_idx < 0, 0, o_idx))


@pytest.mark.parametrize("max_range,radius,nsample", [
    ((2, 2, 2), 1.5, 8), ((4, 4, 4), 0.8, 16), ((1, 2, 3), 1.0, 4)])
def test_voxel_query_matches_jax(max_range, radius, nsample):
    """Denser sites, queries past the range's edges (out-of-grid
    neighbours), against JAX exactly."""
    rng = np.random.default_rng(sum(max_range))
    pad, valid = _sites(rng, n=300, cap=400, both_frames=True)
    queries = _queries(rng, q=64, margin=1.0)
    want = jax.jit(lambda q, c, v: j_voxel_query(
        q, c, v, GRID, VOXEL_SIZE, PC_RANGE, max_range, radius, nsample,
        BATCH))(jnp.asarray(queries), jnp.asarray(pad), jnp.asarray(valid))
    got = voxel_query(_t(queries), _t(pad), _t(valid), GRID, VOXEL_SIZE,
                      PC_RANGE, max_range, radius, nsample, BATCH)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[1].sum() < got[1].numel()


def test_roi_grid_points_3d_and_shared_mlp_match_jax():
    rng = np.random.default_rng(9)
    rois = np.concatenate([rng.normal(size=(2, 3, 3)),
                           rng.uniform(1, 4, (2, 3, 3)),
                           rng.uniform(-3, 3, (2, 3, 1))], -1).astype(np.float32)
    near(roi_grid_points_3d(_t(rois), 3),
         j_grid_3d(jnp.asarray(rois), 3), "grid points")
    x = rng.normal(size=(2, 5, 4, 6)).astype(np.float32)
    jm = JSharedMLP((8, 4))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want, upd = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm = SharedMLP(6, (8, 4)).train()
    load_flax_variables(tm, variables)
    near(tm(_t(x)), want, "shared MLP")
    got_s = leaves(to_flax_tree(tm, "batch_stats"))
    for k, w in leaves(upd["batch_stats"]).items():
        near(got_s[k], w, k)


def test_neighbor_voxel_sa_train_matches_jax():
    """One scale in training, queries around the sites and far from them
    (empty: row 0 sixteen times): output, parameter and feature
    cotangents."""
    rng = np.random.default_rng(10)
    pad, valid = _sites(rng, n=200, cap=256, both_frames=True)
    feats = (rng.normal(size=(256, 5)) * valid[:, None]).astype(np.float32)
    live = pad[valid]
    ctr = ((live[:, [3, 2, 1]] + 0.5) * np.array(VOXEL_SIZE)
           + np.array(PC_RANGE[:3])).astype(np.float32)
    grid_pts = np.stack([ctr[live[:, 0] == b][:24] + rng.normal(
        size=(24, 3)).astype(np.float32) * 0.2 for b in range(BATCH)])
    grid_pts[:, -4:] = [30.0, 30.0, 5.0]  # no voxel near: empty
    g = rng.normal(size=(BATCH, 24, 6)).astype(np.float32)
    args = dict(mlps=(8, 6), max_range=(2, 2, 2), radius=0.6, nsample=16)
    jm = JNeighborVoxelSA(**args)

    def sp_of(f):
        return JSV.create(features=f, coords=jnp.asarray(pad),
                          valid=jnp.asarray(valid), batch_size=BATCH,
                          spatial_shape=GRID, voxel_size=VOXEL_SIZE,
                          point_cloud_range=PC_RANGE)

    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(grid_pts),
                                       sp_of(jnp.asarray(feats)), BATCH))

    def jf(p, f, q):
        y, _ = jm.apply({**variables, "params": p}, q, sp_of(f), BATCH,
                        train=True, mutable=["batch_stats"])
        return (y * g).sum(), y

    (_, want), (gp, gf, gq) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        variables["params"], jnp.asarray(feats), jnp.asarray(grid_pts))
    tm = NeighborVoxelSA(5, args["mlps"], args["max_range"], args["radius"],
                         args["nsample"]).train()
    load_flax_variables(tm, variables)
    tf = _t(feats).requires_grad_()
    tq = _t(grid_pts).requires_grad_()
    got = tm(tq, SparseVoxels.create(tf, _t(pad), _t(valid), BATCH, GRID,
                                     VOXEL_SIZE, PC_RANGE), BATCH)
    (got * _t(g)).sum().backward()
    near(got, want, "pooled")
    near(tf.grad, gf, "d features")
    near(tq.grad, gq, "d grid points")
    got_g = leaves(to_flax_tree(tm, "params", grads=True))
    for k, w in leaves(gp).items():
        near(got_g[k], w, k)
    assert (np.asarray(want)[:, -4:] == 0).all()


# ------------------------------------------------------------- the detector
def _j_roi_inputs(m, b):
    from mssvt_tpu.models.detectors.generic_post import apply_vfe
    from mssvt_tpu.models.roi_heads import roi_head_template as j_rt

    sp = JSV.create(features=apply_vfe(m.vfe, b, train=True),
                    coords=b["voxel_coords"], valid=b["voxel_valid"],
                    batch_size=m.batch_size, spatial_shape=m.grid_size,
                    voxel_size=m.voxel_size,
                    point_cloud_range=m.point_cloud_range)
    sp_out, stages = m.backbone_3d(sp, train=True)
    f2 = m.backbone_2d(sp_out.bev(), train=True)
    preds = m.dense_head(f2, train=True)
    boxes, scores_mc = m.dense_head.generate_predicted_boxes(preds)
    rois, _, _, rvalid = j_rt.proposal_layer(
        boxes[..., :7], jnp.max(scores_mc, -1),
        jnp.ones(scores_mc.shape[:2], bool), **t_rt.nms_kwargs(m.roi_cfg,
                                                               True))
    return {k: sp.features for k, sp in stages.items()}, rois, rvalid


@pytest.fixture(scope="module")
def pair():
    p = make_pair(voxelrcnn_cfg(), 1, _j_roi_inputs)
    # the stages' site sets, for the RoI stage fed JAX's features
    b = p["batch"]
    with torch.no_grad():
        p["stages"] = p["tm"](b, return_intermediates=True)["stages"]
    return p


def test_voxel_rcnn_eval_matches_jax(pair):
    assert type(pair["tm"]).__name__ == "VoxelRCNN"
    check_eval(pair)


# The pooling MLPs' BatchNorm takes E[x^2] - E[x]^2 (flax's form) over
# every (point, slot) entry, most of them the same few rows (padding slots
# repeat the first hit, empty points read row 0): the two terms nearly
# cancel, so the sums' order (XLA's against PyTorch's) moves a normalised
# value by ~5e-5 of its size, on the same inputs (f32, measured on the
# CPU). The head's outputs, the RoI loss and the gradients carry it.
LOSS_RTOL, STAGE_TOL = 1e-4, 1e-3


def test_voxel_rcnn_loss_and_gradients_match_jax(pair):
    check_train(pair, {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                       "rpn_loss", "rcnn_loss_cls", "rcnn_loss_reg"},
                rtol=LOSS_RTOL)


def test_voxel_rcnn_roi_stage_matches_jax(pair):
    """The head on JAX's stage features (their site sets equal to the
    port's: the sparse-conv engine's, held by test_torch_spconv.py)."""
    from mssvt_tpu.core.sparse import SparseVoxels as J

    sources = pair["cfg"]["ROI_HEAD"]["ROI_GRID_POOL"]["FEATURES_SOURCE"]
    t_st = pair["stages"]

    def j_head(m, x, t, v):
        stages = {k: J.create(
            features=x[k], coords=jnp.asarray(t_st[k].coords.numpy()),
            valid=jnp.asarray(t_st[k].valid.numpy()), batch_size=BATCH,
            spatial_shape=t_st[k].spatial_shape,
            voxel_size=t_st[k].voxel_size,
            point_cloud_range=t_st[k].point_cloud_range) for k in sources}
        return m.roi_head(stages, t["rois"], v, BATCH, train=True)

    def t_head(model, x, t, v):
        stages = {k: t_st[k].with_features(x[k]) for k in sources}
        return model.roi_head(stages, t["rois"], v, BATCH)

    x, rois, rvalid = pair["roi_in"]
    pair = dict(pair, roi_in=({k: x[k] for k in sources}, rois, rvalid))
    for k in sources:
        np.testing.assert_array_equal(
            np.asarray(x[k]).shape, tuple(t_st[k].features.shape))
    check_roi_stage(pair, j_head, t_head, rtol=LOSS_RTOL, tol=STAGE_TOL)


def test_voxel_rcnn_bridge_round_trip(pair):
    check_round_trip(pair)


@pytest.mark.parametrize("name,cls", [("voxel_rcnn_car", "VoxelRCNN"),
                                      ("PartA2", "PartA2Net")])
def test_two_stage_kitti_configs_build_on_cuda_by_default(name, cls,
                                                          monkeypatch):
    """``voxel_rcnn_car.yaml`` and ``PartA2.yaml`` at their published
    widths: ``build_network`` raises without a card unless
    ``device="cpu"``; the stage widths and the RoI heads' input widths are
    the configs'."""
    from mssvt_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(ROOT / f"tools/cfgs/kitti_models/{name}.yaml"),
                             TDict())
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vox = dc.DATA_PROCESSOR[-1]
    vs = tuple(vox.VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    kw = dict(model_cfg=cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
              class_names=cfg.CLASS_NAMES, grid_size=grid, voxel_size=vs,
              point_cloud_range=pcr, batch_size=2,
              max_voxels=vox.MAX_NUMBER_OF_VOXELS["train"],
              max_points_per_voxel=vox.MAX_POINTS_PER_VOXEL,
              num_point_features=len(
                  dc.POINT_FEATURE_ENCODING.used_feature_list))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_build(**kw)
    model = t_build(**kw, device="cpu")
    assert type(model).__name__ == cls
    assert grid == (1408, 1600, 40)
    assert model.backbone_3d.num_bev_features == 128
    assert model.backbone_2d.block0_conv0.in_channels == 128
    head = model.roi_head
    assert head.dp == 0.3
    if name == "voxel_rcnn_car":
        assert model.backbone_3d.stage_channels == {
            "x_conv1": 16, "x_conv2": 32, "x_conv3": 64, "x_conv4": 64}
        assert head.grid == 6 and head.shared_fc_0.in_features == 3 * 32 * 216
        assert head.x_conv2_sa_0.max_range == (4, 4, 4)
        assert head.x_conv4_sa_0.radius == 1.6
    else:
        assert head.grid == 12 and head.conv3d_0.in_channels == 4 + 16
        assert head.shared_fc_0.in_features == 64 * 6 ** 3
        assert model.point_head.seg_out.out_features == 1
    n = sum(p.numel() for p in model.parameters())
    assert n > 1_000_000, n


@pytest.mark.parametrize("name", ["voxel_rcnn_car", "PartA2"])
def test_two_stage_entry_points_train_and_evaluate(name, tmp_path,
                                                   monkeypatch):
    """``tools/train_torch.py`` for one epoch (2 steps at the yaml's batch
    2, dropout 0.3 drawn from the entry point's generator) and
    ``tools/test_torch.py`` on its checkpoint, in-process on the CPU, on
    ``test_torch_second``'s tiny KITTI-derived config of each model."""
    import yaml

    from test_torch_cli import _tool
    from test_torch_second import _tiny_kitti_cfg

    monkeypatch.setenv("MSSVT_OUTPUT_ROOT", str(tmp_path / "output"))
    path = _tiny_kitti_cfg(tmp_path, "second")
    cfg = yaml.safe_load(path.read_text())
    full = json.loads(json.dumps(__import__(
        "mssvt_tpu_torch.config", fromlist=["cfg_from_yaml_file"])
        .cfg_from_yaml_file(str(ROOT / f"tools/cfgs/kitti_models/{name}.yaml"),
                            TDict())))
    m = full["MODEL"]
    assert full["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"] == 2
    for key in ("BACKBONE_2D", "POST_PROCESSING"):
        m[key] = cfg["MODEL"][key]
    m["BACKBONE_3D"].update(NUM_FILTERS=[8, 16, 16, 16], OUT_CHANNELS=16)
    m["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"] = [
        a for a in m["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]
        if a["class_name"] in full["CLASS_NAMES"]]
    roi = m["ROI_HEAD"]
    roi["SHARED_FC"] = [16, 16]
    for split in ("TRAIN", "TEST"):
        roi["NMS_CONFIG"][split].update(NMS_PRE_MAXSIZE=64,
                                        NMS_POST_MAXSIZE=16)
    roi["TARGET_CONFIG"]["ROI_PER_IMAGE"] = 16
    if name == "PartA2":
        m["POINT_HEAD"].update(CLS_FC=[8], PART_FC=[8])
        roi.update(CONV_CHANNELS=[8, 8], ROI_AWARE_POOL={"POOL_SIZE": 4})
    else:
        roi["GRID_SIZE"] = 3
        for layer in roi["ROI_GRID_POOL"]["POOL_LAYERS"].values():
            layer.update(MLPS=[[8, 8]], NSAMPLE=[8])
    cfg.update(MODEL=m, CLASS_NAMES=full["CLASS_NAMES"])
    path.write_text(yaml.safe_dump(cfg))
    common = ["--cfg_file", str(path), "--batch_size", "2", "--workers", "0",
              "--extra_tag", "ci", "--device", "cpu"]
    run = _tool("train_torch").main(common + ["--fix_random_seed",
                                              "--epochs", "1"])
    assert [h["it"] for h in run["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in run["history"])
    metrics = _tool("test_torch").main(common + ["--ckpt", "1"])[1]
    assert {"mAP", "sec_per_example", "recall/rcnn_0.3"} <= set(metrics)
    assert (run["output_dir"] / "eval" / "epoch_1" / "result.pkl").exists()
