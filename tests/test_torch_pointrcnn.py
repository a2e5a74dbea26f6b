"""PointRCNN: the point coder, the box head, the PointNet++ modules, the RoI
head and the detector, the port against the JAX package on the CPU (f32).

- ``PointResidualCoder`` (with and without mean sizes) and
  ``PointHeadBox``'s encoding, decoding and losses to 1e-5 (values and
  cotangents; ``atan2`` rounds its last bit apart between XLA and torch);
- modules (``test_torch_pointnet2.check_module``: eval outputs, training
  outputs, statistics, every parameter's gradient, the inputs'
  cotangents, 1e-5 of the largest magnitude): ``PointHeadBox``,
  ``SAModuleMSG`` (FPS on the plain K2c/K2b version, ball query, max),
  ``FPModule`` (3-NN weights, the gather-form interpolation),
  ``PointNet2MSG`` (the JAX suite's two levels), ``PointRCNNRoIHead``
  (``roipoint_pool3d``, the canonical transform; the RoIs' cotangent; its
  BatchNorm over a few RoIs cancels E[x^2] - E[x]^2: gradients 1e-4);
- the tiny detector (the JAX suite's ``pointrcnn_cfg``) through
  ``test_torch_roi``'s harness: 512 point rows a frame, 120 of them around
  each of two GT boxes, on a 1/32 m grid (the points of ``PointNet2MSG``'s
  test too: there JAX's 3-NN expansion is exact, so its feature
  propagation weighs a coinciding point as the port does, see
  ``test_torch_pointnet2``), and the box head's output kernel scaled by 0.01
  with a cos bias of 1 (its boxes are then near the class mean size at
  each point, heading 0, so that some RoIs are foreground): eval as sets
  (1e-4), loss and every ``tb_dict`` term, statistics, all gradients
  within 1e-3 of their global norm, the RoI stage alone fed JAX's point
  features (1e-4, with the RoIs' cotangent), the bridge's round trip;
- ``pointrcnn.yaml`` builds on the card by default and on the CPU when
  asked, at its published widths; ``PointNet2MSG`` and
  ``PointNet2Backbone`` build through the ``BACKBONE_3D`` registry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.models.backbones_3d.pointnet2_backbone import (
    FPModule as JFPModule,
)
from mssvt_tpu.models.backbones_3d.pointnet2_backbone import (
    PointNet2MSG as JPointNet2MSG,
)
from mssvt_tpu.models.backbones_3d.pointnet2_backbone import (
    SAModuleMSG as JSAModuleMSG,
)
from mssvt_tpu.models.dense_heads.point_head import PointHeadBox as JHeadBox
from mssvt_tpu.models.detectors.point_rcnn import (
    PointRCNNRoIHead as JRoIHead,
)
from mssvt_tpu.models.roi_heads import roi_head_template as j_rt
from mssvt_tpu.utils.box_coder import PointResidualCoder as JCoder
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.models.backbones_3d.pointnet2_backbone import (
    FPModule,
    PointNet2MSG,
    SAModuleMSG,
)
from mssvt_tpu_torch.models.builders import BuildCtx, build_backbone_3d
from mssvt_tpu_torch.models.dense_heads.point_head import PointHeadBox
from mssvt_tpu_torch.models.detectors.generic_post import per_sample_points
from mssvt_tpu_torch.models.detectors.point_rcnn import PointRCNNRoIHead
from mssvt_tpu_torch.models.roi_heads import roi_head_template as t_rt
from mssvt_tpu_torch.utils.box_coder import PointResidualCoder
from test_pvrcnn_pointrcnn import MAX_POINTS, pointrcnn_cfg
from test_torch_pointnet2 import check_module
from test_torch_pvrcnn import kitti_build_kw
from test_torch_roi import (
    BATCH,
    MAX_GT,
    PC_RANGE,
    _t,
    check_eval,
    check_roi_stage,
    check_round_trip,
    check_train,
    make_batch,
    make_pair,
    near,
)

torch.set_num_threads(2)
MEAN = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]


# ------------------------------------------------------ coder and box head
def _boxes(rng, n, classes=3):
    b = np.concatenate([rng.uniform(-20, 20, (n, 3)), rng.uniform(0.5, 4, (n, 3)),
                        rng.uniform(-3, 3, (n, 1)), rng.normal(size=(n, 2))],
                       -1).astype(np.float32)
    return b, rng.integers(1, classes + 1, n).astype(np.int32)


@pytest.mark.parametrize("use_mean_size", [True, False])
def test_point_residual_coder_matches_jax(use_mean_size):
    rng = np.random.default_rng(20)
    gt, cls = _boxes(rng, 50)
    pts = (gt[:, :3] + rng.normal(size=(50, 3))).astype(np.float32)
    kw = dict(use_mean_size=use_mean_size, mean_size=MEAN)
    jc, tc = JCoder(**kw), PointResidualCoder(**kw)
    want = jc.encode(jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(cls))
    got = tc.encode(_t(gt), _t(pts), _t(cls))
    near(got, want, "encode")
    enc = np.asarray(want)
    near(tc.decode(_t(enc), _t(pts), _t(cls)),
         jc.decode(jnp.asarray(enc), jnp.asarray(pts), jnp.asarray(cls)),
         "decode")
    with pytest.raises(ValueError):
        PointResidualCoder(mean_size=[[1.0, 0.0, 1.0]])


def test_point_head_box_targets_and_losses_match_jax():
    """``encode_point_targets``, ``decode_point_boxes`` (values and the
    predictions' cotangent) and ``get_loss`` (both terms and the cotangents
    of the logits and the box codes)."""
    rng = np.random.default_rng(21)
    gt, _ = _boxes(rng, 2 * 30)
    gt = gt[:, :8].reshape(2, 30, 8)
    pts = (gt[..., :3] + rng.normal(size=(2, 30, 3))).astype(np.float32)
    labels = rng.integers(-1, 4, (2, 30)).astype(np.int32)
    want = JHeadBox.encode_point_targets(jnp.asarray(pts), jnp.asarray(gt),
                                         jnp.asarray(labels), MEAN)
    near(PointHeadBox.encode_point_targets(_t(pts), _t(gt), _t(labels), MEAN),
         want, "targets")
    preds = rng.normal(size=(2, 30, 8)).astype(np.float32)
    g = rng.normal(size=(2, 30, 7)).astype(np.float32)
    wdec, vjp = jax.vjp(lambda p: JHeadBox.decode_point_boxes(
        jnp.asarray(pts), p, jnp.asarray(labels), MEAN), jnp.asarray(preds))
    tp = _t(preds).requires_grad_()
    got = PointHeadBox.decode_point_boxes(_t(pts), tp, _t(labels), MEAN)
    (got * _t(g)).sum().backward()
    near(got, wdec, "decoded")
    near(tp.grad, vjp(jnp.asarray(g))[0], "d preds")

    logits = rng.normal(size=(2, 30, 3)).astype(np.float32)
    targets = np.asarray(want)

    def jl(lg, bp):
        c, r = JHeadBox.get_loss(lg, bp, jnp.asarray(labels),
                                 jnp.asarray(targets), 3)
        return c + 2.0 * r, (c, r)

    (_, (wc, wr)), (gl, gb) = jax.value_and_grad(
        jl, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                          jnp.asarray(preds))
    tl, tb = _t(logits).requires_grad_(), _t(preds).requires_grad_()
    c, r = PointHeadBox.get_loss(tl, tb, _t(labels), _t(targets), 3)
    (c + 2.0 * r).backward()
    np.testing.assert_allclose([float(c.detach()), float(r.detach())],
                               [float(wc), float(wr)], rtol=1e-5)
    near(tl.grad, gl, "d logits")
    near(tb.grad, gb, "d box codes")


# ---------------------------------------------------------------- modules
def dyadic(x):
    """Coordinates on a 1/32 m grid: over a 12.8 m range every product and
    three-term sum of the 3-NN expansion is exact in f32, so JAX's d2 is
    exact whatever order XLA rounds it in (at a feature propagation's
    coinciding points too, where the expansion cancels)."""
    return (np.round(np.asarray(x) * 32) / 32).astype(np.float32)


def _frame_points(rng, n=200, c=1, pad=(0, 23)):
    xyz = dyadic(rng.uniform(PC_RANGE[:3], PC_RANGE[3:], (2, n, 3)))
    valid = np.arange(n)[None] < (n - np.array(pad))[:, None]
    xyz *= valid[..., None]
    feat = rng.normal(size=(2, n, c)).astype(np.float32) * valid[..., None]
    return xyz, feat, valid


def test_point_head_box_matches_jax():
    x = np.random.default_rng(22).normal(size=(2, 50, 12)).astype(np.float32)
    cfg = {"CLS_FC": [16], "REG_FC": [16, 8]}
    check_module(JHeadBox(model_cfg=cfg, input_channels=12, num_class=3),
                 PointHeadBox(cfg, 12, num_class=3), {"x": x},
                 lambda m, train, x: m(x, train=train), lambda m, x: m(x),
                 grad_inputs=("x",))


@pytest.mark.parametrize("npoint", [64, 150])
def test_sa_module_msg_matches_jax(npoint):
    """Two radii over 200 padded points (npoint 150 > 128: the row FPS
    path; 64 from 200: both are K2c's plain version here)."""
    xyz, feat, valid = _frame_points(np.random.default_rng(23))
    args = dict(npoint=npoint, radii=(0.8, 1.6), nsamples=(8, 16),
                mlps=((8, 8), (8, 12)))
    got, want = check_module(
        JSAModuleMSG(**args), SAModuleMSG(**args, in_channels=1),
        {"xyz": xyz, "feat": feat, "valid": valid},
        lambda m, train, xyz, feat, valid: m(xyz, feat, valid,
                                             train=train)[:2],
        lambda m, xyz, feat, valid: m(xyz, feat, valid)[:2],
        grad_inputs=("feat",))
    assert got[1].shape == (2, npoint, 20)


def test_fp_module_matches_jax():
    rng = np.random.default_rng(24)
    unknown, ufeat, _ = _frame_points(rng, 120, 5, pad=(0, 0))
    known, kfeat, _ = _frame_points(rng, 30, 7, pad=(0, 0))
    check_module(JFPModule((12, 6)), FPModule(12, (12, 6)),
                 {"u": unknown, "k": known, "uf": ufeat, "kf": kfeat},
                 lambda m, train, u, k, uf, kf: (m(u, k, uf, kf, train=train),),
                 lambda m, u, k, uf, kf: (m(u, k, uf, kf),),
                 grad_inputs=("uf", "kf"))


def test_pointnet2_msg_matches_jax():
    """The JAX suite's two-level config on 512 padded points on the 1/32 m
    grid (level 0 FPS over 512 rows, level 1 over 128: K2c's and K2b's
    plain versions)."""
    cfg = pointrcnn_cfg()["BACKBONE_3D"]
    xyz, feat, valid = _frame_points(np.random.default_rng(25), 512,
                                     pad=(0, 17))
    check_module(JPointNet2MSG(model_cfg=cfg, input_channels=1),
                 PointNet2MSG(cfg, input_channels=1),
                 {"xyz": xyz, "feat": feat, "valid": valid},
                 lambda m, train, xyz, feat, valid: (m(xyz, feat, valid,
                                                       train=train),),
                 lambda m, xyz, feat, valid: (m(xyz, feat, valid),),
                 grad_inputs=("feat",))


def test_pointrcnn_roi_head_matches_jax():
    """RoIs over the points (one holding more points than slots, one none):
    outputs, statistics, gradients, the cotangents of the point features
    and the RoIs."""
    rng = np.random.default_rng(26)
    xyz, feat, valid = _frame_points(rng, 300, 6)
    rois = np.concatenate([xyz[:, :5] + rng.normal(size=(2, 5, 3)).astype(
        np.float32) * 0.2, rng.uniform(1, 4, (2, 5, 3)),
        rng.uniform(-3, 3, (2, 5, 1))], -1).astype(np.float32)
    rois[:, 0, 3:6] = 8.0
    rois[:, -1, :3] = 300.0
    rv = np.array([[True] * 5, [True, True, True, False, True]])
    cfg = {"XYZ_UP_LAYER": [[8, 8]], "SHARED_FC": [16, 8]}
    check_module(JRoIHead(model_cfg=cfg, num_sampled_points=16),
                 PointRCNNRoIHead(cfg, 6, num_sampled_points=16),
                 {"xyz": xyz, "feat": feat, "valid": valid, "rois": rois,
                  "rv": rv},
                 lambda m, train, xyz, feat, valid, rois, rv: m(
                     xyz, feat, valid, rois, rv, train=train),
                 lambda m, xyz, feat, valid, rois, rv: m(xyz, feat, valid,
                                                         rois, rv),
                 grad_inputs=("feat", "rois"), grad_tol=1e-4)


# --------------------------------------------------------------- detector
def pointrcnn_batch(seed=0):
    """512 point rows a frame (17 padding rows in the second) on the 1/32 m
    grid, 120 of them within 0.1 m of each of two class-1 GT boxes (a box
    at any of them overlaps its GT by IoU > 0.7), the rest
    uniform over the range; the harness's voxel keys ride along unused."""
    rng = np.random.default_rng(seed)
    batch = make_batch(rng)
    gt = np.zeros((BATCH, MAX_GT, 8), np.float32)
    pts = np.zeros((BATCH * MAX_POINTS, 4), np.float32)
    valid = np.zeros(BATCH * MAX_POINTS, bool)
    for b in range(BATCH):
        centres = [[4.0 + b, -2.0, -1.0], [9.0, 2.5 - b, -1.2]]
        for j, c in enumerate(centres):
            gt[b, j] = [*c, 3.9, 1.6, 1.56, 0.05 - 0.1 * j, 1]
        n, lo = MAX_POINTS - 17 * b, b * MAX_POINTS
        xyz = rng.uniform(PC_RANGE[:3], PC_RANGE[3:], (n, 3))
        for j, c in enumerate(centres):
            xyz[120 * j:120 * (j + 1)] = np.array(c) + rng.uniform(
                -0.1, 0.1, (120, 3))
        pts[lo:lo + n, :3] = dyadic(xyz)
        pts[lo:lo + n, 3] = rng.uniform(0, 1, n)
        valid[lo:lo + n] = True
    return dict(batch, points=pts, points_valid=valid, gt_boxes=gt)


def near_mean_size_boxes(params):
    """The box head's codes near 0 with a cos of 1: boxes of the class mean
    size at each point, heading ~0."""
    out = params["point_head"]["reg_out"]
    out["kernel"] *= 0.01
    out["bias"][:] = 0.0
    out["bias"][6] = 1.0


def _j_pointrcnn_roi_inputs(m, b):
    xyz, feat, valid = m._points(b)
    pf = m.backbone_3d(xyz, feat, valid, train=True)
    cls_logits, box_preds = m.point_head(pf, train=True)
    labels = jnp.argmax(cls_logits, -1) + 1
    boxes = JHeadBox.decode_point_boxes(xyz, box_preds, labels, m.mean_sizes)
    rois, _, _, rvalid = j_rt.proposal_layer(
        boxes, jnp.max(jax.nn.sigmoid(cls_logits), -1) * valid, valid,
        labels=labels, **t_rt.nms_kwargs(m.roi_cfg, True))
    return {"point_features": pf}, rois, rvalid


@pytest.fixture(scope="module")
def pair():
    return make_pair(pointrcnn_cfg(), 1, _j_pointrcnn_roi_inputs,
                     batch=pointrcnn_batch(), tweak=near_mean_size_boxes)


def test_two_stage_forward_and_loss(pair):
    """The JAX suite's PointRCNN case as parity: eval outputs as sets, then
    the training loss, its terms, statistics and gradients."""
    assert type(pair["tm"]).__name__ == "PointRCNN"
    assert pair["tm"].max_points == MAX_POINTS
    got = check_eval(pair)
    assert torch.isfinite(got["final_boxes"]).all()
    check_train(pair, {"point_loss_cls", "point_loss_box", "rcnn_loss_cls",
                       "rcnn_loss_reg", "rpn_loss"})


def test_pointrcnn_roi_stage_matches_jax(pair):
    """The RoI stage alone on JAX's point features and RoIs: the loss, each
    RoI-head leaf, the cotangents of the point features and of the RoIs
    (the first stage's boxes: JAX stops no gradient there)."""
    xyz_j, _, valid_j = pair["jm"].apply(
        pair["variables"], pair["jb"], method=lambda m, b: m._points(b))
    xyz, _, valid = per_sample_points(pair["batch"], BATCH, MAX_POINTS)
    check_roi_stage(
        pair,
        lambda m, x, t, v: m.roi_head(xyz_j, x["point_features"], valid_j,
                                      t["rois"], v, train=True),
        lambda model, x, t, v: model.roi_head(xyz, x["point_features"], valid,
                                              t["rois"], v),
        rtol=1e-4)


def test_pointrcnn_bridge_round_trip(pair):
    check_round_trip(pair)


# ----------------------------------------------------- the shipped config
def test_pointrcnn_config_builds_on_cuda_by_default(monkeypatch):
    """``pointrcnn.yaml`` at its published widths: ``build_network`` raises
    without a card unless ``device="cpu"``; the level widths are the
    config's; both backbone names build through the registry."""
    cfg, kw = kitti_build_kw("pointrcnn")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_build(**kw)
    model = t_build(**kw, device="cpu")
    assert type(model).__name__ == "PointRCNN"
    assert model.max_points == cfg.DATA_CONFIG.MAX_POINTS == 16384
    b3d = model.backbone_3d
    assert [getattr(b3d, f"sa_{i}").npoint for i in range(4)] == [
        4096, 1024, 256, 64]
    assert b3d.sa_0.mlp_g0.mlp_0.in_features == 3 + 1
    assert [getattr(b3d, f"fp_{i}").mlp.mlp_0.in_features
            for i in range(4)] == [256 + 1, 512 + 96, 512 + 256, 1024 + 512]
    assert model.point_head.cls_out.out_features == 3
    assert model.point_head.reg_out.out_features == 8
    assert model.roi_head.up_0.mlp_0.in_features == 3 + 128
    assert model.roi_head.num_sampled_points == 512
    for name in ("PointNet2MSG", "PointNet2Backbone"):
        ctx = BuildCtx(3, ("Car",), (1, 1, 1), (1, 1, 1), (0,) * 6, 2, 1, 1,
                       num_point_features=4)
        mod = build_backbone_3d(dict(json.loads(json.dumps(
            cfg.MODEL.BACKBONE_3D)), NAME=name), ctx)
        assert isinstance(mod, PointNet2MSG) and mod.num_point_features == 128


def tiny_point_model(name, full):
    """``kitti_models/<name>.yaml``'s MODEL at narrow widths for the tiny
    KITTI-derived CPU config (12.8 m range, 32^3 cells, 1 024 point rows a
    frame)."""
    m = full["MODEL"]
    m["MAX_POINTS"] = 1024
    roi = m["ROI_HEAD"]
    for split in ("TRAIN", "TEST"):
        roi["NMS_CONFIG"][split].update(NMS_PRE_MAXSIZE=64,
                                        NMS_POST_MAXSIZE=16)
    roi["TARGET_CONFIG"]["ROI_PER_IMAGE"] = 16
    roi["SHARED_FC"] = [16, 16]
    if name == "pointrcnn":
        sa = m["BACKBONE_3D"]["SA_CONFIG"]
        sa.update(NPOINTS=[256, 64], RADIUS=[[0.4, 0.8], [0.8, 1.6]],
                  NSAMPLE=[[8, 16], [8, 16]],
                  MLPS=[[[8, 8], [8, 16]], [[16, 16], [16, 16]]])
        m["BACKBONE_3D"]["FP_MLPS"] = [[16, 16], [16, 16]]
        m["POINT_HEAD"].update(CLS_FC=[8], REG_FC=[8])
        roi.update(NUM_SAMPLED_POINTS=32, XYZ_UP_LAYER=[[16, 16]])
        return m
    m["BACKBONE_3D"].update(NUM_FILTERS=[8, 16, 16, 16], OUT_CHANNELS=16)
    pfe = m["PFE"]
    pfe.update(NUM_KEYPOINTS=128, NUM_OUTPUT_FEATURES=16)
    for layer in pfe["SA_LAYER"].values():
        layer["MLPS"] = [[8, 8]] * len(layer["MLPS"])
    m["POINT_HEAD"]["CLS_FC"] = [8]
    roi.update(GRID_SIZE=3)
    roi["ROI_GRID_POOL"]["MLPS"] = [[8, 8], [8, 8]]
    m["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"] = [
        a for a in m["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]
        if a["class_name"] in full["CLASS_NAMES"]]
    return m


@pytest.mark.parametrize("name", ["pv_rcnn", "pv_rcnn_plusplus", "pointrcnn"])
def test_point_detectors_entry_points_train_and_evaluate(name, tmp_path,
                                                         monkeypatch):
    """``tools/train_torch.py`` for one epoch (2 steps at the yaml's batch
    2; PV-RCNN's dropout 0.3 drawn from the entry point's generator) and
    ``tools/test_torch.py`` on its checkpoint, in-process on the CPU, on
    ``test_torch_second``'s tiny KITTI-derived data config with 1 024 raw
    point rows a frame (``MAX_POINTS``) and each model at narrow widths."""
    import yaml

    from mssvt_tpu_torch.config import cfg_from_yaml_file
    from mssvt_tpu_torch.utils.edict import EasyDict as TDict
    from test_torch_cli import _tool
    from test_torch_second import ROOT, _tiny_kitti_cfg

    monkeypatch.setenv("MSSVT_OUTPUT_ROOT", str(tmp_path / "output"))
    path = _tiny_kitti_cfg(tmp_path, "second")
    cfg = yaml.safe_load(path.read_text())
    full = json.loads(json.dumps(cfg_from_yaml_file(
        str(ROOT / f"tools/cfgs/kitti_models/{name}.yaml"), TDict())))
    assert full["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"] == 2
    m = tiny_point_model(name, full)
    for key in ("BACKBONE_2D", "POST_PROCESSING"):
        if key in m:
            m[key] = cfg["MODEL"][key]
    cfg.update(MODEL=m, CLASS_NAMES=full["CLASS_NAMES"])
    cfg["DATA_CONFIG"]["MAX_POINTS"] = 1024
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


def test_pointrcnn_targets_read_roi_per_image_only(monkeypatch):
    """JAX's PointRCNN hands the proposal targets ``ROI_PER_IMAGE`` alone
    (``point_rcnn.py:170-173``): ``pointrcnn.yaml``'s CLS_BG_THRESH 0.6 and
    CLS_BG_THRESH_LO 0.05 are read by neither package, the defaults (0.55,
    0.1) stand. The port follows (ROADMAP Queue 3)."""
    from mssvt_tpu_torch.models.detectors import point_rcnn
    from mssvt_tpu_torch.utils.edict import EasyDict as TDict
    from test_torch_roi import build_kw

    cfg = json.loads(json.dumps(pointrcnn_cfg()))
    cfg["ROI_HEAD"]["TARGET_CONFIG"].update(CLS_BG_THRESH=0.6,
                                            CLS_BG_THRESH_LO=0.05)
    seen = []
    real = point_rcnn.assign_proposal_targets

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(point_rcnn, "assign_proposal_targets", spy)
    model = t_build(TDict(cfg), **build_kw(1), num_point_features=4,
                    device="cpu").train()
    out = model({k: _t(v) for k, v in pointrcnn_batch().items()})
    assert seen == [{"roi_per_image": 16}] and torch.isfinite(out["loss"])
