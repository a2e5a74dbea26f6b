"""CT3D: the port against the JAX package on the CPU (f32, numpy-seeded
inputs, flax-initialised weights carried by ``bridge.load_flax_variables``).

- ``sample_roi_points``: an empty RoI, a RoI of more hits than
  ``num_points`` and one of fewer, invalid points among the hits: exactly
  JAX's rows (the first hits in point order, the first pick repeated, an
  empty RoI zero);
- ``_spherical`` on vectors with exact-zero rows (a padded RoI): values and
  the cotangent to 1e-5, finite;
- ``CTransformer`` at the sizes of the JAX suite's reference-source test
  (d 16, 2 heads, 2 + 2 layers), held against the JAX module instead of
  the reference: outputs, every parameter's gradient and the input's
  cotangent within 1e-5 of their largest magnitude;
- ``CT3DHead`` with a padded RoI: as ``CTransformer``, plus the RoIs'
  cotangent;
- the tiny CT3D_3CAT (``test_ct3d.py``'s config, CAT_THRE at 0.5 for Car)
  through ``test_torch_roi``'s harness: eval detections (gated) as sets a
  frame to 1e-4, the training loss and its terms to 1e-5, gradients within
  1e-3 of the global norm, and the RoI stage alone fed JAX's RoIs (loss to
  1e-5, each head leaf and the cotangents of the RoIs and the points to
  1e-4).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.models.model_utils.ctrans import CTransformer as JCT
from mssvt_tpu.models.roi_heads import ct3d_head as jh
from mssvt_tpu_torch.models.model_utils.ctrans import CTransformer
from mssvt_tpu_torch.models.roi_heads import ct3d_head as th
from test_ct3d import _ct3d_cfg
from test_torch_pointnet2 import check_module
from test_torch_roi import (
    BATCH,
    MAX_VOXELS,
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


def _roi_points(rng, b, p, rois, per_roi):
    """(b, p, 4) points: ``per_roi[j]`` of them around RoI j of each frame
    (inside its cylinder; the first RoI's scattered over the first half of
    the rows, the others' in runs after it), the rest far away, every 7th
    one invalid."""
    pts = np.zeros((b, p, 4), np.float32)
    pts[..., :2] = rng.uniform(40, 60, (b, p, 2))
    pts[..., 2:] = rng.uniform(0, 1, (b, p, 2))
    for i in range(b):
        at = p // 2
        for j, n in enumerate(per_roi):
            if j == 0:
                idx = rng.permutation(p // 2)[:n]
            else:
                idx, at = np.arange(at, at + n), at + n
            pts[i, idx, :2] = rois[i, j, :2] + rng.uniform(-0.5, 0.5, (n, 2))
    valid = np.ones((b, p), bool)
    valid[:, ::7] = False
    return pts, valid


def test_sample_roi_points_matches_jax():
    rng = np.random.default_rng(0)
    rois = np.zeros((2, 3, 7), np.float32)
    rois[..., :2] = [[-8.0, -8.0], [0.0, 0.0], [8.0, 8.0]]
    rois[..., 3:6] = [2.0, 1.5, 1.5]
    pts, valid = _roi_points(rng, 2, 96, rois, (30, 5, 0))
    want = np.asarray(jh.sample_roi_points(jnp.asarray(pts),
                                           jnp.asarray(valid),
                                           jnp.asarray(rois), 16))
    got = th.sample_roi_points(_t(pts), _t(valid), _t(rois), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 2] == 0).all()  # the empty RoI
    assert (got[:, 1, 4:] == got[:, 1, :1]).all()  # fewer hits: the first
    full = got[:, 0]
    assert len({tuple(r) for r in full[0]}) == 16  # more hits: 16 distinct


def test_spherical_gradient_on_zero_rows():
    rng = np.random.default_rng(1)
    rel = rng.normal(size=(3, 5, 27)).astype(np.float32)
    rel[1] = 0.0  # a padded RoI
    rel[2, :2, 3:9] = 0.0  # points on two keypoints
    diag = np.array([2.0, 0.0, 3.0], np.float32)[:, None, None]
    ct = rng.normal(size=(3, 5, 27)).astype(np.float32)
    want, vjp = jax.vjp(jh._spherical, jnp.asarray(rel), jnp.asarray(diag))
    g_rel, g_diag = vjp(jnp.asarray(ct))
    tr, td = _t(rel).requires_grad_(), _t(diag).requires_grad_()
    got = th._spherical(tr, td)
    got.backward(_t(ct))
    near(got, want, "spherical")
    assert torch.isfinite(tr.grad).all() and torch.isfinite(td.grad).all()
    near(tr.grad, g_rel, "d rel")
    near(td.grad, g_diag, "d diag")


# analytically zero gradients: down_b shifts every channel of the
# cross-attention's output equally, which the LayerNorm after it (norm2)
# removes; a key bias shifts a query's scores equally, which the softmax
# removes
ZERO_GRAD = ("['multihead_attn']['down_b']", "['self_attn']['k_b']")


def test_ctransformer_matches_jax():
    """The twin of ``test_ctransformer_parity_vs_reference_source``."""
    d, heads, enc_l, dec_l, ff = 16, 2, 2, 2, 32
    src = np.random.default_rng(1).normal(size=(3, 10, d)).astype(np.float32)
    jm = JCT(d_model=d, nhead=heads, num_encoder_layers=enc_l,
             num_decoder_layers=dec_l, dim_feedforward=ff, num_queries=1)
    tm = CTransformer(d, heads, enc_l, dec_l, ff, 1)
    got, _ = check_module(jm, tm, {"src": src},
                          lambda m, train, src: (m(src),),
                          lambda m, src: (m(src),), grad_inputs=("src",),
                          zero_grad_leaves=ZERO_GRAD)
    assert got[0].shape == (3, 1, d)


TINY_T = {"num_queries": 1, "hidden_dim": 32, "num_points": 16, "nheads": 2,
          "enc_layers": 1, "dec_layers": 1, "dim_feedforward": 32}


def test_ct3d_head_matches_jax():
    rng = np.random.default_rng(2)
    rois = np.zeros((2, 4, 7), np.float32)
    rois[..., :2] = rng.uniform(-8, 8, (2, 4, 2))
    rois[..., 2] = rng.uniform(-1, 0, (2, 4))
    rois[..., 3:6] = rng.uniform(1.0, 4.0, (2, 4, 3))
    rois[..., 6] = rng.uniform(-3, 3, (2, 4))
    rois[1, 3] = 0.0  # a padded RoI
    rvalid = np.ones((2, 4), bool)
    rvalid[1, 3] = False
    pts, valid = _roi_points(rng, 2, 128, rois, (40, 6, 0, 3))
    cfg = {"Transformer": TINY_T}
    got, _ = check_module(
        jh.CT3DHead(model_cfg=cfg), th.CT3DHead(cfg),
        {"points": pts, "valid": valid, "rois": rois, "rvalid": rvalid},
        lambda m, train, points, valid, rois, rvalid: m(
            points, valid, rois, rvalid, train=train),
        lambda m, points, valid, rois, rvalid: m(points, valid, rois, rvalid),
        grad_inputs=("rois", "points"), zero_grad_leaves=ZERO_GRAD)
    assert got[0].shape == (2, 4) and float(got[0][1, 3]) == 0.0


# ------------------------------------------------------------- detector
MAX_POINTS = 512


def ct3d_cfg():
    cfg = json.loads(json.dumps(_ct3d_cfg()))
    cfg["POST_PROCESSING"]["CAT_THRE"] = {"Car": 0.5, "Ped": 0.0, "Cyc": 0.0}
    return cfg


def ct3d_batch(rng):
    """The harness's tiny voxel batch and GT boxes near anchors, with
    ``MAX_POINTS`` raw points a frame: a third around the GT boxes, the
    rest uniform over the range, 31 padding rows in the second frame."""
    batch = make_batch(rng)
    pts = np.zeros((BATCH, MAX_POINTS, 4), np.float32)
    valid = np.zeros((BATCH, MAX_POINTS), bool)
    lo, hi = np.array(PC_RANGE[:3]), np.array(PC_RANGE[3:])
    for b in range(BATCH):
        n = MAX_POINTS - 31 * b
        pts[b, :n, :3] = rng.uniform(lo, hi, (n, 3))
        gts = batch["gt_boxes"][b][batch["gt_boxes"][b, :, 7] > 0]
        for j, g in enumerate(gts):
            sl = slice(j * 80, j * 80 + 80)
            pts[b, sl, :3] = g[:3] + rng.uniform(-1.5, 1.5, (80, 3)) * [
                1.0, 0.6, 0.5]
        pts[b, :n, 3] = rng.uniform(0, 1, n)
        valid[b, :n] = True
    batch["points"] = pts.reshape(-1, 4)
    batch["points_valid"] = valid.reshape(-1)
    return batch


def _j_ct3d_roi_inputs(m, b):
    from mssvt_tpu.core.sparse import SparseVoxels as JSV
    from mssvt_tpu.models.detectors.generic_post import apply_vfe
    from mssvt_tpu.models.roi_heads import roi_head_template as j_rt
    from mssvt_tpu_torch.models.roi_heads.roi_head_template import nms_kwargs

    sp = JSV.create(features=apply_vfe(m.vfe, b, train=True),
                    coords=b["voxel_coords"], valid=b["voxel_valid"],
                    batch_size=m.batch_size, spatial_shape=m.grid_size,
                    voxel_size=m.voxel_size,
                    point_cloud_range=m.point_cloud_range)
    f2 = m.backbone_2d(m.backbone_3d(sp, train=True).bev(), train=True)
    preds = m.dense_head(f2, train=True)
    boxes, scores_mc = m.dense_head.generate_predicted_boxes(preds)
    rois, _, _, rvalid = j_rt.proposal_layer(
        boxes[..., :7], jnp.max(scores_mc, -1),
        jnp.ones(scores_mc.shape[:2], bool),
        labels=jnp.argmax(scores_mc, -1) + 1, **nms_kwargs(m.roi_cfg, True))
    return {"points": m._points(b)[0]}, rois, rvalid


@pytest.fixture(scope="module")
def ct3d():
    pair = make_pair(ct3d_cfg(), 1, _j_ct3d_roi_inputs,
                     batch=ct3d_batch(np.random.default_rng(3)))
    assert type(pair["tm"]).__name__ == "CT3D3CAT"
    assert pair["tm"].max_points == MAX_POINTS and MAX_VOXELS == 256
    return pair


def test_ct3d_eval_matches_jax(ct3d):
    got = check_eval(ct3d)
    scores = got["final_scores"][got["final_mask"]]
    assert float(scores.min()) >= 0.5  # CAT_THRE gates the lower scores
    with torch.no_grad():
        raw = ct3d["tm"](ct3d["batch"], return_intermediates=True)
    assert int(raw["roi_valid"].sum()) > int(got["final_mask"].sum())


def test_ct3d_loss_and_gradients_match_jax(ct3d):
    """The first decoder layer starts from a zero target and flax's zero
    biases: its self-attention is a softmax over one key (exactly 1) of
    values that are the zero bias, and its norm1 normalises a zero vector,
    so the query, key, value and output kernels, the query and key biases
    and norm1's scale get exactly zero gradient in both packages."""
    check_train(ct3d, {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                       "rpn_loss", "rcnn_loss_cls", "rcnn_loss_reg"},
                zero_leaves=("['dec0']['self_attn']['q_",
                             "['dec0']['self_attn']['k_",
                             "['dec0']['self_attn']['v_w']",
                             "['dec0']['self_attn']['out_w']",
                             "['dec0']['norm1']['scale']"))


def test_ct3d_roi_stage_matches_jax(ct3d):
    pvalid = ct3d["jb"]["points_valid"].reshape(BATCH, MAX_POINTS)
    check_roi_stage(
        ct3d,
        lambda m, x, t, v: m.roi_head(x["points"], pvalid, t["rois"], v,
                                      train=True),
        lambda model, x, t, v: model.roi_head(
            x["points"], torch.as_tensor(np.array(pvalid)), t["rois"], v),
        zero_grad_leaves=ZERO_GRAD)


def test_ct3d_bridge_round_trip(ct3d):
    check_round_trip(ct3d)


def test_ct3d_yaml_builds_and_needs_max_points_in_data_config(monkeypatch):
    """``ct3d_3cat.yaml`` at its published widths builds on the card by
    default (on the CPU when asked) with MODEL.MAX_POINTS raw rows; its
    DATA_CONFIG leaves MAX_POINTS out (``pv_rcnn.yaml`` sets it), so its
    dataset, in either package, yields no raw points: the entry points
    need it passed through (chip_smoke 14b does)."""
    from test_torch_registry import _build_kw, _model_names

    from mssvt_tpu_torch.models import build_network

    cfg, kw = _build_kw(_model_names()["CT3D_3CAT"])
    assert cfg.MODEL.MAX_POINTS == 16384
    assert "MAX_POINTS" not in cfg.DATA_CONFIG
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_network(cfg.MODEL, **kw)
    model = build_network(cfg.MODEL, **kw, device="cpu")
    assert model.max_points == 16384 and model.roi_head.num_sample == 256
    t = model.roi_head.transformer
    assert (t.num_encoder_layers, t.num_decoder_layers) == (3, 3)
    assert t.enc0.linear1.out_features == 512
    assert model.roi_head.up_dimension.layer2.out_features == 256


def test_ct3d_entry_points_train_and_evaluate(tmp_path, monkeypatch):
    """``tools/train_torch.py`` for one epoch (2 steps at batch 2) and
    ``tools/test_torch.py`` on its checkpoint, in-process on the CPU, on
    ``test_torch_second``'s tiny KITTI-derived data config with 1 024 raw
    point rows a frame, ``ct3d_3cat.yaml``'s model at narrow widths."""
    import yaml

    from mssvt_tpu_torch.config import cfg_from_yaml_file
    from mssvt_tpu_torch.utils.edict import EasyDict as TDict
    from test_torch_cli import _tool
    from test_torch_second import ROOT, _tiny_kitti_cfg

    monkeypatch.setenv("MSSVT_OUTPUT_ROOT", str(tmp_path / "output"))
    path = _tiny_kitti_cfg(tmp_path, "second")
    cfg = yaml.safe_load(path.read_text())
    full = json.loads(json.dumps(cfg_from_yaml_file(
        str(ROOT / "tools/cfgs/kitti_models/ct3d_3cat.yaml"), TDict())))
    m = full["MODEL"]
    m["MAX_POINTS"] = 1024
    m["BACKBONE_3D"].update(NUM_FILTERS=[8, 16, 16, 16], OUT_CHANNELS=16)
    m["ROI_HEAD"]["Transformer"].update(TINY_T)
    for split in ("TRAIN", "TEST"):
        m["ROI_HEAD"]["NMS_CONFIG"][split].update(NMS_PRE_MAXSIZE=64,
                                                  NMS_POST_MAXSIZE=16)
    m["ROI_HEAD"]["TARGET_CONFIG"]["ROI_PER_IMAGE"] = 16
    m["BACKBONE_2D"] = cfg["MODEL"]["BACKBONE_2D"]
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
