"""PartA2: UNetV2, RoI-aware pooling, the point targets and part head, and
the detector, the port against the JAX package on the CPU.

- ``roiaware_pool3d``: the JAX suite's brute-force test on the port, then
  against JAX (max and avg) with a cell whose maximum is tied across three
  points: values exact, ``empty`` exact, the cotangent of the features to
  1e-6 (JAX splits a tied maximum's cotangent evenly; so must the port);
- ``intra_part_targets`` (the JAX suite's canonical points, then seeded
  ones against JAX), ``assign_point_targets`` exactly, the part head's
  losses and their cotangents to 1e-5;
- ``UNetV2`` at the tiny widths in training: both outputs, every
  parameter leaf's gradient and the input cotangent to 1e-5 of their
  size, the updated statistics to 1e-5 (its inverse convs' backward
  gathers over the down layers' strided tables);
- the tiny detector (``test_parta2.parta2_cfg``, the JAX suite's ``slow``
  test at its sizes, DP_RATIO 0) through ``test_torch_roi``'s harness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.models.backbones_3d.spconv_unet import UNetV2 as JUNetV2
from mssvt_tpu.models.dense_heads import point_head as j_point_head
from mssvt_tpu.models.dense_heads import point_intra_part_head as j_part
from mssvt_tpu.ops.roiaware_pool import roiaware_pool3d as j_pool
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.core.sparse import SparseVoxels
from mssvt_tpu_torch.models.backbones_3d.spconv_unet import UNetV2
from mssvt_tpu_torch.models.dense_heads.point_head import assign_point_targets
from mssvt_tpu_torch.models.dense_heads.point_intra_part_head import (
    PointIntraPartOffsetHead,
    intra_part_targets,
)
from mssvt_tpu_torch.ops.roiaware_pool import roiaware_pool3d
from test_parta2 import parta2_cfg
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

torch.set_num_threads(2)


def test_roiaware_pool_matches_bruteforce(rng):
    """The JAX suite's brute-force test, on the port."""
    n, r, g, c = 64, 3, 4, 5
    pts = rng.uniform(-5, 5, (1, n, 3)).astype(np.float32)
    feats = rng.normal(size=(1, n, c)).astype(np.float32)
    valid = np.ones((1, n), bool)
    valid[0, 50:] = False
    rois = np.zeros((1, r, 7), np.float32)
    rois[0, 0] = [0, 0, 0, 4, 3, 2, 0.4]
    rois[0, 1] = [2, 2, 0, 3, 3, 3, -0.7]
    rois[0, 2] = [1, 1, 1, 2, 2, 2, 0.0]
    roi_valid = np.array([[True, True, False]])
    for pool in ("max", "avg"):
        got, empty = roiaware_pool3d(_t(pts), _t(feats), _t(valid), _t(rois),
                                     _t(roi_valid), g, pool)
        cnt = np.zeros((1, r, g, g, g), np.int64)
        acc = np.zeros((1, r, g, g, g, c), np.float64)
        mx = np.full((1, r, g, g, g, c), -np.inf)
        for ri in range(r):
            if not roi_valid[0, ri]:
                continue
            cx0, cy0, cz0, dx, dy, dz, h = rois[0, ri]
            for pi in range(n):
                if not valid[0, pi]:
                    continue
                lx = ((pts[0, pi, 0] - cx0) * np.cos(-h)
                      - (pts[0, pi, 1] - cy0) * np.sin(-h))
                ly = ((pts[0, pi, 0] - cx0) * np.sin(-h)
                      + (pts[0, pi, 1] - cy0) * np.cos(-h))
                lz = pts[0, pi, 2] - cz0
                ux, uy, uz = ((lx / dx + .5) * g, (ly / dy + .5) * g,
                              (lz / dz + .5) * g)
                if not (0 <= ux < g and 0 <= uy < g and 0 <= uz < g):
                    continue
                cell = (0, ri, int(ux), int(uy), int(uz))
                cnt[cell] += 1
                acc[cell] += feats[0, pi]
                mx[cell] = np.maximum(mx[cell], feats[0, pi])
        e = cnt == 0
        np.testing.assert_array_equal(empty.numpy(), e)
        exp = (np.where(e[..., None], 0, mx) if pool == "max" else
               np.where(e[..., None], 0, acc / np.clip(cnt, 1, None)[..., None]))
        np.testing.assert_allclose(got.numpy(), exp.astype(np.float32),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_roiaware_pool_matches_jax_with_a_tied_cell(pool):
    rng = np.random.default_rng(11)
    n, r, g, c = 300, 6, 4, 5
    pts = rng.uniform(-4, 4, (2, n, 3)).astype(np.float32)
    feats = rng.normal(size=(2, n, c)).astype(np.float32)
    valid = rng.random((2, n)) < 0.9
    rois = np.concatenate([rng.uniform(-1, 1, (2, r, 3)),
                           rng.uniform(2, 5, (2, r, 3)),
                           rng.uniform(-3, 3, (2, r, 1))], -1).astype(np.float32)
    rois[0, 0] = [0, 0, 0, 4, 4, 4, 0]  # cells of 1 m
    roi_valid = rng.random((2, r)) < 0.8
    roi_valid[0, 0] = True
    # three points in cell (2, 2, 2) of RoI 0 with the same maximum
    pts[0, :3] = [[0.3, 0.4, 0.5], [0.6, 0.2, 0.7], [0.5, 0.5, 0.5]]
    valid[0, :4] = True
    feats[0, :3] = 7.0
    feats[0, 3] = feats[0, 0] - 1.0
    pts[0, 3] = [0.2, 0.2, 0.2]
    cot = rng.normal(size=(2, r, g, g, g, c)).astype(np.float32)

    def jf(f):
        return j_pool(jnp.asarray(pts), f, jnp.asarray(valid),
                      jnp.asarray(rois), jnp.asarray(roi_valid), g, pool)

    (want, w_empty), vjp = jax.vjp(jf, jnp.asarray(feats))
    (g_feats,) = vjp((jnp.asarray(cot),
                      np.zeros(w_empty.shape, jax.dtypes.float0)))
    tf = _t(feats).requires_grad_()
    got, empty = roiaware_pool3d(_t(pts), tf, _t(valid), _t(rois),
                                 _t(roi_valid), g, pool)
    got.backward(_t(cot))
    np.testing.assert_array_equal(empty.numpy(), np.asarray(w_empty))
    near(got, want, "pooled", 1e-6)
    near(tf.grad, g_feats, "d features", 1e-6)
    assert 0 < (~empty).sum() < empty.numel()
    if pool == "max":  # the tied points share the cell's cotangent evenly
        one = np.zeros_like(cot)
        one[0, 0, 2, 2, 2] = 1.0
        (g_one,) = vjp((jnp.asarray(one),
                        np.zeros(w_empty.shape, jax.dtypes.float0)))
        tf.grad = None
        got, _ = roiaware_pool3d(_t(pts), tf, _t(valid), _t(rois),
                                 _t(roi_valid), g, pool)
        got.backward(_t(one))
        want_one = np.zeros_like(feats)
        want_one[0, :3] = 1.0 / 3
        np.testing.assert_allclose(np.asarray(g_one), want_one, atol=1e-7)
        np.testing.assert_allclose(tf.grad.numpy(), want_one, atol=1e-7)


def test_intra_part_targets_canonical():
    """The JAX suite's three points, then seeded points against JAX."""
    gt = np.zeros((1, 2, 8), np.float32)
    gt[0, 0] = [10, 0, 0, 4, 2, 2, 0, 1]
    pts = np.array([[[10, 0, 0], [12, 0, 0], [10, -1, -1]]], np.float32)
    labels = np.array([[1, 1, 1]], np.int32)
    gt_of = np.broadcast_to(gt[0, 0], (1, 3, 8))
    part = intra_part_targets(_t(pts), _t(gt_of), _t(labels)).numpy()
    np.testing.assert_allclose(part[0], [[0.5, 0.5, 0.5], [1.0, 0.5, 0.5],
                                         [0.5, 0.0, 0.0]], atol=1e-6)

    rng = np.random.default_rng(12)
    pts = rng.uniform(-3, 3, (2, 50, 3)).astype(np.float32)
    gt_of = np.concatenate([rng.uniform(-1, 1, (2, 50, 3)),
                            rng.uniform(1, 4, (2, 50, 3)),
                            rng.uniform(-3, 3, (2, 50, 1)),
                            np.ones((2, 50, 1))], -1).astype(np.float32)
    labels = rng.integers(-1, 3, (2, 50)).astype(np.int32)
    near(intra_part_targets(_t(pts), _t(gt_of), _t(labels)),
         j_part.intra_part_targets(jnp.asarray(pts), jnp.asarray(gt_of),
                                   jnp.asarray(labels)), "part targets")


def _point_scene(rng, n=400):
    gt = np.zeros((BATCH, 6, 8), np.float32)
    gt[:, :3, :7] = np.concatenate([rng.uniform(-3, 3, (BATCH, 3, 2)),
                                    rng.uniform(-0.5, 0.5, (BATCH, 3, 1)),
                                    rng.uniform(1.5, 4, (BATCH, 3, 3)),
                                    rng.uniform(-3, 3, (BATCH, 3, 1))], -1)
    gt[:, :3, 7] = [1, 2, 3]
    pts = rng.uniform(-5, 5, (BATCH, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 2, (BATCH, n))
    valid = rng.random((BATCH, n)) < 0.9
    return pts, valid, gt


def test_point_targets_and_part_losses_match_jax():
    """``assign_point_targets`` exactly (foreground, background, the
    enlarged boxes' ignore band, padding) and the part head's two losses
    with their logit cotangents to 1e-5."""
    rng = np.random.default_rng(13)
    pts, valid, gt = _point_scene(rng)
    w_labels, w_gt = j_point_head.assign_point_targets(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(gt))
    labels, gt_of = assign_point_targets(_t(pts), _t(valid), _t(gt))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(w_labels))
    np.testing.assert_array_equal(gt_of.numpy(), np.asarray(w_gt))
    assert {-1, 0, 1, 2, 3} <= set(np.unique(labels.numpy()).tolist())
    seg = rng.normal(size=(BATCH, 400, 1)).astype(np.float32)
    part = rng.normal(size=(BATCH, 400, 3)).astype(np.float32)

    def jf(s, p):
        a, b, _ = j_part.PointIntraPartOffsetHead.get_loss(
            s, p, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(gt))
        return a + 2.0 * b, (a, b)

    (_, (ws, wp)), (gs, gp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(seg), jnp.asarray(part))
    ts, tp = _t(seg).requires_grad_(), _t(part).requires_grad_()
    a, b, _ = PointIntraPartOffsetHead.get_loss(ts, tp, _t(pts), _t(valid),
                                                _t(gt))
    (a + 2.0 * b).backward()
    np.testing.assert_allclose(float(a.detach()), float(ws), rtol=1e-5)
    np.testing.assert_allclose(float(b.detach()), float(wp), rtol=1e-5)
    near(ts.grad, gs, "d seg")
    near(tp.grad, gp, "d part")


@pytest.fixture(scope="module")
def sites():
    rng = np.random.default_rng(14)
    cap = 512
    coords = np.unique(np.stack([
        rng.integers(0, BATCH, 900), rng.integers(0, GRID[2], 900),
        rng.integers(0, GRID[1] // 2, 900), rng.integers(0, GRID[0] // 2, 900)],
        1), axis=0)
    coords = coords[rng.permutation(len(coords))][:400]
    pad = np.full((cap, 4), -1, np.int32)
    pad[:len(coords)] = coords
    valid = np.arange(cap) < len(coords)
    feat = (rng.normal(size=(cap, 4)) * valid[:, None]).astype(np.float32)
    return pad, valid, feat


def test_unet_v2_train_matches_jax(sites):
    pad, valid, feat = sites
    cap = len(valid)
    rng = np.random.default_rng(15)
    jm = JUNetV2(input_capacity=cap, num_filters=(8, 16, 16, 16),
                 out_channels=32)

    def mk(f):
        return JSV.create(features=f, coords=jnp.asarray(pad),
                          valid=jnp.asarray(valid), batch_size=BATCH,
                          spatial_shape=GRID, voxel_size=VOXEL_SIZE,
                          point_cloud_range=PC_RANGE)

    variables = jax.device_get(jax.jit(lambda f: jm.init(
        jax.random.PRNGKey(0), mk(f)))(jnp.asarray(feat)))

    def jf(p, x):
        (e, pt), upd = jm.apply({"params": p,
                                 "batch_stats": variables["batch_stats"]},
                                mk(x), train=True, mutable=["batch_stats"])
        return (e.features, pt.features), upd["batch_stats"]

    (je, jp), vjp, stats = jax.vjp(jax.jit(jf), variables["params"],
                                   jnp.asarray(feat), has_aux=True)
    ge = rng.normal(size=je.shape).astype(np.float32)
    gp = rng.normal(size=jp.shape).astype(np.float32)
    g_params, g_x = vjp((jnp.asarray(ge), jnp.asarray(gp)))
    tm = UNetV2(4, cap, GRID, (8, 16, 16, 16), 32).train()
    assert load_flax_variables(tm, variables) == len(leaves(variables))
    x = _t(feat).requires_grad_()
    te, tp = tm(SparseVoxels.create(x, _t(pad), _t(valid), BATCH, GRID,
                                    VOXEL_SIZE, PC_RANGE))
    ((te.features * _t(ge)).sum() + (tp.features * _t(gp)).sum()).backward()
    near(te.features, je, "encoded")
    near(tp.features, jp, "point features")
    near(x.grad, g_x, "d input")
    got = leaves(to_flax_tree(tm, "params", grads=True))
    want = leaves(g_params)
    assert set(got) == set(want) and any("inv_kernel" in k for k in want)
    for k, w in want.items():
        err = np.sqrt(((got[k] - w) ** 2).sum())
        assert err <= 1e-5 * np.sqrt((w ** 2).sum()), (k, err)
    got_s = leaves(to_flax_tree(tm, "batch_stats"))
    for k, w in leaves(stats).items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------------- the detector
def _j_roi_inputs(m, b):
    from mssvt_tpu.models.detectors.generic_post import apply_vfe
    from mssvt_tpu.models.roi_heads import roi_head_template as j_rt
    from mssvt_tpu_torch.models.roi_heads.roi_head_template import nms_kwargs

    sp = JSV.create(features=apply_vfe(m.vfe, b, train=True),
                    coords=b["voxel_coords"], valid=b["voxel_valid"],
                    batch_size=m.batch_size, spatial_shape=m.grid_size,
                    voxel_size=m.voxel_size,
                    point_cloud_range=m.point_cloud_range)
    encoded, sp_points = m.backbone_3d(sp, train=True)
    preds = m.dense_head(m.backbone_2d(encoded.bev(), train=True), train=True)
    seg, part = m.point_head(sp_points.features, train=True)
    boxes, scores_mc = m.dense_head.generate_predicted_boxes(preds)
    rois, _, _, rvalid = j_rt.proposal_layer(
        boxes[..., :7], jnp.max(scores_mc, -1),
        jnp.ones(scores_mc.shape[:2], bool), **nms_kwargs(m.roi_cfg, True))
    nb = m.batch_size
    part_feats = jnp.concatenate([jax.nn.sigmoid(part), jax.nn.sigmoid(seg)],
                                 -1).reshape(nb, -1, 4)
    return ({"part_feats": part_feats,
             "seg_feats": sp_points.features.reshape(nb, -1,
                                                     sp_points.features.shape[-1])},
            rois, rvalid)


@pytest.fixture(scope="module")
def pair():
    p = make_pair(parta2_cfg(), 3, _j_roi_inputs)
    with torch.no_grad():
        sp = p["tm"](p["batch"], return_intermediates=True)["points"]
    p["points"] = (sp.metric_centers().reshape(BATCH, -1, 3),
                   sp.valid.reshape(BATCH, -1))
    return p


def test_parta2_eval_matches_jax(pair):
    assert type(pair["tm"]).__name__ == "PartA2Net"
    check_eval(pair)


def test_parta2_loss_and_gradients_match_jax(pair):
    check_train(pair, {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                       "rpn_loss", "rcnn_loss_cls", "rcnn_loss_reg",
                       "point_loss_seg", "point_loss_part"})


def test_parta2_roi_stage_matches_jax(pair):
    pts, pvalid = pair["points"]

    def j_head(m, x, t, v):
        return m.roi_head(jnp.asarray(pts.numpy()), x["part_feats"],
                          x["seg_feats"], jnp.asarray(pvalid.numpy()),
                          t["rois"], v, train=True)

    def t_head(model, x, t, v):
        return model.roi_head(pts, x["part_feats"], x["seg_feats"], pvalid,
                              t["rois"], v)

    check_roi_stage(pair, j_head, t_head)


def test_parta2_bridge_round_trip(pair):
    check_round_trip(pair)
