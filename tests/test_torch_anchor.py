"""The port's pillar VFEs, scatter, box coder, losses and anchor head
against the JAX package, on the CPU.

Same numpy-seeded inputs through ``mssvt_tpu`` and ``mssvt_tpu_torch``,
weights carried across by ``bridge.py``. Tolerances: anchors, their layout
and the assigned labels exactly; the VFEs, the coder, the regression
targets and every loss to rtol 1e-5 (the same f32 math in another order);
the post-processed detections as equal sets of boxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.models import losses as j_losses
from mssvt_tpu.models.backbones_2d.map_to_bev import PointPillarScatter as JPPS
from mssvt_tpu.models.backbones_3d import vfe as j_vfe
from mssvt_tpu.models.dense_heads import anchor_head as j_ah
from mssvt_tpu.models.detectors.generic_post import (
    post_process_anchor as j_post,
)
from mssvt_tpu.utils.box_coder import ResidualCoder as JCoder
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.models import losses as t_losses
from mssvt_tpu_torch.models.backbones_2d.map_to_bev import (
    PointPillarScatter as TPPS,
)
from mssvt_tpu_torch.models.backbones_3d import vfe as t_vfe
from mssvt_tpu_torch.models.dense_heads import anchor_head as t_ah
from mssvt_tpu_torch.models.detectors.generic_post import (
    post_process_anchor as t_post,
)
from mssvt_tpu_torch.utils.box_coder import ResidualCoder as TCoder
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_anchor_layout import CFGS, GRID, PCR, STRIDE

torch.set_num_threads(2)
CLOSE = dict(rtol=1e-5, atol=1e-5)
VS = (0.4, 0.4, 0.25)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, name=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=name,
                               **CLOSE)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------ the VFEs
def _voxels(seed, v=24, p=6, c=4):
    rng = np.random.default_rng(seed)
    npts = rng.integers(0, p + 1, v).astype(np.float32)
    mask = np.arange(p)[None, :] < npts[:, None]
    voxels = (rng.normal(size=(v, p, c)) * mask[..., None]).astype(np.float32)
    coords = np.stack([rng.integers(0, 2, v), rng.integers(0, 8, v),
                       rng.integers(0, 32, v), rng.integers(0, 32, v)],
                      1).astype(np.int32)
    return voxels, npts, coords


def _dynamic_inputs(seed, v=12):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, v, 70).astype(np.int32)
    points = rng.normal(size=(70, 4)).astype(np.float32)
    coords = np.stack([np.zeros(v), rng.integers(0, 8, v),
                       rng.integers(0, 16, v), rng.integers(0, 16, v)],
                      1).astype(np.int32)
    return points, rows, coords


VFE_CASES = {
    # name: (JAX module, port module, kind)
    "pillar": (lambda: j_vfe.PillarVFE(num_filters=(16,), voxel_size=VS,
                                       point_cloud_range=PCR),
               lambda: t_vfe.PillarVFE(4, (16,), VS, PCR), "hard"),
    "pillar_deep": (lambda: j_vfe.PillarVFE(
        num_filters=(8, 16), voxel_size=VS, point_cloud_range=PCR,
        use_absolute_xyz=False, with_distance=True),
        lambda: t_vfe.PillarVFE(4, (8, 16), VS, PCR, use_absolute_xyz=False,
                                with_distance=True), "hard"),
    "pillar_no_norm": (lambda: j_vfe.PillarVFE(
        num_filters=(8, 16), voxel_size=VS, point_cloud_range=PCR,
        use_norm=False),
        lambda: t_vfe.PillarVFE(4, (8, 16), VS, PCR, use_norm=False), "hard"),
    "hard": (lambda: j_vfe.HardVFE(num_filters=(16, 16), voxel_size=VS,
                                   point_cloud_range=PCR, with_distance=True),
             lambda: t_vfe.HardVFE(4, (16, 16), VS, PCR, with_distance=True),
             "hard"),
    "dynamic": (lambda: j_vfe.DynamicVFE(num_filters=(8, 16), voxel_size=VS,
                                         point_cloud_range=PCR, num_voxels=12),
                lambda: t_vfe.DynamicVFE(4, (8, 16), VS, PCR, 12), "dynamic"),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", list(VFE_CASES))
def test_vfe_matches_jax(case, train):
    """Output (rtol 1e-5) in eval and train mode (BatchNorm over the
    points, padding included, as flax reduces), and in train mode the
    updated running statistics and the parameter gradients of a seeded
    cotangent."""
    jcls, tcls, kind = VFE_CASES[case]
    inputs = _voxels(1) if kind == "hard" else _dynamic_inputs(2)
    jm = jcls()
    variables = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    if "batch_stats" in variables:
        rng = np.random.default_rng(3)
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.uniform(0.5, 2, x.shape) if p[-1].key == "var"
                          else rng.normal(size=x.shape)).astype(np.float32),
            variables["batch_stats"])

    def f(params):
        return jm.apply({**variables, "params": params},
                        *map(jnp.asarray, inputs), train=train,
                        mutable=["batch_stats"])

    want, upd = f(variables["params"])
    tm = tcls()
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    tm.train(train)
    got = tm(*map(_t, inputs))
    _close(got, want, case)
    if not train:
        return
    got_s = _leaves(to_flax_tree(tm, "batch_stats"))
    for k, w in _leaves(upd.get("batch_stats", {})).items():
        _close(got_s[k], w, k)
    g = np.random.default_rng(4).normal(size=want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p: f(p)[0], variables["params"])
    (grads,) = vjp(jnp.asarray(g))
    got.backward(_t(g))
    got_g = _leaves(to_flax_tree(tm, "params", grads=True))
    for k, w in _leaves(grads).items():
        np.testing.assert_allclose(got_g[k], w, rtol=1e-5, atol=1e-5 *
                                   np.abs(w).max(), err_msg=k)


def test_pointpillar_scatter_matches_jax():
    """Pillars onto the BEV canvas, padding rows dropped (exact)."""
    rng = np.random.default_rng(5)
    cells = rng.choice(2 * 12 * 10, 30, replace=False)
    b, rest = np.divmod(cells, 120)
    y, x = np.divmod(rest, 10)
    coords = np.full((40, 4), -1, np.int32)
    coords[:30] = np.stack([b, np.zeros_like(b), y, x], 1)
    valid = np.arange(40) < 30
    feats = (rng.normal(size=(40, 5)) * valid[:, None]).astype(np.float32)
    want = JPPS(5, (10, 12, 1))(jnp.asarray(feats), jnp.asarray(coords),
                                jnp.asarray(valid), 2)
    got = TPPS(5, (10, 12, 1))(_t(feats), _t(coords), _t(valid), 2)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (_np(got) != 0).any(axis=-1).sum() == 30


# ---------------------------------------------------- anchors and coder
def test_anchors_and_layout_equal_jax():
    """Mirrors test_anchor_layout.py: the same anchors (exactly), in the
    location-major layout [class][rotation] a cell, cells row-major."""
    want, wc = j_ah.generate_anchors(CFGS, GRID, PCR, STRIDE)
    got, gc = t_ah.generate_anchors(CFGS, GRID, PCR, STRIDE)
    assert gc == wc == [2, 2]
    np.testing.assert_array_equal(got, want)
    a = got.reshape(GRID[1] // STRIDE, GRID[0] // STRIDE, 4, 7)
    assert np.allclose(a[0, 0, :, 3], [3.9, 3.9, 0.8, 0.8])
    assert np.allclose(a[0, 0, :, 6], [0.0, 1.57, 0.0, 1.57])
    assert a[0, 1, 0, 0] > a[0, 0, 0, 0] and a[1, 0, 0, 1] > a[0, 0, 0, 1]
    head = t_ah.AnchorHeadSingle(_head_cfg(TDict), 8, 2, ["Car", "Ped"], GRID,
                                 PCR)
    np.testing.assert_array_equal(_np(head.anchor_class_ids).reshape(-1, 4)[0],
                                  [0, 0, 1, 1])
    np.testing.assert_array_equal(_np(head.matched_th).reshape(-1, 4)[3],
                                  np.float32([0.6, 0.6, 0.5, 0.5]))


@pytest.mark.parametrize("sincos", [False, True])
def test_residual_coder_matches_jax(sincos):
    rng = np.random.default_rng(6)
    anchors = np.concatenate([rng.normal(size=(50, 3)) * 5,
                              rng.uniform(0.5, 4, (50, 3)),
                              rng.uniform(-3, 3, (50, 1))], 1).astype(
        np.float32)
    boxes = anchors + rng.normal(size=(50, 7)).astype(np.float32) * 0.3
    boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 0.1
    jc, tc = JCoder(encode_angle_by_sincos=sincos), \
        TCoder(encode_angle_by_sincos=sincos)
    assert jc.code_size == tc.code_size == 7 + sincos
    enc_w = jc.encode(jnp.asarray(boxes), jnp.asarray(anchors))
    enc = tc.encode(_t(boxes), _t(anchors))
    _close(enc, enc_w, "encode")
    _close(tc.decode(enc, _t(anchors)), jc.decode(enc_w, jnp.asarray(anchors)),
           "decode")
    _close(tc.decode(enc, _t(anchors)), boxes if not sincos else
           jc.decode(enc_w, jnp.asarray(anchors)), "round trip")


def test_losses_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 30, 3)).astype(np.float32) * 3
    target = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 30))]
    w = rng.uniform(0, 1, (2, 30)).astype(np.float32)
    pred = rng.normal(size=(2, 30, 7)).astype(np.float32)
    tgt = pred + rng.normal(size=(2, 30, 7)).astype(np.float32) * 0.2
    cw = [1.0, 2.0, 1.0, 0.5, 1.0, 1.0, 3.0]
    J, T = j_losses, t_losses
    _close(T.sigmoid_focal_cls_loss(_t(logits), _t(target), _t(w)),
           J.sigmoid_focal_cls_loss(logits, target, w), "focal")
    _close(T.sigmoid_focal_cls_loss(_t(logits), _t(target), None),
           J.sigmoid_focal_cls_loss(logits, target, None), "focal, no w")
    _close(T.weighted_smooth_l1(_t(pred), _t(tgt), _t(w), code_weights=cw),
           J.weighted_smooth_l1(pred, tgt, w, code_weights=cw), "smooth l1")
    _close(T.weighted_smooth_l1(_t(pred), _t(tgt)),
           J.weighted_smooth_l1(pred, tgt), "smooth l1, no weights")
    _close(T.weighted_l1(_t(pred), _t(tgt), _t(w), code_weights=cw),
           J.weighted_l1(pred, tgt, w, code_weights=cw), "l1")
    _close(T.weighted_cross_entropy(_t(logits), _t(target), _t(w)),
           J.weighted_cross_entropy(logits, target, w), "cross entropy")


# ------------------------------------------------------- the anchor head
def _head_cfg(D, use_dir=False, sincos=False):
    cfg = {
        "NAME": "AnchorHeadSingle",
        "USE_DIRECTION_CLASSIFIER": use_dir,
        "DIR_OFFSET": 0.78539, "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
        "ANCHOR_GENERATOR_CONFIG": CFGS,
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {
            "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
            "code_weights": [1.0] * (7 + sincos)}},
    }
    if sincos:
        cfg["TARGET_ASSIGNER_CONFIG"] = {
            "BOX_CODER_CONFIG": {"encode_angle_by_sincos": True}}
    return D(cfg)


def _gt(seed):
    """Two frames of GT boxes, each placed on its own anchor cell (so that
    no two GTs share a best anchor: JAX leaves that order to XLA), plus
    padding rows."""
    rng = np.random.default_rng(seed)
    anchors, _ = j_ah.generate_anchors(CFGS, GRID, PCR, STRIDE)
    gt = np.zeros((2, 5, 8), np.float32)
    for b in range(2):
        cells = rng.choice(anchors.shape[0] // 4, 4, replace=False)
        for j, c in enumerate(cells):
            cls = int(rng.integers(1, 3))
            a = anchors[c * 4 + 2 * (cls - 1) + int(rng.integers(0, 2))]
            box = a.copy()
            box[:2] += rng.uniform(-0.3, 0.3, 2) * box[3:5]
            box[3:6] *= rng.uniform(0.8, 1.2, 3)
            box[6] += rng.uniform(-0.4, 0.4) + (np.pi if j % 2 else 0.0)
            gt[b, j] = [*box, cls]
    return gt


@pytest.fixture(scope="module", params=[(False, False), (True, False),
                                        (True, True)],
                ids=["plain", "dir", "dir_sincos"])
def head_pair(request):
    use_dir, sincos = request.param
    jh = j_ah.AnchorHeadSingle(
        model_cfg=_head_cfg(JDict, use_dir, sincos), input_channels=8,
        num_class=2, class_names=["Car", "Ped"], grid_size=GRID,
        point_cloud_range=PCR)
    x = np.random.default_rng(8).normal(
        size=(2, GRID[1] // STRIDE, GRID[0] // STRIDE, 8)).astype(np.float32)
    variables = jh.init(jax.random.PRNGKey(0), jnp.asarray(x))
    th = t_ah.AnchorHeadSingle(_head_cfg(TDict, use_dir, sincos), 8, 2,
                               ["Car", "Ped"], GRID, PCR)
    load_flax_variables(th, jax.tree_util.tree_map(np.asarray, variables))
    return jh, variables, th, x


def test_head_maps_and_targets_match_jax(head_pair):
    """Prediction maps (rtol 1e-5), labels (exactly, with positives and
    force-matched GTs present), regression targets and weights (1e-5)."""
    jh, variables, th, x = head_pair
    want = jh.apply(variables, jnp.asarray(x))
    got = th(_t(x))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    gt = _gt(9)
    tw = jh.apply(variables, jnp.asarray(gt), method=jh.assign_targets)
    tg = th.assign_targets(_t(gt))
    np.testing.assert_array_equal(_np(tg["box_cls_labels"]),
                                  np.asarray(tw["box_cls_labels"]))
    labels = _np(tg["box_cls_labels"])
    assert (labels == 1).sum() and (labels == 2).sum() and (labels == -1).sum()
    _close(tg["box_reg_targets"], tw["box_reg_targets"], "reg targets")
    _close(tg["reg_weights"], tw["reg_weights"], "reg weights")


def test_force_match_keeps_the_last_gt_on_a_shared_anchor():
    """Two GTs whose best anchor is the same: the port labels and
    regresses it from the GT of the larger index (its stated rule)."""
    th = t_ah.AnchorHeadSingle(_head_cfg(TDict), 8, 2, ["Car", "Ped"], GRID,
                               PCR)
    anchors = _np(th.anchors)
    gt = np.zeros((1, 3, 8), np.float32)
    i = 4 * 37  # the Car rot-0 anchor of cell 37
    tiny = anchors[i].copy()
    tiny[3:6] = [0.3, 0.3, 0.3]  # below every threshold but its best anchor
    gt[0, 0] = [*tiny, 1]
    gt[0, 1] = [*(tiny + [0.01, 0, 0, 0, 0, 0, 0]), 1]
    t = th.assign_targets(_t(gt))
    labels = _np(t["box_cls_labels"])[0]
    assert labels[i] == 1 and (labels > 0).sum() == 1
    want = th.box_coder.encode(_t(gt[0, 1, :7]), th.anchors[i])
    _close(t["box_reg_targets"][0, i], want, "the last GT's target")


def test_head_loss_and_boxes_match_jax(head_pair):
    """``get_loss`` (total and each term, rtol 1e-5) and its gradients
    with respect to the three maps (1e-5 of their largest magnitude), then
    ``generate_predicted_boxes`` (boxes after the direction fix, scores)."""
    jh, variables, th, x = head_pair
    gt = _gt(10)
    preds_w = jh.apply(variables, jnp.asarray(x))
    tw = jh.apply(variables, jnp.asarray(gt), method=jh.assign_targets)

    def loss(p):
        return jh.apply(variables, p, tw, method=jh.get_loss)

    (lw, tbw), vjp = jax.vjp(loss, preds_w)
    (gw,) = vjp((jnp.ones(()), jax.tree_util.tree_map(jnp.zeros_like, tbw)))
    preds = {k: _t(v).requires_grad_(True) for k, v in preds_w.items()}
    lt, tbt = th.get_loss(preds, th.assign_targets(_t(gt)))
    assert set(tbt) == set(tbw)
    for k in tbw:
        _close(tbt[k], tbw[k], k)
    lt.backward()
    for k in preds:
        w = np.asarray(gw[k])
        assert np.abs(_np(preds[k].grad) - w).max() <= 1e-5 * np.abs(w).max()
    bw, sw = jh.apply(variables, preds_w, method=jh.generate_predicted_boxes)
    bt, st = th.generate_predicted_boxes({k: v.detach()
                                          for k, v in preds.items()})
    _close(bt, bw, "boxes")
    _close(st, sw, "scores")


@pytest.mark.parametrize("pre_max,post_max", [(64, 16), (300, 64)])
def test_post_process_anchor_matches_jax(pre_max, post_max):
    """Max over the classes, 1-based labels, score threshold and rotated
    NMS a frame: the kept (box, score, label) sets equal after sorting."""
    rng = np.random.default_rng(pre_max)
    n = 400
    centers = rng.uniform(0, 12, (2, n, 2))
    boxes = np.concatenate([centers, rng.normal(size=(2, n, 1)),
                            rng.uniform(1, 4, (2, n, 3)),
                            rng.uniform(-3, 3, (2, n, 1))], -1).astype(
        np.float32)
    scores = rng.uniform(0, 1, (2, n, 3)).astype(np.float32)
    cfg = {"SCORE_THRESH": 0.3, "NMS_CONFIG": {
        "NMS_THRESH": 0.2, "NMS_PRE_MAXSIZE": pre_max,
        "NMS_POST_MAXSIZE": post_max}}
    want = jax.jit(lambda b, s: j_post(b, s, cfg))(jnp.asarray(boxes),
                                                   jnp.asarray(scores))
    got = t_post(_t(boxes), _t(scores), cfg)
    for b in range(2):
        wm, gm = np.asarray(want[3][b]), _np(got[3][b])
        assert wm.sum() == gm.sum() > 0
        rows = []
        for bx, sc, lb, m in ((want[0][b], want[1][b], want[2][b], wm),
                              (got[0][b], got[1][b], got[2][b], gm)):
            r = np.concatenate([np.asarray(_np(bx))[m],
                                np.asarray(_np(sc))[m][:, None],
                                np.asarray(_np(lb))[m][:, None]], 1)
            rows.append(r[np.lexsort(r.T[::-1])])
        np.testing.assert_allclose(rows[1], rows[0], **CLOSE)
    assert _np(got[2]).dtype == np.int32 and _np(got[2]).min() >= 0


@pytest.mark.parametrize("pairs", [1, 7 * 300, 2 * 300 * 64])
def test_nms_iou_row_blocks_change_nothing(pairs, monkeypatch):
    """On the CPU, ``nms_bev`` computes the pairwise IoU in row blocks
    (``kernels/nms_iou.overlaps``) of at most
    ``IOU_BLOCK_PAIRS`` pairs (KITTI's 4 x 4096 candidates at once would
    hold ~2 GiB temporaries each): the overlaps and the kept boxes equal
    the one-block computation exactly, for blocks of one row up."""
    from mssvt_tpu_torch.kernels import nms_iou
    from mssvt_tpu_torch.ops import box_ops, nms

    rng = np.random.default_rng(pairs)
    n = 300
    boxes = np.concatenate([rng.uniform(0, 15, (2, n, 2)),
                            rng.normal(size=(2, n, 1)),
                            rng.uniform(0.5, 4, (2, n, 3)),
                            rng.uniform(-3, 3, (2, n, 1))], -1).astype(
        np.float32)
    b = _t(boxes)
    scores = _t(rng.uniform(0, 1, (2, n)).astype(np.float32))
    want_over = box_ops.pairwise_iou_bev(b, b) > 0.1
    want = nms.nms_bev(b, scores, scores > 0.2, 0.1, 256, 64)
    monkeypatch.setattr(nms_iou, "IOU_BLOCK_PAIRS", pairs)
    assert torch.equal(nms_iou.overlaps(b, 0.1), want_over)
    got = nms.nms_bev(b, scores, scores > 0.2, 0.1, 256, 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[1].min()) > 5
