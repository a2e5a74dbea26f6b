"""The two-stage RoI machinery and SECONDNetIoU: the port against the JAX
package on the CPU, and the shared harness of the two-stage detector tests
(``test_torch_voxel_rcnn.py``, ``test_torch_parta2.py`` import it).

Module level (f32, numpy-seeded inputs): ``lookup_dense`` exactly; the
legacy decoders, the corner loss, ``bilinear_sample_bev`` and the grid
points to 1e-5 relative (values and input cotangents); ``proposal_layer``
exactly (indices) and ``assign_proposal_targets`` to 1e-5 (every output
and the cotangent of the RoIs: JAX lets the gradient through the IoU-based
class labels and the canonical targets); ``segment_sum`` against
``index_add_`` in float64; the BEV-grid head with JAX's dropout masks
injected.

Detectors (tiny: grid 32^3, 256 voxels a frame, batch 2, the JAX suite's
``test_voxel_rcnn.py`` / ``test_parta2.py`` sizes; GT boxes near anchors
but never on them, so that RoIs are foreground and no RoI copies a GT box:
``jax.jit(pairwise_iou_3d)`` gives 1.087 for identical boxes on the CPU):
flax initialises, random BatchNorm statistics and a zero classification
bias are set, ``bridge.py`` carries the variables across and back (leaf by
leaf, exact), DP_RATIO is 0 (dropout parity is the head test's). Eval: the
RoIs and the refined boxes as sets a frame (box, score, label) to 1e-4.
Train: loss and every ``tb_dict`` term to rtol 1e-5, the updated
BatchNorm statistics to 1e-5, all gradients to 1e-3 of their global norm;
then the RoI stage alone (targets, head, RoI losses) fed JAX's inputs: its
loss to 1e-5, each RoI-head leaf to 1e-4 of its norm, the cotangents of
its feature inputs and of the RoIs to 1e-4 of their largest magnitude.
JAX runs jitted in module-scoped fixtures.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.core.index import build_dense_row_table as j_table
from mssvt_tpu.core.index import lookup_dense as j_lookup_dense
from mssvt_tpu.models import build_network as j_build
from mssvt_tpu.models import losses as j_losses
from mssvt_tpu.models.roi_heads import roi_head_template as j_rt
from mssvt_tpu.models.roi_heads.bev_grid_head import (
    BEVGridRoIHead as JBEVHead,
)
from mssvt_tpu.models.roi_heads.bev_grid_head import (
    bilinear_sample_bev as j_bilinear,
)
from mssvt_tpu.models.roi_heads.bev_grid_head import (
    roi_grid_points_bev as j_grid_bev,
)
from mssvt_tpu.ops.pointnet2 import points_in_boxes as j_pib
from mssvt_tpu.utils import box_coder as j_coder
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.core.index import build_dense_row_table, lookup_dense
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.models import losses as t_losses
from mssvt_tpu_torch.models.model_utils import layers as t_layers
from mssvt_tpu_torch.models.roi_heads import roi_head_template as t_rt
from mssvt_tpu_torch.models.roi_heads.bev_grid_head import (
    BEVGridRoIHead,
    bilinear_sample_bev,
    roi_grid_points_bev,
)
from mssvt_tpu_torch.ops.pointnet2 import points_in_boxes
from mssvt_tpu_torch.ops.sampling import gather_rows, segment_sum
from mssvt_tpu_torch.runtime.train_utils import forward_backward
from mssvt_tpu_torch.utils import box_coder as t_coder
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_torch_dropout import Masks
from test_voxel_rcnn import voxelrcnn_cfg

torch.set_num_threads(2)

GRID = (32, 32, 32)
VOXEL_SIZE = (0.4, 0.4, 0.125)
PC_RANGE = (0.0, -6.4, -2.0, 12.8, 6.4, 2.0)
MAX_VOXELS = 256
BATCH = 2
MAX_GT = 8
# anchor centres of the tiny grid (4 x 4 BEV cells, align_center False)
ANCHOR_X = np.arange(4) * 12.8 / 3
ANCHOR_Y = -6.4 + np.arange(4) * 12.8 / 3


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def near(got, want, name, tol=1e-5):
    """Within ``tol`` of the largest magnitude of ``want`` (exact zeros
    exactly)."""
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), (name, err, scale)


# ------------------------------------------------------------ module level
def test_lookup_dense_matches_jax():
    rng = np.random.default_rng(0)
    coords = np.unique(np.stack([rng.integers(0, 2, 60),
                                 rng.integers(0, 4, 60),
                                 rng.integers(0, 5, 60),
                                 rng.integers(0, 6, 60)], 1), axis=0)
    pad = np.full((64, 4), -1, np.int32)
    pad[:len(coords)] = coords
    valid = np.arange(64) < len(coords)
    shape = (6, 5, 4)
    keys = np.concatenate([rng.integers(-5, 2 * 120 + 5, 200),
                           [2**31 - 1, -1, 240, 239, 0]]).astype(np.int32)
    want = j_lookup_dense(j_table(jnp.asarray(pad), jnp.asarray(valid), shape,
                                  2), jnp.asarray(keys))
    got = lookup_dense(build_dense_row_table(_t(pad), _t(valid), shape, 2),
                       _t(keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > 20


@pytest.mark.parametrize("name", ["PreviousResidualDecoder",
                                  "PreviousResidualRoIDecoder"])
def test_legacy_decoders_match_jax(name):
    rng = np.random.default_rng(1)
    anchors = np.concatenate([rng.normal(size=(3, 5, 3)),
                              rng.uniform(0.5, 4, (3, 5, 3)),
                              rng.uniform(-3, 3, (3, 5, 1)),
                              rng.normal(size=(3, 5, 2))], -1).astype(np.float32)
    enc = (rng.normal(size=(3, 5, 9)) * 0.5).astype(np.float32)
    want = getattr(j_coder, name)().decode(jnp.asarray(enc),
                                           jnp.asarray(anchors))
    got = getattr(t_coder, name)().decode(_t(enc), _t(anchors))
    near(got, want, name)


def test_corner_loss_matches_jax():
    rng = np.random.default_rng(2)
    pred = np.concatenate([rng.normal(size=(20, 3)),
                           rng.uniform(0.5, 4, (20, 3)),
                           rng.uniform(-3, 3, (20, 1))], -1).astype(np.float32)
    gt = pred + rng.normal(size=pred.shape).astype(np.float32) * 0.3
    gt[:4] = 0.0  # padded RoIs: coincident corners, a zero gradient
    pred[:4] = 0.0
    gt[4:8, 6] = pred[4:8, 6] + np.pi  # the flipped twin
    w = rng.normal(size=20).astype(np.float32)
    want, vjp = jax.vjp(j_losses.get_corner_loss_lidar, jnp.asarray(pred),
                        jnp.asarray(gt))
    gp, gg = vjp(jnp.asarray(w))
    tp, tg = _t(pred).requires_grad_(), _t(gt).requires_grad_()
    got = t_losses.get_corner_loss_lidar(tp, tg)
    got.backward(_t(w))
    near(got, want, "corner loss")
    near(tp.grad, gp, "d pred")
    near(tg.grad, gg, "d gt")
    assert np.isfinite(tp.grad.numpy()).all()


def test_points_in_boxes_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-2, 2, (6, 3)),
                            rng.uniform(0.5, 3, (6, 3)),
                            rng.uniform(-3, 3, (6, 1))], -1).astype(np.float32)
    pts[:6] = boxes[:, :3] + boxes[:, 3:6] / 2 * np.array([1, 0, 0])  # a face
    want = np.asarray(j_pib(jnp.asarray(pts), jnp.asarray(boxes)))
    got = points_in_boxes(_t(pts), _t(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    # batched form, as the point targets call it
    got_b = points_in_boxes(_t(pts)[None].expand(2, -1, -1),
                            _t(boxes)[None].expand(2, -1, -1))
    np.testing.assert_array_equal(got_b[1].numpy(), want)


def test_bilinear_sample_bev():
    """The JAX suite's three points, then seeded maps and rotated RoIs:
    values and the cotangents of the map and the RoIs."""
    feat = np.zeros((1, 4, 4, 1), np.float32)
    feat[0, :, :, 0] = np.arange(16).reshape(4, 4)
    pts = np.array([[[0.5, 0.5], [1.5, 0.5], [1.0, 0.5]]], np.float32)
    out = bilinear_sample_bev(_t(feat), _t(pts), (0, 0, 0, 4, 4, 1),
                              (1.0, 1.0))[0, :, 0].numpy()
    np.testing.assert_allclose(out, [0.0, 1.0, 0.5], atol=1e-5)

    rng = np.random.default_rng(4)
    f = rng.normal(size=(2, 8, 10, 3)).astype(np.float32)
    rois = np.zeros((2, 5, 7), np.float32)
    rois[..., :2] = rng.uniform(-1, 5, (2, 5, 2))
    rois[..., 3:5] = rng.uniform(1, 4, (2, 5, 2))
    rois[..., 6] = rng.uniform(-3, 3, (2, 5))
    g = rng.normal(size=(2, 80, 3)).astype(np.float32)

    def jf(f_, r_):
        return j_bilinear(f_, j_grid_bev(r_, 4).reshape(2, -1, 2),
                          (0, 0, 0, 4, 4, 1), (0.5, 0.5))

    want, vjp = jax.vjp(jf, jnp.asarray(f), jnp.asarray(rois))
    gf, gr = vjp(jnp.asarray(g))
    tf, tr = _t(f).requires_grad_(), _t(rois).requires_grad_()
    got = bilinear_sample_bev(tf, roi_grid_points_bev(tr, 4).reshape(2, -1, 2),
                              (0, 0, 0, 4, 4, 1), (0.5, 0.5))
    got.backward(_t(g))
    near(got, want, "samples")
    near(tf.grad, gf, "d map")
    near(tr.grad, gr, "d rois", 1e-4)


def test_roi_grid_points_cover_box():
    rois = np.asarray([[10.0, -5.0, 0, 4, 2, 1.5, 0.7]], np.float32)
    pts = roi_grid_points_bev(_t(rois), 6)[0]
    np.testing.assert_allclose(
        pts.numpy(), np.asarray(j_grid_bev(jnp.asarray(rois), 6))[0],
        rtol=1e-6, atol=1e-6)
    p3 = torch.cat([pts, torch.zeros(len(pts), 1)], 1)
    assert points_in_boxes(p3, _t(rois)).all()


@pytest.mark.parametrize("n,rows,hot", [(0, 3, 0), (1, 3, 0), (33, 5, 0),
                                        (5000, 3000, 2500), (20000, 7, 15000)])
def test_segment_sum_matches_index_add(n, rows, hot):
    """Any pick order, a row of ``hot`` picks: equal to ``index_add_`` in
    float64 within its rounding, and ``gather_rows``' backward with it."""
    gen = torch.Generator().manual_seed(n)
    idx = torch.randint(0, rows, (n,), generator=gen)
    idx[:hot] = 1
    idx = idx[torch.randperm(n, generator=gen)]
    vals = torch.randn(n, 3, generator=gen, dtype=torch.float64)
    want = torch.zeros(rows, 3, dtype=torch.float64).index_add_(0, idx, vals)
    np.testing.assert_allclose(segment_sum(idx, vals, rows).numpy(),
                               want.numpy(), rtol=1e-12, atol=1e-12)
    x = torch.randn(rows, 3, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    gather_rows(x, idx.view(-1, 1)).backward(vals.view(-1, 1, 3))
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    if n <= 33:
        assert torch.autograd.gradcheck(
            lambda v: gather_rows(v, idx.view(-1, 1)), (x.detach()
                                                         .requires_grad_(),))


# --------------------------------------------------------- proposals/targets
def _boxes(rng, shape, spread=8.0):
    return np.concatenate([rng.uniform(-spread, spread, shape + (2,)),
                           rng.uniform(-1.5, 0.5, shape + (1,)),
                           rng.uniform(1.5, 4.5, shape + (1,)),
                           rng.uniform(1.2, 2.0, shape + (1,)),
                           rng.uniform(1.3, 1.8, shape + (1,)),
                           rng.uniform(-3, 3, shape + (1,))],
                          -1).astype(np.float32)


def test_proposal_layer_and_targets():
    """``proposal_layer`` (NMS picks exactly) and ``assign_proposal_targets``
    (values, and the cotangent of the RoIs through the IoU, the soft labels
    and the canonical targets) against JAX on boxes jittered around GT
    boxes, with tied scores and padded GT rows."""
    rng = np.random.default_rng(5)
    b, n, m = 2, 48, 6
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :4, :7] = _boxes(rng, (b, 4))
    gt[:, :4, 7] = rng.integers(1, 4, (b, 4))
    boxes = np.repeat(gt[:, :4, :7], n // 4, axis=1)
    boxes = boxes + rng.normal(size=boxes.shape).astype(np.float32) * np.array(
        [0.4, 0.4, 0.2, 0.3, 0.2, 0.1, 0.2], np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    scores[:, 10:20] = 0.5  # ties keep their index order
    valid = np.ones((b, n), bool)
    jp = jax.jit(lambda x, s: j_rt.proposal_layer(
        x, s, jnp.asarray(valid), nms_pre=40, nms_post=40, nms_thresh=0.5))(
        jnp.asarray(boxes), jnp.asarray(scores))
    tp = t_rt.proposal_layer(_t(boxes), _t(scores), _t(valid), nms_pre=40,
                             nms_post=40, nms_thresh=0.5)
    for w, g, name in zip(jp, tp, ("rois", "scores", "labels", "valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    rois, rvalid = np.asarray(jp[0]), np.asarray(jp[3])
    assert 10 < rvalid.sum() < rvalid.size

    keys = ("rois", "gt_of_rois", "roi_ious", "reg_valid", "cls_labels")
    kw = dict(roi_per_image=16, fg_thresh=0.55, bg_thresh_hi=0.55,
              bg_thresh_lo=0.1, fg_ratio=0.5)

    def jf(r):
        out = j_rt.assign_proposal_targets(r, jnp.asarray(rvalid),
                                           jnp.asarray(gt), **kw)
        return tuple(out[k] for k in keys)

    want, vjp = jax.vjp(jax.jit(jf), jnp.asarray(rois))
    cts = [rng.normal(size=w.shape).astype(np.float32) if w.dtype != bool
           else np.zeros(w.shape, jax.dtypes.float0) for w in want]
    (g_rois,) = vjp(tuple(jnp.asarray(c) for c in cts))
    tr = _t(rois).requires_grad_()
    got = t_rt.assign_proposal_targets(tr, _t(rvalid), _t(gt), **kw)
    for k, w in zip(keys, want):
        if w.dtype == bool:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            near(got[k], w, k)
    assert np.asarray(want[3]).sum() > 4  # foreground RoIs
    sum(( got[k] * _t(c)).sum() for k, c in zip(keys, cts)
        if got[k].dtype != torch.bool).backward()
    near(tr.grad, g_rois, "d rois", 1e-4)
    assert np.abs(np.asarray(g_rois)).max() > 0


def test_roi_losses_match_jax():
    """``roi_cls_loss`` and ``roi_box_loss`` (code weights, corner loss) and
    their cotangents, including padded RoIs."""
    rng = np.random.default_rng(6)
    b, r = 2, 12
    rois = _boxes(rng, (b, r))
    rois[:, -3:] = 0.0
    gt = np.concatenate([rng.normal(size=(b, r, 3)) * 0.3,
                         rois[..., 3:6] * rng.uniform(0.8, 1.2, (b, r, 3)),
                         rng.normal(size=(b, r, 1)) * 0.3,
                         np.ones((b, r, 1))], -1).astype(np.float32)
    reg_valid = rng.random((b, r)) < 0.6
    reg_valid[:, -3:] = False
    gt = gt * reg_valid[..., None]
    labels = np.where(rng.random((b, r)) < 0.2, -1.0,
                      rng.uniform(0, 1, (b, r))).astype(np.float32)
    logits = rng.normal(size=(b, r)).astype(np.float32)
    reg = (rng.normal(size=(b, r, 7)) * 0.3).astype(np.float32)
    cw = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]

    def jf(lg, rg, ro):
        return (j_rt.roi_cls_loss(lg, jnp.asarray(labels)),
                j_rt.roi_box_loss(rg, jnp.asarray(gt), ro,
                                  jnp.asarray(reg_valid), code_weights=cw,
                                  corner_loss_weight=1.5))

    want, vjp = jax.vjp(jf, jnp.asarray(logits), jnp.asarray(reg),
                        jnp.asarray(rois))
    grads = vjp((jnp.ones(()), jnp.ones(())))
    ins = [_t(x).requires_grad_() for x in (logits, reg, rois)]
    got = (t_rt.roi_cls_loss(ins[0], _t(labels)),
           t_rt.roi_box_loss(ins[1], _t(gt), ins[2], _t(reg_valid),
                             code_weights=cw, corner_loss_weight=1.5))
    (got[0] + got[1]).backward()
    for g, w, name in zip(got, want, ("cls", "reg")):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5,
                                   err_msg=name)
    for t, w, name in zip(ins, grads, ("d logits", "d reg", "d rois")):
        near(t.grad, w, name)
    assert t_rt.corner_weight_from_cfg({"LOSS_CONFIG": {
        "CORNER_LOSS_REGULARIZATION": True,
        "LOSS_WEIGHTS": {"rcnn_corner_weight": 2.5}}}) == 2.5
    assert t_rt.corner_weight_from_cfg({}) == 0.0


def test_bev_grid_head_dropout_matches_flax(monkeypatch):
    """``BEVGridRoIHead`` in training at DP_RATIO 0.3 with JAX's dropout
    masks injected (``test_torch_dropout.Masks``): outputs, every parameter
    cotangent and the map's, to 1e-5."""
    rng = np.random.default_rng(7)
    cfg = {"GRID_SIZE": 3, "SHARED_FC": [16, 8], "DP_RATIO": 0.3}
    f = rng.normal(size=(2, 6, 6, 5)).astype(np.float32)
    rois = _boxes(rng, (2, 4), spread=1.0)
    rois[..., :2] += 1.2
    rvalid = np.array([[1, 1, 1, 0], [1, 0, 1, 1]], bool)
    jm = JBEVHead(model_cfg=cfg, input_channels=5,
                  point_cloud_range=(0, 0, 0, 2.4, 2.4, 1),
                  bev_stride_metric=(0.4, 0.4))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(f),
                                       jnp.asarray(rois), jnp.asarray(rvalid)))
    masks = Masks(3)
    monkeypatch.setattr(jax.random, "bernoulli", masks.jax_draw)
    gc, gr = rng.normal(size=(2, 4)), rng.normal(size=(2, 4, 7))

    def jf(p, f_):
        c, r = jm.apply({"params": p}, f_, jnp.asarray(rois),
                        jnp.asarray(rvalid), train=True,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        return (c * gc).sum() + (r * gr).sum(), (c, r)

    (_, (jc, jr)), (jg, jgf) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(f))
    assert len(masks.drawn) == 2
    monkeypatch.setattr(t_layers, "keep_mask", masks.port_draw)
    tm = BEVGridRoIHead(cfg, 5, (0, 0, 0, 2.4, 2.4, 1), (0.4, 0.4)).train()
    load_flax_variables(tm, variables)
    tf = _t(f).requires_grad_()
    c, r = tm(tf, _t(rois), _t(rvalid), generator=torch.Generator())
    ((c * _t(gc)).sum() + (r * _t(gr)).sum()).backward()
    assert masks.served == 2
    near(c, jc, "cls")
    near(r, jr, "reg")
    near(tf.grad, jgf, "d map")
    got = leaves(to_flax_tree(tm, "params", grads=True))
    for k, w in leaves(jg).items():
        near(got[k], w, k)


# ------------------------------------------------- the detector harness
def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)}


def gt_near_anchors(rng, classes=1):
    """Two GT boxes a frame 0.2-0.4 m off an anchor's centre (foreground
    RoIs, none a copy of its GT), plus padding rows."""
    gt = np.zeros((BATCH, MAX_GT, 8), np.float32)
    sizes = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}
    for b in range(BATCH):
        for j, (ix, iy) in enumerate(((1, 1), (2, 2))):
            cls = 1 + (b + j) % classes
            gt[b, j] = [ANCHOR_X[ix] + rng.uniform(0.2, 0.4),
                        ANCHOR_Y[iy] + rng.uniform(0.2, 0.4),
                        -1.0 + rng.uniform(-0.1, 0.1), *sizes[cls],
                        rng.uniform(-0.2, 0.2) + (1.57 if j else 0.0), cls]
    return gt


def make_batch(rng, classes=1):
    """The JAX suite's tiny batch (``test_voxel_rcnn.py``): up to 256 seeded
    voxels a frame in the grid's lower x/y half, 4 points each."""
    cap = BATCH * MAX_VOXELS
    coords = np.unique(np.stack([
        rng.integers(0, BATCH, cap * 2), rng.integers(0, GRID[2], cap * 2),
        rng.integers(0, GRID[1] // 2, cap * 2),
        rng.integers(0, GRID[0] // 2, cap * 2)], 1), axis=0)
    pad = np.full((cap, 4), -1, np.int32)
    valid = np.zeros((cap,), bool)
    for b in range(BATCH):
        cb = coords[coords[:, 0] == b][:MAX_VOXELS]
        lo = b * MAX_VOXELS
        pad[lo:lo + len(cb)] = cb
        valid[lo:lo + len(cb)] = True
    voxels = rng.normal(size=(cap, 4, 4)).astype(np.float32) * valid[:, None,
                                                                     None]
    return {"voxels": voxels,
            "voxel_num_points": np.full(cap, 3.0, np.float32) * valid,
            "voxel_coords": pad, "voxel_valid": valid,
            "gt_boxes": gt_near_anchors(rng, classes)}


def second_iou_cfg():
    cfg = json.loads(json.dumps(voxelrcnn_cfg()))
    cfg["NAME"] = "SECONDNetIoU"
    cfg["ROI_HEAD"] = {
        "NAME": "BEVGridRoIHead", "GRID_SIZE": 4, "SHARED_FC": [32, 16],
        "DP_RATIO": 0.3,
        "NMS_CONFIG": cfg["ROI_HEAD"]["NMS_CONFIG"],
        "TARGET_CONFIG": {"ROI_PER_IMAGE": 16},
        "LOSS_CONFIG": {"CORNER_LOSS_REGULARIZATION": True, "LOSS_WEIGHTS": {
            "rcnn_corner_weight": 1.0,
            "code_weights": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]}}}
    return cfg


def build_kw(classes=1):
    return dict(num_class=classes,
                class_names=["Car", "Pedestrian", "Cyclist"][:classes],
                grid_size=GRID, voxel_size=VOXEL_SIZE,
                point_cloud_range=PC_RANGE, batch_size=BATCH,
                max_voxels=MAX_VOXELS, max_points_per_voxel=4)


def make_pair(cfg, classes, roi_inputs, seed=0, batch=None, tweak=None):
    """JAX's tiny detector of ``cfg`` (plain dicts; DP_RATIO set to 0),
    initialised by flax with random BatchNorm statistics and a zero
    classification bias, its eval and train results on a seeded batch
    (``batch``, a dict of numpy arrays, replaces it), and the port's model
    on the same variables; ``tweak(params)`` edits the flax parameters
    (numpy, in place) before either runs.

    ``roi_inputs(m, jb)`` (a JAX method, or None to skip it) returns the
    RoI stage's inputs of a train-mode forward: (head features, rois,
    roi_valid)."""
    cfg = json.loads(json.dumps(cfg))
    cfg["ROI_HEAD"]["DP_RATIO"] = 0.0
    kw = build_kw(classes)
    jm = j_build(model_cfg=JDict(cfg), **kw)
    if batch is None:
        batch = make_batch(np.random.default_rng(seed), classes)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k, b: jm.init({"params": k, "dropout": k}, b,
                                             train=False))(key, jb)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    if "dense_head" in variables["params"]:
        variables["params"]["dense_head"]["conv_cls"]["bias"][:] = 0.0
    if tweak is not None:
        tweak(variables["params"])
    evals = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, jb)

    def loss_fn(params):
        out, upd = jm.apply({**variables, "params": params}, jb, train=True,
                            rngs={"dropout": key}, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], upd["batch_stats"])

    (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    x = rois = rvalid = None
    if roi_inputs is not None:
        (x, rois, rvalid), _ = jax.jit(lambda v: jm.apply(
            v, jb, method=roi_inputs, mutable=["batch_stats"]))(variables)
    tm = t_build(TDict(cfg), **kw, num_point_features=4, device="cpu")
    load_flax_variables(tm, variables)
    return dict(jm=jm, cfg=cfg, variables=variables, jb=jb, evals=evals,
                train=(loss, tb, stats, grads), roi_in=(x, rois, rvalid),
                tm=tm, batch={k: _t(v) for k, v in batch.items()})


def j_targets_and_loss(m, cls_reg_fn, rois, rvalid, gt, code_weights=None):
    """JAX's RoI stage: targets, the head (``cls_reg_fn(targets,
    valid)``), the two RoI losses summed."""
    roi_cfg = m.model_cfg["ROI_HEAD"]
    t = t_rt.target_kwargs(roi_cfg)
    targets = j_rt.assign_proposal_targets(rois, rvalid, gt, **t)
    cls, reg = cls_reg_fn(targets, targets["reg_valid"]
                          | (targets["cls_labels"] >= 0))
    return (j_rt.roi_cls_loss(cls, targets["cls_labels"])
            + j_rt.roi_box_loss(reg, targets["gt_of_rois"], targets["rois"],
                                targets["reg_valid"], code_weights=code_weights,
                                corner_loss_weight=j_rt.corner_weight_from_cfg(
                                    roi_cfg)))


def t_targets_and_loss(model, cls_reg_fn, rois, rvalid, gt,
                       code_weights=None):
    targets = t_rt.assign_proposal_targets(rois, rvalid, gt,
                                           **t_rt.target_kwargs(model.roi_cfg))
    cls, reg = cls_reg_fn(targets, t_rt.head_valid(targets))
    return (t_rt.roi_cls_loss(cls, targets["cls_labels"])
            + t_rt.roi_box_loss(reg, targets["gt_of_rois"], targets["rois"],
                                targets["reg_valid"], code_weights=code_weights,
                                corner_loss_weight=t_rt.corner_weight_from_cfg(
                                    model.roi_cfg)))


def box_rows(boxes, scores, labels, m):
    r = np.concatenate([np.asarray(boxes)[m], np.asarray(scores)[m][:, None],
                        np.asarray(labels)[m][:, None].astype(np.float32)], 1)
    return r[np.lexsort(np.round(r, 3).T[::-1])]


def check_eval(pair):
    """The port's eval outputs against JAX's: RoIs and the refined
    detections as sets a frame (1e-4)."""
    want = pair["evals"]
    with torch.no_grad():
        got = pair["tm"](pair["batch"])
    for b in range(BATCH):
        wm, gm = np.asarray(want["final_mask"][b]), got["final_mask"][b].numpy()
        assert wm.sum() == gm.sum() > 0
        np.testing.assert_allclose(
            box_rows(got["final_boxes"][b].numpy(),
                     got["final_scores"][b].numpy(),
                     got["final_labels"][b].numpy(), gm),
            box_rows(want["final_boxes"][b], want["final_scores"][b],
                     want["final_labels"][b], wm), rtol=1e-4, atol=1e-4)
    return got


def check_train(pair, tb_keys, rtol=1e-5, zero_leaves=()):
    """One train-mode forward and backward of the whole model: loss and
    each ``tb_dict`` term (``rtol``), updated statistics (1e-5), every
    gradient within 1e-3 of the global norm, and every RoI-head leaf's
    gradient nonzero but those holding one of ``zero_leaves``, which must
    be exactly zero on both sides."""
    loss, tb, stats, grads = pair["train"]
    model = copy.deepcopy(pair["tm"])
    model.zero_grad()
    got_loss, got_tb = forward_backward(model, pair["batch"])
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=rtol)
    assert set(got_tb) == set(tb) == set(tb_keys)
    for k, v in tb.items():
        np.testing.assert_allclose(float(got_tb[k]), float(v), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    assert float(tb["rcnn_loss_reg"]) > 0  # foreground RoIs
    got_s, want_s = leaves(to_flax_tree(model, "batch_stats")), leaves(stats)
    assert set(got_s) == set(want_s)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    got_g, want_g = leaves(to_flax_tree(model, "params", grads=True)), \
        leaves(grads)
    assert set(got_g) == set(want_g)
    diff = np.sqrt(sum(((got_g[k] - w) ** 2).sum() for k, w in want_g.items()))
    norm = np.sqrt(sum((w ** 2).sum() for w in want_g.values()))
    assert diff <= 1e-3 * norm, (diff, norm)
    roi = [k for k in want_g if k.startswith("['roi_head']")]
    zero = [k for k in roi if any(z in k for z in zero_leaves)]
    assert roi and all(np.abs(want_g[k]).sum() > 0 for k in roi
                       if k not in zero)
    assert all(not want_g[k].any() and not got_g[k].any() for k in zero)


def check_roi_stage(pair, j_head, t_head, code_weights=None, rtol=1e-5,
                    tol=1e-4, zero_grad_leaves=()):
    """The RoI stage alone fed JAX's inputs: ``j_head(m, x, targets,
    valid)`` / ``t_head(model, x, targets, valid)`` run the head on the
    stage's features ``x`` (a dict of arrays, tensors for the port). Loss
    (``rtol``), each RoI-head leaf (``tol`` of its norm), the cotangents of
    ``x`` and of the RoIs (``tol`` of their largest magnitude). A leaf whose
    name ends with one of ``zero_grad_leaves`` has an analytically zero
    gradient (rounding noise on both sides): it is held within ``tol`` of
    the largest leaf's norm instead."""
    x, rois, rvalid = pair["roi_in"]
    jm, variables, gt = pair["jm"], pair["variables"], pair["jb"]["gt_boxes"]

    def jf(p, x_, r_):
        def stage(m):
            return j_targets_and_loss(
                m, lambda t, v: j_head(m, x_, t, v), r_, rvalid, gt,
                code_weights)
        return jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                        method=stage, mutable=["batch_stats"])[0]

    want, (gp, gx, gr) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(
        variables["params"], x, rois)
    model = copy.deepcopy(pair["tm"]).train()
    model.zero_grad()
    tx = {k: _t(v).requires_grad_() for k, v in x.items()}
    tr = _t(rois).requires_grad_()
    got = t_targets_and_loss(model, lambda t, v: t_head(model, tx, t, v), tr,
                             _t(rvalid), pair["batch"]["gt_boxes"],
                             code_weights)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=rtol)
    near(tr.grad, gr, "d rois", tol)
    for k, t in tx.items():
        near(t.grad, gx[k], f"d {k}", tol)
    got_g = leaves(to_flax_tree(model.roi_head, "params", grads=True))
    want_g = leaves(gp["roi_head"])
    assert set(got_g) == set(want_g)
    top = max(np.sqrt((w ** 2).sum()) for w in want_g.values())
    for k, w in want_g.items():
        err = np.sqrt(((got_g[k] - w) ** 2).sum())
        scale = top if k.endswith(tuple(zero_grad_leaves)) else \
            np.sqrt((w ** 2).sum())
        assert err <= tol * scale, (k, err)
    assert np.abs(np.asarray(gr)).max() > 0


def check_round_trip(pair):
    """flax tree -> port -> flax tree, leaf by leaf, exact."""
    variables = pair["variables"]
    for coll in ("params", "batch_stats"):
        got, want = leaves(to_flax_tree(pair["tm"], coll)), leaves(
            variables[coll])
        assert set(got) == set(want), set(got) ^ set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)


# --------------------------------------------------------------- SECONDNetIoU
def _j_second_iou_roi_inputs(m, b):
    from mssvt_tpu.core.sparse import SparseVoxels as JSV
    from mssvt_tpu.models.detectors.generic_post import apply_vfe

    sp = JSV.create(features=apply_vfe(m.vfe, b, train=True),
                    coords=b["voxel_coords"], valid=b["voxel_valid"],
                    batch_size=m.batch_size, spatial_shape=m.grid_size,
                    voxel_size=m.voxel_size,
                    point_cloud_range=m.point_cloud_range)
    f2 = m.backbone_2d(m.backbone_3d(sp, train=True).bev(), train=True)
    preds = m.dense_head(f2, train=True)
    boxes, scores_mc = m.dense_head.generate_predicted_boxes(preds)
    nms = t_rt.nms_kwargs(m.roi_cfg, True)
    rois, _, _, rvalid = j_rt.proposal_layer(
        boxes[..., :7], jnp.max(scores_mc, -1),
        jnp.ones(scores_mc.shape[:2], bool), **nms)
    return {"spatial_2d": f2}, rois, rvalid


SECOND_IOU_CW = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]


@pytest.fixture(scope="module")
def second_iou():
    return make_pair(second_iou_cfg(), 1, _j_second_iou_roi_inputs)


def test_second_net_iou_eval_matches_jax(second_iou):
    got = check_eval(second_iou)
    assert type(second_iou["tm"]).__name__ == "SECONDNetIoU"
    assert got["final_scores"].max() > 0


def test_second_net_iou_loss_and_gradients_match_jax(second_iou):
    check_train(second_iou, {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                             "rpn_loss", "rcnn_loss_cls", "rcnn_loss_reg"})


def test_second_net_iou_roi_stage_matches_jax(second_iou):
    check_roi_stage(
        second_iou,
        lambda m, x, t, v: m.roi_head(x["spatial_2d"], t["rois"], v,
                                      train=True),
        lambda model, x, t, v: model.roi_head(x["spatial_2d"], t["rois"], v),
        code_weights=SECOND_IOU_CW)


def test_second_net_iou_bridge_round_trip(second_iou):
    check_round_trip(second_iou)
