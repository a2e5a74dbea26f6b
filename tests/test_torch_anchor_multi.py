"""AnchorHeadMulti and the ATSS assigner: the port against the JAX package
on the CPU (f32, numpy-seeded inputs, flax-initialised weights carried by
``bridge.load_flax_variables``).

- ``assign_atss_targets``: the JAX suite's adaptive-threshold case, and
  seeded frames with several GTs, padding rows and anchors tied in
  distance (a location's rotations share a centre): labels exactly,
  targets and weights to 1e-6;
- the head alone (two groups, ATSS, the direction classifier): eval and
  train maps, the loss of ``assign_targets`` + ``get_loss`` and the
  decoded boxes and global scores, the updated BatchNorm statistics, every
  parameter's gradient and the input's cotangent within 1e-5 of their
  largest magnitude; once more with the axis-aligned assigner;
- the three anchor-layout tests of ``tests/test_anchor_layout.py`` for
  the multi head (location-major anchors a group, a delta written into a
  group's map decodes at its anchor, a GT on a Car anchor labels the Car
  group's slot and not the Pedestrian group's), each beside JAX's result;
- SECOND with the multi head and ATSS (the JAX suite's
  ``test_anchor_head_multi_atss`` config, its two GT boxes a frame moved
  to hold an anchor centre each, a Car and a Pedestrian, so that both
  groups have ATSS positives): eval detections as a set to
  1e-4, the training loss and each group's term to 1e-5 relative, the
  updated statistics to 1e-5, the gradients within 1e-3 of their global
  norm (f32 through the sparse backbone's ReLUs, as ``test_torch_second``).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.models import build_network as j_build
from mssvt_tpu.models.dense_heads import anchor_head_multi as jmh
from mssvt_tpu.models.dense_heads.anchor_head import generate_anchors
from mssvt_tpu.utils.box_coder import ResidualCoder as JCoder
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.models.dense_heads import anchor_head_multi as tmh
from mssvt_tpu_torch.runtime.train_utils import forward_backward
from mssvt_tpu_torch.utils.box_coder import ResidualCoder
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_anchor_layout import CFGS, GRID as L_GRID, PCR as L_PCR, STRIDE
from test_second_pointpillar import (
    BATCH,
    GRID,
    MAX_VOXELS,
    PC_RANGE,
    anchor_head_cfg,
    make_batch,
    second_cfg,
)
from test_torch_pointnet2 import check_module
from test_torch_roi import _t, box_rows, leaves

torch.set_num_threads(2)
CLASSES = ["Car", "Pedestrian"]


def multi_head_cfg(atss=True, stride=8):
    """``test_anchor_head_multi_atss``'s dense head (two groups, Car and
    Pedestrian, the direction classifier on)."""
    car = dict(anchor_head_cfg()["ANCHOR_GENERATOR_CONFIG"][0],
               feature_map_stride=stride)
    return {
        "NAME": "AnchorHeadMulti", "USE_DIRECTION_CLASSIFIER": True,
        "DIR_OFFSET": 0.78539, "NUM_DIR_BINS": 2,
        "SHARED_CONV_NUM_FILTER": 16,
        "RPN_HEAD_CFGS": [{"HEAD_CLS_NAME": ["Car"]},
                          {"HEAD_CLS_NAME": ["Pedestrian"]}],
        "TARGET_ASSIGNER_CONFIG": (
            {"NAME": "ATSSTargetAssigner", "TOPK": 9} if atss else
            {"NAME": "AxisAlignedTargetAssigner"}),
        "ANCHOR_GENERATOR_CONFIG": [
            car, dict(car, class_name="Pedestrian",
                      anchor_sizes=[[0.8, 0.6, 1.73]],
                      anchor_bottom_heights=[-0.6], matched_threshold=0.5,
                      unmatched_threshold=0.35)],
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {
            "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
            "code_weights": [1.0] * 7}}}


def _atss_pair(anchors, gt, topk=9):
    want = jmh.assign_atss_targets(jnp.asarray(anchors), jnp.asarray(gt),
                                   JCoder(), topk=topk)
    got = tmh.assign_atss_targets(_t(anchors), _t(gt), ResidualCoder(),
                                  topk=topk)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_atss_assigner_adaptive_threshold():
    """A GT centred exactly on an anchor makes that anchor positive."""
    cfgs = [anchor_head_cfg()["ANCHOR_GENERATOR_CONFIG"][0]]
    anchors, _ = generate_anchors(cfgs, GRID, PC_RANGE, 8)
    gt = np.zeros((4, 8), np.float32)
    gt[0, :7] = anchors[10]
    gt[0, 7] = 1
    (wl, wr, ww), (labels, reg_t, reg_w) = _atss_pair(anchors, gt)
    assert labels[10] == 1
    assert labels.sum() < 20  # only a handful of positives
    np.testing.assert_allclose(reg_t[10], 0, atol=1e-5)
    np.testing.assert_array_equal(labels, wl)
    np.testing.assert_allclose(reg_t, wr, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(reg_w, ww, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_atss_assigner_matches_jax(seed):
    rng = np.random.default_rng(seed)
    anchors, _ = generate_anchors(multi_head_cfg()["ANCHOR_GENERATOR_CONFIG"],
                                  GRID, PC_RANGE, 8)
    gt = np.zeros((6, 8), np.float32)
    for j in range(4):
        a = anchors[rng.integers(len(anchors))]
        gt[j, :7] = a + np.concatenate([rng.uniform(-0.6, 0.6, 3),
                                        rng.uniform(-0.2, 0.2, 3),
                                        rng.uniform(-0.3, 0.3, 1)])
        gt[j, 7] = 1 + j % 2
    gt[3, :3] = gt[2, :3] + 0.3  # two GTs sharing candidates
    (wl, wr, ww), (labels, reg_t, reg_w) = _atss_pair(anchors, gt, topk=9)
    np.testing.assert_array_equal(labels, wl)
    np.testing.assert_allclose(reg_t, wr, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(reg_w, ww, rtol=1e-6, atol=1e-6)
    assert 0 < (labels > 0).sum() < 40 and set(np.unique(labels)) <= {0, 1, 2}


HEAD_GRID = (16, 16, 8)


def _head_gt(rng, anchors_by_group):
    """(2, 5, 8) GT boxes a little off anchors of each group, padded."""
    gt = np.zeros((2, 5, 8), np.float32)
    for b in range(2):
        for j in range(3):
            grp = anchors_by_group[j % 2]
            a = grp[rng.integers(len(grp))]
            gt[b, j, :7] = a + np.concatenate([rng.uniform(-0.3, 0.3, 3),
                                               [0, 0, 0],
                                               rng.uniform(-0.2, 0.2, 1)])
            gt[b, j, 7] = 1 + j % 2
    return gt


@pytest.mark.parametrize("atss", [True, False])
def test_anchor_head_multi_matches_jax(atss):
    cfg = multi_head_cfg(atss, stride=2)
    kw = dict(model_cfg=cfg, input_channels=6, num_class=2,
              class_names=CLASSES, grid_size=HEAD_GRID,
              point_cloud_range=PC_RANGE)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    groups = [generate_anchors([c], HEAD_GRID, PC_RANGE, 2)[0]
              for c in cfg["ANCHOR_GENERATOR_CONFIG"]]
    gt = _head_gt(rng, groups)

    def run(m, preds, gt_boxes):
        loss, tb = m.get_loss(preds, m.assign_targets(gt_boxes))
        boxes, scores = m.generate_predicted_boxes(preds)
        return (loss, tb["rpn_head0_loss"], tb["rpn_head1_loss"], boxes,
                scores, *[p[k] for p in preds for k in sorted(p)])

    got, want = check_module(
        jmh.AnchorHeadMulti(**kw), tmh.AnchorHeadMulti(**kw),
        {"x": x, "gt": gt},
        lambda m, train, x, gt: run(m, m(x, train=train), gt),
        lambda m, x, gt: run(m, m(x), gt), grad_inputs=("x",))
    assert float(want[1]) > 0 and float(want[2]) > 0
    assert want[3].shape == (2, sum(len(g) for g in groups), 7)
    assert want[4].shape[-1] == 2


def _layout_head():
    """The multi head over ``test_anchor_layout``'s grid and two classes,
    one group each (axis-aligned assigner), JAX's and the port's on the
    same variables."""
    cfg = {"NAME": "AnchorHeadMulti", "USE_DIRECTION_CLASSIFIER": False,
           "SHARED_CONV_NUM_FILTER": 8,
           "RPN_HEAD_CFGS": [{"HEAD_CLS_NAME": ["Car"]},
                             {"HEAD_CLS_NAME": ["Pedestrian"]}],
           "ANCHOR_GENERATOR_CONFIG": CFGS,
           "LOSS_CONFIG": {"LOSS_WEIGHTS": {
               "cls_weight": 1.0, "loc_weight": 2.0,
               "code_weights": [1.0] * 7}}}
    kw = dict(model_cfg=cfg, input_channels=8, num_class=2,
              class_names=CLASSES, grid_size=L_GRID, point_cloud_range=L_PCR)
    jm = jmh.AnchorHeadMulti(**kw)
    x = jnp.zeros((1, L_GRID[1] // STRIDE, L_GRID[0] // STRIDE, 8))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    tm = tmh.AnchorHeadMulti(**kw)
    load_flax_variables(tm, variables)
    return jm, variables, tm.eval()


def test_multi_head_anchors_location_major():
    jm, variables, tm = _layout_head()
    nx, ny = L_GRID[0] // STRIDE, L_GRID[1] // STRIDE
    for hi, (size, jmeta) in enumerate(zip((3.9, 0.8), jm.bind(
            variables).metas)):
        a = tm.meta(hi, "anchors").numpy()
        np.testing.assert_array_equal(a, np.asarray(jmeta["anchors"]))
        assert a.shape == (ny * nx * 2, 7)
        a = a.reshape(ny, nx, 2, 7)
        assert np.allclose(a[..., 0], a[..., 0:1, 0])
        assert np.allclose(a[..., 1], a[..., 0:1, 1])
        assert np.allclose(a[0, 0, :, 3], size)  # the group's own class
        assert np.allclose(a[0, 0, :, 6], [0.0, 1.57])
        assert a[0, 1, 0, 0] > a[0, 0, 0, 0]  # x fastest
        assert a[1, 0, 0, 1] > a[0, 0, 0, 1]


def test_multi_head_pred_anchor_alignment_roundtrip():
    jm, variables, tm = _layout_head()
    nx, ny = L_GRID[0] // STRIDE, L_GRID[1] // STRIDE
    anchors = tm.meta(1, "anchors").numpy()
    coder = ResidualCoder(code_size=7)
    flat_i = (2 * nx + 5) * 2 + 0  # group 1 (Pedestrian), cell (2, 5), rot 0
    gt = anchors[flat_i].copy()
    gt[:3] += [0.3, -0.2, 0.1]
    gt[3:6] *= 1.1
    delta = coder.encode(_t(gt[None]), _t(anchors[flat_i][None]))[0].numpy()
    box_map = np.zeros((1, ny, nx, 2 * 7), np.float32)
    box_map[0, 2, 5, :7] = delta
    n0 = ny * nx * 2
    preds = [{"box_preds": np.zeros((1, n0, 7), np.float32),
              "cls_preds": np.zeros((1, n0, 1), np.float32)},
             {"box_preds": box_map.reshape(1, -1, 7),
              "cls_preds": np.zeros((1, n0, 1), np.float32)}]
    boxes, scores = tm.generate_predicted_boxes(
        [{k: _t(v) for k, v in p.items()} for p in preds])
    jb, js = jm.apply(variables, jax.tree_util.tree_map(jnp.asarray, preds),
                      method=jm.generate_predicted_boxes)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(js))
    boxes = boxes.numpy()[0]
    np.testing.assert_allclose(boxes[n0 + flat_i], gt, rtol=1e-4, atol=1e-4)
    others = np.delete(boxes[n0:], flat_i, axis=0)
    np.testing.assert_allclose(others, np.delete(anchors, flat_i, axis=0),
                               rtol=1e-4, atol=1e-4)
    s = scores.numpy()[0]  # each group scores its own class only
    assert (s[:n0, 1] == 0).all() and (s[n0:, 0] == 0).all()


def test_multi_head_assign_targets_hits_matching_slot():
    jm, variables, tm = _layout_head()
    nx = L_GRID[0] // STRIDE
    car = tm.meta(0, "anchors").numpy()
    flat_i = (3 * nx + 4) * 2 + 0  # the Car rot-0 slot at cell (3, 4)
    gt = np.zeros((1, 2, 8), np.float32)
    gt[0, 0, :7] = car[flat_i]
    gt[0, 0, 7] = 1
    got = tm.assign_targets(_t(gt))
    want = jm.apply(variables, jnp.asarray(gt), method=jm.assign_targets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["box_cls_labels"].numpy(),
                                      np.asarray(w["box_cls_labels"]))
        np.testing.assert_allclose(g["box_reg_targets"].numpy(),
                                   np.asarray(w["box_reg_targets"]),
                                   rtol=1e-6, atol=1e-6)
    car_l = got[0]["box_cls_labels"].numpy()[0]
    ped_l = got[1]["box_cls_labels"].numpy()[0]
    assert car_l[flat_i] == 1  # the Car slot matched as Car
    assert (ped_l[flat_i:flat_i + 2] <= 0).all()  # not the Pedestrian slots


# ------------------------------------------------------------- detector
def second_multi_cfg():
    cfg = json.loads(json.dumps(second_cfg()))
    cfg["DENSE_HEAD"] = multi_head_cfg()
    return cfg


MULTI_KW = dict(num_class=2, class_names=CLASSES, grid_size=GRID,
                voxel_size=(0.4, 0.4, 0.5), point_cloud_range=PC_RANGE,
                batch_size=BATCH, max_voxels=MAX_VOXELS,
                max_points_per_voxel=4)


@pytest.fixture(scope="module")
def second_multi():
    rng = np.random.default_rng(0)
    batch = make_batch(rng, pillar=False)
    # a Car and a Pedestrian a frame with an anchor centre inside each
    # (the 4 x 4 anchor grid is 12.8 / 3 m apart): ATSS positives in both
    # groups
    batch["gt_boxes"][:, 0] = [4.5, 2.3, -1.0, 3.9, 1.6, 1.56, 0.3, 1]
    batch["gt_boxes"][:, 1] = [8.7, -2.0, -0.6, 0.8, 0.6, 1.73, -0.5, 2]
    batch["gt_boxes"][1, :2, :2] += 0.1
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jm = j_build(model_cfg=JDict(second_multi_cfg()), **MULTI_KW)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k, b: jm.init({"params": k, "dropout": k}, b,
                                             train=False))(key, jb)
    brng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (brng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else brng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    for hi in range(2):
        variables["params"]["dense_head"][f"head{hi}_cls"]["bias"][:] = 0.0
    evals = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, jb)

    def loss_fn(params):
        out, upd = jm.apply({**variables, "params": params}, jb, train=True,
                            rngs={"dropout": key}, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], upd["batch_stats"])

    (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tm = t_build(TDict(second_multi_cfg()), **MULTI_KW, num_point_features=4,
                 device="cpu")
    load_flax_variables(tm, variables)
    return dict(evals=evals, loss=loss, tb=tb, stats=stats, grads=grads,
                tm=tm, batch={k: _t(v) for k, v in batch.items()})


def test_second_anchor_head_multi_atss_eval_matches_jax(second_multi):
    want = second_multi["evals"]
    with torch.no_grad():
        got = second_multi["tm"](second_multi["batch"])
    for b in range(BATCH):
        wm = np.asarray(want["final_mask"][b])
        gm = got["final_mask"][b].numpy()
        assert wm.sum() == gm.sum() > 0
        np.testing.assert_allclose(
            box_rows(got["final_boxes"][b].numpy(),
                     got["final_scores"][b].numpy(),
                     got["final_labels"][b].numpy(), gm),
            box_rows(want["final_boxes"][b], want["final_scores"][b],
                     want["final_labels"][b], wm), rtol=1e-4, atol=1e-4)


def test_second_anchor_head_multi_atss_train_matches_jax(second_multi):
    model = copy.deepcopy(second_multi["tm"])
    model.zero_grad()
    loss, tb = forward_backward(model, second_multi["batch"])
    np.testing.assert_allclose(float(loss), float(second_multi["loss"]),
                               rtol=1e-5)
    assert set(tb) == set(second_multi["tb"]) == {
        "rpn_head0_loss", "rpn_head1_loss", "rpn_loss"}
    for k, v in second_multi["tb"].items():
        np.testing.assert_allclose(float(tb[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    got_s = leaves(to_flax_tree(model, "batch_stats"))
    want_s = leaves(second_multi["stats"])
    assert set(got_s) == set(want_s)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    got_g = leaves(to_flax_tree(model, "params", grads=True))
    want_g = leaves(second_multi["grads"])
    assert set(got_g) == set(want_g)
    diff = np.sqrt(sum(((got_g[k] - w) ** 2).sum() for k, w in want_g.items()))
    norm = np.sqrt(sum((w ** 2).sum() for w in want_g.values()))
    assert diff <= 1e-3 * norm, (diff, norm)
    zero = [k for k in want_g if k.startswith("['dense_head']")
            and not np.abs(want_g[k]).sum() > 0]
    assert not zero, zero
