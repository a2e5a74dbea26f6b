"""CaDDN's camera branch and detector: the port against the JAX package on
the CPU (f32, numpy-seeded inputs, flax-initialised weights carried by
``bridge.load_flax_variables``).

- ``bin_depths_lid`` on depths in front of DEPTH_MIN, inside and past
  DEPTH_MAX, to 1e-6 (finite everywhere);
- ``DepthFFN`` at an even and an odd image size (48 x 64, 45 x 62: the
  flax ``SAME`` split of every stride-2 conv differs between them), and
  ``Conv2DCollapse``: eval and train outputs, updated BatchNorm statistics
  and the input's cotangent within 1e-5 of their largest magnitude, every
  parameter's gradient within 1e-5 (``Conv2DCollapse``) or 1e-4
  (``DepthFFN``: the ASPP's image-level branch sums its kernel's cotangent
  over every pixel of the map, and the two packages' f32 sums, in other
  orders, were seen 1.1e-5 apart) of its largest magnitude
  (``check_module``);
- ``ddn_loss`` with and without ``gt_boxes2d`` at 45 x 62 depth maps over
  6 x 8 logits (stride ``45 // 6 = 7``, a half-pixel nearest resize):
  the loss and its terms to 1e-5 relative, the logits' cotangent to 1e-5;
- ``ImageVFE`` (the frustum-to-voxel sampler) on a grid wider than the
  camera's view, with voxels behind the camera, past the depth range and
  off the image: as ``DepthFFN``;
- the tiny CaDDN of the JAX suite (``test_model_forward.py``'s config):
  eval detections as a set to 1e-4, the training loss (anchor terms and
  the depth loss) to 1e-5 relative, the updated statistics to 1e-5 and
  every gradient leaf within 1e-4 of its norm;
- the shipped ``CaDDN.yaml``'s BEV backbone leaves its map at stride 1
  while its anchors are laid at stride 2: both packages refuse it at the
  same place (the JAX package when tracing the decode, the port by
  shapes), and ``LOAD_IMAGES`` is read by neither package's datasets.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.models import build_network as j_build
from mssvt_tpu.models.backbones_2d.map_to_bev import (
    Conv2DCollapse as JCollapse,
)
from mssvt_tpu.models.backbones_3d import image_vfe as jv
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.models.backbones_2d.map_to_bev import Conv2DCollapse
from mssvt_tpu_torch.models.backbones_3d import image_vfe as tv
from mssvt_tpu_torch.runtime.train_utils import forward_backward
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_torch_pointnet2 import check_module
from test_torch_roi import _t, box_rows, leaves, near

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
D_MIN, D_MAX = 2.0, 20.0
# the parameter gradients through DepthFFN, whose ASPP pooling branch sums
# over every pixel (the module note)
FFN_GRAD_TOL = 1e-4


def test_bin_depths_lid_matches_jax():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(-5.0, 60.0, 200), [-1.0, 0.0, 1.99, 2.0,
                                                        46.8, 100.0]])
    d = d.astype(np.float32)
    for n in (16, 80):
        want = np.asarray(jv.bin_depths_lid(jnp.asarray(d), 2.0, 46.8, n))
        got = tv.bin_depths_lid(_t(d), 2.0, 46.8, n).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert got[d < 2.0].max() == 0.0 and got[d > 46.8].min() == n - 1


@pytest.mark.parametrize("hw", [(48, 64), (45, 62)])
def test_depth_ffn_matches_jax(hw):
    """Two stages of two blocks (strided projections), the ASPP rates
    (1, 6, 12) over a map smaller than the widest rate."""
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jm = jv.DepthFFN(num_depth_bins=6, num_channels=4, num_blocks=3,
                     blocks_per_stage=2)
    tm = tv.DepthFFN(6, 4, 3, 2)
    got, _ = check_module(
        jm, tm, {"images": images},
        lambda m, train, images: m(images, train=train),
        lambda m, images: m(images), grad_inputs=("images",),
        grad_tol=FFN_GRAD_TOL)
    feat, logits = got
    assert feat.shape == (2, -(-hw[0] // 8), -(-hw[1] // 8), 4)
    assert logits.shape[-1] == 7


def test_conv2d_collapse_matches_jax():
    rng = np.random.default_rng(2)
    vox = rng.normal(size=(2, 5, 6, 3, 4)).astype(np.float32)
    check_module(JCollapse(num_bev_features=8), Conv2DCollapse(12, 8),
                 {"vox": vox}, lambda m, train, vox: (m(vox, train=train),),
                 lambda m, vox: (m(vox),), grad_inputs=("vox",))


def _depth_inputs(rng):
    b, h, w, n = 2, 6, 8, 12
    logits = rng.normal(size=(b, h, w, n + 1)).astype(np.float32)
    depth = rng.uniform(-2.0, 25.0, (b, 45, 62)).astype(np.float32)
    depth[:, ::4] = 0.0  # rows without depth
    boxes = np.array([[[3.0, 2.0, 30.0, 20.0], [40.0, 10.0, 61.0, 44.0],
                       [5.0, 5.0, 5.0, 9.0]],
                      [[0.0, 0.0, 13.0, 44.0], [0.0, 0.0, 0.0, 0.0],
                       [20.0, 30.0, 50.0, 40.0]]], np.float32)
    return logits, depth, boxes, n


@pytest.mark.parametrize("with_boxes", [False, True])
def test_ddn_loss_matches_jax(with_boxes):
    logits, depth, boxes, n = _depth_inputs(np.random.default_rng(3))
    kw = dict(d_min=D_MIN, d_max=D_MAX, n_bins=n, alpha=0.25, gamma=2.0,
              fg_weight=13.0, bg_weight=1.0)
    jb = jnp.asarray(boxes) if with_boxes else None

    def jf(lg):
        loss, tb = jv.ddn_loss(lg, jnp.asarray(depth), gt_boxes2d=jb, **kw)
        return loss, tb

    (want, wtb), g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    tl = _t(logits).requires_grad_()
    got, tb = tv.ddn_loss(tl, _t(depth), gt_boxes2d=_t(boxes) if with_boxes
                          else None, **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in wtb:
        np.testing.assert_allclose(float(tb[k].detach()), float(wtb[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    near(tl.grad, g, "d logits")
    fg = float(wtb["ddn_loss_fg"])
    assert (fg > 0) == with_boxes and float(wtb["ddn_loss_bg"]) > 0


def test_depth_map_resize_and_stride_as_jax():
    """The half-pixel nearest resize (``nearest-exact``) and the ``//``
    stride: at 375 x 1242 -> 47 x 156 the stride is 7, and plain
    ``nearest`` would sample other pixels."""
    rng = np.random.default_rng(4)
    d = rng.uniform(0, 1, (1, 375, 1242)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(d), (1, 47, 156),
                                       "nearest"))
    exact = torch.nn.functional.interpolate(_t(d)[:, None], size=(47, 156),
                                            mode="nearest-exact")[:, 0]
    floor = torch.nn.functional.interpolate(_t(d)[:, None], size=(47, 156),
                                            mode="nearest")[:, 0]
    np.testing.assert_array_equal(exact.numpy(), want)
    assert (floor.numpy() != want).mean() > 0.5
    assert 375 // 47 == 7


VFE_CFG = {"FFN": {"DDN_CFG": {"NUM_CHANNELS": 4, "NUM_BLOCKS": 2}},
           "DISCRETIZE": {"DEPTH_MIN": D_MIN, "DEPTH_MAX": D_MAX,
                          "NUM_BINS": 8}}


def _calib(b):
    """A camera looking down lidar +x (cam z = lidar x), focal 30, the
    principal point (32, 24), one frame yawed a little."""
    l2c = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    base = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
    for i in range(b):
        a = 0.15 * i
        yaw = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]], np.float32)
        l2c[i, :3, :3] = base @ yaw
        l2c[i, :3, 3] = [0.1 * i, -0.2, 0.05]
    c2i = np.zeros((b, 3, 4), np.float32)
    c2i[:, 0, 0] = c2i[:, 1, 1] = 30.0
    c2i[:, 0, 2], c2i[:, 1, 2] = 32.0, 24.0
    c2i[:, 2, 2] = 1.0
    return l2c, c2i


def test_image_vfe_sampler_matches_jax():
    """Grid x from -4 m (behind the camera) to 28 m (past DEPTH_MAX), y
    across +-12 m (off the image's sides)."""
    grid, vs, pcr = (16, 12, 3), (2.0, 2.0, 1.0), (-4.0, -12.0, -1.5, 28.0,
                                                   12.0, 1.5)
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 1, (2, 45, 62, 3)).astype(np.float32)
    l2c, c2i = _calib(2)
    jm = jv.ImageVFE(model_cfg=VFE_CFG, grid_size=grid, voxel_size=vs,
                     point_cloud_range=pcr)
    tm = tv.ImageVFE(VFE_CFG, grid, vs, pcr)
    got, want = check_module(
        jm, tm, {"images": images, "l2c": l2c, "c2i": c2i},
        lambda m, train, images, l2c, c2i: m(images, l2c, c2i, train=train),
        lambda m, images, l2c, c2i: m(images, l2c, c2i),
        grad_inputs=("images",), grad_tol=FFN_GRAD_TOL)
    vox = np.asarray(want[0])
    live = np.abs(vox).sum(-1) > 0
    assert vox.shape == (2, *grid, 4)
    assert 0.05 < live.mean() < 0.6  # voxels in and out of the view


# ------------------------------------------------------------- detector
def caddn_cfg():
    """``tests/test_model_forward.py``'s tiny CaDDN."""
    return {
        "NAME": "CaDDN",
        "VFE": {"NAME": "ImageVFE",
                "FFN": {"DDN_CFG": {"NUM_CHANNELS": 8, "NUM_BLOCKS": 2}},
                "DISCRETIZE": {"DEPTH_MIN": 2.0, "DEPTH_MAX": 20.0,
                               "NUM_BINS": 16},
                "LOSS_WEIGHT": 3.0},
        "MAP_TO_BEV": {"NAME": "Conv2DCollapse", "NUM_BEV_FEATURES": 16},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2],
                        "LAYER_STRIDES": [2], "NUM_FILTERS": [16],
                        "UPSAMPLE_STRIDES": [2], "NUM_UPSAMPLE_FILTERS": [16]},
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle", "USE_DIRECTION_CLASSIFIER": False,
            "ANCHOR_GENERATOR_CONFIG": [{
                "class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]],
                "anchor_rotations": [0, 1.57],
                "anchor_bottom_heights": [-1.78], "align_center": False,
                "feature_map_stride": 1, "matched_threshold": 0.6,
                "unmatched_threshold": 0.45}],
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                "cls_weight": 1.0, "loc_weight": 2.0,
                "code_weights": [1.0] * 7}}},
        "POST_PROCESSING": {
            "SCORE_THRESH": 0.1,
            "NMS_CONFIG": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                           "NMS_PRE_MAXSIZE": 32, "NMS_POST_MAXSIZE": 16}}}


CADDN_KW = dict(num_class=1, class_names=["Car"], grid_size=(16, 16, 4),
                voxel_size=(0.8, 0.8, 1.0),
                point_cloud_range=(0.0, -6.4, -2.0, 12.8, 6.4, 2.0),
                batch_size=2, max_voxels=64, max_points_per_voxel=1)


def caddn_batch(rng):
    """Two frames of the JAX suite's synthetic calibration (the second
    yawed), images, depth maps with holes, GT boxes and 2D boxes."""
    l2c, c2i = _calib(2)
    depth = rng.uniform(2, 18, (2, 48, 64)).astype(np.float32)
    depth[:, ::3] = 0.0
    gt = np.zeros((2, 3, 8), np.float32)
    gt[0, 0] = [6, 0, -1, 3.9, 1.6, 1.56, 0.2, 1]
    gt[0, 1] = [9.5, 3.0, -1, 3.9, 1.6, 1.56, 1.4, 1]
    gt[1, 0] = [4.3, -2.2, -1, 3.9, 1.6, 1.56, -0.3, 1]
    return {"images": rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32),
            "trans_lidar_to_cam": l2c, "trans_cam_to_img": c2i,
            "depth_maps": depth, "gt_boxes": gt,
            "gt_boxes2d": np.array([[[10, 8, 40, 30], [30, 2, 60, 20]],
                                    [[0, 0, 20, 47], [0, 0, 0, 0]]],
                                   np.float32)}


@pytest.fixture(scope="module")
def caddn_pair():
    batch = caddn_batch(np.random.default_rng(6))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jm = j_build(model_cfg=JDict(caddn_cfg()), **CADDN_KW)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k, b: jm.init({"params": k, "dropout": k}, b,
                                             train=False))(key, jb)
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    variables["params"]["dense_head"]["conv_cls"]["bias"][:] = 0.0
    evals = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, jb)

    def loss_fn(params):
        out, upd = jm.apply({**variables, "params": params}, jb, train=True,
                            rngs={"dropout": key}, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], upd["batch_stats"])

    (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tm = t_build(TDict(caddn_cfg()), **CADDN_KW, device="cpu")
    assert load_flax_variables(tm, variables) == len(leaves(variables))
    return dict(variables=variables, evals=evals, loss=loss, tb=tb,
                stats=stats, grads=grads, tm=tm,
                batch={k: _t(v) for k, v in batch.items()})


def test_caddn_eval_matches_jax(caddn_pair):
    want = caddn_pair["evals"]
    with torch.no_grad():
        got = caddn_pair["tm"](caddn_pair["batch"])
    for b in range(2):
        wm = np.asarray(want["final_mask"][b])
        gm = got["final_mask"][b].numpy()
        assert wm.sum() == gm.sum() > 0
        np.testing.assert_allclose(
            box_rows(got["final_boxes"][b].numpy(),
                     got["final_scores"][b].numpy(),
                     got["final_labels"][b].numpy(), gm),
            box_rows(want["final_boxes"][b], want["final_scores"][b],
                     want["final_labels"][b], wm), rtol=1e-4, atol=1e-4)


def test_caddn_loss_and_gradients_match_jax(caddn_pair):
    model = copy.deepcopy(caddn_pair["tm"])
    model.zero_grad()
    loss, tb = forward_backward(model, caddn_pair["batch"])
    np.testing.assert_allclose(float(loss), float(caddn_pair["loss"]),
                               rtol=1e-5)
    want_tb = caddn_pair["tb"]
    assert set(tb) == set(want_tb) == {"rpn_loss_cls", "rpn_loss_loc",
                                       "rpn_loss", "depth_loss"}
    for k, v in want_tb.items():
        np.testing.assert_allclose(float(tb[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    got_s = leaves(to_flax_tree(model, "batch_stats"))
    want_s = leaves(caddn_pair["stats"])
    assert set(got_s) == set(want_s)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    got_g = leaves(to_flax_tree(model, "params", grads=True))
    want_g = leaves(caddn_pair["grads"])
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        err = np.sqrt(((got_g[k] - w) ** 2).sum())
        assert err <= 1e-4 * np.sqrt((w ** 2).sum()), (k, err)
    assert np.abs(want_g["['vfe']['ffn']['stem']['kernel']"]).sum() > 0


def _yaml_kw():
    from mssvt_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(ROOT / "tools/cfgs/kitti_models/CaDDN.yaml"),
                             TDict())
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vs = tuple(dc.DATA_PROCESSOR[-1].VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    return cfg, dict(num_class=3, class_names=cfg.CLASS_NAMES, grid_size=grid,
                     voxel_size=vs, point_cloud_range=pcr, batch_size=1,
                     max_voxels=16, max_points_per_voxel=5)


def test_caddn_yaml_anchor_stride_divergence_as_in_jax():
    """``CaDDN.yaml`` lays its anchors at stride 2 (140 x 188 x 6 = 157 920)
    while its BEV backbone (strides [1, 2], upsampling [1, 2]) leaves the
    map at stride 1 (376 x 280 x 6 = 631 680 predictions): the JAX package
    fails tracing the decode, and the port's head holds the same anchors
    against the same map."""
    from mssvt_tpu.config import cfg_from_yaml_file as j_cfg

    cfg, kw = _yaml_kw()
    assert kw["grid_size"] == (280, 376, 25)
    jcfg = j_cfg(str(ROOT / "tools/cfgs/kitti_models/CaDDN.yaml"), JDict())
    jm = j_build(model_cfg=jcfg.MODEL, **kw)
    S = jax.ShapeDtypeStruct
    b = {"images": S((1, 375, 1242, 3), jnp.float32),
         "trans_lidar_to_cam": S((1, 4, 4), jnp.float32),
         "trans_cam_to_img": S((1, 3, 4), jnp.float32)}
    with pytest.raises(TypeError, match="631680.*157920|157920.*631680"):
        jax.eval_shape(lambda b: jm.init({"params": jax.random.PRNGKey(0)},
                                         b, train=False), b)
    model = t_build(cfg.MODEL, **kw, device="cpu")
    b2d = cfg.MODEL.BACKBONE_2D
    out_stride = b2d.LAYER_STRIDES[0] // b2d.UPSAMPLE_STRIDES[0]
    assert model.dense_head.anchors.shape[0] == 157_920
    assert (376 // out_stride) * (280 // out_stride) * 6 == 631_680
    assert model.map_to_bev.collapse_conv.in_channels == 25 * 64


def test_load_images_is_read_by_no_dataset():
    """``LOAD_IMAGES: True`` in ``CaDDN.yaml`` has no reader in either
    package's datasets, so neither yields camera inputs from files: CaDDN
    trains from in-memory batches only (no image loader is added)."""
    cfg, _ = _yaml_kw()
    assert cfg.DATA_CONFIG.LOAD_IMAGES is True
    for pkg in ("mssvt_tpu", "mssvt_tpu_torch"):
        for path in (ROOT / pkg / "datasets").glob("*.py"):
            assert "LOAD_IMAGES" not in path.read_text(), path
