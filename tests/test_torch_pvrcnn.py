"""PV-RCNN and PV-RCNN++: the point head, VoxelSetAbstraction, the PV-RCNN
head and the detectors, the port against the JAX package on the CPU (f32).

- modules (``test_torch_pointnet2.check_module``: flax-initialised
  variables with random BatchNorm statistics, eval outputs, then training
  outputs, updated statistics, every parameter's gradient and the inputs'
  cotangents): ``PointHeadSimple`` and its loss, ``VoxelSetAbstraction``
  with FPS keypoints and with SPC keypoints and the vector-pool source,
  ``PVRCNNHead`` (with the RoIs' cotangent), each to 1e-5 of the largest
  magnitude, but for the head's gradients: its BatchNorm layers take
  E[x^2] - E[x]^2 over every (grid point, slot) entry, the replicated
  slots and the zeroed rows of empty grid points among them, and over a
  few RoIs, and the rounding of that cancellation leaves them 1e-4 of each
  leaf's largest magnitude apart (as VoxelRCNN's pooling BatchNorm).
- detectors (the JAX suite's ``test_pvrcnn_pointrcnn.py`` configs: FPS
  keypoints, SPC keypoints, PVRCNNPlusPlus with the vector pool; DP_RATIO
  0) through ``test_torch_roi``'s harness, on its tiny grid with GT boxes
  near anchors and 512 seeded point rows a frame (17 padding rows in the
  second): eval as sets (1e-4), loss and every ``tb_dict`` term, updated
  statistics, all gradients within 1e-3 of their global norm; for FPS the
  RoI stage alone fed JAX's keypoints and features (loss 1e-4 relative,
  each RoI-head leaf and the cotangents of the keypoint features and the
  RoIs 1e-4) and the bridge's round trip for both registry names.
- the shipped ``pv_rcnn.yaml`` / ``pv_rcnn_plusplus.yaml``: registry names,
  the ++ recipe (SPC, vector pool), and both build on the card by default
  and on the CPU when asked, at their published widths.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.models.backbones_3d.pfe import (
    VoxelSetAbstraction as JVSA,
)
from mssvt_tpu.models.dense_heads.point_head import (
    PointHeadSimple as JPointHeadSimple,
)
from mssvt_tpu.models.dense_heads.point_head import (
    assign_point_targets as j_assign,
)
from mssvt_tpu.models.detectors.generic_post import apply_vfe as j_apply_vfe
from mssvt_tpu.models.roi_heads import roi_head_template as j_rt
from mssvt_tpu.models.roi_heads.pvrcnn_head import PVRCNNHead as JPVRCNNHead
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.models.backbones_3d.pfe import VoxelSetAbstraction
from mssvt_tpu_torch.models.dense_heads.point_head import (
    PointHeadSimple,
    assign_point_targets,
)
from mssvt_tpu_torch.models.roi_heads import roi_head_template as t_rt
from mssvt_tpu_torch.models.roi_heads.pvrcnn_head import PVRCNNHead
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_pvrcnn_pointrcnn import MAX_POINTS, pvrcnn_cfg
from test_torch_pointnet2 import check_module, kitti_points
from test_torch_roi import (
    BATCH,
    PC_RANGE,
    VOXEL_SIZE,
    _t,
    check_eval,
    check_roi_stage,
    check_round_trip,
    check_train,
    make_batch,
    make_pair,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def point_batch(seed=0):
    """``test_torch_roi.make_batch`` (voxels, GT boxes near anchors) with
    the JAX suite's raw points: 512 rows a frame over the range, 17 padding
    rows in the second frame."""
    rng = np.random.default_rng(seed)
    batch = make_batch(rng)
    pts = np.zeros((BATCH * MAX_POINTS, 4), np.float32)
    valid = np.zeros(BATCH * MAX_POINTS, bool)
    for b in range(BATCH):
        n, lo = MAX_POINTS - 17 * b, b * MAX_POINTS
        pts[lo:lo + n, :3] = rng.uniform(PC_RANGE[:3], PC_RANGE[3:], (n, 3))
        pts[lo:lo + n, 3] = rng.uniform(0, 1, n)
        valid[lo:lo + n] = True
    return dict(batch, points=pts, points_valid=valid)


# ------------------------------------------------------------------ modules
def test_point_head_simple_and_loss_match_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 40, 12)).astype(np.float32)
    cfg = {"CLS_FC": [16, 8]}
    check_module(JPointHeadSimple(model_cfg=cfg, input_channels=12),
                 PointHeadSimple(cfg, 12), {"x": x},
                 lambda m, train, x: (m(x, train=train),),
                 lambda m, x: (m(x),), grad_inputs=("x",))
    logits = rng.normal(size=(2, 40, 1)).astype(np.float32)
    pts = rng.uniform(-4, 4, (2, 40, 3)).astype(np.float32)
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, 0] = [0, 0, 0, 4, 3, 2, 0.3, 1]
    gt[:, 1] = [2, -2, 0, 2, 2, 2, -0.4, 2]
    valid = np.ones((2, 40), bool)
    labels, _ = assign_point_targets(_t(pts), _t(valid), _t(gt))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_assign(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(gt))[0]))
    assert (labels > 0).any() and (labels == 0).any()
    want, gw = jax.value_and_grad(lambda l_: JPointHeadSimple.get_loss(
        l_, jnp.asarray(labels.numpy())))(jnp.asarray(logits))
    tl = _t(logits).requires_grad_()
    got = PointHeadSimple.get_loss(tl, labels)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-8)


def _sources(rng, n_pts=300, n_vox=120, c_vox=6):
    """Raw points (padded at the origin) and a sparse stage's voxel sites
    near them, per frame, over a 12.8 m range."""
    pts = rng.uniform(PC_RANGE[:3], PC_RANGE[3:], (2, n_pts, 3)).astype(
        np.float32)
    pvalid = np.arange(n_pts)[None].repeat(2, 0) < np.array([[280], [250]])
    pts *= pvalid[..., None]
    feat = rng.normal(size=(2, n_pts, 1)).astype(np.float32) * pvalid[..., None]
    sx = rng.uniform(PC_RANGE[:3], PC_RANGE[3:], (2, n_vox, 3)).astype(
        np.float32)
    sv = np.arange(n_vox)[None].repeat(2, 0) < np.array([[110], [90]])
    sf = rng.normal(size=(2, n_vox, c_vox)).astype(np.float32) * sv[..., None]
    bev = rng.normal(size=(2, 4, 4, 5)).astype(np.float32)
    return dict(pts=pts, feat=feat, pvalid=pvalid, sx=sx, sf=sf, sv=sv,
                bev=bev)


VSA_CASES = {
    "fps": {"SAMPLE_METHOD": "FPS"},
    "spc_vector_pool": {"SAMPLE_METHOD": "SPC", "vector_pool": True},
}


@pytest.mark.parametrize("case", sorted(VSA_CASES))
def test_voxel_set_abstraction_matches_jax(case):
    """FPS keypoints (K2c's plain version), or SPC keypoints around two
    proposals with the vector-pool source: keypoints exactly, fused and
    concatenated features, statistics, every parameter's gradient, the
    cotangents of the sparse features and the BEV map."""
    rng = np.random.default_rng(12)
    cfg = json.loads(json.dumps(pvrcnn_cfg()["PFE"]))
    cfg["SAMPLE_METHOD"] = VSA_CASES[case]["SAMPLE_METHOD"]
    if VSA_CASES[case].get("vector_pool"):
        cfg["SA_LAYER"]["x_conv_out"] = {
            "NAME": "VectorPoolAggregationModuleMSG", "GRID_SIZE": 2,
            "POOL_RADIUS": [1.6, 3.2], "NSAMPLE": [16, 8],
            "MLPS": [[16, 16], [8, 8]]}
    x = _sources(rng)
    rois = np.zeros((2, 3, 7), np.float32)
    rois[:, :2, :3] = [[3, 2, 0], [9, -3, -1]]
    rois[:, :, 3:6] = 2.0
    roi_valid = np.array([[True, True, False], [True, False, False]])
    x.update(rois=rois, roi_valid=roi_valid)
    kw = dict(voxel_size=VOXEL_SIZE, point_cloud_range=PC_RANGE,
              num_keypoints=64)

    def j_call(m, train, pts, feat, pvalid, sx, sf, sv, bev, rois, roi_valid):
        return m(pts, feat, pvalid, {"x_conv_out": (sx, sf, sv)},
                 bev_features=bev, bev_stride=8, rois=rois,
                 roi_valid=roi_valid, train=train)

    def t_call(m, pts, feat, pvalid, sx, sf, sv, bev, rois, roi_valid):
        picks = m.sample_keypoints(pts, pvalid, rois, roi_valid)
        return m(pts, feat, pvalid, {"x_conv_out": (sx, sf, sv)}, picks,
                 bev_features=bev, bev_stride=8)

    got, want = check_module(
        JVSA(model_cfg=cfg, **kw),
        VoxelSetAbstraction(cfg, point_channels=1,
                            source_channels={"x_conv_out": 6},
                            bev_channels=5, **kw),
        x, j_call, t_call, grad_inputs=("sf", "bev"), grad_tol=1e-5)
    np.testing.assert_array_equal(got[0].detach().numpy(), np.asarray(want[0]))


def test_pvrcnn_head_matches_jax():
    """The head in training on keypoints around two RoIs and one far from
    every keypoint (its grid points are empty and pick keypoint 0):
    outputs, statistics, gradients, the cotangents of the keypoint
    features and of the RoIs."""
    rng = np.random.default_rng(13)
    kp = kitti_points(rng, 2, 96) * 0.15
    kf = rng.normal(size=(2, 96, 10)).astype(np.float32)
    rois = np.concatenate([kp[:, :4] + rng.normal(size=(2, 4, 3)).astype(
        np.float32) * 0.3, rng.uniform(1, 4, (2, 4, 3)),
        rng.uniform(-3, 3, (2, 4, 1))], -1).astype(np.float32)
    rois[:, -1, :3] = 200.0
    rv = np.array([[True, True, True, True], [True, True, False, True]])
    cfg = json.loads(json.dumps(pvrcnn_cfg()["ROI_HEAD"]))
    cfg.update(DP_RATIO=0.0, SHARED_FC=[16, 8],
               ROI_GRID_POOL={"POOL_RADIUS": [0.8, 1.6], "NSAMPLE": [8, 16],
                              "MLPS": [[8, 8], [8, 6]]})
    check_module(JPVRCNNHead(model_cfg=cfg, input_channels=10),
                 PVRCNNHead(cfg, 10),
                 {"kp": kp, "kf": kf, "rois": rois, "rv": rv},
                 lambda m, train, kp, kf, rois, rv: m(kp, kf, rois, rv,
                                                      train=train),
                 lambda m, kp, kf, rois, rv: m(kp, kf, rois, rv),
                 grad_inputs=("kf", "rois"), grad_tol=1e-4)


# ---------------------------------------------------------------- detectors
def _j_pvrcnn_roi_inputs(m, b):
    sp = JSV.create(features=j_apply_vfe(m.vfe, b, train=True),
                    coords=b["voxel_coords"], valid=b["voxel_valid"],
                    batch_size=m.batch_size, spatial_shape=m.grid_size,
                    voxel_size=m.voxel_size,
                    point_cloud_range=m.point_cloud_range)
    sp_out = m.backbone_3d(sp, train=True)
    bev = m.backbone_2d(sp_out.bev(), train=True)
    preds = m.dense_head(bev, train=True)
    boxes, scores_mc = m.dense_head.generate_predicted_boxes(preds)
    rois, _, _, rvalid = j_rt.proposal_layer(
        boxes[..., :7], jnp.max(scores_mc, -1),
        jnp.ones(scores_mc.shape[:2], bool), labels=jnp.argmax(scores_mc, -1)
        + 1, **t_rt.nms_kwargs(m.roi_cfg, True))
    xyz, feat, pvalid = m._per_sample_points(b)
    keypoints, kp_feat, _ = m.pfe(
        xyz, feat, pvalid, sources={"x_conv_out": sp_out.per_sample()},
        bev_features=bev, bev_stride=8, rois=rois, roi_valid=rvalid,
        train=True)
    kp_feat = kp_feat * jax.nn.sigmoid(m.point_head(kp_feat, train=True))
    return {"keypoints": keypoints, "kp_feat": kp_feat}, rois, rvalid


def plusplus_cfg():
    """The JAX suite's ``test_pvrcnn_plusplus_vector_pool`` config."""
    cfg = json.loads(json.dumps(pvrcnn_cfg("SPC")))
    cfg["NAME"] = "PVRCNNPlusPlus"
    cfg["PFE"]["SA_LAYER"]["x_conv_out"] = {
        "NAME": "VectorPoolAggregationModuleMSG", "GRID_SIZE": 2,
        "POOL_RADIUS": [1.6], "NSAMPLE": [16], "MLPS": [[16, 16]]}
    return cfg


PAIRS = {"pvrcnn": lambda: json.loads(json.dumps(pvrcnn_cfg("FPS"))),
         "pvrcnn_spc": lambda: json.loads(json.dumps(pvrcnn_cfg("SPC"))),
         "pvrcnn_plusplus": plusplus_cfg}
TB_KEYS = {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss",
           "rcnn_loss_cls", "rcnn_loss_reg", "point_loss_cls"}


@pytest.fixture(scope="module", params=sorted(PAIRS))
def pair(request):
    roi_inputs = _j_pvrcnn_roi_inputs if request.param == "pvrcnn" else None
    p = make_pair(PAIRS[request.param](), 1, roi_inputs, batch=point_batch())
    p["name"] = request.param
    return p


def test_two_stage_forward_and_loss(pair):
    """The JAX suite's three tiny cases as parity: eval outputs as sets,
    then the training loss, its terms, statistics and gradients."""
    assert pair["tm"].max_points == MAX_POINTS
    got = check_eval(pair)
    assert torch.isfinite(got["final_boxes"]).all()
    check_train(pair, TB_KEYS)
    if pair["name"] == "pvrcnn_plusplus":
        assert type(pair["tm"]).__name__ == "PVRCNN"
        assert hasattr(pair["tm"].pfe, "x_conv_out_vp_fc_0")
        assert pair["tm"].pfe.method == "SPC"


def test_pvrcnn_roi_stage_and_bridge(pair):
    """The RoI stage alone on JAX's keypoints (the FPS model), and the
    flax tree -> port -> flax tree round trip (every case)."""
    check_round_trip(pair)
    if pair["name"] != "pvrcnn":
        return
    check_roi_stage(
        pair,
        lambda m, x, t, v: m.roi_head(x["keypoints"], x["kp_feat"], t["rois"],
                                      v, train=True),
        lambda model, x, t, v: model.roi_head(x["keypoints"], x["kp_feat"],
                                              t["rois"], v),
        rtol=1e-4)


# ------------------------------------------------------- the shipped configs
def test_pv_rcnn_plusplus_yaml_recipe():
    """The shipped ``pv_rcnn_plusplus.yaml`` loads as the ++ recipe and its
    name is in the port's registry, as PVRCNN's."""
    from mssvt_tpu_torch.config import cfg_from_yaml_file
    from mssvt_tpu_torch.models.detectors import __all__ as registry

    cfg = cfg_from_yaml_file(
        str(ROOT / "tools/cfgs/kitti_models/pv_rcnn_plusplus.yaml"), TDict())
    assert cfg.MODEL.NAME == "PVRCNNPlusPlus"
    assert registry["PVRCNNPlusPlus"] is registry["PVRCNN"]
    assert cfg.MODEL.PFE.SAMPLE_METHOD == "SPC"
    assert (cfg.MODEL.PFE.SA_LAYER.x_conv_out.NAME
            == "VectorPoolAggregationModuleMSG")
    assert cfg.MODEL.ROI_HEAD.NAME == "PVRCNNHead"


def kitti_build_kw(name):
    """``build_network``'s arguments for ``kitti_models/<name>.yaml`` at its
    published widths and batch 2."""
    from mssvt_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(ROOT / f"tools/cfgs/kitti_models/{name}.yaml"),
                             TDict())
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vox = dc.DATA_PROCESSOR[-1]
    vs = tuple(vox.VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    return cfg, dict(model_cfg=cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                     class_names=cfg.CLASS_NAMES, grid_size=grid,
                     voxel_size=vs, point_cloud_range=pcr, batch_size=2,
                     max_voxels=vox.MAX_NUMBER_OF_VOXELS["train"],
                     max_points_per_voxel=vox.MAX_POINTS_PER_VOXEL,
                     num_point_features=len(
                         dc.POINT_FEATURE_ENCODING.used_feature_list))


@pytest.mark.parametrize("name", ["pv_rcnn", "pv_rcnn_plusplus"])
def test_pv_rcnn_configs_build_on_cuda_by_default(name, monkeypatch):
    """``build_network`` raises without a card unless ``device="cpu"``; the
    widths are the published ones."""
    cfg, kw = kitti_build_kw(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_build(**kw)
    model = t_build(**kw, device="cpu")
    assert type(model).__name__ == "PVRCNN"
    assert model.max_points == cfg.DATA_CONFIG.MAX_POINTS == 16384
    pfe = model.pfe
    assert pfe.num_keypoints == 2048 and pfe.raw_mlp_0.mlp_0.in_features == 4
    assert pfe.vsa_point_fc.in_features == 512 + 32 + 128
    assert pfe.vsa_point_fc.out_features == 128
    if name == "pv_rcnn":
        assert pfe.method == "FPS"
        assert pfe.x_conv_out_mlp_1.mlp_0.in_features == 3 + 128
    else:
        assert pfe.method == "SPC"
        assert pfe.x_conv_out_vp_fc_0.in_features == 8 * (3 + 128)
    head = model.roi_head
    assert head.grid == 6 and head.dp == 0.3
    assert head.pool_mlp_0.mlp_0.in_features == 3 + 128
    assert head.shared_fc_0.in_features == 128 * 216
    assert model.point_head.cls_fc_0.in_features == 128
    n = sum(p.numel() for p in model.parameters())
    assert n > 10_000_000, n


# -------------------------------- PV-RCNN++ at pcdet's sparse depth (41 z)
@pytest.mark.parametrize("pcdet,depth", [(True, 2), (False, 1)])
def test_pv_rcnn_plusplus_widths_at_pcdet_depth(pcdet, depth):
    """``pv_rcnn_plusplus.yaml`` at KITTI's grid with
    ``BACKBONE_3D.PCDET_SPARSE_SHAPE``: the sites one cell deeper in z (41
    -> 2), a 2 x 128-channel BEV map into the 2-D backbone; without the key
    the JAX package's 1 x 128. The keypoints sample the 2-D backbone's
    512-channel map either way, and the second stage keeps its widths."""
    cfg, kw = kitti_build_kw("pv_rcnn_plusplus")
    cfg.MODEL.BACKBONE_3D.PCDET_SPARSE_SHAPE = pcdet
    model = t_build(**kw, device="cpu")
    b3d = model.backbone_3d
    assert b3d.sparse_shape == (1408, 1600, 40 + pcdet)
    assert b3d.out_spatial_shape == (176, 200, depth)
    assert b3d.num_bev_features == 128 * depth
    assert model.backbone_2d.block0_conv0.weight.shape[1] == 128 * depth
    assert model.backbone_2d.num_bev_features == 512
    assert model.pfe.vsa_point_fc.in_features == 512 + 32 + 128
    assert model.pfe.x_conv_out_vp_fc_0.in_features == 8 * (3 + 128)
    assert model.roi_head.shared_fc_0.in_features == 128 * 216
    assert model.proposals.roi_cfg is model.roi_cfg


def test_pv_rcnn_plusplus_point_geometry_at_pcdet_depth():
    """At 41 z-cells (the benchmark's CPU rehearsal grid, 0.2 m voxels,
    KITTI's -3..1 m): the final stage's sites, which the vector pool reads,
    sit at their cells' centres with its (1.6, 1.6, 1.6) m cells, z in the
    two slices -2.2 and -0.6 m; a keypoint at the centre of a 2-D map cell
    reads that cell's features (the map at 8 voxels a cell); the RoI grid
    points lie inside their RoI."""
    from benchmark.harness import spec
    from benchmark.traffic import kitti_points_scene
    from mssvt_tpu_torch.models.roi_heads.pvrcnn_head import (
        roi_grid_points_3d,
    )

    reh = json.loads(json.dumps(spec.load_json(
        spec.BENCH / "rehearsal" / "pvrcnnpp-kitti.json")))
    reh["MODEL"].pop("DTYPE")
    data = reh["data"]
    torch.manual_seed(0)
    model = t_build(TDict(reh["MODEL"]), 3, reh["class_names"],
                    tuple(data["grid_size"]), tuple(data["voxel_size"]),
                    tuple(data["point_cloud_range"]), 2,
                    data["max_voxels_per_frame"], 5, num_point_features=4,
                    device="cpu").eval()
    host, _ = kitti_points_scene.make(
        dict(reh["traffic"]["params"], distinct_batches=1), reh, 2, 7)
    batch = {k: torch.as_tensor(v) for k, v in host[0].items()}
    seen = {}
    model.backbone_3d.conv_out.register_forward_hook(
        lambda m, a, o: seen.__setitem__("out", o))
    model.backbone_2d.register_forward_hook(
        lambda m, a, o: seen.__setitem__("map", o))
    with torch.no_grad():
        model(batch)
    out = seen["out"]
    assert out.spatial_shape[2] == 2
    assert out.voxel_size == pytest.approx((1.6, 1.6, 1.6))
    xyz, _, ok = out.per_sample()
    c = out.coords[out.valid][:, [3, 2, 1]].float()
    want = (c + 0.5) * 1.6 + torch.tensor([0.0, -6.4, -3.0])
    got = torch.cat([xyz[b][ok[b]] for b in range(2)])
    order = torch.argsort(out.coords[out.valid][:, 0], stable=True)
    torch.testing.assert_close(got, want[order], rtol=0, atol=1e-6)
    slices = torch.tensor([-2.2, -0.6])
    assert ((got[:, 2, None] - slices).abs().amin(1) < 1e-5).all()
    # a keypoint at the centre of the 2-D map's cell (y 3, x 5)
    bev = seen["map"]
    pts = torch.zeros(2, 4, 3)
    pts[:, 0] = torch.tensor([0.0 + 5.5 * 1.6, -6.4 + 3.5 * 1.6, -1.0])
    sources = {"x_conv_out": out.per_sample()}
    with torch.no_grad():
        _, _, cat = model.pfe(pts, pts[..., :1], torch.ones(2, 4, dtype=bool),
                              sources, torch.zeros(2, 3, dtype=torch.int32),
                              bev_features=bev, bev_stride=8)
    torch.testing.assert_close(cat[:, 0, :bev.shape[-1]], bev[:, 3, 5])
    rois = torch.tensor([[[4.0, 1.0, -1.0, 4.0, 2.0, 1.5, 0.7]]])
    g = roi_grid_points_3d(rois, 6)[0, 0]
    local = g[:, :2] - rois[0, 0, :2]
    h = rois[0, 0, 6]
    lx = local[:, 0] * torch.cos(h) + local[:, 1] * torch.sin(h)
    ly = -local[:, 0] * torch.sin(h) + local[:, 1] * torch.cos(h)
    assert (lx.abs() < 2.0).all() and (ly.abs() < 1.0).all()
    assert ((g[:, 2] + 1.0).abs() < 0.75).all()
