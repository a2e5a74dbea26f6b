"""The plain reference of ``pointrcnn-kitti`` (``benchmark/reference/
pointrcnn-kitti.py``: the frozen plain FPS and rotated NMS,
``point_voxel``'s ball query, pcdet's 3-NN, pool and heads written out)
against the port's PointRCNN with pcdet's RoI head, on the CPU at the
rehearsal's size, in float32 on both sides, on the benchmark's seeded
weights: stage by stage with the FPS picks and ball-query members, the
RoI head alone on RoIs that hold points, its pooled channels, the whole
forward, and the choice of head by the config."""

import copy

import pytest
import torch

from benchmark.harness import compare, program, spec, weights
from benchmark.traffic import kitti_points_scene
from mssvt_tpu_torch.models import build_network
from mssvt_tpu_torch.models.detectors.point_rcnn import PointRCNNRoIHead
from mssvt_tpu_torch.models.roi_heads.pointrcnn_head import PointRCNNHead
from mssvt_tpu_torch.utils.edict import EasyDict
from test_pvrcnnpp_kitti_reference import _program_outputs

REHEARSAL = spec.load_json(spec.BENCH / "rehearsal" / "pointrcnn-kitti.json")
BATCH = 2
SEED = 2**32 + 11


@pytest.fixture(scope="module")
def pair():
    """(reference module, reference model, program, batches) on the seeded
    weights, float32 on both sides."""
    torch.set_num_threads(2)
    config = copy.deepcopy(REHEARSAL)
    config["MODEL"].pop("DTYPE")
    ref = spec.load_module(spec.BENCH / "reference" / "pointrcnn-kitti.py")
    cpu = torch.device("cpu")
    host, _ = kitti_points_scene.make(config["traffic"]["params"], config,
                                      BATCH, SEED)
    batches = [program.to_device(b, cpu) for b in host]
    ref_model = ref.build(config, BATCH, cpu)
    made = weights.make(ref_model, SEED, cpu, batches[0], ref.forward)
    model = program.build(config, BATCH, cpu, made)
    return ref, ref_model, model, batches


def test_weights_cover_the_programs_parameters(pair):
    """The reference holds every parameter of the program under its name
    and shape (the harness loads them by name); the program's RoI head is
    pcdet's, at the rehearsal's levels."""
    _, ref_model, model, _ = pair
    mine = dict(ref_model.named_parameters())
    for name, p in model.named_parameters():
        assert name in mine and mine[name].shape == p.shape, name
    assert isinstance(model.roi_head, PointRCNNHead)
    assert [getattr(model.roi_head, f"sa_{i}").npoint
            for i in range(3)] == [32, 8, None]


def test_stages_equal_the_reference(pair):
    """Stage by stage (each reference stage fed the program's output of the
    one before): the same FPS picks at every level of the backbone and the
    RoI head, the same ball-query members, the set abstractions, the point
    head, the RoI head's pool, MLPs and outputs to f32 rounding (1e-5), the
    proposals and detections equal. The feature propagations to 1e-3: the
    port's 3-NN expands |u|^2 + |k|^2 - 2 u.k (the JAX package's), the
    reference subtracts (pcdet's), and the weights of a point's farther
    neighbours round apart by ~1e-4."""
    ref, ref_model, model, batches = pair
    for batch in batches:
        got, dets = _program_outputs(ref, ref_model, model, batch)
        assert set(got) == set(ref.capture(ref_model))
        n = ref.judge(ref_model, batch, got, dets)
        assert n["fps_gap"] == 0.0 and n["query_gap"] == 0.0, n
        for k in ("backbone_rel", "head_rel", "roi_rel"):
            assert n[k] < 1e-5, n
        assert n["bev_rel"] < 1e-3, n
        assert n["det_gap"] == 0.0 and n["count_gap"] == 0.0, n
        assert int(dets[3].sum()) > 0
        assert int(got["proposals"][3].sum()) > 0


def _rois_on_points(xyz, valid, g):
    """(B, 6, 7) RoIs: four centred on valid points (3 x 2 x 2 m, any
    heading), one of 0.5 m holding a few points (the pool wraps), one
    far from every point (empty)."""
    rois = []
    for b in range(xyz.shape[0]):
        pts = xyz[b][valid[b]]
        pick = pts[torch.randint(len(pts), (5,), generator=g)]
        size = torch.tensor([[3.0, 2.0, 2.0]] * 4 + [[0.5, 0.5, 0.5]])
        head = torch.rand((5, 1), generator=g) * 6.0 - 3.0
        far = torch.tensor([[500.0, 500.0, 500.0, 1.0, 1.0, 1.0, 0.0]])
        rois.append(torch.cat([torch.cat([pick, size, head], 1), far]))
    return torch.stack(rois)


def test_pcdet_head_equals_the_reference_head(pair):
    """The program's ``PointRCNNHead`` against the reference's on the
    program's point features and class scores and RoIs that hold points
    (one few-point RoI, one empty, one not valid): the pool equal, every
    FPS pick and ball-query member inside the RoIs equal, the outputs to
    1e-5 of their magnitude."""
    ref, ref_model, model, batches = pair
    batch = batches[0]
    got, _ = _program_outputs(ref, ref_model, model, batch)
    xyz, _, valid = ref_model.points(batch)
    pf = got["backbone_3d.fp_0"]
    scores = torch.sigmoid(got["point_head"][0]).amax(-1) * valid
    rois = _rois_on_points(xyz, valid, torch.Generator().manual_seed(3))
    roi_valid = torch.ones(rois.shape[:2], dtype=torch.bool)
    roi_valid[1, 2] = False
    seen = {}
    hooks = [getattr(model.roi_head, f"sa_{i}").register_forward_hook(
        lambda m, a, o, i=i: seen.__setitem__(i, (a[0], o)))
        for i in range(2)]
    with torch.no_grad():
        got_cls, got_reg = model.roi_head(xyz, pf, valid, rois, roi_valid,
                                          scores)
    for h in hooks:
        h.remove()
    head = ref_model.roi_head
    pooled, empty = head.pool(xyz, pf, valid, scores, rois)
    want_pool, want_empty = model.roi_head.pool(xyz, pf, valid, scores, rois)
    assert torch.equal(pooled, want_pool) and torch.equal(empty, want_empty)
    assert empty[:, 5].all() and not empty[:, :5].any()
    for i, (xyz_in, (_, _, picks)) in seen.items():
        assert torch.equal(picks, getattr(head, f"sa_{i}").sample(xyz_in))
    with torch.no_grad():
        want_cls, want_reg = head(xyz, pf, valid, scores, rois, roi_valid)
    assert float((got_cls - want_cls).abs().max()) <= 1e-5 * max(
        1.0, float(want_cls.abs().max()))
    assert float((got_reg - want_reg).abs().max()) <= 1e-5 * max(
        1.0, float(want_reg.abs().max()))
    assert got_cls[1, 2] == 0 and (got_reg[1, 2] == 0).all()


def test_pooled_channels_are_canonical_xyz_score_depth_features(pair):
    """Each pooled row is a point of its RoI: its xyz in the RoI's canonical
    frame (rotated back by the heading and moved by the centre it is the
    point), then the point's class score, its depth / 70 - 0.5 and its
    features; an empty RoI's rows are zero; a RoI holding fewer points than
    slots repeats them in index order."""
    _, ref_model, model, batches = pair
    xyz, _, valid = ref_model.points(batches[0])
    n = xyz.shape[1]
    feats = torch.arange(BATCH * n, dtype=torch.float32).reshape(
        BATCH, n, 1)
    scores = torch.rand((BATCH, n), generator=torch.Generator().manual_seed(5))
    rois = _rois_on_points(xyz, valid, torch.Generator().manual_seed(4))
    pooled, empty = model.roi_head.pool(xyz, feats, valid, scores, rois)
    assert pooled.shape == (BATCH, 6, 64, 6)
    for b in range(BATCH):
        for r in range(5):
            rows = pooled[b, r]
            idx = rows[:, 5].long() - b * n
            h = rois[b, r, 6]
            c, s = torch.cos(h), torch.sin(h)
            x, y = rows[:, 0], rows[:, 1]
            back = torch.stack([x * c - y * s, x * s + y * c, rows[:, 2]],
                               -1) + rois[b, r, :3]
            assert torch.allclose(back, xyz[b, idx], atol=1e-5)
            assert torch.equal(rows[:, 3], scores[b, idx])
            depth = torch.linalg.vector_norm(xyz[b, idx], dim=-1) / 70 - 0.5
            assert torch.allclose(rows[:, 4], depth, atol=1e-6)
            k = len(torch.unique(idx))
            assert torch.equal(idx, idx[:k].repeat(-(-64 // k))[:64])
            assert bool((idx[1:k] > idx[:k - 1]).all())
        assert (pooled[b, 5] == 0).all() and empty[b, 5]


def test_reference_end_to_end_keeps_the_programs_boxes(pair):
    """From the inputs alone (no stage fed the program's), the reference
    refines the same RoIs into the program's boxes: the same count and
    labels a frame, the boxes within 1e-3 of their largest magnitude (the
    3-NN's rounding, above, carried through both stages), the scores
    within 1e-3."""
    ref, ref_model, model, batches = pair
    batch = batches[1]
    _, dets = _program_outputs(ref, ref_model, model, batch)
    out = ref.forward(ref_model, batch)
    kept = (out["final_boxes"], out["final_scores"], out["final_labels"],
            out["final_mask"])
    assert compare.count_gap(dets[3], kept[3]) == 0.0
    assert torch.equal(dets[2], kept[2]) and torch.equal(dets[3], kept[3])
    scale = float(kept[0].abs().amax())
    assert float((dets[0] - kept[0]).abs().amax()) <= 1e-3 * scale
    assert float((dets[1] - kept[1]).abs().amax()) <= 1e-3


@pytest.mark.parametrize("pcdet", [True, False], ids=["pcdet", "jax"])
def test_the_head_follows_sa_config(pcdet):
    """``PointRCNN`` builds pcdet's ``PointRCNNHead`` where ``ROI_HEAD``
    holds ``SA_CONFIG`` and the JAX package's ``PointRCNNRoIHead`` where it
    does not (``XYZ_UP_LAYER`` a list of MLPs, ``SHARED_FC``, as
    ``tools/cfgs/kitti_models/pointrcnn.yaml``); both serve a request."""
    m = copy.deepcopy(REHEARSAL["MODEL"])
    m.pop("DTYPE")
    roi = m["ROI_HEAD"]
    if not pcdet:
        for k in ("SA_CONFIG", "ROI_POINT_POOL", "CLS_FC", "REG_FC",
                  "USE_BN"):
            roi.pop(k)
        roi.update(NUM_SAMPLED_POINTS=64, XYZ_UP_LAYER=[[16, 16]],
                   SHARED_FC=[32, 32])
    data = REHEARSAL["data"]
    model = build_network(
        EasyDict(m), 3, REHEARSAL["class_names"], tuple(data["grid_size"]),
        tuple(data["voxel_size"]), tuple(data["point_cloud_range"]), BATCH,
        data["max_voxels_per_frame"], data["max_points_per_voxel"],
        num_point_features=4, device="cpu")
    want = PointRCNNHead if pcdet else PointRCNNRoIHead
    assert type(model.roi_head) is want
    host, _ = kitti_points_scene.make(
        dict(REHEARSAL["traffic"]["params"], distinct_batches=1), REHEARSAL,
        BATCH, 3)
    boxes, scores, labels, mask = program.request(
        model, program.to_device(host[0], torch.device("cpu")))
    assert boxes.shape == (BATCH, 16, 7) and torch.isfinite(boxes).all()
    assert int(mask.sum()) > 0
