"""The plain reference of ``pvrcnnpp-kitti`` (``benchmark/reference/
pvrcnnpp-kitti.py``: dense convolutions for the sparse ones, pcdet's anchor
head and proposals, ``point_voxel.py``'s ball queries, vector pool and
RoI-grid pooling) against the port's PV-RCNN++ at pcdet's depth, on the
CPU at the rehearsal's size, in float32 on both sides, on the benchmark's
seeded weights, stage by stage and with the keypoint picks; the sweep
generator with raw points; and the four readers of the cell's spans and
kernel on a hand-made trace."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import compare, program, sector_fps, spec, weights
from benchmark.traffic import kitti_points_scene, kitti_scene

REHEARSAL = spec.load_json(spec.BENCH / "rehearsal" / "pvrcnnpp-kitti.json")
CONFIG = spec.load_json(spec.BENCH / "configs" / "pvrcnnpp-kitti.json")
TRAFFIC = spec.load_json(spec.BENCH / "traffic" / "kitti-points-closed-b2.json")
BATCH = 2
SEED = 2**32 + 11


@pytest.fixture(scope="module")
def pair():
    """(reference module, reference model, program, batches) on the seeded
    weights, float32 on both sides."""
    torch.set_num_threads(2)
    config = copy.deepcopy(REHEARSAL)
    config["MODEL"].pop("DTYPE")
    ref = spec.load_module(spec.BENCH / "reference" / "pvrcnnpp-kitti.py")
    cpu = torch.device("cpu")
    host, _ = kitti_points_scene.make(config["traffic"]["params"], config,
                                      BATCH, SEED)
    batches = [program.to_device(b, cpu) for b in host]
    ref_model = ref.build(config, BATCH, cpu)
    made = weights.make(ref_model, SEED, cpu, batches[0], ref.forward)
    model = program.build(config, BATCH, cpu, made)
    return ref, ref_model, model, batches


def _program_outputs(ref, ref_model, model, batch):
    got = {}
    hooks = [getattr(*program.resolve(model, p)).register_forward_hook(
        lambda m, a, o, p=p: got.__setitem__(p, o))
        for p in ref.capture(ref_model)]
    dets = program.request(model, batch)
    for h in hooks:
        h.remove()
    return got, dets


def test_weights_cover_the_programs_parameters(pair):
    """The reference holds every parameter of the program under its name
    and shape (the harness loads them by name), the BEV map 2 x 128 wide."""
    ref, ref_model, model, _ = pair
    mine = dict(ref_model.named_parameters())
    for name, p in model.named_parameters():
        assert name in mine and mine[name].shape == p.shape, name
    assert ref_model.backbone_3d.out_spatial_shape[2] == 2
    assert model.backbone_3d.num_bev_features == 256


def test_stages_and_keypoints_equal_the_reference(pair):
    """Stage by stage (each reference stage fed the program's output of the
    one before): the same sites at every strided stage, the same keypoint
    picks, the features, maps, fused keypoint features and the RoI head's
    outputs to f32 rounding, and the refined boxes equal."""
    ref, ref_model, model, batches = pair
    for batch in batches:
        got, dets = _program_outputs(ref, ref_model, model, batch)
        assert set(got) == set(ref.capture(ref_model))
        n = ref.judge(ref_model, batch, got, dets)
        assert n["site_gap"] == 0.0 and n["kp_gap"] == 0.0, n
        for k in ("backbone_rel", "bev_rel", "head_rel", "pfe_rel",
                  "roi_rel"):
            assert n[k] < 1e-5, n
        assert n["det_gap"] < 1e-4 and n["count_gap"] == 0.0, n
        assert int(dets[3].sum()) > 0
        assert int(got["proposals"][3].sum()) > 0


def test_keypoints_are_raw_points_near_the_rois(pair):
    """Every keypoint of the program is a valid raw point within the sample
    radius of one of the frame's RoIs (SPC), and a frame's keypoints hold
    as many distinct points as a sector's quota at least."""
    from benchmark.reference.detector.ops.sampling import (
        sample_points_with_roi,
    )

    ref, ref_model, model, batches = pair
    got, _ = _program_outputs(ref, ref_model, model, batches[0])
    xyz, _, valid = ref_model.points(batches[0])
    rois, _, _, roi_valid = got["proposals"]
    near = sample_points_with_roi(xyz, valid, rois, roi_valid, 1.6)
    kp = got["pfe"][0]
    quota = -(-kp.shape[1] // 6)
    for b in range(BATCH):
        pts = xyz[b][near[b]]
        assert bool((kp[b][:, None] == pts[None]).all(-1).any(1).all())
        assert len(torch.unique(kp[b], dim=0)) >= min(quota, len(pts))


def test_x_conv_out_sites_are_cell_centres_at_pcdet_depth(pair):
    """At pcdet's 41 z-cells the final stage's sites lie in two z slices
    of 1.6 m (centres -2.2 and -0.6 m over KITTI's -3 m floor), and the
    program's per-frame layout puts each at its cell's centre."""
    ref, ref_model, model, batches = pair
    got, _ = _program_outputs(ref, ref_model, model, batches[0])
    out = got["backbone_3d.conv_out"]
    assert tuple(out.spatial_shape)[2] == 2
    assert tuple(out.voxel_size) == pytest.approx((1.6, 1.6, 1.6))
    xyz, _, ok = out.per_sample()
    c = out.coords[out.valid].float()
    zs = torch.unique(xyz[ok][:, 2])
    assert {round(float(z), 4) for z in zs} <= {-2.2, -0.6}
    rx, _, rok = ref_model.sites_of_stage(out)
    assert torch.equal(ok.sum(1), rok.sum(1))
    assert torch.equal(xyz[ok], rx[rok])
    assert len(c) == int(ok.sum())


def test_reference_end_to_end_keeps_the_programs_boxes(pair):
    """From the inputs alone (no stage fed the program's), the reference
    refines the same RoIs into the program's boxes: the same count a frame,
    the boxes within 1e-5 of their largest magnitude (the seeded weights'
    boxes reach kilometres; f32 sums in another order through the whole
    network), the scores within 1e-5."""
    ref, ref_model, model, batches = pair
    batch = batches[1]
    got, dets = _program_outputs(ref, ref_model, model, batch)
    out = ref.forward(ref_model, batch)
    kept = (out["final_boxes"], out["final_scores"], out["final_labels"],
            out["final_mask"])
    assert compare.count_gap(dets[3], kept[3]) == 0.0
    assert torch.equal(dets[2], kept[2]) and torch.equal(dets[3], kept[3])
    scale = float(kept[0].abs().amax())
    assert float((dets[0] - kept[0]).abs().amax()) <= 1e-5 * scale
    assert float((dets[1] - kept[1]).abs().amax()) <= 1e-5


def test_kitti_points_scene_voxels_and_points():
    """The voxels are ``kitti_scene``'s for the same seed; the raw points
    are the first ``MAX_POINTS`` in range of the same sweep, padded."""
    params = REHEARSAL["traffic"]["params"]
    a, la = kitti_points_scene.make(params, REHEARSAL, BATCH, 2**31 + 17)
    b, lb = kitti_scene.make(params, REHEARSAL, BATCH, 2**31 + 17)
    assert la == lb
    rows = REHEARSAL["MODEL"]["MAX_POINTS"]
    lo = np.asarray(REHEARSAL["data"]["point_cloud_range"][:3])
    hi = np.asarray(REHEARSAL["data"]["point_cloud_range"][3:])
    for x, y in zip(a, b):
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])
        pts, ok = x["points"], x["points_valid"]
        assert pts.shape == (BATCH * rows, 4) and ok.shape == (BATCH * rows,)
        assert ((pts[ok, :3] >= lo) & (pts[ok, :3] < hi)).all()
        assert (pts[~ok] == 0).all()
    few = copy.deepcopy(REHEARSAL)
    few["MODEL"]["MAX_POINTS"] = 100_000  # more rows than a sweep has
    c, _ = kitti_points_scene.make(dict(params, distinct_batches=1), few,
                                   BATCH, 2**31 + 17)
    n = c[0]["points_valid"].reshape(BATCH, -1).sum(1)
    assert (n > rows).all() and (n < 100_000).all()
    first = c[0]["points"].reshape(BATCH, 100_000, 4)[:, :rows]
    np.testing.assert_array_equal(
        first, a[0]["points"].reshape(BATCH, rows, 4))


def test_kitti_points_scene_at_the_cells_size():
    """One batch at KITTI's grid: 12 000 to 24 000 live voxels and all
    16 384 raw rows of a frame filled."""
    lo, hi = TRAFFIC["live_voxels"]
    params = dict(TRAFFIC["params"], distinct_batches=1)
    batches, live = kitti_points_scene.make(params, CONFIG, BATCH, 2**33 + 3)
    assert all(lo <= n <= hi for n in live), live
    assert batches[0]["points_valid"].all()


# -- the readers --------------------------------------------------------------


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one request of 2 frames in [0, 1000) us: launches at 110 (keypoints), 210
# and 230 (pfe), 320 (roi_head), 50 (outside the spans); the masked FPS
# kernel twice, 40 us and 60 us
EVENTS = [
    _ev("bench.request", "user_annotation", 0, 1000),
    _ev("mssvt.post", "user_annotation", 100, 400),
    _ev("mssvt.keypoints", "user_annotation", 100, 100),
    _ev("mssvt.pfe", "user_annotation", 200, 100),
    _ev("mssvt.roi_head", "user_annotation", 300, 100),
    _ev("cudaLaunchKernel", "cuda_runtime", 50, 1, 1),
    _ev("cudaLaunchKernel", "cuda_runtime", 110, 1, 2),
    _ev("cudaLaunchKernel", "cuda_runtime", 120, 1, 6),
    _ev("cudaLaunchKernel", "cuda_runtime", 210, 1, 3),
    _ev("cudaLaunchKernel", "cuda_runtime", 230, 1, 4),
    _ev("cudaLaunchKernel", "cuda_runtime", 320, 1, 5),
    _ev("elementwise_kernel", "kernel", 60, 10, 1),
    _ev("void (anonymous namespace)::fps_masked_kernel<1024, 1, true>("
        "float const*, float const*, float const*, unsigned char const*, "
        "int, int, int, int*, int)", "kernel", 120, 40, 2),
    _ev("void (anonymous namespace)::fps_masked_kernel<512, 1, false>()",
        "kernel", 160, 60, 6),
    _ev("gather_kernel", "kernel", 215, 30, 3),
    _ev("gemm_kernel", "kernel", 250, 20, 4),
    _ev("reduce_kernel", "kernel", 330, 50, 5),
]


@pytest.mark.parametrize("name,want", [
    ("keypoints_device_ms.infer", (40 + 60) / 1e3 / 2),
    ("pfe_device_ms.infer", (30 + 20) / 1e3 / 2),
    ("roi_head_device_ms.infer", 50 / 1e3 / 2)])
def test_span_readers(name, want):
    rec = SimpleNamespace(events=EVENTS, requests=1, batch=2)
    got = spec.load_module(spec.BENCH / "metrics" / f"{name}.py").read(rec)
    assert got == pytest.approx(want)
    empty = SimpleNamespace(events=EVENTS[:1] + EVENTS[5:], requests=1,
                            batch=2)
    reader = spec.load_module(spec.BENCH / "metrics" / f"{name}.py")
    assert reader.read(empty) is None


def test_sector_fps_roofline_reader():
    """The two passes' bound at the configuration's sizes over the masked
    FPS kernel's 100 us; nothing to read without the kernel."""
    reader = spec.load_module(spec.BENCH / "metrics" /
                              "sector_fps_roofline_pct.infer.py")
    rec = SimpleNamespace(events=EVENTS, requests=1, batch=2)
    bound = sum(w.bound()[0] for w in sector_fps.work(CONFIG, 2))
    assert reader.read(rec) == pytest.approx(100.0 * bound / 0.1)
    plain = [e for e in EVENTS if "fps_masked" not in e["name"]]
    assert reader.read(SimpleNamespace(events=plain, requests=1,
                                       batch=2)) is None


@pytest.mark.parametrize("grids,reads", [
    ((12, 2), True), ((2, 12), True), ((8, 2), False), ((12,), False)],
    ids=["config_rows", "any_order", "other_rows", "one_pass"])
def test_sector_fps_roofline_reader_holds_the_grids(grids, reads):
    """Where the trace gives the launches' grids, the masked FPS kernel's
    rows a launch must be the configuration's (frames x sectors, then
    frames), else the reader reads nothing."""
    reader = spec.load_module(spec.BENCH / "metrics" /
                              "sector_fps_roofline_pct.infer.py")
    masked = [e for e in EVENTS if "fps_masked" in e["name"]]
    events = [e for e in EVENTS if "fps_masked" not in e["name"]]
    for e, g in zip(masked, grids):
        events.append(dict(e, args=dict(e["args"], grid=[g, 1, 1])))
    got = reader.read(SimpleNamespace(events=events, requests=1, batch=2))
    if not reads:
        assert got is None
        return
    used = sum(e["dur"] for e in masked[:len(grids)]) / 1e3
    bound = sum(w.bound()[0] for w in sector_fps.work(CONFIG, 2))
    assert got == pytest.approx(100.0 * bound / used)
