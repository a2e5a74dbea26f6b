"""The plain reference of ``second-kitti`` (``benchmark/reference/
second-kitti.py``: dense convolutions for the sparse ones, pcdet's anchor
head and NMS) against the port's SECOND at pcdet's depth, on the CPU at
the rehearsal's size, in float32 on both sides, on the benchmark's seeded
weights; and the KITTI sweep generator."""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness import compare, program, spec, weights
from benchmark.traffic import kitti_scene

REHEARSAL = spec.load_json(spec.BENCH / "rehearsal" / "second-kitti.json")
CONFIG = spec.load_json(spec.BENCH / "configs" / "second-kitti.json")
TRAFFIC = spec.load_json(spec.BENCH / "traffic" / "kitti-closed-b4.json")
BATCH = 4


@pytest.fixture(scope="module")
def pair():
    """(config, reference model, program, batches) on the seeded weights,
    float32 on both sides."""
    torch.set_num_threads(2)
    config = copy.deepcopy(REHEARSAL)
    config["MODEL"].pop("DTYPE")
    ref = spec.load_module(spec.BENCH / "reference" / "second-kitti.py")
    cpu = torch.device("cpu")
    host, _ = kitti_scene.make(config["traffic"]["params"], config, BATCH,
                               2**32 + 7)
    batches = [program.to_device(b, cpu) for b in host]
    ref_model = ref.build(config, BATCH, cpu)
    made = weights.make(ref_model, 2**32 + 7, cpu, batches[0], ref.forward)
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


def test_stages_and_kept_boxes_equal_the_reference(pair):
    """Stage by stage (each reference stage fed the program's output of the
    one before): the same sites at every strided stage (``site_gap`` 0),
    the features, the BEV backbone's output and the head's three maps to
    f32 rounding, and the kept boxes equal as sets."""
    ref, ref_model, model, batches = pair
    for batch in batches:
        got, dets = _program_outputs(ref, ref_model, model, batch)
        assert {p for p in got} == set(ref.capture(ref_model))
        n = ref.judge(ref_model, batch, got, dets)
        assert n["site_gap"] == 0.0
        assert n["backbone_rel"] < 1e-5, n
        assert n["bev_rel"] < 1e-5, n
        assert n["head_rel"] < 1e-5, n
        assert n["det_gap"] < 1e-4 and n["count_gap"] == 0.0, n
        assert int(dets[3].sum()) > 0


def test_reference_end_to_end_keeps_the_programs_boxes(pair):
    """From the inputs alone (no stage fed the program's), the reference
    keeps the program's boxes: the same count a frame, each box within
    1e-3 of one of the other side's (f32 sums in another order through the
    whole network)."""
    ref, ref_model, model, batches = pair
    batch = batches[1]
    _, dets = _program_outputs(ref, ref_model, model, batch)
    out = ref.forward(ref_model, batch)
    kept = (out["final_boxes"], out["final_scores"], out["final_labels"],
            out["final_mask"])
    assert compare.count_gap(dets[3], kept[3]) == 0.0
    assert compare.det_gap(dets, kept, ref.candidates(
        ref_model, out["pred_dicts"])) < 1e-3


def test_reference_sites_are_spconvs_rule():
    """The max-pool site rule and the dense strided conv against a direct
    enumeration: an output site o where some input i has 0 <= i + p - o s
    <= k - 1 on every axis, its value the sum over those inputs."""
    dense = spec.load_module(spec.BENCH / "reference" / "dense_spconv.py")
    rng = np.random.default_rng(0)
    shape = (9, 7, 11)  # x, y, z
    cells = np.unique(rng.integers(0, [2, 11, 7, 9], (60, 4)), axis=0)
    coords = torch.as_tensor(cells, dtype=torch.int32)
    feats = torch.as_tensor(rng.normal(size=(len(cells), 3)),
                            dtype=torch.float32)
    sp = dense.sites_of(feats, coords, torch.ones(len(cells), dtype=bool), 2,
                        shape)
    geo = ((3, 3, 3), (2, 2, 2), (1, 1, 0))
    oc, oshape = dense.strided_sites(sp.coords, 2, shape, *geo)
    w = torch.as_tensor(rng.normal(size=(27, 3, 4)), dtype=torch.float32)
    got = dense.conv_at(sp, w, *geo, oc, oshape)
    want = {}
    for (b, z, y, x), f in zip(sp.coords.tolist(), sp.features):
        i = (x, y, z)
        ranges = [[o for o in range(oshape[a])
                   if 0 <= i[a] + geo[2][a] - o * 2 <= 2] for a in range(3)]
        for ox in ranges[0]:
            for oy in ranges[1]:
                for oz in ranges[2]:
                    k = ((i[2] + geo[2][2] - oz * 2) * 3
                         + (i[1] + geo[2][1] - oy * 2)) * 3 \
                        + (i[0] + geo[2][0] - ox * 2)
                    key = (b, oz, oy, ox)
                    want[key] = want.get(key, 0) + f @ w[k]
    assert sorted(want) == sorted(tuple(c) for c in oc.tolist())
    torch.testing.assert_close(
        got, torch.stack([want[tuple(c)] for c in oc.tolist()]),
        rtol=1e-5, atol=1e-5)


def test_kitti_scene_is_deterministic_per_seed_and_in_range():
    params = REHEARSAL["traffic"]["params"]
    lo, hi = REHEARSAL["traffic"]["live_voxels"]
    a, la = kitti_scene.make(params, REHEARSAL, BATCH, 2**31 + 17)
    b, lb = kitti_scene.make(params, REHEARSAL, BATCH, 2**31 + 17)
    c, lc = kitti_scene.make(params, REHEARSAL, BATCH, 2**31 + 18)
    assert la == lb and len(a) == params["distinct_batches"]
    assert len(la) == BATCH * params["distinct_batches"]
    for x, y, z in zip(a, b, c):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x["voxel_coords"], z["voxel_coords"])
    assert all(lo <= n <= hi for n in la + lc), (la, lc)
    for x in a:  # each frame's coordinates distinct, inside the grid
        v, cd = x["voxel_valid"], x["voxel_coords"]
        assert len(np.unique(cd[v], axis=0)) == int(v.sum())
        assert (cd[v, 1:] < np.asarray(REHEARSAL["data"]["grid_size"])[::-1]
                ).all()
        assert ((x["voxels"][v, :, 3] >= 0) & (x["voxels"][v, :, 3] <= 1)
                ).all()


def test_kitti_scene_at_the_cells_size_is_in_range():
    """One batch at KITTI's grid: 12 000 to 24 000 live voxels a frame."""
    lo, hi = TRAFFIC["live_voxels"]
    params = dict(TRAFFIC["params"], distinct_batches=1)
    _, live = kitti_scene.make(params, CONFIG, BATCH, 2**33 + 3)
    assert all(lo <= n <= hi for n in live), live
