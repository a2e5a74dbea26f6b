"""The port's eval path against the JAX package's, on the CPU.

3D IoU and the rotated intersection area, the AP evaluator, the per-frame
recall, the merge of per-process results, the shape-tolerant weight load
and the whole ``eval_one_epoch`` of the tiny CenterPoint on bridged weights
over two batches of the synthetic loader (JAX with
``MSSVT_PALLAS=xla_fill`` on a one-device mesh, the port with
``device="cpu"``, i.e. the kernels' plain versions).
"""

import logging
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.ops import box_ops as j_box
from mssvt_tpu.runtime import eval_utils as j_eval
from mssvt_tpu.utils import eval_ap as j_ap
from mssvt_tpu_torch.ops import box_ops as t_box
from mssvt_tpu_torch.runtime import eval_utils as t_eval
from mssvt_tpu_torch.utils import eval_ap as t_ap

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = ROOT / "tools/cfgs/synthetic_models/mssvt_tiny.yaml"
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]


def _boxes(rng, n, spread=6.0):
    """Seeded boxes that overlap often; every fifth repeats an earlier one
    and every seventh is axis-aligned beside it (shared edges)."""
    b = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n),
                  rng.uniform(-1, 1, n), rng.uniform(1, 5, n),
                  rng.uniform(0.6, 2.5, n), rng.uniform(1, 2, n),
                  rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    for i in range(5, n, 5):
        b[i] = b[i - 5]
    for i in range(7, n, 7):
        b[i] = b[i - 1]
        b[i, 6] = 0.0
        b[i - 1, 6] = 0.0
        b[i, 0] = b[i - 1, 0] + (b[i - 1, 3] + b[i, 3]) / 2
    return b


@pytest.mark.parametrize("n,m", [(1, 1), (9, 14), (40, 25)])
def test_pairwise_iou_3d_matches_jax(n, m):
    rng = np.random.default_rng(n * 100 + m)
    a, b = _boxes(rng, n), _boxes(rng, m)
    b[:min(n, m)] = a[:min(n, m)]  # identical pairs: IoU 1
    # eager, as the JAX eval loop calls it (jit moves degenerate pairs)
    want = np.asarray(j_box.pairwise_iou_3d(jnp.asarray(a), jnp.asarray(b)))
    got = t_box.pairwise_iou_3d(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (want > 0.01).sum() > 0
    np.testing.assert_allclose(np.diagonal(got)[:min(n, m)], 1.0, atol=1e-5)


def test_rotated_intersection_area_matches_jax():
    rng = np.random.default_rng(4)
    a, b = _boxes(rng, 64), _boxes(rng, 64, spread=2.0)
    ca, cb = j_box.boxes_to_corners_bev(jnp.asarray(a)), \
        j_box.boxes_to_corners_bev(jnp.asarray(b))
    want = np.asarray(j_box.rotated_intersection_area(ca, cb))
    got = t_box.rotated_intersection_area(
        t_box.boxes_to_corners_bev(torch.as_tensor(a)),
        t_box.boxes_to_corners_bev(torch.as_tensor(b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (want > 0).sum() > 10


# ------------------------------------------------------------------ AP eval
def _frames(seed, n_frames=6):
    """Seeded detections around seeded GT: jittered matches, misses, false
    positives and duplicates over three classes."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for f in range(n_frames):
        ng = int(rng.integers(0, 9))
        g = _boxes(rng, ng, spread=30.0) if ng else np.zeros((0, 7), np.float32)
        gl = rng.integers(1, 4, ng)
        keep = rng.random(ng) < 0.8
        d = g[keep].copy()
        d[:, :2] += rng.normal(0, 0.2, (len(d), 2))
        d[:, 3:6] *= rng.uniform(0.85, 1.15, (len(d), 3))
        fp = _boxes(rng, int(rng.integers(0, 5)), spread=30.0)
        dup = d[:1].copy()
        d = np.concatenate([d, fp, dup]).astype(np.float32)
        dl = np.concatenate([gl[keep], rng.integers(1, 4, len(fp)),
                             gl[keep][:1]]).astype(np.int64)
        dets.append({"boxes": d, "scores": rng.uniform(0.05, 1, len(d)),
                     "labels": dl})
        gts.append({"boxes": g, "labels": gl.astype(np.int64)})
    return dets, gts


@pytest.mark.parametrize("metric", ["bev", "3d"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kitti_style_eval_matches_jax(seed, metric):
    dets, gts = _frames(seed)
    want_report, want = j_ap.kitti_style_eval(dets, gts, CLASSES,
                                              metric=metric)
    got_report, got = t_ap.kitti_style_eval(dets, gts, CLASSES, metric=metric)
    assert got_report == want_report
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert np.isfinite(got["mAP"])


def _box(x, y, heading=0.0, dx=4.0, dy=2.0):
    return np.array([x, y, 0.0, dx, dy, 1.5, heading], np.float32)


EVAL_AP_CASES = {  # the JAX suite's cases (tests/test_eval_ap.py)
    "perfect": ([_box(0, 0), _box(10, 0)], [_box(0, 0), _box(10, 0)],
                [0.9, 0.8], 0.7),
    "missed": ([_box(0, 0), _box(10, 0)], [_box(0, 0)], [0.9], 0.7),
    "false_positive": ([_box(0, 0)], [_box(50, 50), _box(0, 0)],
                       [0.95, 0.9], 0.7),
    "duplicate": ([_box(0, 0)], [_box(0, 0), _box(0.1, 0)], [0.9, 0.8], 0.5),
}


@pytest.mark.parametrize("case", sorted(EVAL_AP_CASES))
def test_eval_class_ap_matches_jax(case):
    g, d, s, th = EVAL_AP_CASES[case]
    gt = {"boxes": np.stack(g), "labels": np.ones(len(g), np.int64)}
    det = {"boxes": np.stack(d), "scores": np.array(s),
           "labels": np.ones(len(d), np.int64)}
    want = j_ap.eval_class_ap([det], [gt], 1, th)
    got = t_ap.eval_class_ap([det], [gt], 1, th)
    assert got == want


def test_frame_recall_and_merge_match_jax(tmp_path):
    """Per-frame recall counts (JAX computes them eagerly, one compile per
    frame's shapes: three frames) and the merge of per-rank parts."""
    dets, gts = _frames(0, n_frames=3)
    th = (0.1, 0.3, 0.5, 0.7)
    parts = []
    for rank, (d, g) in enumerate(zip(dets, gts)):
        want = j_eval._frame_recall(d["boxes"], g["boxes"], th)
        got = t_eval._frame_recall(d["boxes"], g["boxes"], th)
        assert got == want
        parts.append({"det": [d], "gt": [g], "recall": got[0],
                      "gt_total": got[1], "n": 1, "t": 0.1 * rank})
    assert t_eval._frame_recall(np.zeros((0, 7)), gts[0]["boxes"], th) == \
        ({t: 0 for t in th}, len(gts[0]["boxes"]))
    for rank, p in enumerate(parts):
        with open(tmp_path / f"part_{rank}.pkl", "wb") as f:
            pickle.dump(p, f)
    want = j_eval.merge_result_parts(tmp_path, th)
    got = t_eval.merge_result_parts(tmp_path, th)
    assert [len(x) for x in got[:2]] == [len(dets)] * 2
    for w, g in zip(want, got):
        if isinstance(w, list):
            for a, b in zip(w, g):
                for k in a:
                    np.testing.assert_array_equal(b[k], a[k])
        else:
            assert g == w


def test_partial_load_params_matches_jax():
    """Loaded where the name and the shape match, fresh init elsewhere, the
    same choice as the JAX package's on the same flat tree."""
    from mssvt_tpu.runtime.checkpoint import partial_load_params as j_load
    from mssvt_tpu_torch.runtime.checkpoint import partial_load_params as t_load

    rng = np.random.default_rng(0)
    init = {"a.weight": rng.normal(size=(4, 3)), "a.bias": rng.normal(size=4),
            "b.weight": rng.normal(size=(2, 2)), "c.mean": rng.normal(size=5)}
    restored = {"a.weight": rng.normal(size=(4, 3)),
                "a.bias": rng.normal(size=5),  # shape changed
                "c.mean": rng.normal(size=5), "extra": rng.normal(size=1)}
    want = j_load(restored, init)
    got = t_load({k: torch.as_tensor(v) for k, v in restored.items()},
                 {k: torch.as_tensor(v) for k, v in init.items()},
                 logging.getLogger("test"))
    assert list(got) == list(init)
    for k in init:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["a.bias"].numpy(), init["a.bias"])
    np.testing.assert_array_equal(got["c.mean"].numpy(), restored["c.mean"])


# --------------------------------------------------- eval_one_epoch, tiny
@pytest.fixture(scope="module")
def eval_pair():
    """The JAX and the port's ``eval_one_epoch`` of mssvt_tiny.yaml (4 test
    frames, batch 2) on the same bridged weights with random BatchNorm
    statistics; the JAX compile runs once for the module."""
    from mssvt_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml
    from mssvt_tpu.datasets.loader import build_dataloader as j_loader
    from mssvt_tpu.models import build_network as j_build
    from mssvt_tpu.parallel.mesh import make_mesh, shard_batch_for_mesh
    from mssvt_tpu.utils.edict import EasyDict as JDict
    from mssvt_tpu_torch.bridge import load_flax_variables
    from mssvt_tpu_torch.config import cfg_from_yaml_file as t_cfg_from_yaml
    from mssvt_tpu_torch.datasets.loader import build_dataloader as t_loader
    from mssvt_tpu_torch.runtime.cli import build_model
    from mssvt_tpu_torch.utils.edict import EasyDict as TDict

    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_PALLAS", "xla_fill")
    try:
        cfg_j = j_cfg_from_yaml(str(TINY_YAML), JDict())
        cfg_t = t_cfg_from_yaml(str(TINY_YAML), TDict())
        for c in (cfg_j, cfg_t):
            c.DATA_CONFIG.NUM_FRAMES = 4
        jd, jl = j_loader(cfg_j.DATA_CONFIG, CLASSES, 2, False, workers=0)
        td, tl = t_loader(cfg_t.DATA_CONFIG, CLASSES, 2, False, workers=0)
        jm = j_build(model_cfg=cfg_j.MODEL, num_class=3, class_names=CLASSES,
                     grid_size=jd.grid_size, voxel_size=jd.voxel_size,
                     point_cloud_range=jd.point_cloud_range, batch_size=2,
                     max_voxels=jd.max_voxels,
                     max_points_per_voxel=jd.max_points_per_voxel)
        mesh = make_mesh(1)
        first = jax.tree_util.tree_map(
            lambda x: x[0], shard_batch_for_mesh(next(iter(jl)), mesh, 2))
        variables = jax.jit(lambda k, b: jm.init(
            {"params": k, "dropout": k}, b, train=False))(
            jax.random.PRNGKey(0), first)
        rng = np.random.default_rng(0)
        variables = {**variables, "batch_stats": jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                          else rng.normal(size=x.shape) * 0.1).astype(np.float32),
            variables["batch_stats"])}
        want = j_eval.eval_one_epoch(jm, variables["params"],
                                     variables["batch_stats"], jl, mesh,
                                     CLASSES)
        tm = build_model(cfg_t, td, 2, "cpu")
        load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
        got = t_eval.eval_one_epoch(tm, tl, CLASSES)
    finally:
        mp.undo()
    return want, got, (jl, tl)


def _rows(frame):
    r = np.concatenate([frame["boxes"], frame["scores"][:, None],
                        frame["labels"][:, None].astype(np.float32)], 1)
    return r[np.lexsort(r.T[::-1])]


def test_eval_one_epoch_box_sets_match_jax(eval_pair):
    """The same decoded box set in every frame (boxes, scores, labels;
    1e-4: f32 through ~20 layers summed in another order)."""
    (_, want), (_, got), _ = eval_pair
    assert len(got) == len(want) == 4
    assert sum(len(f["boxes"]) for f in want) > 0
    for g, w in zip(got, want):
        assert len(g["boxes"]) == len(w["boxes"])
        np.testing.assert_allclose(_rows(g), _rows(w), atol=1e-4, rtol=1e-4)


def test_eval_one_epoch_metrics_match_jax(eval_pair):
    """Recall at each threshold exactly (so the recalled counts are equal),
    the AP metrics to rtol 1e-6, the same keys; seconds per example is
    each side's own."""
    (want, _), (got, _), _ = eval_pair
    assert set(got) == set(want)
    for k in want:
        if k.startswith("recall/"):
            assert got[k] == want[k], k
        elif k != "sec_per_example":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["sec_per_example"] > 0


def test_eval_loaders_yield_equal_batches(eval_pair):
    """The two eval loops saw the same batches."""
    from test_torch_pipeline import _equal

    _, _, (jl, tl) = eval_pair
    for jb, tb in zip(jl, tl):
        _equal(tb, jb, "batch")


def test_eval_one_epoch_takes_one_process():
    """Without a process group there is one process: asking for two ranks
    raises (the multi-process merge is held by test_torch_ddp.py)."""
    with pytest.raises(ValueError, match="process group holds 1 ranks"):
        t_eval.eval_one_epoch(None, [], CLASSES, world_size=2)
