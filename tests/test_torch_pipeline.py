"""The port's data pipeline against the JAX package's, on the CPU.

Voxelizer, processors, augmentor, GT sampler, synthetic items, collate and
loader: the same seeded inputs through both packages, compared exactly.
The JAX side draws its randomness from numpy's global legacy stream after
``np.random.seed(s)``, the port from the ``numpy.random.RandomState(s)`` its
dataset owns, which yields the same stream, so the outputs must be equal.
"""

import pickle
from collections import Counter

import numpy as np
import pytest

from mssvt_tpu.datasets import augmentor as j_aug
from mssvt_tpu.datasets import processor as j_proc
from mssvt_tpu.datasets.loader import Loader as JLoader
from mssvt_tpu.datasets.loader import build_dataloader as j_build_dataloader
from mssvt_tpu.ops.voxelize import voxelize_points as j_voxelize
from mssvt_tpu_torch.datasets import augmentor as t_aug
from mssvt_tpu_torch.datasets import processor as t_proc
from mssvt_tpu_torch.datasets.loader import Loader as TLoader
from mssvt_tpu_torch.datasets.loader import build_dataloader as t_build_dataloader
from mssvt_tpu_torch.ops import voxelize as t_vox
from test_pipeline import synthetic_cfg

CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
SMALL = dict(vs=(0.5, 0.5, 0.5), pcr=(0.0, 0.0, 0.0, 4.0, 4.0, 2.0))
WAYMO = dict(vs=(0.32, 0.32, 0.1875),
             pcr=np.array([-76.8, -76.8, -2.0, 76.8, 76.8, 4.0], np.float32))


def _equal(a, b, what=""):
    """Equal values, shapes and dtypes, recursively through dicts, lists
    and tuples."""
    if isinstance(a, dict):
        assert set(a) == set(b), (what, sorted(a), sorted(b))
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


# ---------------------------------------------------------------- voxelizer
def _cloud(case):
    """(points, grid, max points a voxel, max voxels) of a seeded case."""
    rng = np.random.default_rng(11)
    if case == "out_of_range":
        return rng.uniform(-0.5, 4.5, (500, 5)).astype(np.float32), SMALL, 3, 1000
    if case == "duplicate_cells":
        cells = rng.integers(0, 8, (40, 3)) * 0.5 + 0.25
        pts = cells[rng.integers(0, 40, 600)] + rng.uniform(-0.2, 0.2, (600, 3))
        pts = np.concatenate([pts, pts[:50]])  # exact duplicate points
        extra = rng.normal(size=(len(pts), 2))
        return np.concatenate([pts, extra], 1).astype(np.float32), SMALL, 5, 1000
    if case == "max_voxels_overflow":
        return rng.uniform(0.0, 4.0, (500, 5)).astype(np.float32), SMALL, 3, 10
    if case == "max_points_overflow":
        pts = rng.uniform(0.0, 1.0, (800, 5)).astype(np.float32)  # 8 cells
        return pts, SMALL, 2, 1000
    if case == "empty_in_range":
        return np.full((10, 5), -100.0, np.float32), SMALL, 5, 100
    if case == "empty_cloud":
        return np.zeros((0, 5), np.float32), SMALL, 5, 100
    assert case == "waymo_5_features"
    n = 20000
    pts = np.stack([rng.uniform(-80, 80, n), rng.uniform(-80, 80, n),
                    rng.uniform(-3, 5, n), rng.uniform(0, 1, n),
                    rng.uniform(0, 1, n)], 1).astype(np.float32)
    return pts, WAYMO, 5, 8000


VOX_CASES = ["out_of_range", "duplicate_cells", "max_voxels_overflow",
             "max_points_overflow", "empty_in_range", "empty_cloud",
             "waymo_5_features"]


@pytest.mark.parametrize("case", VOX_CASES)
def test_voxelizer_bit_equal_to_jax(case):
    """The port's C++ voxelizer, its numpy version and the JAX package's
    numpy version give identical voxels, coords and counts; the JAX
    package's C++ voxelizer too where the voxel size and range are exact
    in float32 (it takes them as floats, the port's two as doubles)."""
    pts, g, max_pts, max_vox = _cloud(case)
    args = (g["vs"], g["pcr"], max_pts, max_vox)
    got = t_vox.voxelize_points(pts, *args)
    want = j_voxelize(pts, *args, use_native=False)
    _equal(t_vox.voxelize_points(pts, *args, use_native=False), want, "numpy")
    _equal(got, want, "native")
    if g is SMALL:
        _equal(j_voxelize(pts, *args), want, "jax native")
    if case == "max_voxels_overflow":
        assert len(got[0]) == max_vox
    if case == "max_points_overflow":
        assert got[2].max() == max_pts
    if case.startswith("empty"):
        assert got[0].shape == (0, max_pts, 5)


def test_voxelizer_raises_when_the_build_fails(monkeypatch, tmp_path):
    """No silent switch to numpy: a failed g++ build raises; only
    use_native=False takes the numpy version."""
    pts, g, max_pts, max_vox = _cloud("out_of_range")
    monkeypatch.setattr(t_vox, "_LIB", None)
    monkeypatch.setattr(t_vox, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(t_vox, "GXX_FLAGS", ["-O3", "--no-such-flag"])
    with pytest.raises(RuntimeError, match="voxelizer build failed"):
        t_vox.voxelize_points(pts, g["vs"], g["pcr"], max_pts, max_vox)
    out = t_vox.voxelize_points(pts, g["vs"], g["pcr"], max_pts, max_vox,
                                use_native=False)
    assert len(out[0]) > 0


# ------------------------------------------------------------- processors
PROC_CASES = {
    "mask_points_and_boxes_outside_range": [
        {"NAME": "mask_points_and_boxes_outside_range",
         "REMOVE_OUTSIDE_BOXES": True}],
    "shuffle_points": [{"NAME": "shuffle_points",
                        "SHUFFLE_ENABLED": {"train": True, "test": False}}],
    "sample_points_fewer": [{"NAME": "sample_points",
                             "NUM_POINTS": {"train": 300, "test": 300}}],
    "sample_points_more": [{"NAME": "sample_points",
                            "NUM_POINTS": {"train": 900, "test": 900}}],
    "transform_points_to_voxels": [
        {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": [0.4, 0.4, 0.5],
         "MAX_POINTS_PER_VOXEL": 3,
         "MAX_NUMBER_OF_VOXELS": {"train": 300, "test": 400}}],
    "calculate_grid_size": [{"NAME": "calculate_grid_size",
                             "VOXEL_SIZE": [0.5, 0.5, 1.0]}],
    "downsample_depth_map": [{"NAME": "downsample_depth_map",
                              "DOWNSAMPLE_FACTOR": 3}],
}


def _scene(seed=5, n=700, cols=4):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 21, n), rng.uniform(-11, 11, n),
                    rng.uniform(-2.5, 2.5, n)]
                   + [rng.uniform(0, 1, n) for _ in range(cols - 3)],
                   1).astype(np.float32)
    boxes = np.stack([rng.uniform(-3, 22, 6), rng.uniform(-12, 12, 6),
                      rng.uniform(-1, 1, 6), rng.uniform(1, 4, 6),
                      rng.uniform(1, 3, 6), rng.uniform(1, 2, 6),
                      rng.uniform(-np.pi, np.pi, 6)], 1).astype(np.float32)
    return {"points": pts, "gt_boxes": boxes,
            "gt_names": np.array(["Vehicle", "Pedestrian"] * 3),
            "depth_maps": rng.uniform(0, 50, (20, 28)).astype(np.float32)}


def _copy(d):
    return {k: v.copy() for k, v in d.items()}


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name", sorted(PROC_CASES))
def test_processor_matches_jax(name, training):
    pcr = [0.0, -9.6, -2.0, 19.2, 9.6, 2.0]
    jp = j_proc.DataProcessor(PROC_CASES[name], pcr, training, 4)
    tp = t_proc.DataProcessor(PROC_CASES[name], pcr, training, 4,
                              rng=np.random.RandomState(3))
    for attr in ("grid_size", "voxel_size", "max_points_per_voxel",
                 "max_voxels"):
        _equal(getattr(tp, attr), getattr(jp, attr), attr)
    np.random.seed(3)
    want = jp.forward(_copy(_scene()))
    got = tp.forward(_copy(_scene()))
    _equal(got, want, name)


def test_point_feature_encoder_matches_jax():
    cfg = {"encoding_type": "absolute_coordinates_encoding",
           "used_feature_list": ["x", "y", "z", "elongation"],
           "src_feature_list": ["x", "y", "z", "intensity", "elongation"]}
    d = _scene(cols=5)
    want = j_proc.PointFeatureEncoder(cfg).forward(_copy(d))
    got = t_proc.PointFeatureEncoder(cfg).forward(_copy(d))
    _equal(got, want)
    assert t_proc.PointFeatureEncoder(cfg).num_point_features == 4


# --------------------------------------------------------------- augmentor
def _aug_scene(cols=8):
    """Two boxes with points inside and around them; ``cols`` 9 carries
    velocities (vx, vy) at 7:9."""
    rng = np.random.default_rng(8)
    gt = np.array([[5.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.3, 1.0, 0.5],
                   [-4.0, 6.0, 0.5, 4.0, 1.8, 1.6, -1.2, 2.0, -0.7]],
                  np.float32)[:, :cols]
    inside = np.concatenate([rng.uniform(-0.9, 0.9, (20, 3)) + gt[0, :3],
                             rng.uniform(-0.8, 0.8, (20, 3)) + gt[1, :3]])
    outside = rng.uniform(10, 20, (30, 3))
    pts = np.concatenate([inside, outside]).astype(np.float32)
    pts = np.concatenate([pts, rng.uniform(0, 1, (70, 1))], 1).astype(np.float32)
    return gt, pts


TRANSFORMS = {
    "random_flip_along_x": (),
    "random_flip_along_y": (),
    "global_rotation": ([-0.78, 0.78],),
    "global_scaling": ([0.95, 1.05],),
    "random_world_translation": ([0.2, 0.3, 0.1],),
    "random_local_translation": ([0.3, 0.6],),
    "random_local_rotation": ([-0.5, 0.5],),
    "random_local_scaling": ([0.9, 1.1],),
    "global_frustum_dropout": ([0.1, 0.3],),
    "random_local_frustum_dropout": ([0.2, 0.6],),
}


@pytest.mark.parametrize("cols", [8, 9])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, cols):
    """Each transform with matched randomness, five draws in a row (so a
    flip both fires and does not): exactly equal boxes and points."""
    args = TRANSFORMS[name]
    rng = np.random.RandomState(21)
    np.random.seed(21)
    for _ in range(5):
        gt, pts = _aug_scene(cols)
        want = getattr(j_aug, name)(gt.copy(), pts.copy(), *args)
        got = getattr(t_aug, name)(gt.copy(), pts.copy(), *args, rng)
        _equal(got, want, name)
    for direction in ("bottom", "left", "right"):
        if "frustum" in name:
            gt, pts = _aug_scene(cols)
            want = getattr(j_aug, name)(gt.copy(), pts.copy(), *args,
                                        direction=direction)
            got = getattr(t_aug, name)(gt.copy(), pts.copy(), *args, rng,
                                       direction=direction)
            _equal(got, want, f"{name} {direction}")


QUEUE = {
    "random_world_flip": {"ALONG_AXIS_LIST": ["x", "y"]},
    "random_world_rotation": {"WORLD_ROT_ANGLE": 0.6},
    "random_world_scaling": {"WORLD_SCALE_RANGE": [0.95, 1.05]},
    "random_world_translation": {"NOISE_TRANSLATE_STD": 0.2},
    "random_local_translation": {"LOCAL_TRANSLATION_RANGE": [-0.4, 0.4],
                                 "ALONG_AXIS_LIST": ["x", "y", "z"]},
    "random_local_rotation": {"LOCAL_ROT_ANGLE": [-0.3, 0.3]},
    "random_local_scaling": {"LOCAL_SCALE_RANGE": [0.9, 1.1]},
    "random_world_frustum_dropout": {"INTENSITY_RANGE": [0.0, 0.2],
                                     "DIRECTION": ["top", "left"]},
    "random_local_frustum_dropout": {"INTENSITY_RANGE": [0.1, 0.4],
                                     "DIRECTION": ["bottom", "right"]},
}


@pytest.mark.parametrize("name", sorted(QUEUE))
def test_augmentor_queue_method_matches_jax(name):
    """Each of the nine queue methods through ``DataAugmentor.forward``
    (with the heading normalisation and the gt_boxes_mask filter)."""
    cfgs = {"AUG_CONFIG_LIST": [dict(NAME=name, **QUEUE[name])],
            "DISABLE_AUG_LIST": ["placeholder"]}
    gt, pts = _aug_scene()
    gt[0, 6] = 7.0  # outside [-pi, pi): normalised at the end
    data = {"gt_boxes": gt, "points": pts,
            "gt_names": np.array(["Vehicle", "Cyclist"]),
            "gt_boxes_mask": np.array([True, False])}
    ja = j_aug.DataAugmentor(None, cfgs, CLASSES)
    ta = t_aug.DataAugmentor(None, cfgs, CLASSES,
                             rng=np.random.RandomState(4))
    np.random.seed(4)
    want = ja.forward(_copy(data))
    got = ta.forward(_copy(data))
    _equal(got, want, name)
    assert len(got["gt_boxes"]) == 1


def _write_db(root):
    """A seeded GT database: per class a few objects' points in .bin files
    and their infos in a pickle."""
    rng = np.random.default_rng(2)
    db = {"Vehicle": [], "Pedestrian": []}
    k = 0
    for name, n in (("Vehicle", 6), ("Pedestrian", 5)):
        for i in range(n):
            pts = rng.normal(0, 0.4, (int(rng.integers(4, 30)), 5)).astype(np.float32)
            path = f"gt_db/{name}_{i}.bin"
            (root / path).parent.mkdir(exist_ok=True)
            (root / path).write_bytes(pts.tobytes())
            # boxes crowd one area: many collide with the scene and each other
            box = np.array([rng.uniform(2, 9), rng.uniform(-3, 3), 0.0,
                            4.0 if name == "Vehicle" else 0.8,
                            1.8 if name == "Vehicle" else 0.8, 1.6,
                            rng.uniform(-np.pi, np.pi)], np.float32)
            db[name].append({"name": name, "path": path, "box3d_lidar": box,
                             "num_points_in_gt": len(pts),
                             "difficulty": int(k % 3 == 0) - (k % 5 == 0)})
            k += 1
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(db, f)


@pytest.fixture
def writable_jax_iou(monkeypatch):
    """The JAX sampler's collision test writes into
    ``np.asarray(pairwise_iou_bev(...))`` (``np.fill_diagonal``), which is a
    read-only view of a jax array: with any box already in the scene it
    raises. The test hands it a writable copy of the same IoU; the port's
    sampler needs no such help."""
    from mssvt_tpu.ops import box_ops

    iou = box_ops.pairwise_iou_bev
    monkeypatch.setattr(box_ops, "pairwise_iou_bev",
                        lambda a, b: np.array(iou(a, b)))


@pytest.mark.parametrize("limit_whole_scene", [False, True])
def test_database_sampler_matches_jax(tmp_path, limit_whole_scene,
                                      writable_jax_iou):
    """The GT sampler on a seeded db-info pickle and point files, with
    boxes that collide with the scene's and with each other, three calls in
    a row (the second and third wrap the sample pointer and reshuffle)."""
    _write_db(tmp_path)
    cfg = {"DB_INFO_PATH": ["dbinfos.pkl"],
           "PREPARE": {"filter_by_min_points": ["Vehicle:6", "Pedestrian:5"],
                       "filter_by_difficulty": [-1]},
           "SAMPLE_GROUPS": ["Vehicle:3", "Pedestrian:2"],
           "NUM_POINT_FEATURES": 5, "LIMIT_WHOLE_SCENE": limit_whole_scene}
    classes = ["Vehicle", "Pedestrian"]
    js = j_aug.DataBaseSampler(tmp_path, cfg, classes)
    ts = t_aug.DataBaseSampler(tmp_path, cfg, classes,
                               rng=np.random.RandomState(9))
    _equal(ts.db_infos, js.db_infos, "db_infos")
    np.random.seed(9)
    rng = np.random.default_rng(3)
    for _ in range(3):
        gt = np.array([[5.0, 0.0, 0.0, 4.0, 1.8, 1.6, 0.2]], np.float32)
        data = {"gt_boxes": gt, "gt_names": np.array(["Vehicle"]),
                "points": rng.uniform(-2, 12, (200, 5)).astype(np.float32),
                "gt_boxes_mask": np.array([True])}
        want = js(_copy(data))
        got = ts(_copy(data))
        _equal(got, want, "sampled")
    assert len(got["gt_boxes"]) > 1


def test_database_sampler_road_plane_matches_jax(tmp_path):
    _write_db(tmp_path)
    cfg = {"DB_INFO_PATH": ["dbinfos.pkl"], "SAMPLE_GROUPS": ["Vehicle:2"],
           "NUM_POINT_FEATURES": 5, "USE_ROAD_PLANE": True}
    js = j_aug.DataBaseSampler(tmp_path, cfg, ["Vehicle"])
    ts = t_aug.DataBaseSampler(tmp_path, cfg, ["Vehicle"],
                               rng=np.random.RandomState(1))
    data = {"gt_boxes": np.zeros((0, 7), np.float32),
            "gt_names": np.array([], str),
            "points": np.zeros((5, 5), np.float32) + 50,
            "gt_boxes_mask": np.zeros((0,), bool),
            "road_plane": np.array([0.1, 0.0, -1.0, 0.2])}
    np.random.seed(1)
    want = js(_copy(data))
    got = ts(_copy(data))
    _equal(got, want)
    box = got["gt_boxes"][0]
    np.testing.assert_allclose(box[2] - box[5] / 2, 0.1 * box[0] + 0.2,
                               atol=1e-5)


def test_missing_gt_database_disables_sampling():
    cfg = {"DB_INFO_PATH": ["none.pkl"], "SAMPLE_GROUPS": ["Vehicle:2"]}
    s = t_aug.DataBaseSampler(None, cfg, ["Vehicle"])
    data = {"gt_boxes": np.zeros((1, 7), np.float32)}
    assert s.disabled and s(data) is data


# ------------------------------------------- synthetic dataset and collate
@pytest.mark.parametrize("training", [True, False])
def test_synthetic_items_and_collate_match_jax(training):
    from mssvt_tpu.datasets import build_dataset as j_build
    from mssvt_tpu_torch.datasets import build_dataset as t_build

    jd = j_build(synthetic_cfg(), CLASSES, training)
    td = t_build(synthetic_cfg(), CLASSES, training, seed=13)
    for attr in ("grid_size", "voxel_size", "max_voxels",
                 "max_points_per_voxel", "max_gt_boxes"):
        _equal(getattr(td, attr), getattr(jd, attr), attr)
    np.random.seed(13)
    want = [jd[i] for i in (0, 3, 5)]
    got = [td[i] for i in (0, 3, 5)]
    _equal(got, want, "items")
    _equal(td.collate_batch(got), jd.collate_batch(want), "collate")


def test_file_backed_datasets_raise_pointing_at_roadmap():
    from mssvt_tpu_torch.datasets import build_dataset

    cfg = dict(synthetic_cfg(), DATASET="WaymoDataset")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_dataset(cfg, CLASSES, True)


# ------------------------------------------------------------------ loader
class _Stub:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"frame_id": i}

    @staticmethod
    def collate_batch(samples):
        return {"frame_id": [s["frame_id"] for s in samples]}


LOADER_CASES = [
    dict(n=12, batch_size=1, shuffle=True, seed=7),
    dict(n=12, batch_size=5, shuffle=True, seed=3, drop_last=False),
    dict(n=11, batch_size=2, shuffle=False, drop_last=False, rank=1,
         world_size=2),
    dict(n=13, batch_size=2, shuffle=True, seed=1, rank=2, world_size=3),
    dict(n=12, batch_size=3, shuffle=True, seed=7, merge=3),
    dict(n=7, batch_size=3, shuffle=False, drop_last=False, workers=1),
]


@pytest.mark.parametrize("case", range(len(LOADER_CASES)))
def test_loader_order_shards_merge_and_padding_match_jax(case):
    """Index order, rank sharding, merged epochs, the padded last batch and
    ``n_real``: the same batches from both loaders, epochs 0 and 1."""
    kw = dict(LOADER_CASES[case])
    n, merge, workers = kw.pop("n"), kw.pop("merge", None), kw.pop("workers", 0)
    out = []
    for cls in (JLoader, TLoader):
        loader = cls(_Stub(n), num_workers=workers, **kw)
        if merge:
            loader.merge_all_iters_to_one_epoch(merge=True, epochs=merge)
        batches = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            batches.append((len(loader), list(loader)))
        out.append(batches)
    _equal(out[1], out[0], "batches")
    if merge:
        ids = [b["frame_id"][i] for b in out[1][0][1] for i in range(3)]
        assert set(Counter(ids).values()) == {merge}


def test_loader_thread_raises_producer_failure_and_stops_early():
    """A failure in the prefetch thread reaches the consumer; leaving an
    iteration early stops and joins the thread."""
    import threading

    class Bad(_Stub):
        def __getitem__(self, i):
            if i == 3:
                raise ValueError("bad frame 3")
            return super().__getitem__(i)

    loader = TLoader(Bad(6), batch_size=1, shuffle=False, num_workers=1,
                     drop_last=False)
    with pytest.raises(ValueError, match="bad frame 3"):
        list(loader)
    before = threading.active_count()
    it = iter(TLoader(_Stub(50), batch_size=1, shuffle=False, num_workers=1,
                      prefetch=2))
    assert next(it)["frame_id"] == [0]
    it.close()
    assert threading.active_count() == before


@pytest.mark.parametrize("training", [True, False])
def test_synthetic_loader_batches_match_jax(training):
    """The first two batches of the synthetic dataset's loader (prefetch
    thread on), augmentation and shuffling included."""
    np.random.seed(5)
    _, jl = j_build_dataloader(synthetic_cfg(), CLASSES, 2, training,
                               workers=1, seed=4)
    want = [b for _, b in zip(range(2), jl)]
    _, tl = t_build_dataloader(synthetic_cfg(), CLASSES, 2, training,
                               workers=1, seed=4, data_seed=5)
    got = [b for _, b in zip(range(2), tl)]
    _equal(got, want, "batches")
    assert len(tl.make_seconds) >= 2


def test_batch_to_device_moves_arrays_and_keeps_host_values():
    import torch

    from mssvt_tpu_torch.runtime.train_utils import batch_to_device

    _, tl = t_build_dataloader(synthetic_cfg(), CLASSES, 2, False, workers=0)
    batch = next(iter(tl))
    got = batch_to_device(batch, "cpu")
    assert set(got) == set(batch)
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            assert isinstance(got[k], torch.Tensor)
            np.testing.assert_array_equal(got[k].numpy(), v)
        else:
            assert got[k] == v, k
    assert got["frame_id"] == [0, 1] and got["n_real"] == 2
