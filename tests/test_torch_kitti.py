"""The port's KITTI dataset layer against the JAX package's, on the CPU:
calibration, label parsing and the camera/LiDAR/image box transforms
(``datasets/kitti.py``), the info and GT-database preparation, the dataset
with its field-of-view filter, and the official R40 evaluator
(``utils/kitti_eval.py``).

The cases of ``tests/test_kitti_prep.py``, ``test_kitti_eval.py`` and
``test_kitti_aos_bbox.py`` run their assertions on the port's results,
while every call also runs JAX's function on the same input and holds the
two equal (the host numpy code is the same, so exactly).
"""

import copy
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml

import test_kitti_aos_bbox as jax_aos
import test_kitti_eval as jax_eval
import test_kitti_prep as jax_prep
from mssvt_tpu.datasets import kitti as j_kitti
from mssvt_tpu.utils import kitti_eval as j_keval
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.datasets import kitti as t_kitti
from mssvt_tpu_torch.datasets.synthetic_files import (
    KITTI_CALIB,
    write_kitti_tree,
)
from mssvt_tpu_torch.utils import kitti_eval as t_keval
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_torch_pipeline import _equal
from test_torch_waymo import jax_items  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CLASSES = ["Car", "Pedestrian", "Cyclist"]


def _same(got, want, what=""):
    """Equal values (NaN equal to NaN) through dicts, lists and tuples."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_equal(got, want, err_msg=what)


def _both(j_fn, t_fn):
    """Runs JAX's function on a copy of the arguments and the port's on
    them, holds the results equal and returns the port's."""
    def call(*args, **kw):
        want = j_fn(*copy.deepcopy(args), **copy.deepcopy(kw))
        got = t_fn(*args, **kw)
        _same(got, want, t_fn.__name__)
        return got
    return call


def _prep_both(dataset_cfg, class_names, data_path, save_path):
    """``create_kitti_infos``: JAX's into a copy of the tree, the port's
    into the tree itself; the infos, dbinfos and object files equal."""
    data_path, save_path = Path(data_path), Path(save_path)
    assert data_path == save_path
    jax_root = data_path.parent / (data_path.name + "_jax")
    shutil.copytree(data_path, jax_root)
    j_kitti.create_kitti_infos(JDict(dict(dataset_cfg, DATA_PATH=str(jax_root))),
                               class_names, jax_root, jax_root)
    t_kitti.create_kitti_infos(TDict(dict(dataset_cfg)), class_names,
                               data_path, save_path)
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_infos_trainval.pkl", "kitti_dbinfos_train.pkl"):
        with open(data_path / name, "rb") as f, \
                open(jax_root / name, "rb") as g:
            _same(pickle.load(f), pickle.load(g), name)
    for p in sorted((jax_root / "gt_database_train").iterdir()):
        assert (data_path / "gt_database_train" / p.name).read_bytes() == \
            p.read_bytes(), p.name


JAX_CASES = [(m, n) for m in (jax_prep, jax_eval, jax_aos)
             for n in sorted(dir(m)) if n.startswith("test_")]


def test_the_jax_suites_have_thirteen_cases():
    assert [len([1 for m, _ in JAX_CASES if m is mod])
            for mod in (jax_prep, jax_eval, jax_aos)] == [1, 5, 7]


@pytest.mark.parametrize("case", [f"{m.__name__}::{n}" for m, n in JAX_CASES])
def test_jax_kitti_cases_on_the_port(case, monkeypatch, tmp_path):
    mod_name, name = case.split("::")
    mod = {m.__name__: m for m in (jax_prep, jax_eval, jax_aos)}[mod_name]
    for fn in ("clean_data", "get_thresholds", "kitti_official_eval",
               "_bbox_iou_2d", "_eval_class"):
        both = _both(getattr(j_keval, fn), getattr(t_keval, fn))
        monkeypatch.setattr(mod, fn, both, raising=False)
    # the cases that import from the dataset module inside their body
    for fn in ("boxes_camera_to_imageboxes", "boxes_lidar_to_camera",
               "generate_kitti_prediction_dict"):
        monkeypatch.setattr(j_kitti, fn,
                            _both(getattr(j_kitti, fn), getattr(t_kitti, fn)))
    monkeypatch.setattr(jax_prep, "create_kitti_infos", _prep_both)
    test = getattr(mod, name)
    if "tmp_path" in test.__code__.co_varnames[:test.__code__.co_argcount]:
        test(tmp_path)
    else:
        test()


def _random_frames(seed, n_frames=5):
    """Seeded det/GT frames with camera fields: names with neighbour
    classes and DontCare, image boxes around the difficulty heights,
    occlusion, truncation, alphas, tied scores."""
    rng = np.random.default_rng(seed)
    names = np.array(CLASSES + ["Van", "Person_sitting", "DontCare"])
    dets, gts = [], []
    for _ in range(n_frames):
        g = int(rng.integers(0, 12))
        gb = np.stack([rng.uniform(0, 60, g), rng.uniform(-20, 20, g),
                       rng.uniform(-1, 1, g), rng.uniform(0.5, 4.5, g),
                       rng.uniform(0.5, 2, g), rng.uniform(1.4, 1.8, g),
                       rng.uniform(-np.pi, np.pi, g)], 1)
        u, v = rng.uniform(0, 1100, g), rng.uniform(100, 250, g)
        gbbox = np.stack([u, v, u + rng.uniform(10, 120, g),
                          v + rng.uniform(15, 80, g)], 1)
        gts.append({"boxes": gb, "name": rng.choice(names, g, p=[
            .4, .2, .2, .08, .06, .06]), "bbox": gbbox,
            "alpha": rng.uniform(-np.pi, np.pi, g),
            "occluded": rng.integers(0, 3, g),
            "truncated": rng.choice([0.0, 0.2, 0.4, 0.6], g)})
        pick = rng.uniform(size=g) < 0.8
        d = int(pick.sum()) + int(rng.integers(0, 4))
        db = np.concatenate([gb[pick], np.stack([
            rng.uniform(0, 60, d - pick.sum()), rng.uniform(-20, 20, d - pick.sum()),
            np.zeros(d - pick.sum()), np.full(d - pick.sum(), 3.9),
            np.full(d - pick.sum(), 1.6), np.full(d - pick.sum(), 1.5),
            np.zeros(d - pick.sum())], 1)])
        db[:, :2] += rng.normal(0, 0.1, (d, 2))
        dbbox = np.concatenate([gbbox[pick], gbbox[:1].repeat(
            d - pick.sum(), 0) if g else np.full((d - pick.sum(), 4), 50.0)])
        dbbox += rng.normal(0, 2, dbbox.shape)
        dname = np.concatenate([np.where(np.isin(gts[-1]["name"][pick], CLASSES),
                                         gts[-1]["name"][pick], "Car"),
                                rng.choice(CLASSES, d - pick.sum())])
        dets.append({"boxes": db, "name": dname,
                     "scores": np.round(rng.uniform(0, 1, d), 1),
                     "bbox": dbbox,
                     "alpha": np.concatenate([gts[-1]["alpha"][pick],
                                              np.zeros(d - pick.sum())])
                     + rng.normal(0, 0.3, d)})
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1])
def test_kitti_official_eval_on_random_frames_matches_jax(seed):
    dets, gts = _random_frames(seed)
    want = j_keval.kitti_official_eval(copy.deepcopy(dets),
                                       copy.deepcopy(gts), CLASSES)
    got = t_keval.kitti_official_eval(dets, gts, CLASSES)
    _same(got, want)
    assert got[0] == want[0]
    assert len(got[1]) == 3 * 4 * 3  # classes x (bbox, bev, 3d, aos) x 3
    assert any(np.isfinite(v) and v > 0 for v in got[1].values())


def test_calibration_and_box_transforms_match_jax(tmp_path):
    calib_file = tmp_path / "calib.txt"
    calib_file.write_text(KITTI_CALIB)
    jc, tc = j_kitti.Calibration(calib_file), t_kitti.Calibration(calib_file)
    for attr in ("P2", "R0", "V2C"):
        np.testing.assert_array_equal(getattr(tc, attr), getattr(jc, attr))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-40, 40, (200, 3))
    pts[:, 0] = np.abs(pts[:, 0]) + 1
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)  # noqa: E731
    close(tc.lidar_to_rect(pts), jc.lidar_to_rect(pts))
    close(tc.rect_to_lidar(pts), jc.rect_to_lidar(pts))
    for a, b in zip(tc.rect_to_img(tc.lidar_to_rect(pts)),
                    jc.rect_to_img(jc.lidar_to_rect(pts))):
        close(a, b)
    boxes = np.concatenate([pts[:20], rng.uniform(0.5, 4, (20, 3)),
                            rng.uniform(-np.pi, np.pi, (20, 1))], 1)
    cam_t = t_kitti.boxes_lidar_to_camera(boxes, tc)
    cam_j = j_kitti.boxes_lidar_to_camera(boxes, jc)
    close(cam_t, cam_j)
    close(t_kitti.boxes_camera_to_imageboxes(cam_t, tc, (375, 1242)),
          j_kitti.boxes_camera_to_imageboxes(cam_j, jc, (375, 1242)))
    objs = [{"loc": c[:3], "hwl": c[[4, 5, 3]], "ry": c[6], "name": "Car"}
            for c in cam_t]
    got, want = (m.boxes_camera_to_lidar(objs, c)
                 for m, c in ((t_kitti, tc), (j_kitti, jc)))
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # the round trip, in f32 (its ulp at 64 m is 7.6e-6)
    np.testing.assert_allclose(got[0], boxes, rtol=0, atol=1e-5)
    label = tmp_path / "label.txt"
    label.write_text("Car 0.10 1 -1.57 500 150 700 300 1.5 1.6 3.9 0.0 0.8 "
                     "10.0 -1.5708 0.93\nDontCare -1 -1 -10 1 2 3 4 -1 -1 -1 "
                     "-1000 -1000 -1000 -10\nshort line\n")
    _same(t_kitti.parse_label_file(label), j_kitti.parse_label_file(label))


# --------------------------------------------------------------- dataset
TRAIN = [f"{i:06d}" for i in range(6)]
VAL = [f"{i:06d}" for i in range(6, 9)]


def dataset_cfg(root, db=True):
    """``kitti_dataset.yaml`` as shipped (FOV filter on), on ``root``."""
    cfg = yaml.safe_load(
        (REPO / "tools/cfgs/dataset_configs/kitti_dataset.yaml").read_text())
    cfg["DATA_PATH"] = str(root)
    if not db:
        cfg["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = ["gt_sampling"]
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two copies of one seeded KITTI tree, each prepared by its package
    (infos of both splits and the train split's GT database)."""
    roots = {}
    for name, mod, edict in (("jax", j_kitti, JDict),
                             ("torch", t_kitti, TDict)):
        root = tmp_path_factory.mktemp(f"kitti_{name}")
        write_kitti_tree(root, TRAIN, VAL, points_per_frame=6000, seed=4)
        mod.create_kitti_infos(edict(dataset_cfg(root)), CLASSES, root, root)
        roots[name] = root
    return roots


def test_prepared_infos_and_gt_database_match_jax(trees):
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_dbinfos_train.pkl"):
        with open(trees["torch"] / name, "rb") as f, \
                open(trees["jax"] / name, "rb") as g:
            _same(pickle.load(f), pickle.load(g), name)
    files = sorted((trees["jax"] / "gt_database_train").iterdir())
    assert len(files) > 20
    for p in files:
        assert (trees["torch"] / "gt_database_train" / p.name).read_bytes() \
            == p.read_bytes()
    with open(trees["torch"] / "kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    names = np.concatenate([i["annos"]["name"] for i in infos])
    counts = np.concatenate([i["annos"]["num_points_in_gt"] for i in infos])
    assert set(names) == set(CLASSES) | {"DontCare"}
    assert (counts[names == "DontCare"] == -1).all()
    assert (counts[names != "DontCare"] >= 6).all()  # the planted points


@pytest.mark.parametrize("training", [False, True])
def test_items_match_jax(trees, training, jax_items):
    """``__getitem__`` with the FOV filter on: points outside the camera's
    view dropped, labels without DontCare; in training with the shipped
    augmentation (gt_sampling from each package's database) from one
    seed."""
    jd = j_kitti.KittiDataset(JDict(dataset_cfg(trees["jax"], training)),
                              CLASSES, training=training,
                              root_path=trees["jax"])
    td = t_kitti.KittiDataset(TDict(dataset_cfg(trees["torch"], training)),
                              CLASSES, training=training,
                              root_path=trees["torch"], seed=8)
    assert len(td) == len(jd) == (6 if training else 3)
    np.random.seed(8)
    want = [jd[i] for i in range(len(jd))]
    got = [td[i] for i in range(len(td))]
    _equal(got, want, "items")
    idx = td.sample_id_list[0]
    pts = td.get_lidar(idx)
    fov = td._fov_flag(pts, td.get_calib(idx))
    assert 0.2 < fov.mean() < 0.5  # the camera sees about a third
    if not training:
        assert len(got[0]["points"]) <= fov.sum()
        assert all(len(g["gt_boxes"]) > 0 for g in got)


def gt_frame(annos):
    """An info's annos as a GT frame of the evaluator: the cared-for rows
    (``gt_boxes_lidar`` holds no DontCare box) with their camera fields."""
    care = annos["name"] != "DontCare"
    frame = {k: annos[k][care] for k in ("name", "bbox", "alpha", "occluded",
                                         "truncated")}
    frame["boxes"] = annos["gt_boxes_lidar"]
    frame["labels"] = np.array([CLASSES.index(n) + 1 for n in frame["name"]])
    return frame


def test_evaluation_matches_jax(trees):
    """``KittiDataset.evaluation`` on predictions made from the val infos'
    boxes (perturbed) through ``generate_kitti_prediction_dict`` with the
    frame's calibration: the official R40 metrics by default, the proxy
    for another ``EVAL_METRIC``; the same report and metrics as JAX's."""
    results = {}
    for name, mod, edict in (("jax", j_kitti, JDict),
                             ("torch", t_kitti, TDict)):
        with open(trees[name] / "kitti_infos_val.pkl", "rb") as f:
            infos = pickle.load(f)
        ds = mod.KittiDataset(edict(dataset_cfg(trees[name])), CLASSES,
                              training=False, root_path=trees[name])
        rng = np.random.default_rng(3)
        dets, gts = [], []
        for info in infos:
            gt = gt_frame(info["annos"])
            boxes = gt["boxes"] + rng.normal(0, 0.05, gt["boxes"].shape)
            scores = np.round(rng.uniform(0.2, 1, len(boxes)), 1)
            dets.append(mod.generate_kitti_prediction_dict(
                boxes, scores, gt["labels"], CLASSES,
                calib=ds.get_calib(info["point_cloud"]["lidar_idx"]),
                image_shape=(375, 1242)))
            dets[-1]["labels"] = gt["labels"]
            gts.append(gt)
        official = ds.evaluation(dets, CLASSES, gt_annos=gts)
        ds.dataset_cfg["EVAL_METRIC"] = "proxy"
        results[name] = (official, ds.evaluation(dets, CLASSES, gt_annos=gts))
    _same(results["torch"], results["jax"])
    official = results["torch"][0][1]
    assert {"Car_bbox/moderate_R40", "Car_aos/moderate_R40",
            "Car_3d/moderate_R40"} <= set(official)
    assert any(v > 0 for v in official.values() if np.isfinite(v))
    assert "mAP" in results["torch"][1][1]


def test_data_preparation_cli(tmp_path):
    """``python -m mssvt_tpu_torch.datasets.kitti --cfg_file ...`` on a
    seeded tree writes the infos and the GT database, as JAX's CLI does."""
    import subprocess
    import sys

    write_kitti_tree(tmp_path, TRAIN[:2], VAL[:1], points_per_frame=3000)
    res = subprocess.run(
        [sys.executable, "-m", "mssvt_tpu_torch.datasets.kitti", "--cfg_file",
         str(REPO / "tools/cfgs/dataset_configs/kitti_dataset.yaml"),
         "--data_path", str(tmp_path)],
        cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Data preparation Done" in res.stdout
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_infos_trainval.pkl", "kitti_dbinfos_train.pkl"):
        assert (tmp_path / name).exists(), name
    assert list((tmp_path / "gt_database_train").glob("*_Car_*.bin"))
