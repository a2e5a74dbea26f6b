"""The port's Waymo dataset layer against the JAX package's, on the CPU:
the official-protocol metrics (``datasets/waymo_eval.py``), the dataset on
a seeded processed tree (``datasets/waymo.py``: split files,
``SAMPLED_INTERVAL``, the no-label-zone filter, the ``tanh`` of the
intensity, the empty-box filter, the shared-memory cache, the GT database,
``evaluation``) and the record converter's lazy SDK import
(``datasets/waymo_utils.py``).

JAX's metric takes its 3D IoU from eager jnp ops, which compile once for
every new pair of box counts; ``padded_jax_iou`` hands them one padded
shape (the pairs of real boxes are computed as before, the padding is cut
off), so the JAX side compiles once.
"""

import copy
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import test_waymo_eval as jax_cases
import test_waymo_shm_cache as jax_shm
from mssvt_tpu.datasets import waymo as j_waymo
from mssvt_tpu.datasets import waymo_eval as j_eval
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.datasets import waymo as t_waymo
from mssvt_tpu_torch.datasets import waymo_eval as t_eval
from mssvt_tpu_torch.datasets.synthetic_files import write_waymo_tree
from mssvt_tpu_torch.ops.box_ops import pairwise_iou_3d
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_torch_pipeline import _equal

REPO = Path(__file__).resolve().parent.parent
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
SIZES = {"Vehicle": (4.5, 2.0, 1.7), "Pedestrian": (0.8, 0.8, 1.7),
         "Cyclist": (1.8, 0.8, 1.7)}
IOU_PAD = 64  # boxes of one class in one frame, at most
GATES = (0.5, 0.7)


@pytest.fixture
def padded_jax_iou(monkeypatch):
    iou = j_eval._boxes_iou3d_numpy
    far = np.array([1e3, 1e3, 0.0, 1.0, 1.0, 1.0, 0.0])

    def padded(a, b):
        n, m = len(a), len(b)
        if n == 0 or m == 0:
            return iou(a, b)
        assert max(n, m) <= IOU_PAD, (n, m)
        pa = np.concatenate([np.asarray(a, np.float64),
                             np.tile(far, (IOU_PAD - n, 1))])
        pb = np.concatenate([np.asarray(b, np.float64),
                             np.tile(far, (IOU_PAD - m, 1))])
        return iou(pa, pb)[:n, :m]

    monkeypatch.setattr(j_eval, "_boxes_iou3d_numpy", padded)


@pytest.fixture
def jax_items(monkeypatch):
    """JAX's dataset items as the port computes them, in one compile:
    - its GT sampler's collision IoU gets one padded shape and hands back a
      writable array (the sampler writes into ``np.asarray`` of a jax
      array, a read-only view, ``writable_jax_iou`` of
      ``test_torch_pipeline.py``);
    - its voxelizer takes its numpy version, which computes every point's
      cell in float64 as the port's C++ voxelizer does (JAX's C++ takes
      float32 sizes: a point on a cell edge can land one cell over)."""
    from mssvt_tpu.ops import box_ops, voxelize

    iou = box_ops.pairwise_iou_bev
    far = np.array([1e3, 1e3, 0.0, 1.0, 1.0, 1.0, 0.0], np.float32)

    def padded(a, b):
        n, m = len(a), len(b)
        assert max(n, m) <= 2 * IOU_PAD, (n, m)
        pa = np.concatenate([np.asarray(a), np.tile(far, (2 * IOU_PAD - n, 1))])
        pb = np.concatenate([np.asarray(b), np.tile(far, (2 * IOU_PAD - m, 1))])
        return np.array(iou(pa, pb))[:n, :m]

    monkeypatch.setattr(box_ops, "pairwise_iou_bev", padded)
    monkeypatch.setattr(voxelize, "_voxelize_native", lambda *a: None)


def _same_metrics(got, want, tol=1e-6):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


# ------------------------------------------------------------ the metrics
JAX_CASES = sorted(n for n in dir(jax_cases) if n.startswith("test_"))


def test_the_jax_suite_has_eleven_metric_cases():
    assert len(JAX_CASES) == 11


@pytest.mark.parametrize("case", JAX_CASES)
def test_jax_metric_cases_on_the_port(case, monkeypatch, padded_jax_iou):
    """Each case of ``tests/test_waymo_eval.py`` runs its assertions on the
    port's results; every call also runs JAX's function on the same input
    and holds the two equal (metrics within 1e-6, arrays exactly)."""
    def both(name, check):
        j_fn, t_fn = getattr(j_eval, name), getattr(t_eval, name)

        def call(*args, **kw):
            want = j_fn(*copy.deepcopy(args), **copy.deepcopy(kw))
            got = t_fn(*args, **kw)
            check(got, want)
            return got
        return call

    metrics = both("compute_waymo_metrics", _same_metrics)
    monkeypatch.setattr(jax_cases, "compute_waymo_metrics", metrics)
    # the cases that import it inside their body
    monkeypatch.setattr(j_eval, "compute_waymo_metrics", metrics)
    monkeypatch.setattr(jax_cases, "generate_waymo_type_results", both(
        "generate_waymo_type_results", lambda g, w: _equal(g, w, "types")))
    getattr(jax_cases, case)()


def _random_frames(seed, n_frames=6):
    """Seeded prediction and GT frames: 0-30 GT boxes a frame on a 10 m
    lattice (no two overlap), 0-2 noisy predictions each (10% with another
    class) and up to 4 stray ones, scores on a 0.1 grid (ties), difficulty
    0 or 2 and 0-39 points a GT (so L2-only GTs both ways). A prediction
    whose IoU with a GT lies within 1e-3 of a gate, or of another
    prediction's IoU with that GT, is dropped: the two packages' IoUs
    differ by ~4e-6, which must not flip a match."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(n_frames):
        n = int(rng.integers(0, 31))
        names = rng.choice(CLASSES, n)
        cells = rng.permutation(100)[:n]
        gt = np.array([[c % 10 * 10.0 - 45, c // 10 * 10.0 - 45,
                        rng.uniform(-0.5, 0.5),
                        *(s * rng.uniform(0.9, 1.1) for s in SIZES[nm]),
                        rng.uniform(-np.pi, np.pi)]
                       for nm, c in zip(names, cells)]).reshape(-1, 7)
        gts.append({"name": names, "gt_boxes_lidar": gt,
                    "num_points_in_gt": rng.integers(0, 40, n),
                    "difficulty": rng.choice([0, 0, 0, 2], n)})
        cand, cand_names = [], []
        for i in range(n):
            for _ in range(int(rng.integers(0, 3))):
                b = gt[i].copy()
                b[:3] += rng.normal(0, 0.15, 3) * b[3:6]
                b[6] += rng.normal(0, 0.5)
                cand.append(b)
                cand_names.append(names[i] if rng.uniform() < 0.9
                                  else rng.choice(CLASSES))
        for _ in range(int(rng.integers(0, 5))):
            nm, c = rng.choice(CLASSES), int(rng.integers(0, 100))
            cand.append([c % 10 * 10.0 - 45 + rng.uniform(-5, 5),
                         c // 10 * 10.0 - 45 + rng.uniform(-5, 5), 0.0,
                         *SIZES[nm], rng.uniform(-3, 3)])
            cand_names.append(nm)
        keep, taken = [], [[] for _ in range(n)]
        for b in cand:
            iou = (pairwise_iou_3d(torch.as_tensor(np.asarray(b)[None], dtype=torch.float32),
                                   torch.as_tensor(gt, dtype=torch.float32))
                   .numpy()[0] if n else np.zeros(0))
            near = [abs(v - g) < 1e-3 for v in iou for g in GATES] + [
                abs(v - w) < 1e-3 for j, v in enumerate(iou) if v > 0
                for w in taken[j]]
            keep.append(not any(near))
            if keep[-1]:
                for j, v in enumerate(iou):
                    if v > 0:
                        taken[j].append(v)
        keep = np.array(keep, bool)
        boxes = np.array(cand).reshape(-1, 7)[keep]
        dets.append({"name": np.array(cand_names)[keep] if len(cand)
                     else np.array([], str),
                     "score": np.round(rng.uniform(0, 1, len(boxes)),
                                       1).astype(np.float32),
                     "boxes_lidar": boxes})
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_waymo_metrics_on_random_frames_matches_jax(
        seed, padded_jax_iou):
    dets, gts = _random_frames(seed)
    assert sum(len(d["score"]) for d in dets) > 20
    want = j_eval.compute_waymo_metrics(copy.deepcopy(dets),
                                        copy.deepcopy(gts), CLASSES)
    got = t_eval.compute_waymo_metrics(dets, gts, CLASSES)
    assert len(got) == 12 and any(v > 0 for v in got.values())
    _same_metrics(got, want)


def test_generate_waymo_type_results_matches_jax():
    dets, gts = _random_frames(7, n_frames=4)
    cases = [(dets, False, True), (gts, True, True)]
    no_diff = [{k: v for k, v in g.items() if k != "difficulty"}
               for g in gts]
    no_pts = [{k: v for k, v in g.items() if k != "num_points_in_gt"}
              for g in gts]
    boxes_key = [{"name": d["name"], "score": d["score"],
                  "boxes": d["boxes_lidar"]} for d in dets]
    cases += [(no_diff, True, True), (no_pts, True, True),
              (boxes_key, False, True)]
    for infos, is_gt, fake in cases:
        want = j_eval.generate_waymo_type_results(infos, CLASSES, is_gt, fake)
        got = t_eval.generate_waymo_type_results(infos, CLASSES, is_gt, fake)
        _equal(got, want, f"is_gt={is_gt}")
    for mod in (j_eval, t_eval):
        with pytest.raises(ValueError, match="num_points_in_gt"):
            mod.generate_waymo_type_results(no_pts, CLASSES, True, False)


# --------------------------------------------------------------- dataset
TREE = dict(splits={"train": ["seq_a", "seq_b"], "val": ["seq_v"]},
            frames_per_sequence=5, points_per_frame=3000, seed=3)


def dataset_cfg(root, shm_root=None, db_info=None):
    """``waymo_dataset.yaml`` as shipped, on the tree under ``root``."""
    cfg = yaml.safe_load(
        (REPO / "tools/cfgs/dataset_configs/waymo_dataset.yaml").read_text())
    cfg["DATA_PATH"] = str(root)
    if shm_root is not None:
        cfg.update(USE_SHARED_MEMORY=True, SHARED_MEMORY_ROOT=str(shm_root))
    sampler = cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0]
    assert sampler["NAME"] == "gt_sampling"
    if db_info is None:
        cfg["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = ["gt_sampling"]
    else:
        sampler["DB_INFO_PATH"] = [db_info]
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two copies of one seeded processed tree, one a package, each with
    its package's GT database of the train split."""
    roots = {}
    for name, mod, edict in (("jax", j_waymo, JDict), ("torch", t_waymo,
                                                       TDict)):
        root = tmp_path_factory.mktemp(f"waymo_{name}")
        write_waymo_tree(root, **TREE)
        kw = {} if name == "jax" else {"seed": 0}
        ds = mod.WaymoDataset(edict(dataset_cfg(root)), CLASSES,
                              training=False, root_path=root, **kw)
        ds.set_split("train")
        ds.include_waymo_data("train")
        ds.create_groundtruth_database(used_classes=CLASSES, split="train",
                                       sampled_interval=1)
        roots[name] = root
    return roots


DB_INFO = "pcdet_waymo_dbinfos_train_sampled_1.pkl"


def test_gt_database_bytes_and_dbinfos_match_jax(trees):
    dbs = {}
    for name, root in trees.items():
        with open(root / DB_INFO, "rb") as f:
            dbs[name] = pickle.load(f)
    _equal(dbs["torch"], dbs["jax"], "dbinfos")
    n = 0
    for infos in dbs["jax"].values():
        for info in infos:
            assert (trees["torch"] / info["path"]).read_bytes() == \
                (trees["jax"] / info["path"]).read_bytes(), info["path"]
            n += 1
    # 2 x 5 train frames, 6-15 labelled objects each besides the
    # unknown ones and the empty box
    assert n > 60 and set(dbs["jax"]) == set(CLASSES)
    difficulties = {int(i["difficulty"]) for v in dbs["jax"].values()
                    for i in v}
    assert difficulties == {0, 2}


@pytest.mark.parametrize("training", [False, True])
def test_items_match_jax(trees, training, jax_items):
    """``__getitem__`` of both packages' datasets on the same tree:
    ``SAMPLED_INTERVAL`` (train 5: 2 of 10 frames; test 1), the NLZ filter,
    the tanh, the ``unknown`` drop and the empty-box filter; in training
    with the shipped augmentation (gt_sampling from each package's own
    database, flips, rotation, scaling, shuffle) from the same seed."""
    db = DB_INFO if training else None
    jd = j_waymo.WaymoDataset(JDict(dataset_cfg(trees["jax"], db_info=db)),
                              CLASSES, training=training,
                              root_path=trees["jax"])
    td = t_waymo.WaymoDataset(TDict(dataset_cfg(trees["torch"], db_info=db)),
                              CLASSES, training=training,
                              root_path=trees["torch"], seed=5)
    assert len(td) == len(jd) == (2 if training else 5)
    _equal([i["frame_id"] for i in td.infos],
           [i["frame_id"] for i in jd.infos])
    np.random.seed(5)
    want = [jd[i] for i in range(len(jd))]
    got = [td[i] for i in range(len(td))]
    _equal(got, want, "items")
    if training:  # the sampler pasted objects beside the frame's own
        own = [(i["annos"]["name"] != "unknown")
               & (i["annos"]["num_points_in_gt"] > 0) for i in td.infos]
        assert sum(len(g["gt_boxes"]) for g in got) > sum(
            int(m.sum()) for m in own)
    else:
        raw = np.load(trees["torch"] / "waymo_processed_data" / "seq_v" /
                      "0000.npy")
        kept = raw[raw[:, 5] == -1]
        assert len(kept) < len(raw)
        pts = td.get_lidar("seq_v", 0)
        np.testing.assert_array_equal(pts[:, 3], np.tanh(kept[:, 3]))


def test_shared_memory_cache_matches_jax(tmp_path):
    """``tests/test_waymo_shm_cache.py`` on the port: a second instance
    with an empty per-process dict reads the staged points after the
    source file is gone; the port stages the points and the file that JAX
    stages (each under its own private root), and ``clean_shared_memory``
    removes them."""
    jax_root = tmp_path / "jax_shm"
    jds = jax_shm._make_dataset(tmp_path, jax_root)  # the tree, JAX's side
    want = jds.get_lidar("seq0", 0)
    cfg = TDict(json.loads(json.dumps(jds.dataset_cfg)))
    shm_root = tmp_path / "shm"
    cfg["SHARED_MEMORY_ROOT"] = str(shm_root)

    def port_dataset():
        return t_waymo.WaymoDataset(cfg, ["Vehicle"], training=True,
                                    root_path=jds.root_path, seed=0)

    ds1 = port_dataset()
    pts1 = ds1.get_lidar("seq0", 0)
    np.testing.assert_array_equal(pts1, want)
    staged = [sorted(p.relative_to(r) for p in r.rglob("*.npy"))
              for r in (shm_root, jax_root)]
    assert staged[0] == staged[1] == [
        Path("mssvt_waymo_cache/train/seq0_0000.npy")]
    ds2 = port_dataset()
    assert not ds2._lidar_cache
    (jds.root_path / "waymo_processed_data" / "seq0" / "0000.npy").unlink()
    np.testing.assert_array_equal(ds2.get_lidar("seq0", 0), pts1)
    ds1.clean_shared_memory()
    assert not list(shm_root.rglob("*.npy"))


def _det_frames(seed, n):
    """Result-pickle frames (boxes, scores, labels) near the val split's
    GT boxes, off the IoU gates."""
    rng = np.random.default_rng(seed)
    dets, _ = _random_frames(seed, n_frames=n)
    out = []
    for d in dets:
        labels = np.array([CLASSES.index(x) + 1 for x in d["name"]],
                          np.int64)
        out.append({"boxes": d["boxes_lidar"].astype(np.float32),
                    "scores": d["score"], "labels": labels})
    rng.shuffle(out)
    return out


def test_generate_prediction_dicts_matches_jax():
    dets = _det_frames(4, 5)
    _equal(t_waymo.WaymoDataset.generate_prediction_dicts(dets, CLASSES),
           j_waymo.WaymoDataset.generate_prediction_dicts(dets, CLASSES))


@pytest.mark.parametrize("metric", ["waymo", "kitti", "data_config_wins"])
def test_evaluation_matches_jax(trees, metric, padded_jax_iou):
    """``evaluation`` on the val split: the official protocol when the
    caller asks for ``eval_metric="waymo"`` (``EVAL_METRIC`` is not in
    ``DATA_CONFIG``), the KITTI-style proxy by default, and the proxy when
    ``DATA_CONFIG`` says ``EVAL_METRIC: kitti`` whatever the caller asks
    (it is read first); the same report and metrics as JAX's. Predictions are the val frames' own GT boxes,
    perturbed, so every metric has matches."""
    extra = {"EVAL_METRIC": "kitti"} if metric == "data_config_wins" else {}
    jd = j_waymo.WaymoDataset(JDict(dataset_cfg(trees["jax"]), **extra),
                              CLASSES, training=False, root_path=trees["jax"])
    td = t_waymo.WaymoDataset(TDict(dataset_cfg(trees["torch"]), **extra),
                              CLASSES, training=False,
                              root_path=trees["torch"], seed=0)
    rng = np.random.default_rng(11)
    dets, gt_annos = [], []
    for info in td.infos:
        a = info["annos"]
        keep = np.isin(a["name"], CLASSES)
        boxes = a["gt_boxes_lidar"][keep].astype(np.float32)
        labels = np.array([CLASSES.index(x) + 1 for x in a["name"][keep]])
        noisy = boxes + rng.normal(0, 0.03, boxes.shape).astype(np.float32)
        dets.append({"boxes": noisy, "labels": labels,
                     "scores": np.round(rng.uniform(0.1, 1, len(boxes)), 1)})
        gt_annos.append({"boxes": boxes, "labels": labels})
    kw = {"gt_annos": gt_annos}
    annos = dets  # the proxy reads result.pkl's frames as they are
    if metric != "kitti":
        kw["eval_metric"] = "waymo"
    if metric == "waymo":
        annos = t_waymo.WaymoDataset.generate_prediction_dicts(dets, CLASSES)
    want = jd.evaluation(copy.deepcopy(annos), CLASSES, **kw)
    got = td.evaluation(annos, CLASSES, **kw)
    assert got[0] == want[0]
    np.testing.assert_equal(got[1], want[1])
    if metric == "waymo":
        assert len(got[1]) == 12 and got[0].startswith("Waymo official")
        assert all(0.0 < v <= 1.0 for v in got[1].values())
    else:
        assert "mAP" in got[1]


def test_waymo_utils_imports_no_sdk_and_raises_without_it(tmp_path):
    """Importing the converter loads no tensorflow; converting a record
    without waymo-open-dataset raises ImportError; the metric estimator
    falls back to numpy without importing tensorflow either."""
    code = (
        "import sys\n"
        "sys.modules['waymo_open_dataset'] = None  # as if not installed\n"
        "import numpy as np\n"
        "from mssvt_tpu_torch.datasets import waymo_utils\n"
        "from mssvt_tpu_torch.datasets.waymo_eval import "
        "OpenPCDetWaymoDetectionMetricsEstimator as E\n"
        "assert 'tensorflow' not in sys.modules\n"
        "try:\n"
        f"    waymo_utils.process_single_sequence('seg.tfrecord', {str(tmp_path)!r})\n"
        "except ImportError as e:\n"
        "    assert 'waymo-open-dataset' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('no ImportError')\n"
        "b = np.array([[0., 0, 0, 4, 2, 1.5, 0]])\n"
        "r = E().waymo_evaluation([{'name': np.array(['Vehicle']), "
        "'score': np.array([0.9]), 'boxes_lidar': b}], [{'name': "
        "np.array(['Vehicle']), 'gt_boxes_lidar': b, 'num_points_in_gt': "
        "np.array([9]), 'difficulty': np.array([0])}], ['Vehicle'])\n"
        "assert r['OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP'] == 1.0, r\n"
        "assert 'tensorflow' not in sys.modules\n"
        "assert not list(__import__('pathlib').Path("
        f"{str(tmp_path)!r}).iterdir())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_data_preparation_cli_needs_the_sdk(tmp_path):
    """``python -m mssvt_tpu_torch.datasets.waymo --cfg_file ...`` parses
    its arguments and starts the record conversion, which raises the SDK's
    ImportError when waymo-open-dataset is absent."""
    (tmp_path / "ImageSets").mkdir()
    (tmp_path / "ImageSets" / "train.txt").write_text("seg.tfrecord\n")
    cfg = REPO / "tools/cfgs/dataset_configs/waymo_dataset.yaml"
    code = (
        "import runpy, sys\n"
        "sys.modules['waymo_open_dataset'] = None  # as if not installed\n"
        f"sys.argv = ['waymo', '--cfg_file', {str(cfg)!r}, "
        f"'--data_path', {str(tmp_path)!r}]\n"
        "runpy.run_module('mssvt_tpu_torch.datasets.waymo', "
        "run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "ImportError: waymo-open-dataset (+ tensorflow) is required" in \
        res.stderr, res.stderr[-2000:]
    assert "Start to generate data infos" in res.stdout
