"""The port's entry points on a file-backed dataset, on the CPU: a tiny
seeded Waymo tree in ``WaymoDataset``'s layout, its GT database written by
the port, ``tools/train_torch.py`` for one epoch with ``gt_sampling`` on
and the shared-memory cache staged under a private root, then
``tools/test_torch.py`` on the checkpoint; the official Waymo metrics of
its ``result.pkl`` from the port's and JAX's ``WaymoDataset.evaluation``
are the same. The model is the 2-block tiny MsSVT of
``tests/test_torch_cli.py``.
"""

import copy
import json
import math
import pickle
import sys

import numpy as np
import pytest
import torch
import yaml

from mssvt_tpu.datasets import waymo as j_waymo
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.datasets import waymo as t_waymo
from mssvt_tpu_torch.datasets.synthetic_files import write_waymo_tree
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_torch_cli import REPO, _tool
from test_torch_waymo import dataset_cfg, padded_jax_iou  # noqa: F401

CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
PCR = [0.0, -9.6, -2.0, 19.2, 9.6, 2.0]  # mssvt_tiny.yaml's range
DB_INFO = "pcdet_waymo_dbinfos_train_sampled_1.pkl"

torch.set_num_threads(2)


def _config(root, tree, shm):
    sys.path.insert(0, str(REPO))
    from __graft_entry__ import _model_cfg

    model = json.loads(json.dumps(_model_cfg()))
    model["BACKBONE_3D"]["PARAMS"] = model["BACKBONE_3D"]["PARAMS"][:2]
    model["MAP_TO_BEV"]["NUM_BEV_FEATURES"] = 64 * 2
    data = dataset_cfg(tree, shm_root=shm, db_info=DB_INFO)
    data.update(POINT_CLOUD_RANGE=PCR, MAX_GT_BOXES=48)
    vox = data["DATA_PROCESSOR"][-1]
    vox.update(VOXEL_SIZE=[0.4, 0.4, 0.5],
               MAX_NUMBER_OF_VOXELS={"train": 2048, "test": 2048})
    cfg = {
        "CLASS_NAMES": CLASSES, "DATA_CONFIG": data, "MODEL": model,
        "OPTIMIZATION": {
            "BATCH_SIZE_PER_GPU": 2, "NUM_EPOCHS": 1,
            "OPTIMIZER": "adam_onecycle", "LR": 0.003,
            "WEIGHT_DECAY": 0.01, "MOMENTUM": 0.9, "MOMS": [0.95, 0.85],
            "PCT_START": 0.4, "DIV_FACTOR": 10, "GRAD_NORM_CLIP": 10,
        },
    }
    path = root / "cfgs" / "waymo_models" / "tiny_mssvt_files.yaml"
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo_cli")
    tree, shm = root / "waymo", root / "shm"
    # train: 2 x 5 frames, SAMPLED_INTERVAL 5 -> 2 frames (1 step at batch
    # 2); val: 4 frames (2 requests)
    write_waymo_tree(tree, {"train": ["seq_a", "seq_b"]}, 5, 4000, seed=5,
                     pcr=PCR)
    write_waymo_tree(tree, {"val": ["seq_v"]}, 4, 4000, seed=6, pcr=PCR)
    cfg_path, cfg = _config(root, tree, shm)
    prep = t_waymo.WaymoDataset(TDict(cfg["DATA_CONFIG"]), CLASSES,
                                training=False, seed=0)
    prep.set_split("train")
    prep.include_waymo_data("train")
    prep.create_groundtruth_database(used_classes=CLASSES, split="train",
                                     sampled_interval=1)
    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_OUTPUT_ROOT", str(root / "output"))
    try:
        common = ["--cfg_file", str(cfg_path), "--batch_size", "2",
                  "--workers", "0", "--extra_tag", "ci", "--device", "cpu"]
        train = _tool("train_torch").main(common + ["--epochs", "1",
                                                    "--fix_random_seed"])
        evals = _tool("test_torch").main(common + ["--ckpt", "1"])
    finally:
        mp.undo()
    yield dict(root=root, tree=tree, shm=shm, cfg=cfg, train=train,
               evals=evals)


def test_train_and_test_on_a_waymo_tree_with_gt_sampling(run):
    hist = run["train"]["history"]
    assert len(hist) == 1 and all(math.isfinite(h["loss"]) for h in hist)
    metrics = run["evals"][1]
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    # the entry point reports the KITTI-style proxy, as JAX's does; the
    # official metrics come from result.pkl through the dataset
    assert "mAP" in metrics and not any("LEVEL" in k for k in metrics)
    out = run["train"]["output_dir"] / "eval" / "epoch_1" / "result.pkl"
    with open(out, "rb") as f:
        dets = pickle.load(f)
    assert len(dets) == 4
    with open(run["tree"] / DB_INFO, "rb") as f:
        db = pickle.load(f)
    assert set(db) == set(CLASSES)
    # the loader staged the train frames' processed points
    staged = sorted(p.name for p in run["shm"].rglob("*.npy"))
    assert {"seq_a_0000.npy", "seq_b_0000.npy"} <= set(staged)


@pytest.mark.parametrize("metric", ["waymo", "kitti"])
def test_result_pkl_metrics_equal_jax(run, metric, padded_jax_iou):
    """``evaluation`` of both packages on the entry point's result.pkl:
    ``eval_metric="waymo"`` on the prediction dicts, the default proxy on
    the frames as written (against the val infos' boxes)."""
    out = run["train"]["output_dir"] / "eval" / "epoch_1" / "result.pkl"
    with open(out, "rb") as f:
        dets = pickle.load(f)
    data = run["cfg"]["DATA_CONFIG"]
    td = t_waymo.WaymoDataset(TDict(data), CLASSES, training=False, seed=0)
    jd = j_waymo.WaymoDataset(JDict(copy.deepcopy(data)), CLASSES,
                              training=False)
    gt_annos = []
    for info in td.infos:
        a = info["annos"]
        keep = np.isin(a["name"], CLASSES)
        gt_annos.append({"boxes": a["gt_boxes_lidar"][keep],
                         "labels": np.array([CLASSES.index(n) + 1
                                             for n in a["name"][keep]])})
    kw = {"gt_annos": gt_annos}
    annos = dets
    if metric == "waymo":
        kw["eval_metric"] = "waymo"
        annos = t_waymo.WaymoDataset.generate_prediction_dicts(dets, CLASSES)
    got = td.evaluation(annos, CLASSES, **kw)
    want = jd.evaluation(copy.deepcopy(annos), CLASSES, **kw)
    assert got[0] == want[0]
    np.testing.assert_equal(got[1], want[1])
    if metric == "waymo":
        assert len(got[1]) == 12
        assert all(0.0 <= v <= 1.0 for v in got[1].values())
