"""The port's Lyft and PandaSet datasets against the JAX package's, on the
CPU (the SDK-free paths: cuboid conversion, sweep aggregation with its
time-lag channel, the Lyft mAP protocol), and ``build_dataset`` on every
file-backed name."""

import copy
import pickle

import numpy as np
import pytest

import test_lyft_pandaset as jax_cases
from mssvt_tpu.datasets import lyft as j_lyft
from mssvt_tpu.datasets import pandaset as j_pandaset
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.datasets import build_dataset
from mssvt_tpu_torch.datasets import lyft as t_lyft
from mssvt_tpu_torch.datasets import pandaset as t_pandaset
from mssvt_tpu_torch.datasets.synthetic_files import (
    write_kitti_tree,
    write_waymo_tree,
)
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_torch_kitti import _same
from test_torch_kitti import dataset_cfg as kitti_cfg
from test_torch_pipeline import _equal
from test_torch_waymo import dataset_cfg as waymo_cfg


def test_pandaset_cuboid_conversion_matches_jax(monkeypatch):
    """Seeded cuboid frames (mapped and unmapped labels) give JAX's boxes
    and names; JAX's own case runs on the port's class. Skips without
    pandas, as JAX's case does."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    labels = ["Car", "Pickup Truck", "Semi-truck", "Pedestrian",
              "Pedestrian with Object", "Bicycle", "Motorcycle", "Animal",
              "Cones"]
    rows = [{"label": labels[int(rng.integers(0, len(labels)))],
             **{f"position.{a}": rng.uniform(-40, 40) for a in "xyz"},
             **{f"dimensions.{a}": rng.uniform(0.5, 5) for a in "xyz"},
             "yaw": rng.uniform(-np.pi, np.pi)} for _ in range(40)]
    for frame in (pd.DataFrame(rows), pd.DataFrame([dict(rows[0],
                                                         label="Animal")])):
        got = t_pandaset.PandasetDataset.cuboids_to_boxes(frame)
        _equal(got, j_pandaset.PandasetDataset.cuboids_to_boxes(frame))
    assert len(t_pandaset.PandasetDataset.cuboids_to_boxes(
        pd.DataFrame(rows))[0]) > 10
    monkeypatch.setattr(j_pandaset, "PandasetDataset",
                        t_pandaset.PandasetDataset)
    jax_cases.test_pandaset_cuboid_conversion()


@pytest.mark.parametrize("seed", [0, 1])
def test_lyft_map_eval_matches_jax(seed):
    """The Lyft mAP on seeded frames (3 classes, GT boxes with noisy
    detections and strays, tied scores): equal to JAX's."""
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(4):
        g = int(rng.integers(0, 10))
        boxes = np.stack([rng.uniform(-30, 30, g), rng.uniform(-30, 30, g),
                          rng.uniform(-1, 1, g), rng.uniform(1, 5, g),
                          rng.uniform(0.6, 2, g), rng.uniform(1.4, 2, g),
                          rng.uniform(-np.pi, np.pi, g)], 1)
        labels = rng.integers(1, 4, g)
        noisy = boxes + rng.normal(0, 0.2, boxes.shape)
        extra = int(rng.integers(0, 3))
        dets.append({"boxes": np.concatenate([noisy, boxes[:extra] + 3.0]),
                     "scores": np.round(rng.uniform(0, 1, g + min(extra, g)), 1),
                     "labels": np.concatenate([labels, labels[:extra]])})
        gts.append({"boxes": boxes, "labels": labels})
    classes = ["car", "pedestrian", "bicycle"]
    want = j_lyft.LyftDataset.lyft_map_eval(copy.deepcopy(dets),
                                            copy.deepcopy(gts), classes)
    got = t_lyft.LyftDataset.lyft_map_eval(dets, gts, classes)
    _same(got, want)
    assert 0 < got["mAP"] < 1


def test_lyft_jax_cases_on_the_port(tmp_path, monkeypatch):
    """``test_lyft_map_eval_protocol`` and ``test_lyft_sweep_aggregation``
    of ``tests/test_lyft_pandaset.py`` on the port's class; the port's
    sweeps and item equal to JAX's on the same files."""
    monkeypatch.setattr(j_lyft, "LyftDataset", t_lyft.LyftDataset)
    monkeypatch.setattr("mssvt_tpu.utils.edict.EasyDict", TDict)
    jax_cases.test_lyft_map_eval_protocol()
    jax_cases.test_lyft_sweep_aggregation(tmp_path)
    monkeypatch.undo()
    with open(tmp_path / "infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    cfg = {
        "DATASET": "LyftDataset", "DATA_PATH": str(tmp_path),
        "INFO_PATH": {"test": ["infos_val.pkl"]}, "MAX_SWEEPS": 2,
        "POINT_CLOUD_RANGE": [-10, -10, -3, 10, 10, 3],
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": ["x", "y", "z", "intensity", "timestamp"],
            "src_feature_list": ["x", "y", "z", "intensity", "timestamp"]},
        "DATA_PROCESSOR": [
            {"NAME": "mask_points_and_boxes_outside_range",
             "REMOVE_OUTSIDE_BOXES": True},
            {"NAME": "transform_points_to_voxels",
             "VOXEL_SIZE": [0.5, 0.5, 0.5], "MAX_POINTS_PER_VOXEL": 5,
             "MAX_NUMBER_OF_VOXELS": {"train": 100, "test": 100}}]}
    jd = j_lyft.LyftDataset(JDict(cfg), ["car"], training=False,
                            root_path=tmp_path)
    td = t_lyft.LyftDataset(TDict(cfg), ["car"], training=False,
                            root_path=tmp_path, seed=0)
    _equal(td.get_lidar_with_sweeps(infos[0]),
           jd.get_lidar_with_sweeps(infos[0]))
    _equal(td[0], jd[0])


def test_build_dataset_builds_every_file_backed_name(tmp_path):
    """Waymo and KITTI from their shipped dataset configs on seeded trees,
    Lyft from an info pickle, PandaSet from its sequence list (its SDK is
    needed only to read a frame); an unknown name raises KeyError."""
    write_waymo_tree(tmp_path / "waymo", {"val": ["seq_v"]}, 3, 2000)
    write_kitti_tree(tmp_path / "kitti", ["000000"], ["000001"], 2000)
    (tmp_path / "lyft").mkdir()
    with open(tmp_path / "lyft" / "infos_val.pkl", "wb") as f:
        pickle.dump([{"lidar_path": "x.bin"}] * 2, f)
    base = {k: v for k, v in kitti_cfg(tmp_path).items()
            if k in ("POINT_CLOUD_RANGE", "POINT_FEATURE_ENCODING",
                     "DATA_PROCESSOR")}
    cfgs = {
        "WaymoDataset": (waymo_cfg(tmp_path / "waymo"), 3),
        "KittiDataset": (kitti_cfg(tmp_path / "kitti"), 1),
        "LyftDataset": (dict(base, DATASET="LyftDataset",
                             DATA_PATH=str(tmp_path / "lyft"),
                             INFO_PATH={"test": ["infos_val.pkl"]}), 2),
        "PandasetDataset": (dict(base, DATASET="PandasetDataset",
                                 DATA_PATH=str(tmp_path / "pandaset"),
                                 DATA_SPLIT={"train": "train", "test": "val"},
                                 SEQUENCES={"val": ["001", "002"]}), 160),
    }
    for name, (cfg, n) in cfgs.items():
        ds = build_dataset(TDict(cfg), ["Car"], training=False, seed=0)
        assert type(ds).__name__ == name and len(ds) == n, name
    with pytest.raises(KeyError, match="NuScenesDataset"):
        build_dataset(TDict(dict(base, DATASET="NuScenesDataset")), ["Car"],
                      training=False)
