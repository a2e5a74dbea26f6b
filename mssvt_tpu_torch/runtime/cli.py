"""What ``tools/train_torch.py`` and ``tools/test_torch.py`` share: the
config of a run (YAML, TAG, EXP_GROUP_PATH, ``--set`` overrides), its
output tree, the one-device rule, the model of a dataset and the recall
thresholds."""

from __future__ import annotations

import os
from pathlib import Path

from ..config import cfg, cfg_from_list, cfg_from_yaml_file
from ..models import build_network
from ..utils.edict import EasyDict


def load_run_config(cfg_file, set_cfgs=None):
    """A fresh config (the global ``cfg``'s ROOT_DIR and LOCAL_RANK, the
    YAML file, TAG and EXP_GROUP_PATH from its path, then ``--set``)."""
    cfg_ = EasyDict(ROOT_DIR=cfg.ROOT_DIR, LOCAL_RANK=cfg.LOCAL_RANK)
    cfg_from_yaml_file(cfg_file, cfg_)
    cfg_.TAG = Path(cfg_file).stem
    cfg_.EXP_GROUP_PATH = "/".join(Path(cfg_file).parts[-3:-1])
    if set_cfgs is not None:
        cfg_from_list(set_cfgs, cfg_)
    return cfg_


def output_dir_of(cfg_, extra_tag) -> Path:
    """``$MSSVT_OUTPUT_ROOT`` (default ``output/`` at the repo root) /
    EXP_GROUP / TAG / extra_tag."""
    out_root = Path(os.environ.get("MSSVT_OUTPUT_ROOT",
                                   cfg_.ROOT_DIR / "output"))
    return out_root / cfg_.EXP_GROUP_PATH / cfg_.TAG / extra_tag


def refuse_multi_device(launcher, num_devices):
    if launcher != "none" or (num_devices or 1) > 1:
        raise NotImplementedError(
            f"--launcher {launcher} / --num_devices {num_devices}: "
            "the port runs one process on one device; data parallelism is "
            "ROADMAP.md Queue 1 item 10")


def build_model(cfg_, dataset, batch_size, device):
    """The detector of ``cfg_.MODEL`` for ``dataset``'s grid and point
    features at ``batch_size``, on ``device``."""
    return build_network(
        model_cfg=cfg_.MODEL, num_class=len(cfg_.CLASS_NAMES),
        class_names=cfg_.CLASS_NAMES, grid_size=dataset.grid_size,
        voxel_size=dataset.voxel_size,
        point_cloud_range=dataset.point_cloud_range,
        batch_size=batch_size, max_voxels=dataset.max_voxels,
        max_points_per_voxel=dataset.max_points_per_voxel,
        num_point_features=dataset.point_feature_encoder.num_point_features,
        device=device)


def recall_thresholds(cfg_):
    return tuple(cfg_.MODEL.get("POST_PROCESSING", {}).get(
        "RECALL_THRESH_LIST", [0.3, 0.5, 0.7]))
