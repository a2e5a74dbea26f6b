"""What ``tools/train_torch.py`` and ``tools/test_torch.py`` share: the
config of a run (YAML, TAG, EXP_GROUP_PATH, ``--set`` overrides), its
output tree, the data-parallel flags and launch, the model of a dataset and
the recall thresholds."""

from __future__ import annotations

import functools
import os
from pathlib import Path

import torch

from ..config import cfg, cfg_from_list, cfg_from_yaml_file
from ..models import build_network
from ..parallel import dist
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


def add_dist_args(parser):
    """``--launcher`` (pcdet's names: ``none``, ``pytorch`` under
    ``torchrun``, ``slurm``), ``--num_devices`` and ``--tcp_port``."""
    parser.add_argument("--launcher", choices=list(dist.LAUNCHERS),
                        default="none")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="--launcher none: start this many local ranks "
                             "(one card each, or CPU processes with --device "
                             "cpu); else the expected world size")
    parser.add_argument("--tcp_port", type=int, default=18888,
                        help="--launcher slurm: the rendezvous port")


def wants_local_launch(args, launcher=None) -> bool:
    """``--num_devices N > 1`` under ``--launcher none``: the entry point
    starts N ranks of itself (``local_launch``)."""
    return (launcher or args.launcher) == "none" and (args.num_devices or 1) > 1


def local_launch(script, argv, args):
    """Run ``script``'s ``main(argv, launcher="pytorch")`` in
    ``args.num_devices`` local processes joined by a file rendezvous (one
    card each with ``--device cuda``); returns the ranks' results in rank
    order."""
    n = args.num_devices
    if args.device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"--num_devices {n}: {torch.cuda.device_count()} "
                           "card(s) visible; NCCL runs one rank a card")
    return dist.launch_local(
        functools.partial(dist.run_script, str(script), "main", argv,
                          "pytorch"), n)


def join_ranks(args, launcher):
    """``init_distributed`` for the entry point's flags; checks
    ``--num_devices`` against the world size. Returns (rank, world,
    device)."""
    rank, world = dist.init_distributed(launcher, args.device,
                                        tcp_port=args.tcp_port)
    if launcher != "none" and args.num_devices and args.num_devices != world:
        raise ValueError(f"--num_devices {args.num_devices}, but the launcher "
                         f"started {world} ranks")
    return rank, world, dist.local_device(args.device)


def per_rank_batch(batch_size, world):
    """The global ``batch_size`` split over the ranks, as the JAX entry
    points split it over their devices (ref: train.py:71-75)."""
    if batch_size % world:
        raise ValueError(f"batch size {batch_size} is not divisible by "
                         f"{world} ranks")
    return batch_size // world


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
