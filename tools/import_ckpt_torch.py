"""Import a reference (pcdet) PyTorch checkpoint into the port
(``mssvt_tpu_torch``), beside ``tools/import_ckpt.py`` for the JAX package.

The reference's ``checkpoint_state`` (``{epoch, it, model_state,
version}``, saved by ``torch.save``) goes through the name map and layout
rules of ``mssvt_tpu_torch/runtime/torch_import.py`` into a port checkpoint
(``checkpoint_<step>.pt`` with ``model``, as ``tools/train_torch.py``
writes it), shape-tolerant: tensors without a match keep the fresh
initialisation and are listed.

    python tools/import_ckpt_torch.py --cfg_file tools/cfgs/waymo_models/mssvt.yaml \\
        --ckpt checkpoint_epoch_30.pth --out output/imported_mssvt
    python tools/test_torch.py --cfg_file ... --ckpt_dir output/imported_mssvt --ckpt 30

The model is built on the CPU from the config alone (no dataset file is
read). ``main(argv)`` returns (checkpoint path, report).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mssvt_tpu_torch.models import build_network  # noqa: E402
from mssvt_tpu_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from mssvt_tpu_torch.runtime.cli import load_run_config  # noqa: E402
from mssvt_tpu_torch.runtime.torch_import import (  # noqa: E402
    bev_depth_of,
    convert_state_dict,
)


def derive_grid(data_cfg):
    """(grid, voxel size, range, points a voxel, voxels a frame) from the
    voxelize processor of ``data_cfg``."""
    pc_range = np.asarray(data_cfg.POINT_CLOUD_RANGE, np.float64)
    vox, max_pts, max_vox = None, 5, 90000
    for p in data_cfg.DATA_PROCESSOR:
        if p.NAME == "transform_points_to_voxels":
            vox = np.asarray(p.VOXEL_SIZE, np.float64)
            max_pts = int(p.get("MAX_POINTS_PER_VOXEL", 5))
            mnv = p.get("MAX_NUMBER_OF_VOXELS", 90000)
            max_vox = int(mnv["test"] if isinstance(mnv, dict) else mnv)
    if vox is None:
        raise ValueError("no transform_points_to_voxels processor in config")
    grid = np.round((pc_range[3:] - pc_range[:3]) / vox).astype(np.int64)
    return (tuple(int(g) for g in grid), tuple(vox), tuple(pc_range),
            max_pts, max_vox)


def main(argv=None):
    parser = argparse.ArgumentParser(description="pcdet -> port checkpoint")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True,
                        help="reference .pth checkpoint")
    parser.add_argument("--out", type=str, required=True,
                        help="output checkpoint directory")
    parser.add_argument("--step", type=int, default=0,
                        help="step to save under (default: the ref epoch)")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = load_run_config(args.cfg_file, args.set_cfgs)

    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    epoch = int(ckpt.get("epoch", 0) or 0)
    print(f"==> {len(ckpt['model_state'])} tensors in {args.ckpt} (epoch "
          f"{epoch}, version {ckpt.get('version')})")
    grid, vox, pc_range, max_pts, max_vox = derive_grid(cfg.DATA_CONFIG)
    n_feat = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    model = build_network(
        cfg.MODEL, num_class=len(cfg.CLASS_NAMES), class_names=cfg.CLASS_NAMES,
        grid_size=grid, voxel_size=vox, point_cloud_range=pc_range,
        batch_size=1, max_voxels=max_vox, max_points_per_voxel=max_pts,
        num_point_features=n_feat, device="cpu")
    state, report = convert_state_dict(ckpt["model_state"], model,
                                       bev_depth_of(cfg.MODEL, grid[2]))
    print(f"==> loaded {len(report['loaded'])} tensors; "
          f"{len(report['missing'])} kept their initialisation; "
          f"{len(report['shape_mismatch'])} shape mismatches; "
          f"{len(report['unused'])} reference tensors unused")
    for kind, tag in (("shape_mismatch", "SHAPE"), ("missing", "INIT "),
                      ("unused", "UNUSED")):
        for k in report[kind]:
            print(f"   {tag}: {k}")
    step = args.step or epoch
    manager = CheckpointManager(args.out)
    manager.save(step, {"model": state, "optimizer": {}, "epoch": epoch,
                        "it": int(ckpt.get("it", 0) or 0)})
    path = Path(args.out).resolve() / f"checkpoint_{step}.pt"
    print(f"==> saved {path}")
    return path, report


if __name__ == "__main__":
    main()
