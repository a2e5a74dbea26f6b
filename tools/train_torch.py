"""Training entry point of the PyTorch port (``mssvt_tpu_torch``), beside
``tools/train.py`` with the same CLI surface (cfg_file, batch_size, epochs,
workers, extra_tag, ckpt, fix_random_seed, --set overrides) and the same
output tree, ``$MSSVT_OUTPUT_ROOT`` (default ``output/`` at the repo root)
/ EXP_GROUP / TAG / extra_tag / {ckpt, eval}:

    python tools/train_torch.py --cfg_file tools/cfgs/waymo_models/mssvt.yaml \\
        [--device cuda|cpu] [--epochs N] [--batch_size B] [--eval_after_train]

It runs on the card (``--device cuda``, the default, raises when there is
none); ``--device cpu`` runs the kernels' plain versions on the CPU. A run
resumes from the newest checkpoint of its ``ckpt`` directory. ``--ckpt
FILE`` starts a fresh run from a checkpoint's weights, shape-tolerant
(``partial_load_params``). ``main(argv)`` returns what the run did
(directories, start epoch and iteration, per-step records, eval metrics).

Data parallel (DDP with SyncBN; ``--batch_size`` is the global batch, each
rank takes ``batch_size // world`` from its shard of the loader):

    torchrun --nproc_per_node 8 tools/train_torch.py --launcher pytorch ...
    srun -n 8 python tools/train_torch.py --launcher slurm ...
    python tools/train_torch.py --num_devices 2 [--device cpu] ...

The last starts the ranks itself (``--launcher none``); on the CPU they
talk over gloo, on cards over NCCL, one card a rank.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import torch  # noqa: E402

from mssvt_tpu_torch.config import log_config_to_file  # noqa: E402
from mssvt_tpu_torch.datasets.loader import build_dataloader  # noqa: E402
from mssvt_tpu_torch.parallel import dist  # noqa: E402
from mssvt_tpu_torch.runtime.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_training_state,
    partial_load_params,
)
from mssvt_tpu_torch.runtime.cli import (  # noqa: E402
    add_dist_args,
    build_model,
    join_ranks,
    load_run_config,
    local_launch,
    output_dir_of,
    per_rank_batch,
    recall_thresholds,
    wants_local_launch,
)
from mssvt_tpu_torch.runtime.eval_utils import eval_one_epoch  # noqa: E402
from mssvt_tpu_torch.runtime.optimization import build_optimizer  # noqa: E402
from mssvt_tpu_torch.runtime.train_utils import (  # noqa: E402
    set_deterministic,
    train_model,
)
from mssvt_tpu_torch.utils.common import create_logger, set_random_seed  # noqa: E402
from mssvt_tpu_torch.utils.device import resolve_device  # noqa: E402

FIXED_SEED = 666  # --fix_random_seed, as tools/train.py


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="mssvt_tpu_torch training")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4,
                        help="> 0: one thread prefetches batches")
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint file whose weights start a fresh run")
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    add_dist_args(parser)
    parser.add_argument("--eval_after_train", action="store_true")
    parser.add_argument("--merge_all_iters_to_one_epoch", action="store_true",
                        help="fold all epochs into one continuous pass")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return args, load_run_config(args.cfg_file, args.set_cfgs)



def main(argv=None, launcher=None):
    """One run; ``launcher`` overrides ``--launcher`` (the ranks that
    ``--num_devices`` starts under ``--launcher none`` run as ``pytorch``)."""
    args, cfg_ = parse_config(argv)
    launcher = launcher or args.launcher
    resolve_device(args.device)
    if wants_local_launch(args, launcher):
        results = local_launch(__file__, argv, args)
        return {**results[0], "ranks": results}
    rank, world, device = join_ranks(args, launcher)
    try:
        return train(args, cfg_, rank, world, device)
    finally:
        dist.shutdown()


def train(args, cfg_, rank, world, device):
    set_deterministic()
    data_seed = None
    if args.fix_random_seed:
        set_random_seed(FIXED_SEED)
        data_seed = FIXED_SEED + rank  # each rank its own augmentations

    batch_size = per_rank_batch(
        args.batch_size or cfg_.OPTIMIZATION.BATCH_SIZE_PER_GPU, world)
    epochs = args.epochs or cfg_.OPTIMIZATION.NUM_EPOCHS

    output_dir = output_dir_of(cfg_, args.extra_tag)
    ckpt_dir = output_dir / "ckpt"
    output_dir.mkdir(parents=True, exist_ok=True)
    log_file = output_dir / (
        "log_train_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    logger = create_logger(log_file if rank == 0 else None, rank=rank)
    logger.info("**********************Start logging**********************")
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else "")
                + f"; {world} rank(s), batch {batch_size} a rank")
    log_config_to_file(cfg_, logger=logger)

    dataset, train_loader = build_dataloader(
        dataset_cfg=cfg_.DATA_CONFIG, class_names=cfg_.CLASS_NAMES,
        batch_size=batch_size, training=True, workers=args.workers,
        logger=logger, data_seed=data_seed, rank=rank, world_size=world)
    model = build_model(cfg_, dataset, batch_size, device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model parameters: {n_params / 1e6:.2f} M")

    if args.merge_all_iters_to_one_epoch:
        train_loader.merge_all_iters_to_one_epoch(merge=True, epochs=epochs)
        epochs = 1  # the merged stream is the whole schedule

    steps_per_epoch = len(train_loader)
    total_steps = steps_per_epoch * epochs
    optimizer, lr_fn = build_optimizer(
        cfg_.OPTIMIZATION, model.named_parameters(), total_steps,
        steps_per_epoch)

    ckpt_manager = CheckpointManager(ckpt_dir, max_keep=args.max_ckpt_save_num)
    start_epoch, start_iter = 0, 0
    latest = ckpt_manager.latest_step()
    if latest is not None:  # auto-resume on every rank (ref: train.py:130-140)
        start_epoch, start_iter = load_training_state(
            model, optimizer, ckpt_manager.restore(latest,
                                                   map_location=device))
        logger.info(f"auto-resumed from epoch {start_epoch} "
                    f"(iteration {start_iter})")
    elif args.ckpt is not None:
        state = torch.load(args.ckpt, map_location=device, weights_only=False)
        model.load_state_dict(partial_load_params(
            state["model"], model.state_dict(), logger))
    dist.barrier()  # every rank has read the checkpoint before rank 0 writes
    if dist.initialized():
        model = dist.wrap_ddp(model)

    # DropPath and dropout masks: one generator a rank
    generator = torch.Generator(device=device).manual_seed(rank)
    history = []
    logger.info("**********************Start training**********************")
    it = train_model(
        model, optimizer, train_loader, total_epochs=epochs,
        ckpt_manager=ckpt_manager, ckpt_save_interval=args.ckpt_save_interval,
        start_epoch=start_epoch, start_iter=start_iter, generator=generator,
        lr_fn=lr_fn, logger=logger, history=history)
    logger.info("**********************End training**********************")
    model = dist.unwrap(model)
    result = {"output_dir": output_dir, "ckpt_dir": ckpt_dir,
              "start_epoch": start_epoch, "start_iter": start_iter,
              "iterations": it, "history": history, "rank": rank,
              "world_size": world,
              "loader_make_seconds": list(train_loader.make_seconds),
              "metrics": None}
    dist.barrier()  # rank 0's last checkpoint is written

    if args.eval_after_train:
        _, test_loader = build_dataloader(
            dataset_cfg=cfg_.DATA_CONFIG, class_names=cfg_.CLASS_NAMES,
            batch_size=batch_size, training=False, workers=args.workers,
            logger=logger, data_seed=data_seed, rank=rank, world_size=world)
        result["metrics"], _ = eval_one_epoch(
            model, test_loader, cfg_.CLASS_NAMES, logger=logger,
            result_dir=output_dir / "eval",
            recall_thresh_list=recall_thresholds(cfg_), world_size=world)
    return result


if __name__ == "__main__":
    main()
