"""Evaluation entry point of the PyTorch port (``mssvt_tpu_torch``), beside
``tools/test.py`` with the same flags: one checkpoint (``--ckpt STEP``,
default the newest) or ``--eval_all`` watch mode, which evaluates every
checkpoint of the directory as it appears and stops after
``--max_waiting_mins`` without a new one:

    python tools/test_torch.py --cfg_file tools/cfgs/waymo_models/mssvt.yaml \\
        [--device cuda|cpu] [--ckpt STEP] [--batch_size B] [--eval_all]

Checkpoints are read from ``--ckpt_dir`` or from the run's output tree,
``$MSSVT_OUTPUT_ROOT`` (default ``output/`` at the repo root) / EXP_GROUP /
TAG / extra_tag / ckpt, as ``tools/train_torch.py`` writes it; results go
to ``.../eval/epoch_<step>/result.pkl``. ``--device cuda`` (the default)
raises when there is no card; ``--device cpu`` runs on the CPU.
``main(argv)`` returns {step: metrics}.

Data parallel as ``tools/train_torch.py`` (``--launcher pytorch`` under
``torchrun``, ``--launcher slurm``, or ``--num_devices N``): each rank
evaluates its shard with ``batch_size // world`` frames a request, and rank
0 merges the parts and computes the metrics (the other ranks return {}).
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from mssvt_tpu_torch.config import log_config_to_file  # noqa: E402
from mssvt_tpu_torch.datasets.loader import build_dataloader  # noqa: E402
from mssvt_tpu_torch.parallel import dist  # noqa: E402
from mssvt_tpu_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
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
from mssvt_tpu_torch.utils.common import create_logger  # noqa: E402
from mssvt_tpu_torch.utils.device import resolve_device  # noqa: E402


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="mssvt_tpu_torch evaluation")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4,
                        help="> 0: one thread prefetches batches")
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint step to evaluate (default: latest)")
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true")
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    add_dist_args(parser)
    parser.add_argument("--save_to_file", action="store_true",
                        help="accepted as by tools/test.py; result.pkl is "
                             "always written")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    return args, load_run_config(args.cfg_file, args.set_cfgs)


def main(argv=None, launcher=None):
    """Evaluate; ``launcher`` overrides ``--launcher`` (see train_torch)."""
    args, cfg_ = parse_config(argv)
    launcher = launcher or args.launcher
    resolve_device(args.device)
    if wants_local_launch(args, launcher):
        return local_launch(__file__, argv, args)[0]
    rank, world, device = join_ranks(args, launcher)
    try:
        return evaluate(args, cfg_, rank, world, device)
    finally:
        dist.shutdown()


def evaluate(args, cfg_, rank, world, device):
    batch_size = per_rank_batch(
        args.batch_size or cfg_.OPTIMIZATION.BATCH_SIZE_PER_GPU, world)

    output_dir = output_dir_of(cfg_, args.extra_tag)
    eval_dir = output_dir / "eval"
    eval_dir.mkdir(parents=True, exist_ok=True)
    log_file = eval_dir / (
        "log_eval_%s.txt" % datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    logger = create_logger(log_file if rank == 0 else None, rank=rank)
    log_config_to_file(cfg_, logger=logger)

    dataset, loader = build_dataloader(
        dataset_cfg=cfg_.DATA_CONFIG, class_names=cfg_.CLASS_NAMES,
        batch_size=batch_size, training=False, workers=args.workers,
        logger=logger, rank=rank, world_size=world)
    model = build_model(cfg_, dataset, batch_size, device)

    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else output_dir / "ckpt"
    manager = CheckpointManager(ckpt_dir)

    def eval_ckpt(step):
        state = manager.restore(step, map_location=device)
        model.load_state_dict(state["model"])
        logger.info(f"*************** evaluating checkpoint step {step} "
                    "***************")
        metrics, _ = eval_one_epoch(
            model, loader, cfg_.CLASS_NAMES, logger=logger,
            result_dir=eval_dir / f"epoch_{step}",
            recall_thresh_list=recall_thresholds(cfg_), world_size=world)
        return metrics

    if not args.eval_all:
        step = int(args.ckpt) if args.ckpt else manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        return {step: eval_ckpt(step)}

    # watch mode (ref: test.py:86-132)
    results = {}
    evaluated = set()
    record = eval_dir / "eval_list_val.txt"
    if record.exists():
        evaluated = {int(x) for x in record.read_text().split()}
    wait_start = time.time()
    while True:
        todo = [s for s in manager.all_steps() if s not in evaluated]
        done = not todo and (time.time() - wait_start
                             > args.max_waiting_mins * 60)
        todo, done = dist.broadcast_object((todo, done))  # rank 0 decides
        if done:
            logger.info("max waiting time reached, exiting")
            break
        if not todo:
            time.sleep(30)
            continue
        wait_start = time.time()
        for step in todo:
            results[step] = eval_ckpt(step)
            evaluated.add(step)
            if rank == 0:
                with open(record, "a") as f:
                    f.write(f"{step}\n")
    return results


if __name__ == "__main__":
    main()
