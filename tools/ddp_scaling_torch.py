"""Data-parallel scaling of the port (``mssvt_tpu_torch``) on the cards of
one host: ``tools/train_torch.py`` and then ``tools/test_torch.py`` under
``torchrun --standalone`` (``--launcher pytorch``, NCCL, one rank a card, a
free rendezvous port) at world ``--cards`` and at world 1, each rank with
the same frames and batch:

    python tools/ddp_scaling_torch.py --cfg_file CFG --cards 4 \\
        [--batch_per_rank 4] [--steps 20]

``CFG`` needs a dataset that makes its frames (``SyntheticDataset``;
``DATA_CONFIG.NUM_FRAMES`` is set so that one epoch is ``WARMUP`` +
``--steps`` steps a rank). Outputs go under ``$MSSVT_OUTPUT_ROOT`` (default
``output/``), extra tag ``ddp_w<world>``, emptied first. Prints one JSON
line a run (train: each step's synchronised seconds, the loader's wait,
the losses, the host clock at each step's end; eval: the metrics, whose
``sec_per_example`` is the slowest rank's forward time over all ranks'
frames) and a summary line: frames a second over the ``--steps`` steps
after the ``WARMUP`` ones, as all their frames over the wall time from the
end of the last warm-up step to the end of the last step (the first step
includes the kernels' build in the first run, one ``nvcc`` run shared by
the ranks through the build lock), and the ratio at world ``--cards`` to
world 1. Run with ``--rank_body train|test`` it is the rank process that
``torchrun`` starts.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
WARMUP = 2  # steps before the measured window


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO_ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rank_body(args):
    """One rank of a torchrun run: the entry point's main for one epoch;
    rank 0 prints what it did as one JSON line."""
    world = int(os.environ["WORLD_SIZE"])
    common = ["--cfg_file", args.cfg_file, "--workers", "1",
              "--batch_size", str(args.batch_per_rank * world),
              "--extra_tag", f"ddp_w{world}", "--launcher", "pytorch",
              "--device", args.device]
    frames = ["--set", "DATA_CONFIG.NUM_FRAMES",  # --set comes last
              str(args.batch_per_rank * (WARMUP + args.steps) * world)]
    t0 = time.time()
    if args.rank_body == "train":
        run = _tool("train_torch").main(
            common + ["--fix_random_seed", "--epochs", "1"] + frames)
        out = {key: [h[name] for h in run["history"]] for key, name in
               (("steps", "step_s"), ("data_s", "data_s"),
                ("losses", "loss"), ("t", "t"))}
    else:
        out = {"metrics": _tool("test_torch").main(
            common + ["--ckpt", "1"] + frames)[1]}
    if int(os.environ["RANK"]) == 0:
        print(json.dumps({"mode": args.rank_body, "world": world,
                          "seconds": time.time() - t0, **out}), flush=True)


def _torchrun(world, mode, args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), __file__, "--rank_body", mode,
           "--cfg_file", args.cfg_file,
           "--batch_per_rank", str(args.batch_per_rank),
           "--steps", str(args.steps), "--device", args.device]
    res = subprocess.run(cmd, cwd=str(REPO_ROOT), capture_output=True,
                         text=True)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if res.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"{' '.join(cmd)} exited {res.returncode}:\n"
                           f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    print(lines[0], flush=True)
    return json.loads(lines[0])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--cards", type=int, default=4)
    parser.add_argument("--batch_per_rank", type=int, default=4)
    parser.add_argument("--steps", type=int, default=20,
                        help="measured steps after the warm-up")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cpu: gloo ranks on the CPU (a rehearsal)")
    parser.add_argument("--rank_body", choices=["train", "test"],
                        default=None)
    args = parser.parse_args(argv)
    if args.rank_body:
        return rank_body(args)
    out_root = Path(os.environ.get("MSSVT_OUTPUT_ROOT",
                                   REPO_ROOT / "output"))
    summary = {}
    for world in (args.cards, 1):
        for d in out_root.rglob(f"ddp_w{world}"):
            shutil.rmtree(d)
        train = _torchrun(world, "train", args)
        test = _torchrun(world, "test", args)
        if len(train["steps"]) != WARMUP + args.steps:
            raise RuntimeError(f"world {world} took {len(train['steps'])} "
                               f"steps, not {WARMUP + args.steps}")
        wall = train["t"][-1] - train["t"][WARMUP - 1]
        summary[world] = {
            "warmup_step_s": train["steps"][:WARMUP],
            "window_s": wall,
            "median_step_s": statistics.median(train["steps"][WARMUP:]),
            "frames_per_s": world * args.batch_per_rank * args.steps / wall,
            "eval_sec_per_example": test["metrics"]["sec_per_example"]}
    print(json.dumps({"summary": summary,
                      "speedup": summary[args.cards]["frames_per_s"]
                      / summary[1]["frames_per_s"]}), flush=True)
    return summary


if __name__ == "__main__":
    main()
