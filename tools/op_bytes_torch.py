"""Bytes one request (or one training step) of the port moves, by
mechanism: the counterpart of ``tools/hlo_bytes.py``.

    python tools/op_bytes_torch.py [--train] [--n 30] [--group]
        [--log FILE] [--tiny] [--device cuda|cpu] [--batch 4]

Runs ``bench_torch.py``'s model and scene (``mssvt.yaml`` at full width,
bf16, batch 4; ``--tiny`` for ``mssvt_tiny.yaml``), answers one request
(with ``--train`` takes one ``train_step`` with ``adam_onecycle``: forward,
backward and optimizer) to warm up, then counts the next one under
``kernels/work.py``'s ``counting()`` with the MsSVT block's four function
mechanisms scoped (``runtime/mechanisms.py``). Each aten op is charged its
results plus its distinct operands on the device, as ``hlo_bytes``
charges each top-level HLO instruction, with the eager rules of
``work.py`` (views free, gathers and scatters what their indices touch);
each kernel is charged its formula's bytes, the same whether the kernel
or its plain version ran.

Prints ``total materialized bytes (per request|step): X GB``, then the top
``--n`` mechanism keys with their GB and charge count. A key is the
innermost module's path (``CenterPoint/backbone_3d/blocks_0/ms_attn``),
then a scoped function's name; ``[bwd]`` marks the backward, and a
kernel's row ends in ``[name]``. ``--group`` cuts a key's path to its first
three parts. ``--log FILE`` reads a log that ``tools/dump_ops_torch.py``
wrote instead of running the model.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="count a training step, not a request")
    ap.add_argument("--n", type=int, default=30, help="keys to print")
    ap.add_argument("--group", action="store_true",
                    help="cut each key to its first three path parts")
    ap.add_argument("--log", default=None, metavar="FILE",
                    help="read a dump_ops_torch.py log instead of running")
    ap.add_argument("--tiny", action="store_true",
                    help="mssvt_tiny.yaml (CPU rehearsals)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    return ap.parse_args(argv)


def build(tiny=False, device="cuda", batch=4, train=False):
    """(cfg, model, scene, batch, device): ``bench_torch.py``'s model and
    its first scene (with GT boxes for training)."""
    import bench_torch

    args = bench_torch.parse_args(
        ["--batch", str(batch), "--device", device]
        + (["--tiny"] if tiny else []))
    cfg, model, (grid, max_voxels), batch, dev = bench_torch.setup(args)
    scenes, _ = bench_torch.make_scenes(grid, max_voxels, batch, dev,
                                        with_gt=train, n_scenes=1)
    return cfg, model, scenes[0], batch, dev


def count(built, train=False, log=False):
    """One warm-up request (or step), then the tally of the next one."""
    import torch

    from mssvt_tpu_torch.kernels import work
    from mssvt_tpu_torch.runtime import mechanisms

    cfg, model, scene, _, device = built
    if train:
        from mssvt_tpu_torch.runtime.optimization import build_optimizer
        from mssvt_tpu_torch.runtime.train_utils import train_step

        optimizer, _ = build_optimizer(
            cfg.OPTIMIZATION, model.named_parameters(), total_steps=1000,
            steps_per_epoch=100)
        gen = torch.Generator(device=device).manual_seed(0)

        def run():
            train_step(model, optimizer, scene, gen)
    else:
        def run():
            model.eval()
            with torch.no_grad():
                model(scene)
    run()
    with mechanisms.function_scopes(), \
            work.counting(device, log=log) as tally:
        if train:  # the optimizer's charges under Global/optimizer
            optimizer.step = work.scoped("optimizer", optimizer.step)
        try:
            run()
        finally:
            if train:
                del optimizer.step
    return tally


def report(groups, ops, total, what, n=30, group=False):
    """Prints the total and the top ``n`` keys (``hlo_bytes``' lines)."""
    from mssvt_tpu_torch.kernels import work

    if group:
        nbytes, counts = collections.Counter(), collections.Counter()
        for key, b in groups.items():
            nbytes[work.group_key(key)] += b
            counts[work.group_key(key)] += ops[key]
        groups, ops = nbytes, counts
    print(f"total materialized bytes (per {what}): {total / 1e9:.2f} GB")
    for key, b in groups.most_common(n):
        print(f"{b / 1e9:8.3f} GB  x{ops[key]:<4d} {key}")


def read_log(path):
    """(bytes by key, charges by key, total, "request" or "step") of a
    ``dump_ops_torch.py`` log."""
    groups, ops, total, what = (collections.Counter(),
                                collections.Counter(), 0, "request")
    with open(path) as f:
        for line in f:
            if line.startswith("# per "):
                what = line.split()[2]
            if line.startswith("#") or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            nbytes, key = int(fields[4]), fields[5]
            groups[key] += nbytes
            ops[key] += 1
            total += nbytes
    return groups, ops, total, what


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.log is not None:
        groups, ops, total, what = read_log(args.log)
    else:
        tally = count(build(args.tiny, args.device, args.batch, args.train),
                      args.train)
        groups, ops, total = tally.groups, tally.group_ops, \
            tally.total_bytes()
        what = "step" if args.train else "request"
        print(f"# {total / args.batch / 1e9:.3f} GB a frame at batch "
              f"{args.batch}: kernels "
              f"{sum(tally.kernel_bytes.values()) / 1e9:.3f} GB "
              f"({dict(tally.kernel_bytes)} bytes), aten "
              f"{tally.aten_bytes() / 1e9:.3f} GB, backward "
              f"{tally.backward_bytes / 1e9:.3f} GB", file=sys.stderr)
    report(groups, ops, total, what, args.n, args.group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
