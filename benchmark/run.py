"""The benchmark of the port (``mssvt_tpu_torch``): one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic
mix, loop, reference and per-layer readers, each found by name under
``benchmark/``), sets up, measures for ``--seconds``, checks the outputs
against the plain reference and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit (also the last lines on standard error).

Needs the card: without CUDA, or with fewer cards than the cell asks
for, it exits 2 and prints no result. ``--rehearse-cpu`` runs the same
path on the CPU at the tiny size of ``benchmark/rehearsal/<config>.json``
(the kernels' plain versions); it is never a cell and its numbers are no
device numbers. ``--control`` puts the reference, computed one precision
below the configuration's, in the program's place (the control of the
correctness check; no run of the benchmark sets it).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="CPU rehearsal at the tiny size (never a cell)")
    ap.add_argument("--control", action="store_true",
                    help="the reference one precision below, in the "
                         "program's place")
    return ap.parse_args(argv)


def environment():
    """Fixed cache directories inside the checkout; no JAX through
    libraries that would load it by themselves; one host thread for the
    CPU's thread pools (the loop's host work is launches and syncs, and
    idle pools spinning on a shared host only add noise)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    environment()
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import isolation, spec

    cell = spec.load_cell(args.workload)
    chips = int(cell.entry.get("chips", 1))
    if args.rehearse_cpu:
        device = torch.device("cpu")
        config = spec.load_json(spec.BENCH / "rehearsal" /
                                f"{cell.entry['config']}.json")
        cell.traffic = dict(cell.traffic, **config.get("traffic", {}))
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            log(f"{args.workload}: needs {chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
        config = cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    control = None
    if args.control:
        from benchmark.harness import precision

        control = lambda: precision.below(config["precision"])  # noqa: E731
    seed = args.seed % 2**63
    ctx = SimpleNamespace(cell=cell, config=config, seed=seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=device, t0=T0, control=control)
    out = cell.loop().run(ctx)

    found = isolation.forbidden_loaded()
    if found:
        log(f"{args.workload}: modules of {', '.join(found)} are loaded")
        return 3

    limits = cell.own["limits"]
    numbers = out["numbers"]
    correct = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                  for k in limits)
    if args.trace:
        rec = SimpleNamespace(**out["trace"])
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        from benchmark.harness import trace

        t = out["trace"]
        win = trace.window(t["events"], "bench.request")
        dev["busy_s"] = trace.busy(t["events"], win) / 1e6
        dev["window_s"] = (win[1] - win[0]) / 1e6
        result["breakdown"] = {
            "device_ops": trace.top_families(t["events"], win),
            "idle_gaps": trace.idle_gaps(t["events"], win)}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    log(f"# {args.workload} seed {args.seed}: {out['attempted']} requests "
        f"in {out['window_s']:.3f} s, live voxels a frame "
        f"{min(out['live_voxels'])}-{max(out['live_voxels'])}"
        f"{' (control)' if args.control else ''}")
    rs = sorted(out["request_s"])
    log("# request s: min {:.4f}, p10 {:.4f}, median {:.4f}, p90 {:.4f}, "
        "max {:.4f}".format(rs[0], rs[len(rs) // 10], rs[len(rs) // 2],
                            rs[len(rs) * 9 // 10], rs[-1]))
    log("# set-up and check phases (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["phases"].items()))
    for k in limits:
        log(f"check {k} = {numbers[k]!r} (limit {limits[k]!r})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
