#!/usr/bin/env python3
"""End-to-end bench of the PyTorch + CUDA port (``mssvt_tpu_torch``) on the
flagship MsSVT model, on one card: ``bench.py``'s protocol without JAX.

    python3 bench_torch.py [--batch1 | --batch N] [--fp32] [--sync]
                           [--no-train | --train] [--profile [DIR]]
                           [--tiny] [--device cuda|cpu]

Prints ONE JSON line on stdout (``#`` lines on stderr):
``{"metric": "e2e_inference_fps_single_chip", "value", "unit", "mfu",
"sync_ms_per_frame", "sync_ms_per_frame_median", "train_ms_per_step",
"train_ms_per_frame", "train_compile_s", "device"}``; with ``--train``
``{"metric": "train_step_ms_single_chip_batch<B>", "value", "unit",
"train_ms_per_step", "train_ms_per_frame", "train_compile_s", "device"}``.

Scene: ``tools/cfgs/waymo_models/mssvt.yaml`` CenterPoint (MeanVFE, the
5-block MsSVT backbone, HeightCompression, BaseBEVBackbone, CenterHead
decode and rotated NMS) at full width with the config's bf16 policy
(``--fp32`` drops ``MODEL.DTYPE``), grid 480 x 480 x 32 of (0.32, 0.32,
0.1875) m voxels over +-76.8 m, 90 000 voxel rows a frame; weights from
seed 0 (``build_network``'s ``torch.Generator``). Four distinct scenes of
``datasets/synthetic_scene.make_waymo_scale_scene`` (seeds 0-3, ~80k
voxels a frame), with ``add_synth_gt``'s boxes for training. ``--tiny``
runs the same protocol on ``tools/cfgs/synthetic_models/mssvt_tiny.yaml``
(its grid and voxel capacity; for ``--device cpu`` rehearsals).

Protocol (``bench.py``'s): batch 4 (``--batch1``, ``--batch N``); the
first request builds the kernels (its seconds are reported as bench.py
reports compile), then every scene is answered once; 20 requests, each
followed by a host readback of ``final_scores`` (the sync figure: mean and
median ms a frame); 40 requests ``MSSVT_BENCH_DEPTH`` (default 2) in
flight, each readback a non-blocking copy into a pinned host buffer with
an event, every result on the host inside the timed window (the pipelined
figure, the headline unless ``--sync``); outputs must differ across
scenes. Host syncs inside a request (the greedy NMS, ``ops/nms.py``) keep
the pipelined loop from overlapping much: both figures are reported.

``mfu``: the FLOPs of one request (``kernels/work.py``'s counting: the
kernels' formulas plus ``FlopCounterMode``'s aten products, the same count
whether the kernels or their plain versions run) a frame, over the
pipelined (or sync) time a frame and the H100's dense bf16 peak, 989
TFLOP/s (67 TFLOP/s f32 under ``--fp32``); null off the card. FLOPs are
counted in an untimed request after the timed loops.

Training tail (on by default; ``--no-train`` or ``--batch1`` skip it,
``--train`` runs only it): the same model, inference state freed first;
``train_step`` with ``adam_onecycle`` from the yaml's ``OPTIMIZATION``: one
first step (``train_compile_s``), one step on each other scene, then 6
timed steps with a loss readback each. A failure there fails the run.

``--profile [DIR]`` (default ``output/bench_torch/profile``) writes
``torch.profiler`` chrome traces of 3 requests (``requests.json``) and 2
training steps (``train_steps.json``), taken after the timed loops (a
profiler session slows the host's later launches);
``tools/profile_top_ops_torch.py DIR`` reads them.

Not carried over from ``bench.py``: ``vs_baseline``, ``a100_sol_fps_bound``
and the A100 band (they rest on XLA's byte count and A100 peaks), and HBM
utilisation (no byte count exists for the aten side).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

GRID = (480, 480, 32)
VOXEL = (0.32, 0.32, 0.1875)
PCR = (-76.8, -76.8, -2.0, 76.8, 76.8, 4.0)
VOXELS_PER_FRAME = 90_000
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
FLAGSHIP = "tools/cfgs/waymo_models/mssvt.yaml"
TINY = "tools/cfgs/synthetic_models/mssvt_tiny.yaml"
SCENES = 4
SYNC_REQUESTS, PIPELINED_REQUESTS = 20, 40
TRAIN_STEPS = 6
PROFILE_REQUESTS, PROFILE_STEPS = 3, 2
DEFAULT_PROFILE = "output/bench_torch/profile"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch1", action="store_true",
                    help="batch 1 (the single-frame latency variant)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--fp32", action="store_true",
                    help="drop MODEL.DTYPE (f32 compute)")
    ap.add_argument("--sync", action="store_true",
                    help="report the sync figure (one request in flight)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--no-train", action="store_true")
    mode.add_argument("--train", action="store_true",
                      help="only the training tail")
    ap.add_argument("--profile", nargs="?", const=DEFAULT_PROFILE,
                    default=None, metavar="DIR")
    ap.add_argument("--tiny", action="store_true",
                    help="mssvt_tiny.yaml (CPU rehearsals)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def setup(args):
    """(cfg, model, (grid, voxel capacity), batch, device)."""
    from mssvt_tpu_torch.config import cfg_from_yaml_file
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.utils.device import resolve_device
    from mssvt_tpu_torch.utils.edict import EasyDict

    device = resolve_device(args.device)
    with contextlib.chdir(ROOT):  # _BASE_CONFIG_ paths are repo-relative
        cfg = cfg_from_yaml_file(TINY if args.tiny else FLAGSHIP, EasyDict())
    if args.fp32:
        cfg.MODEL.pop("DTYPE", None)
    batch = 1 if args.batch1 else (args.batch or 4)
    if args.tiny:
        dc = cfg.DATA_CONFIG
        pcr = tuple(dc.POINT_CLOUD_RANGE)
        proc = dc.DATA_PROCESSOR[-1]
        voxel = tuple(proc.VOXEL_SIZE)
        grid = tuple(int(round((pcr[i + 3] - pcr[i]) / voxel[i]))
                     for i in range(3))
        per_frame = int(proc.MAX_NUMBER_OF_VOXELS["test"])
    else:
        grid, voxel, pcr, per_frame = GRID, VOXEL, PCR, VOXELS_PER_FRAME
    max_voxels = per_frame * batch
    model = build_network(cfg.MODEL, len(CLASSES), CLASSES, grid, voxel, pcr,
                          batch, max_voxels, 5, num_point_features=5,
                          device=device, seed=0)
    return cfg, model, (grid, max_voxels), batch, device


def make_scenes(grid, max_voxels, batch, device, with_gt):
    """SCENES distinct scenes on ``device`` (seeds 0..SCENES-1)."""
    import torch

    from mssvt_tpu_torch.datasets.synthetic_scene import (
        add_synth_gt,
        make_waymo_scale_scene,
    )

    scenes, n = [], 0
    for seed in range(SCENES):
        scene, n = make_waymo_scale_scene(max_voxels, grid, seed=seed,
                                          batch=batch)
        if with_gt:
            add_synth_gt(scene, batch, seed=seed)
        scenes.append({k: torch.as_tensor(v).to(device)
                       for k, v in scene.items()})
    return scenes, n


def sync_device(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_inference(args, model, scenes, batch, device):
    """The inference protocol; returns (JSON fields, per-frame seconds)."""
    import torch

    def request(scene):
        with torch.no_grad():
            return model(scene)["final_scores"]

    t0 = time.perf_counter()
    first = request(scenes[0]).cpu()
    log(f"# first request (kernel build + first run): "
        f"{time.perf_counter() - t0:.3f} s")
    for s in scenes:  # warm every distinct input once
        float(request(s).cpu().sum())

    times, sink = [], 0.0
    t0 = time.perf_counter()
    for i in range(SYNC_REQUESTS):
        ti = time.perf_counter()
        sink += float(request(scenes[i % len(scenes)]).cpu().sum())
        times.append(time.perf_counter() - ti)
    dt_sync = (time.perf_counter() - t0) / SYNC_REQUESTS / batch
    dt_sync_med = statistics.median(times) / batch
    log(f"# sync steady-state: {dt_sync * 1e3:.3f} ms/frame at batch {batch} "
        f"(median {dt_sync_med * 1e3:.3f}, min-max "
        f"{min(times) * 1e3 / batch:.3f}-{max(times) * 1e3 / batch:.3f}, "
        f"{SYNC_REQUESTS} requests, sink={sink:.3f})")

    dt = dt_sync
    if not args.sync:
        depth = int(os.environ.get("MSSVT_BENCH_DEPTH", "2"))
        pinned = [torch.empty(first.shape, dtype=first.dtype,
                              pin_memory=device.type == "cuda")
                  for _ in range(depth)]
        inflight, sink = [], 0.0

        def land():
            event, buf = inflight.pop(0)
            if event is not None:
                event.synchronize()
            return float(buf.sum())

        t0 = time.perf_counter()
        for i in range(PIPELINED_REQUESTS):
            buf = pinned[i % depth]  # its last reader landed already
            buf.copy_(request(scenes[i % len(scenes)]), non_blocking=True)
            event = None
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            inflight.append((event, buf))
            if len(inflight) >= depth:
                sink += land()
        while inflight:  # drain: every result lands on the host
            sink += land()
        dt = (time.perf_counter() - t0) / PIPELINED_REQUESTS / batch
        log(f"# pipelined steady-state: {dt * 1e3:.3f} ms/frame at batch "
            f"{batch}, depth {depth} ({PIPELINED_REQUESTS} requests, "
            f"sink={sink:.3f})")

    # outputs must differ across scenes (no caching)
    if torch.equal(request(scenes[0]).cpu(), request(scenes[1]).cpu()):
        raise RuntimeError("identical outputs across scenes: measurement "
                           "invalid")
    return {"sync_ms_per_frame": round(dt_sync * 1e3, 4),
            "sync_ms_per_frame_median": round(dt_sync_med * 1e3, 4)}, dt


def count_request(model, scene, batch):
    """FLOPs of one request a frame: (total, kernels by name, aten)."""
    import torch

    from mssvt_tpu_torch.kernels import work

    with work.counting() as tally, torch.no_grad():
        model(scene)
    return (tally.total() / batch,
            {k: v / batch for k, v in tally.kernels.items()},
            tally.aten_flops() / batch)


def profile(path, device, fn, n):
    """Chrome trace of ``n`` calls of ``fn`` (each ending in a readback)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        for i in range(n):
            fn(i)
        sync_device(device)
    prof.export_chrome_trace(str(path))
    log(f"# profiler trace written to {path}")


def run_train(cfg, model, scenes, batch, device, profile_dir):
    """The training tail; returns its JSON fields."""
    import torch

    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import train_step

    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                                   total_steps=1000, steps_per_epoch=100)
    gen = torch.Generator(device=device).manual_seed(0)

    def step(scene):
        loss, _ = train_step(model, optimizer, scene, gen)
        value = float(loss)  # host readback forces completion
        if not math.isfinite(value):
            raise RuntimeError(f"non-finite train loss {value}")
        return value

    t0 = time.perf_counter()
    l0 = step(scenes[0])
    first_s = time.perf_counter() - t0
    log(f"# train first step: {first_s:.3f} s (loss={l0:.4f})")
    for s in scenes[1:]:
        step(s)
    sink, times = 0.0, []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        ti = time.perf_counter()
        sink += step(scenes[i % len(scenes)])
        times.append(time.perf_counter() - ti)
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
            "GiB" if device.type == "cuda" else "")
    log(f"# train steady-state: {dt * 1e3:.3f} ms/step at batch {batch} "
        f"({dt * 1e3 / batch:.3f} ms/frame; median "
        f"{statistics.median(times) * 1e3:.3f}, min-max "
        f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f} ms; sink={sink:.3f})"
        f"{peak}")
    if profile_dir is not None:
        profile(profile_dir / "train_steps.json", device,
                lambda i: step(scenes[i % len(scenes)]), PROFILE_STEPS)
    return {"train_ms_per_step": round(dt * 1e3, 4),
            "train_ms_per_frame": round(dt * 1e3 / batch, 4),
            "train_compile_s": round(first_s, 4)}


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from mssvt_tpu_torch.datasets.synthetic_scene import add_synth_gt
    from mssvt_tpu_torch.kernels import work

    cfg, model, (grid, max_voxels), batch, device = setup(args)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    if device.type == "cuda":
        from chip_smoke import card_line

        log(f"# card: {card_line()}")
    profile_dir = None if args.profile is None else Path(args.profile)
    scenes, n_vox = make_scenes(grid, max_voxels, batch, device,
                                with_gt=args.train)
    log(f"# scene: {n_vox} voxels total, batch {batch}, grid {grid}, "
        f"{'tiny' if args.tiny else 'mssvt.yaml'}"
        f"{', fp32' if args.fp32 else ''}, device {kind}")

    if args.train:
        out = run_train(cfg, model, scenes, batch, device, profile_dir)
        print(json.dumps({
            "metric": f"train_step_ms_single_chip_batch{batch}",
            "value": out["train_ms_per_step"], "unit": "ms/step", **out,
            "device": kind}))
        return 0

    fields, dt = run_inference(args, model, scenes, batch, device)
    fps = 1.0 / dt
    flops, by_kernel, aten = count_request(model, scenes[0], batch)
    kernels_line = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                             sorted(by_kernel.items()) if v)
    log(f"# work: {flops / 1e9:.3f} GFLOP/frame = kernels "
        f"{(flops - aten) / 1e9:.3f} ({kernels_line}) + aten {aten / 1e9:.3f}"
        " (kernels/work.py; FlopCounterMode's products)")
    mfu = None
    if device.type == "cuda":
        peak = work.F32_FLOPS if args.fp32 else work.BF16_FLOPS
        mfu = flops / (dt * peak)
        log(f"# mfu: {mfu * 100:.4f}% of {peak / 1e12:.0f} TFLOP/s at "
            f"{dt * 1e3:.3f} ms/frame")
    if profile_dir is not None:
        with torch.no_grad():
            profile(profile_dir / "requests.json", device,
                    lambda i: float(model(scenes[i % len(scenes)])
                                    ["final_scores"].cpu().sum()),
                    PROFILE_REQUESTS)
    out = {"metric": "e2e_inference_fps_single_chip", "value": round(fps, 4),
           "unit": "frames/sec", "mfu": mfu,
           **fields}

    if not (args.no_train or args.batch1):
        for i, s in enumerate(scenes):
            s["gt_boxes"] = torch.as_tensor(
                add_synth_gt({}, batch, seed=i)["gt_boxes"]).to(device)
        if device.type == "cuda":  # free the inference state first
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        out.update(run_train(cfg, model, scenes, batch, device, profile_dir))
    out["device"] = kind
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
