#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mssvt_tpu_torch``) on one card.

Run from the repo root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--profile]

Phases (any failed check raises and the script exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build from ``mssvt_tpu_torch/csrc`` (nvcc, sm_90a) and the
   host voxelizer's (``csrc/host/voxelizer.cpp``, g++);
3. small-input reference: ``mssvt_tiny.yaml`` in f32 on the card (CUDA
   kernels) against the same seeded weights on the CPU (the kernels' plain
   versions, which the CPU tests hold against the JAX package);
4. per kernel, at ``mssvt.yaml`` block-0 shapes on inputs the port itself
   produced from a synthetic Waymo-scale scene: the CUDA kernel against its
   plain version on the card (fill and FPS exactly, attention and FFN within
   the bf16 tolerance below), both timed with CUDA events; K2, K3 and K4
   are also held against their plain versions and timed at the shapes of
   the other two MsSVT blocks of that forward, K1 at its other four calls
   of that forward, K2c also at 4 rows of 16 384 points; K3's and K4's
   shared memory, CTAs an SM and registers are printed, and the unfused
   bf16 chain of PyTorch calls at K4's block-0 inputs is timed as K4's
   yardstick;
5. the main path: ``mssvt.yaml`` CenterPoint, full width, bf16, seeded
   random weights: one warm-up request, then 10 requests cycling 3
   distinct scenes of batch 4, with the kernel launch counts of every
   request checked; host-clock mean, median and min-max; then the headline
   number, the device time of one profiled request (``torch.profiler``);
6a. small-input training reference: one f32 ``mssvt_tiny.yaml`` training
   step on the card against the CPU plain path (loss within 1e-4 relative,
   every gradient within 1e-3 of the global gradient norm);
6b. K5, the attention backward, at ``mssvt.yaml`` block-0 shapes on the
   inputs of a full-width training forward and backward: the CUDA kernel
   against its plain version (each cotangent within the bf16 tolerance),
   twice with bit-identical results, both timed with CUDA events;
6c. the training path: one warm-up and 10 measured ``train_step``s of
   ``mssvt.yaml`` at full width, bf16, batch 4 cycling 3 scenes with
   seeded GT boxes, ``adam_onecycle`` with ``GRAD_NORM_CLIP: 10``: finite
   loss and gradient norm, a finite gradient for every parameter, nonzero
   ones for the 3D backbone's attention, position and FFN parameters and
   the head, the launch counts of every step; then the first measured
   step's forward and backward again from the same weights, batch and
   DropPath generator state, with bit-identical gradients; host-clock
   mean, median and min-max, and the device time of one profiled step.
7a. as 6a with ``ref_compat_keys: False`` on the MsSVT blocks: the tiny
   model then trains through the outside assembly and K6/K7 (the window
   attention on pre-assembled tokens, forward and backward).
7b. K6 and K7 at ``mssvt.yaml`` block-0 shapes on the inputs of a full-width
   flag-off training forward and backward: each kernel against its plain
   version on every window (K7 per cotangent), K7 twice with bit-identical
   results, all timed with CUDA events; the number of windows K7's
   per-window kernel walked (those whose ``g`` has a nonzero element) is
   printed beside the total; K6 is also timed at the other two MsSVT
   blocks' shapes and with a fixed grid.
7c. the flag-off training path: ``train_step``s of ``mssvt.yaml`` with
   ``ref_compat_keys: False`` set on the loaded config, run and checked as
   6c.
7d. the selection-free FPS entry point
   ``ops.sampling.farthest_point_sample_planes`` on block 0's planes (N = 96,
   K2b), on 4 096 rows of 2 048 seeded points and on 4 rows of 16 384 (K2c,
   twice): picks equal to the plain version's, launch counts checked.
   (Phase 4 holds and times K2b and K2c beside K2.)
8. the data pipeline and the entry points: ``mssvt.yaml``'s model at full
   width on ``SyntheticDataset`` frames of ~180 000 points with
   ``waymo_dataset.yaml``'s range, features, voxelizer (80 000 / 90 000
   voxels a frame) and world flip/rotation/scaling (``PIPELINE_DATA``; the
   config is written under ``output/``): ``tools/train_torch.py`` in-process
   for one epoch (2 steps at batch 4), again for two (it resumes at epoch 1,
   iteration 2, and takes 2 more steps), then ``tools/test_torch.py`` on
   checkpoint 2 over the 8 test frames (2 requests); every loss and metric
   finite, checkpoints [1, 2], ``result.pkl`` written, the launch counts of
   every step and request, the C++ host voxelizer equal to its numpy
   version on one frame; prints the voxels a frame, block 0's live
   windows against its cap, the loader's host seconds a batch against the
   synchronised step, eval ms a frame, the checkpoint's size and the peak
   device memory (``# pipeline`` lines).

The profiled request and steps print the device time per kernel name (top
entries, and their sum as a share of the median unprofiled request or step
time) with the device time of each K1, K2, K3 and K4 launch inside the
request, of each K1, K2 and K3 launch inside the pad-key step and of each
K1, K2 and K6 launch inside the flag-off step. With ``--profile`` phases 6b and 7b also
print the device time of each launch inside one K5 and one K7 call
(per-window kernel, weight product, final sums, K7's pre-pass).

9. data parallelism and the rest of the entry points, at ``mssvt.yaml``
   full width: 9a ``tools/train_torch.py --launcher pytorch`` at world size
   1 on NCCL (DDP, SyncBN) for one epoch of phase 8's config (2 steps at
   batch 4, checkpoint 1), then ``tools/test_torch.py --launcher pytorch``
   on it through the part/barrier/merge path, each step's and request's
   launch counts checked and the step times printed beside phase 8's; 9b
   two gloo ranks on ``cuda:0`` (spawned processes), each one DDP step of
   plain SGD on its half of the batch, against the one-process step on the
   whole batch (the tiny f32 model on 2 frames, per parameter update; the
   full-width bf16 model on 4 Waymo-scale frames, loss within 1e-3 and
   gradient norm within 1e-2 relative; DropPath off and window caps raised
   to what the frames need, equal positives a frame), launch counts per
   rank; 9c ``tools/demo_torch.py`` on four ``.npy`` frames of the synthetic
   scene, then ``tools/import_ckpt_torch.py`` on a seeded pcdet-named
   ``mssvt.yaml`` state dict and a request a frame from the imported
   weights; 9d ``voxelize_points_torch`` on a 180 000-point frame against
   the host C++ voxelizer (the same voxels and counts but where a point's
   float32 cell differs from its float64 one), timed.
10. SECOND and PointPillar (``kitti_models/second.yaml``,
   ``pointpillar.yaml``: the sparse-conv engine, the pillar VFE and
   scatter, the anchor head and its post-processing; no kernel of K1-K7
   stands on their path, and every step and request is checked to launch
   none): 10a tiny f32 models on the card against the CPU plain path on
   the same weights (kept boxes as sets within 1e-3; one ``train_step``:
   loss within 1e-4 relative, gradient norm within 1e-3); 10b each at full
   KITTI width on ``SyntheticDataset`` frames (~61 000 points) under
   ``kitti_dataset.yaml``'s processors (``KITTI_DATA``; the config is
   written under ``output/``): ``tools/train_torch.py`` for one epoch (2
   steps at batch 4) and ``tools/test_torch.py`` on its checkpoint (2
   requests), printing voxels a frame against the 16 000 / 40 000 caps, the
   BEV width (128, 64), each synchronised step and request, the anchor
   post-processing's (NMS) share of a request by the host clock and under
   the profiler, and the peak memory, also of a request with the NMS's
   pairwise IoU at once instead of in row blocks (``# 10a``/``# 10b``
   lines).
11. the file-backed datasets, on seeded trees in their on-disk layouts
   under ``output/chip_smoke/data/`` (``datasets/synthetic_files.py``; no
   dataset file ships with the repo), read through the shipped dataset
   configs with gt_sampling on from a database the port wrote: 11a
   ``mssvt.yaml`` (full width, bf16, batch 4) on a ``WaymoDataset`` tree
   of 40 train and 8 val frames of 180 000 points (6 columns, ~5% in the
   no-label zone; ``SAMPLED_INTERVAL`` leaves 8 train frames), the GT
   database from ``create_groundtruth_database``, the shared-memory cache
   under ``output/``: ``tools/train_torch.py`` for one epoch (2 steps) and
   ``tools/test_torch.py`` (2 requests), each step's and request's launch
   counts as phase 8's, the official Waymo AP/APH (12 values, finite, in
   [0, 1]) and the KITTI-style proxy of ``result.pkl`` through
   ``WaymoDataset.evaluation``, a frame read twice by a fresh instance
   (the staged read, then its own dict) against the file read, and
   ``clean_shared_memory``; 11b ``kitti_models/second.yaml`` (f32, batch
   4) on a KITTI tree of 8 train and 4 val frames of 120 000 points
   prepared by ``create_kitti_infos``: one epoch (2 steps) and 1 request,
   no launch of K1-K7, the official R40 evaluation (bbox, bev, 3d, aos;
   finite) of ``result.pkl`` with its camera fields, and of the val GT
   boxes moved ~5 cm (nonzero). Both print the host seconds of BATCH
   training items split by stage (read, each augmentor and processor,
   collate). Prints points a frame
   before and after the NLZ and FOV filters, voxels a frame against the
   caps, objects pasted a frame, the loader's host seconds a batch beside
   the synchronised step, eval ms a frame, the evaluations' host seconds,
   the metrics, the peaks and the phase's seconds (``# 11a``/``# 11b``
   lines).
12. the two-stage voxel family (the RoI machinery, VoxelRCNN, PartA2,
   SECONDNetIoU; no kernel of K1-K7 stands on its path, and every step and
   request is checked to launch none): 12a tiny f32 VoxelRCNN, PartA2 and
   SECONDNetIoU (``second.yaml`` with a BEV-grid RoI head) on the card
   against the CPU plain path on the same weights (RoIs and refined boxes
   as sets within 1e-3; one ``train_step``: loss within 1e-4 relative,
   gradient norm within 1e-3; the card's gradients bit-identical on a
   repeated backward); 12b ``voxel_rcnn_car.yaml`` and ``PartA2.yaml`` at
   their published widths (f32) and the yaml's batch 2 on a KITTI tree of
   11b's seeded writer (4 train, 2 val frames of 120 000 points,
   gt_sampling on): ``tools/train_torch.py`` for one epoch (2 steps),
   ``tools/test_torch.py`` (1 request), the official R40 evaluation of
   ``result.pkl``; prints voxels a frame against the caps, live RoIs a
   frame, each synchronised step and request, the proposal NMS's share of
   a step and a request (host clock, and device time under
   ``torch.profiler`` beside ``voxel_query``'s and ``roiaware_pool3d``'s),
   the peaks and the phase's seconds (``# 12a``/``# 12b`` lines).
13. the point-based two-stage family (PV-RCNN, PV-RCNN++, PointRCNN; K2c
   on PV-RCNN's keypoint FPS and PointRCNN's set abstractions over more
   than 256 points, K2b on its last, none on PV-RCNN++'s plain sector
   FPS): 13a the JAX suite's tiny f32 models on the card against the CPU
   plain path on the same weights (refined boxes as sets within 1e-3; one
   ``train_step``: loss within 1e-4 relative, gradient norm within 1e-3;
   a bit-identical repeated backward; exactly the expected kernels
   launched); 13b ``pv_rcnn.yaml``, ``pv_rcnn_plusplus.yaml`` and
   ``pointrcnn.yaml`` at their published widths (f32) and batch 2 on a
   KITTI tree of 11b's seeded writer, each step and request checked for
   its K2c/K2b launches: the entry points, the official R40 evaluation,
   the picks of every K2c/K2b call of a request (PV-RCNN's 2 x 16 384 ->
   2 048, PointRCNN's four levels) against ``fps_plain`` on the same card
   planes (timed); prints raw points and live RoIs a frame, each
   synchronised step and request, the proposal NMS's share, the sector
   FPS's host seconds, K2c's, K2b's, the groupings', the 3-NN's, the
   interpolation's and the RoI point pool's device time under
   ``torch.profiler``, the peaks and the phase's seconds (``# 13a``/``#
   13b`` lines).
14. the last three families (no kernel of K1-K7 on their path, and every
   step and request is checked to launch none): 14a the JAX suite's tiny
   f32 CaDDN, CT3D_3CAT and SECOND with AnchorHeadMulti/ATSS on the card
   against the CPU plain path on the same weights (as 13a); 14b
   ``ct3d_3cat.yaml`` at its published widths (f32) and batch 2 on a KITTI
   tree of 11b's seeded writer, ``MODEL.MAX_POINTS`` passed to the
   DATA_CONFIG: the entry points (2 steps, 1 request), the official R40
   evaluation, raw points and live RoIs a frame, the proposal NMS's share,
   the device time of the NMS, the RoI point sampling and the transformer;
   14c ``CaDDN.yaml`` at its published widths (280 x 376 x 25 voxels, 64
   channels, 80 bins, 375 x 1242 images; its BEV backbone's first stride 2,
   see ``caddn_config``), f32, batch 4, on seeded in-memory camera batches
   (the KITTI tree's calibration, sparse depth maps, 2D boxes): 2 steps and
   1 request, the parts' host and device time (DepthFFN, the sampler, the
   collapse, the BEV backbone, the head, the post-processing), the peaks
   and the phase's seconds (``# 14a``/``# 14b``/``# 14c`` lines).
15. the bench and the convergence gate: 15a ``bench_torch.py --profile``
   (``mssvt.yaml``, full width, batch 4, its training tail on) as a
   subprocess: exit 0, its JSON line's keys, 0 < ``mfu`` <= 1, a finite
   ``train_ms_per_step``; ``tools/profile_top_ops_torch.py --group`` on its
   traces (the top families and the device-busy share); 15b
   ``runtime/convergence.train_golden`` on the card (the golden scene, 120
   ``adam_onecycle`` steps through K1, K2, K3 and K5): every 10th loss,
   the recall, and the JAX test's two assertions; 15c
   ``tools/ablate_e2e_torch.py``'s ``none`` and ``attn`` cuts at full width
   (3 timed requests each) with their launch counts checked (``attn``
   launches no K3), and ``tools/bench_attn_kernel_torch.py --iters 5`` (K3
   alone at block-0 shapes against its plain version on 2 048 windows)
   (``# 15a``/``# 15b``/``# 15c`` lines).

Its last lines are the card line, one ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
cuDNN convolutions, so f32 comparisons are full f32.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# bf16 keeps 8 significant bits. Kernel and plain version round the same
# intermediates to bf16 but sum in another order, so an intermediate can
# land one bf16 ulp apart and carry that through the next product; the
# outputs must agree to 2^-5 of their largest magnitude.
BF16_TOL = 2.0 ** -5
KERNEL_NAMES = ("fill", "fps", "fps_picks_warp", "fps_picks_block",
                "attention", "attention_bwd", "attention_qk",
                "attention_qk_bwd", "ffn")


def launches(**counts):
    """Expected launch counts: the named kernels, 0 for every other."""
    return {n: counts.get(n, 0) for n in KERNEL_NAMES}


EXPECTED_LAUNCHES = launches(fill=5, fps=3, attention=3, ffn=3)
TRAIN_LAUNCHES = launches(fill=5, fps=3, attention=3, attention_bwd=3)
FLAG_OFF_LAUNCHES = launches(fill=5, fps=3, attention_qk=3, attention_qk_bwd=3)
SAMPLING_LAUNCHES = launches(fps_picks_warp=1, fps_picks_block=2)
PIPELINE_STEP = TRAIN_LAUNCHES       # each training step of phase 8
PIPELINE_REQUEST = EXPECTED_LAUNCHES  # each eval request of phase 8
REQUESTS = 10     # measured requests after one warm-up, cycling the scenes
TRAIN_STEPS = 10  # measured steps of each kind after one warm-up step
FPS_BLOCK_SHAPE = (4096, 2048, 512)  # K2c: rows, points a row, picks
FPS_WIDE_SHAPE = (4, 16384, 4096)    # K2c at its widest N (PointRCNN's SA1)
GRID = (480, 480, 32)
VOXEL = (0.32, 0.32, 0.1875)
PCR = (-76.8, -76.8, -2.0, 76.8, 76.8, 4.0)
BATCH = 4
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else \
        f"nvidia-smi failed: {res.stderr.strip()}"


def time_ms(torch, fn, reps, warm=1):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median(times):
    t = sorted(times)
    mid = len(t) // 2
    return t[mid] if len(t) % 2 else (t[mid - 1] + t[mid]) / 2


def stats_line(times):
    """mean, median and min-max of host-clock times (ms)."""
    return (f"mean {sum(times) / len(times):.1f}, median {median(times):.1f}, "
            f"min-max {min(times):.1f}-{max(times):.1f} ms over {len(times)}")


def to_device(torch, scene, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}


def load_cfg(name, ref_compat_keys=True):
    """The YAML config; ``ref_compat_keys=False`` sets that flag on its
    MsSVT blocks, as a caller who trains from scratch would."""
    from mssvt_tpu_torch.config import cfg_from_yaml_file
    from mssvt_tpu_torch.utils.edict import EasyDict

    cfg = cfg_from_yaml_file(str(ROOT / name), EasyDict())
    if not ref_compat_keys:
        for p in cfg.MODEL.BACKBONE_3D.PARAMS:
            if p["name"] == "MixedScaleSparseTransformerBlock":
                p["ref_compat_keys"] = False
    return cfg


# --------------------------------------------------------------- phase 3
def tiny_gt(np, rng, bsz, max_gt=8):
    """GT boxes inside mssvt_tiny.yaml's range (class 0 rows are padding)."""
    gt = np.zeros((bsz, max_gt, 8), np.float32)
    for b in range(bsz):
        n = int(rng.integers(3, max_gt))
        gt[b, :n, 0] = rng.uniform(1.0, 18.0, n)
        gt[b, :n, 1] = rng.uniform(-8.5, 8.5, n)
        gt[b, :n, 2] = rng.uniform(-1.0, 1.0, n)
        gt[b, :n, 3:6] = rng.uniform(0.8, 4.0, (n, 3))
        gt[b, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[b, :n, 7] = rng.integers(1, 4, n)
    return gt


def tiny_setup(seed, with_gt=False, ref_compat_keys=True):
    """mssvt_tiny.yaml and a seeded 2-frame scene of up to 1024 voxels
    (with GT boxes for training): (cfg, build_network args, scene)."""
    import numpy as np

    cfg = load_cfg("tools/cfgs/synthetic_models/mssvt_tiny.yaml",
                   ref_compat_keys)
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vs = tuple(dc.DATA_PROCESSOR[-1].VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    n_feat = len(dc.POINT_FEATURE_ENCODING.used_feature_list)
    rng = np.random.default_rng(seed)
    bsz, max_vox, n = 2, 1024, 1100
    coords = np.unique(np.stack([
        rng.integers(0, bsz, n), rng.integers(0, grid[2], n),
        rng.integers(0, grid[1], n), rng.integers(0, grid[0], n)], 1),
        axis=0).astype(np.int32)[:max_vox]
    pad = np.full((max_vox, 4), -1, np.int32)
    pad[:len(coords)] = coords
    valid = np.arange(max_vox) < len(coords)
    scene = {"voxels": (rng.normal(size=(max_vox, 5, n_feat))
                        * valid[:, None, None]).astype(np.float32),
             "voxel_num_points": (rng.integers(1, 6, max_vox)
                                  * valid).astype(np.float32),
             "voxel_coords": pad, "voxel_valid": valid}
    if with_gt:
        scene["gt_boxes"] = tiny_gt(np, rng, bsz)
    args = (cfg.MODEL, 3, CLASSES, grid, vs, pcr, bsz, max_vox, 5)
    return args, n_feat, scene


def small_reference(torch):
    """mssvt_tiny.yaml in f32: CUDA kernels vs plain versions on the CPU."""
    from mssvt_tpu_torch.models import build_network

    args, n_feat, scene = tiny_setup(7)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_network(*args, num_point_features=n_feat, device=dev,
                              seed=11)
        with torch.no_grad():
            outs[dev] = model(to_device(torch, scene, dev),
                              return_intermediates=True)
    torch.cuda.synchronize()
    cpu, gpu = outs["cpu"], outs["cuda"]
    worst = 0.0
    pairs = [("backbone", cpu["backbone_voxels"].features,
              gpu["backbone_voxels"].features)]
    pairs += [(k, cpu["pred_dicts"][0][k], gpu["pred_dicts"][0][k])
              for k in cpu["pred_dicts"][0]]
    for name, a, b in pairs:
        err = (a - b.cpu()).abs().max().item()
        scale = max(1.0, a.abs().max().item())
        worst = max(worst, err / scale)
        if err > 1e-3 * scale:
            raise AssertionError(f"small reference: {name} differs by {err}")
    if not torch.equal(cpu["final_mask"], gpu["final_mask"].cpu()):
        raise AssertionError("small reference: kept boxes differ")
    m = cpu["final_mask"]
    err = (cpu["final_boxes"][m] - gpu["final_boxes"].cpu()[m]).abs().max()
    if err.item() > 1e-3:
        raise AssertionError(f"small reference: boxes differ by {err.item()}")
    log(f"# small reference (mssvt_tiny.yaml, f32): card vs CPU plain path, "
        f"worst relative error {worst:.3g}, {int(m.sum())} boxes agree")


# --------------------------------------------------------------- phase 4
# the inference path's kernels (K5, the backward, is phase 6b's)
KERNEL_FUNCS = {
    "fill": ("fill_capacity_buffer", "fill_plain"),
    "fps": ("fps_select", "fps_plain"),
    "attention": ("fused_window_attention_assembled", "attention_plain"),
    "ffn": ("fused_residual_ffn", "ffn_plain"),
}
TPU_COUNTERPART = {
    "fill": "mssvt_tpu/ops/pallas_fill.py:209 fill_capacity_buffer",
    "fps": "mssvt_tpu/ops/pallas_fps.py:172 "
           "farthest_point_sample_planes_pallas_t_sel",
    "attention": "mssvt_tpu/ops/pallas_attention.py:946 "
                 "fused_window_attention_assembled",
    "attention_bwd": "mssvt_tpu/ops/pallas_attention.py:1190 "
                     "_asm_attn_bwd_impl",
    "ffn": "mssvt_tpu/ops/pallas_ffn.py:42 fused_residual_ffn",
    "attention_qk": "mssvt_tpu/ops/pallas_attention.py:426 "
                    "_fused_attention_fwd_impl",
    "attention_qk_bwd": "mssvt_tpu/ops/pallas_attention.py:705 "
                        "_fused_attention_bwd_impl",
    "fps_picks_warp": "mssvt_tpu/ops/pallas_fps.py:244 "
                      "farthest_point_sample_planes_pallas_t",
    "fps_picks_block": "mssvt_tpu/ops/pallas_fps.py:278 "
                       "farthest_point_sample_planes_pallas",
}
SOURCE = {n: f"mssvt_tpu_torch/csrc/{n}.cu" for n in KERNEL_NAMES}
SOURCE["fps_picks_warp"] = SOURCE["fps_picks_block"] = SOURCE["fps"]


def kernel_row(name, err, ms, plain_ms, bound_ms, bound_by):
    return dict(name=name, route="cuda", source=SOURCE[name],
                replaces=TPU_COUNTERPART[name], launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


# timed at every call of a forward: the MsSVT blocks (and K1's two more)
ALL_BLOCKS = ("fill", "fps", "attention", "ffn")


def capture_first_calls(torch, model, batch):
    """Run one forward, recording each inference kernel wrapper's first call
    (block 0 for all four) and, under "<name>_all", every call of the
    kernels in ALL_BLOCKS (the three MsSVT blocks in order)."""
    from mssvt_tpu_torch import kernels

    captured, saved = {}, {}
    for name in KERNEL_FUNCS:
        mod = kernels.KERNELS[name]
        fname = KERNEL_FUNCS[name][0]
        orig = getattr(mod, fname)
        saved[name] = orig

        def rec(*a, _n=name, _f=orig, **k):
            captured.setdefault(_n, (a, k))
            if _n in ALL_BLOCKS:
                captured.setdefault(_n + "_all", []).append((a, k))
            return _f(*a, **k)

        setattr(mod, fname, rec)
    try:
        with torch.no_grad():
            model(batch)
        torch.cuda.synchronize()
    finally:
        for name in KERNEL_FUNCS:
            setattr(kernels.KERNELS[name], KERNEL_FUNCS[name][0], saved[name])
    return captured


def bound(name, a, k):
    """(bound_ms, bound_by) of this call's data, from the kernel's formula
    in ``kernels/work.py``: the bytes that must move (inputs once, outputs
    once; rows past num_valid are not read) over the HBM rate vs the
    operations over the peak rate of their type."""
    from mssvt_tpu_torch.kernels import work

    formula = {"fill": work.fill, "fps": work.fps_select,
               "attention": work.attention, "ffn": work.ffn}[name]
    return formula(*a, **k).bound()


def compare(name, got, want, a, k, torch):
    """Max abs error; raises if the kernel disagrees with its plain version."""
    if name in ("fill", "fps"):
        gl = got if name == "fill" else (got[0], *got[1])
        wl = want if name == "fill" else (want[0], *want[1])
        err = 0.0
        for g, w in zip(gl, wl):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel != plain version")
        return err
    if name == "attention":
        keep = (a[5] > 0)[..., None]  # q_keep: compare after the query mask
        got, want = got.float() * keep, want.float() * keep
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"# {name}: max abs error {err:.4g}, relative to max |plain| "
        f"{scale:.4g}: {err / max(scale, 1e-30):.4g} (limit {BF16_TOL:.4g})")
    if err > BF16_TOL * max(scale, 1e-6):
        raise AssertionError(f"{name}: max abs error {err} > {BF16_TOL} x "
                             f"max |plain| {scale}")
    return err


def log_plan(name, plan, what="kernel"):
    smem, ctas, regs = plan
    log(f"# {name}: {what} {smem} bytes of shared memory a CTA, {ctas} CTAs "
        f"an SM (occupancy API), {regs} registers a thread")


def asm_layout(a, k):
    """(n1cap, nk1, nk2, nq, d, num_heads) of one K3/K5 call."""
    win1, k2, fps1 = a[0], a[1], a[2]
    nq = int(k["nq"]) if k["q_prefix"] else a[4].shape[1]
    return (win1.shape[1], fps1.shape[1], k2.shape[1], nq, win1.shape[2],
            k["num_heads"])


def kernel_phase(torch, captured):
    from mssvt_tpu_torch import kernels

    rows = {}
    for name in KERNEL_FUNCS:
        mod = kernels.KERNELS[name]
        a, k = captured[name]
        kern = getattr(mod, KERNEL_FUNCS[name][0])
        plain = getattr(mod, KERNEL_FUNCS[name][1])
        with torch.no_grad():
            got = kern(*a, **k)
            want = plain(*a, **k)
            torch.cuda.synchronize()
            err = compare(name, got, want, a, k, torch)
            ms = time_ms(torch, lambda: kern(*a, **k), reps=10, warm=2)
            plain_ms = time_ms(torch, lambda: plain(*a, **k), reps=3, warm=1)
        bound_ms, bound_by = bound(name, a, k)
        rows[name] = kernel_row(name, err, ms, plain_ms, bound_ms, bound_by)
        shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]
        log(f"# kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={err:.3g} "
            f"inputs={shapes}")
        if name == "fill":
            for kk, cap, cv in sorted({(c[0][0].shape[1], int(c[0][2]),
                                        (c[1].get("own_slab") or (0, 0))[1])
                                       for c in captured["fill_all"]}):
                smem, ctas, regs, warps = mod.kernel_plan(kk, cap, cv)
                log(f"# fill: kernel at K={kk} cap={cap} cv={cv}: {smem} bytes "
                    f"of shared memory a CTA, {warps} warps a CTA, {ctas} CTAs "
                    f"an SM (occupancy API), {regs} registers a thread")
        del got, want
    a, k = captured["attention"]
    log_plan("attention", kernels.KERNELS["attention"].kernel_plan(
        *asm_layout(a, k)))
    x, w1 = captured["ffn"][0][0], captured["ffn"][0][3]
    log_plan("ffn", kernels.KERNELS["ffn"].kernel_plan(x.shape[1],
                                                       w1.shape[1]))
    ffn_chain(torch, *captured["ffn"])
    with torch.no_grad():
        # the later blocks' calls (fewer windows and rows; K3's query tiles
        # padded from nq = 8) are held against the plain version too
        for name in ALL_BLOCKS:
            mod = kernels.KERNELS[name]
            kern = getattr(mod, KERNEL_FUNCS[name][0])
            plain = getattr(mod, KERNEL_FUNCS[name][1])
            for a, k in captured[name + "_all"][1:]:
                compare(name, kern(*a, **k), plain(*a, **k), a, k, torch)
                ms = time_ms(torch, lambda: kern(*a, **k), reps=10, warm=2)
                log(f"# kernel {name} at a later block: ms={ms:.4f} "
                    f"{later_block_shape(name, a, k)}")
    return rows


def later_block_shape(name, a, k):
    if name == "fill":
        nv = k.get("num_valid")
        return (f"rows={a[0].shape[0]} K={a[0].shape[1]} cap={a[2]} "
                f"own_slab={k.get('own_slab')} num_valid="
                f"{None if nv is None else int(nv)} "
                f"bound_ms={bound(name, a, k)[0]:.4f}")
    if name == "attention":
        return (f"windows={a[0].shape[0]} num_valid={int(k['num_valid'])} "
                f"layout (n1cap, nk1, nk2, nq, d, heads)={asm_layout(a, k)}")
    if name == "fps":
        return (f"rows={a[0].shape[0]} N={a[0].shape[1]} npoint={a[4]} "
                f"planes={3 + len(a[3])} num_valid={int(k['num_valid'])}")
    return f"x={tuple(a[0].shape)} w1={tuple(a[3].shape)}"


def ffn_chain(torch, a, k):
    """K4's yardstick: the unfused bf16 chain of PyTorch calls (layer_norm,
    linear, relu, linear, add; five calls, so no ``library_ms``) on K4's
    block-0 inputs, timed with CUDA events. The port never calls it."""
    import torch.nn.functional as F

    x, s, b, w1, b1, w2, b2 = a
    t = x.dtype
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()  # nn.Linear layout
    s, b, b1, b2 = (p.to(t) for p in (s, b, b1, b2))
    c = x.shape[1]
    chain = lambda: x + F.linear(torch.relu(F.linear(
        F.layer_norm(x, (c,), s, b, k["eps"]), w1t, b1)), w2t, b2)
    with torch.no_grad():
        ms = time_ms(torch, chain, reps=10, warm=2)
    log(f"# ffn yardstick: the unfused {t} chain (layer_norm, linear, relu, "
        f"linear, add) at the same inputs: chain_ms={ms:.4f}")


def fps_picks_inputs(torch, planes):
    """(K2b inputs, K2c inputs, K2c's widest inputs): block 0's planes
    (N = 96, 32 picks), FPS_BLOCK_SHAPE and FPS_WIDE_SHAPE rows of seeded
    normal points."""
    g = torch.Generator(device="cuda").manual_seed(5)
    out = [(*planes, 32)]
    for rows, n, npoint in (FPS_BLOCK_SHAPE, FPS_WIDE_SHAPE):
        out.append((*(torch.randn(rows, n, generator=g, device="cuda")
                      for _ in range(3)), npoint))
    return tuple(out)


def fps_picks_phase(torch, planes):
    """K2b and K2c against fps_plain: exact picks, timed, with bounds (the
    planes read once and the picks written once, vs ~10 f32 operations a
    point and iteration)."""
    from mssvt_tpu_torch.kernels import fps, work

    rows = {}
    inputs = fps_picks_inputs(torch, planes)
    for name, kern, a in zip(("fps_picks_warp", "fps_picks_block"),
                             (fps.fps_picks_warp, fps.fps_picks_block),
                             inputs[:2]):
        x, npoint = a[0], a[3]
        got = kern(*a)
        want = fps.fps_plain(*a[:3], (), npoint)[0]
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain version")
        ms = time_ms(torch, lambda: kern(*a), reps=10, warm=2)
        plain_ms = time_ms(torch, lambda: fps.fps_plain(*a[:3], (), npoint),
                           reps=1, warm=1)
        b, n = x.shape
        rows[name] = kernel_row(name, 0.0, ms, plain_ms,
                                *work.fps_picks(*a).bound())
        log(f"# kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={rows[name]['bound_ms']:.4f} "
            f"({rows[name]['bound_by']}) picks equal; inputs=({b}, {n}) -> "
            f"{npoint}")
    a = inputs[2]
    if not torch.equal(fps.fps_picks_block(*a), fps.fps_plain(*a[:3], (), a[3])[0]):
        raise AssertionError("fps_picks_block: kernel != plain version at "
                             f"{FPS_WIDE_SHAPE}")
    ms = time_ms(torch, lambda: fps.fps_picks_block(*a), reps=3, warm=1)
    log(f"# kernel fps_picks_block at its widest N: ms={ms:.4f} picks equal; "
        f"inputs={FPS_WIDE_SHAPE[:2]} -> {FPS_WIDE_SHAPE[2]}")
    return rows


def sampling_path(torch, planes):
    """Phase 7d: the selection-free FPS entry point on CUDA tensors launches
    K2b for N <= 256 and K2c above it (at N = 2 048 and 16 384)."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.kernels import fps
    from mssvt_tpu_torch.ops.sampling import farthest_point_sample_planes

    kernels.reset_launch_counts()
    for a in fps_picks_inputs(torch, planes):
        got = farthest_point_sample_planes(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, fps.fps_plain(*a[:3], (), a[3])[0]):
            raise AssertionError("farthest_point_sample_planes != plain")
    counts = kernels.launch_counts()
    if counts != SAMPLING_LAUNCHES:
        raise AssertionError(f"sampling entry point: launches {counts} != "
                             f"{SAMPLING_LAUNCHES}")
    log(f"# sampling entry point: picks equal the plain version's at N = "
        f"{planes[0].shape[1]}, {FPS_BLOCK_SHAPE[1]} and {FPS_WIDE_SHAPE[1]}; "
        f"launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


# --------------------------------------------------------------- phase 8
# phase 8's DATA_CONFIG: mssvt.yaml's (waymo_dataset.yaml: range, 5 point
# features, voxelizer, world flip/rotation/scaling) with synthetic frames in
# place of the dataset's files
PIPELINE_DATA = {"DATASET": "SyntheticDataset", "NUM_FRAMES": 8,
                 "POINTS_PER_FRAME": 180_000}


def pipeline_config():
    """mssvt.yaml with PIPELINE_DATA and gt_sampling disabled (no db-info
    file exists), written under output/; returns its path."""
    import yaml

    cfg = json.loads(json.dumps(load_cfg("tools/cfgs/waymo_models/mssvt.yaml")))
    cfg["DATA_CONFIG"].update(PIPELINE_DATA)
    cfg["DATA_CONFIG"]["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = ["gt_sampling"]
    path = ROOT / "output" / "chip_smoke" / "cfgs" / "pipeline" / "mssvt_synthetic.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def load_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def block0_windows(batch, cfg):
    """Occupied block-0 windows of a device batch and the block's cap."""
    from mssvt_tpu_torch.ops.window import window_partition

    p0 = cfg["MODEL"]["BACKBONE_3D"]["PARAMS"][0]
    cap = int(p0["max_num_wins"]) * BATCH
    *_, num = window_partition(batch["voxel_coords"], batch["voxel_valid"],
                               GRID, p0["window_size"][0], cap, BATCH)
    return int(num), cap


def voxelizer_check(cfg):
    """The C++ host voxelizer against its numpy version on the first
    synthetic frame at the eval cap: identical voxels, coords and counts."""
    import numpy as np

    from mssvt_tpu_torch.datasets import build_dataset
    from mssvt_tpu_torch.ops.voxelize import voxelize_points

    ds = build_dataset(cfg["DATA_CONFIG"], CLASSES, training=False)
    points = ds._make_scene(0)[0]
    args = (points, ds.voxel_size, ds.point_cloud_range,
            ds.max_points_per_voxel, ds.max_voxels)
    t0 = time.perf_counter()
    got = voxelize_points(*args)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = voxelize_points(*args, use_native=False)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("host voxelizer: C++ != numpy version")
    log(f"# pipeline voxelizer: C++ equals the numpy version on "
        f"{len(points)} points -> {len(got[0])} voxels; host {native_ms:.1f} "
        f"ms against {numpy_ms:.1f} ms")


def pipeline_path(torch, card):
    """Phase 8: train_torch.py (1 epoch, then 2 with auto-resume) and
    test_torch.py on checkpoint 2, in-process on the card, through the
    port's own dataset, voxelizer, loader and eval loop. Returns the launch
    counts of the whole phase."""
    import math
    import shutil

    import yaml

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.runtime import eval_utils, train_utils

    cfg_path = pipeline_config()
    cfg = yaml.safe_load(cfg_path.read_text())
    voxelizer_check(cfg)
    out_root = ROOT / "output" / "chip_smoke" / "runs"
    shutil.rmtree(out_root, ignore_errors=True)
    os.environ["MSSVT_OUTPUT_ROOT"] = str(out_root)
    train, test = load_tool("train_torch"), load_tool("test_torch")

    seen = {"step": [], "request": []}

    def counted(kind, fn):
        def call(model, *args, **kw):
            before = kernels.launch_counts()
            out = fn(model, *args, **kw)
            after = kernels.launch_counts()
            batch = args[1] if kind == "step" else args[0]
            seen[kind].append(({n: after[n] - before[n] for n in after}, batch))
            return out
        return call

    train_step, eval_step = train_utils.train_step, eval_utils.eval_step
    train_utils.train_step = counted("step", train_step)
    eval_utils.eval_step = counted("request", eval_step)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    common = ["--cfg_file", str(cfg_path), "--batch_size", str(BATCH),
              "--workers", "1", "--extra_tag", "smoke"]
    try:
        runs = [train.main(common + ["--fix_random_seed", "--epochs", "1"]),
                train.main(common + ["--fix_random_seed", "--epochs", "2"])]
        evals = test.main(common + ["--ckpt", "2"])
    finally:
        train_utils.train_step, eval_utils.eval_step = train_step, eval_step
        del os.environ["MSSVT_OUTPUT_ROOT"]
    counts = kernels.launch_counts()
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30

    ckpt_dir = runs[0]["ckpt_dir"]
    steps = sorted(int(p.stem.split("_")[1]) for p in ckpt_dir.glob("checkpoint_*.pt"))
    if steps != [1, 2]:
        raise AssertionError(f"pipeline: checkpoints {steps} != [1, 2]")
    if (runs[1]["start_epoch"], runs[1]["start_iter"]) != (1, 2):
        raise AssertionError("pipeline: the second run did not resume at "
                             f"epoch 1, iteration 2: {runs[1]}")
    history = runs[0]["history"] + runs[1]["history"]
    if len(history) != 4 or len(seen["step"]) != 4 or len(seen["request"]) != 2:
        raise AssertionError(f"pipeline: {len(history)} steps, "
                             f"{len(seen['request'])} requests (4 and 2 due)")
    for i, h in enumerate(history):
        if not math.isfinite(h["loss"]):
            raise AssertionError(f"pipeline step {i}: loss {h['loss']}")
    for kind, want in (("step", PIPELINE_STEP), ("request", PIPELINE_REQUEST)):
        for i, (per, _) in enumerate(seen[kind]):
            if per != want:
                raise AssertionError(f"pipeline {kind} {i}: launches {per} != "
                                     f"{want}")
    metrics = evals[2]
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"pipeline: non-finite metrics {bad}")
    result = runs[0]["output_dir"] / "eval" / "epoch_2" / "result.pkl"
    if not result.exists():
        raise AssertionError(f"pipeline: {result} was not written")

    caps = {"train": int(cfg["DATA_CONFIG"]["DATA_PROCESSOR"][-1]
                         ["MAX_NUMBER_OF_VOXELS"]["train"]),
            "test": int(cfg["DATA_CONFIG"]["DATA_PROCESSOR"][-1]
                        ["MAX_NUMBER_OF_VOXELS"]["test"])}
    for kind, split in (("step", "train"), ("request", "test")):
        vox, wins = [], []
        for _, batch in seen[kind]:
            v = batch["voxel_valid"].reshape(BATCH, -1).sum(1).tolist()
            vox += v
            wins.append(block0_windows(batch, cfg))
        log(f"# pipeline {split}: occupied voxels a frame min {min(vox)}, "
            f"mean {sum(vox) / len(vox):.1f}, max {max(vox)} against the cap "
            f"{caps[split]} ({len(vox)} frames); block-0 windows a batch "
            f"{[w for w, _ in wins]} against the cap {wins[0][1]} "
            f"(max_num_wins {wins[0][1] // BATCH} x batch {BATCH}; the "
            f"overflow is dropped, as the reference does) [{card}]")
    make = runs[0]["loader_make_seconds"] + runs[1]["loader_make_seconds"]
    log(f"# pipeline train: loader host seconds a batch (items + collate) "
        f"{[round(x, 4) for x in make]}, mean {sum(make) / len(make):.4f}; "
        f"the step's wait for it {[round(h['data_s'], 4) for h in history]}; "
        f"synchronised step {[round(h['step_s'], 4) for h in history]} s; "
        f"losses {[round(h['loss'], 4) for h in history]} [{card}]")
    ckpt_mb = (ckpt_dir / "checkpoint_2.pt").stat().st_size / 2**20
    log(f"# pipeline eval: {metrics['sec_per_example'] * 1e3:.2f} ms a frame "
        f"(forward between synchronisations, batch {BATCH}); mAP "
        f"{metrics['mAP']:.4f}, recall@0.3 {metrics['recall/rcnn_0.3']:.4f} "
        f"(untrained: ~0, not gated) [{card}]")
    log(f"# pipeline: checkpoint {ckpt_mb:.1f} MiB; peak device memory "
        f"{peak:.2f} GiB; phase {seconds:.1f} s [{card}]")
    log(f"# pipeline launches: {counts}")
    return counts, [h["step_s"] for h in history]


# --------------------------------------------------------------- phase 9
DDP_STEP = TRAIN_LAUNCHES      # each rank's step of phases 9a and 9b
DDP_REQUEST = EXPECTED_LAUNCHES  # each request of phase 9a's eval
TINY_STEP = launches(fill=3, fps=2, attention=2, attention_bwd=2)
DEMO_FRAMES = 4  # phase 9c: the first request of a fresh model warms it up
DDP_LR = 1e-2  # phase 9b's SGD (adam would scale rounding noise up)
TINY_SLOTS, TINY_VOXELS = 1024, 600  # phase 9b's tiny frames
WAYMO_SLOTS = 90_000  # voxel slots a full-width frame


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_pipeline(torch, card, one_card_steps):
    """Phase 9a: tools/train_torch.py --launcher pytorch at world size 1 on
    NCCL (DDP, SyncBN) on phase 8's config for one epoch (2 steps at batch
    4), then tools/test_torch.py --launcher pytorch on checkpoint 1, whose
    eval goes through the part/barrier/merge path. Returns the launch
    counts of the phase."""
    import math
    import shutil

    from torch.nn.parallel import DistributedDataParallel

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.runtime import eval_utils, train_utils

    cfg_path = pipeline_config()
    out_root = ROOT / "output" / "chip_smoke" / "ddp"
    shutil.rmtree(out_root, ignore_errors=True)
    env = {"MSSVT_OUTPUT_ROOT": str(out_root), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    train, test = load_tool("train_torch"), load_tool("test_torch")
    seen = {"step": [], "request": []}

    def counted(kind, fn):
        def call(model, *args, **kw):
            import torch.distributed as dist

            before = kernels.launch_counts()
            out = fn(model, *args, **kw)
            after = kernels.launch_counts()
            seen[kind].append(({n: after[n] - before[n] for n in after},
                               type(model), dist.get_backend()))
            return out
        return call

    train_step, eval_step = train_utils.train_step, eval_utils.eval_step
    train_utils.train_step = counted("step", train_step)
    eval_utils.eval_step = counted("request", eval_step)
    kernels.reset_launch_counts()
    t0 = time.time()
    common = ["--cfg_file", str(cfg_path), "--batch_size", str(BATCH),
              "--workers", "1", "--extra_tag", "ddp", "--launcher", "pytorch"]
    try:
        run = train.main(common + ["--fix_random_seed", "--epochs", "1"])
        evals = test.main(common + ["--ckpt", "1"])
    finally:
        train_utils.train_step, eval_utils.eval_step = train_step, eval_step
        for k in env:
            del os.environ[k]
    counts = kernels.launch_counts()
    seconds = time.time() - t0
    if run["world_size"] != 1 or len(run["history"]) != 2:
        raise AssertionError(f"ddp pipeline: world {run['world_size']}, "
                             f"{len(run['history'])} steps (2 due)")
    if not (run["ckpt_dir"] / "checkpoint_1.pt").exists():
        raise AssertionError("ddp pipeline: checkpoint 1 was not written")
    for kind, want in (("step", DDP_STEP), ("request", DDP_REQUEST)):
        if len(seen[kind]) != 2:
            raise AssertionError(f"ddp pipeline: {len(seen[kind])} {kind}s")
        for i, (per, cls, backend) in enumerate(seen[kind]):
            if per != want or backend != "nccl":
                raise AssertionError(f"ddp pipeline {kind} {i}: launches "
                                     f"{per} != {want} or backend {backend}")
    if any(cls is not DistributedDataParallel for _, cls, _ in seen["step"]):
        raise AssertionError("ddp pipeline: the steps did not run under DDP")
    for h in run["history"]:
        if not math.isfinite(h["loss"]):
            raise AssertionError(f"ddp pipeline: loss {h['loss']}")
    metrics = evals[1]
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"ddp pipeline: non-finite metrics {bad}")
    result = run["output_dir"] / "eval" / "epoch_1"
    if not (result / "result.pkl").exists() or (result / "tmp_merge").exists():
        raise AssertionError("ddp pipeline: result.pkl missing or parts left")
    log(f"# ddp 9a: train_torch.py --launcher pytorch, world 1, NCCL, DDP + "
        f"SyncBN: synchronised steps {[round(h['step_s'], 4) for h in run['history']]} s "
        f"against phase 8's one-process {[round(s, 4) for s in one_card_steps]} s; "
        f"losses {[round(h['loss'], 4) for h in run['history']]}; launches a "
        f"step {seen['step'][0][0]} [{card}]")
    log(f"# ddp 9a: test_torch.py --launcher pytorch (merged parts): "
        f"{metrics['sec_per_example'] * 1e3:.2f} ms a frame, launches a request "
        f"{seen['request'][0][0]}; phase {seconds:.1f} s [{card}]")
    return counts


def per_frame_slots(np, scene, bsz, slots):
    """A packed scene (frames one after another) re-laid out in per-frame
    voxel slots of ``slots`` rows, as the collate gives it."""
    out = {"voxels": np.zeros((bsz * slots,) + scene["voxels"].shape[1:],
                              np.float32),
           "voxel_num_points": np.zeros(bsz * slots, np.float32),
           "voxel_coords": np.full((bsz * slots, 4), -1, np.int32),
           "voxel_valid": np.zeros(bsz * slots, bool)}
    b_col = scene["voxel_coords"][:, 0]
    for b in range(bsz):
        rows = np.nonzero(scene["voxel_valid"] & (b_col == b))[0][:slots]
        for k in out:
            out[k][b * slots:b * slots + len(rows)] = scene[k][rows]
    return out


def equal_count_gt(np, bsz, x_range, y_range, n, seed, max_gt):
    """``n`` boxes a frame, classes cycling 1, 2, 3: every frame, so every
    rank, has the same positives per class and head, and the mean of the
    ranks' losses is the loss of the batch."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((bsz, max_gt, 8), np.float32)
    for b in range(bsz):
        gt[b, :n, 0] = rng.uniform(*x_range, n)
        gt[b, :n, 1] = rng.uniform(*y_range, n)
        gt[b, :n, 2] = rng.uniform(-1.0, 1.0, n)
        gt[b, :n, 3:6] = rng.uniform(0.8, 4.0, (n, 3))
        gt[b, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[b, :n, 7] = np.arange(n) % 3 + 1
    return gt


def window_caps(np, frames, grid, params):
    """Each block's live windows a frame, at most, on ``frames`` (per-frame
    coordinate arrays (n, 4) b, z, y, x): the block-by-block window
    partition, compress blocks turning windows into the next voxels."""
    caps = []
    coords = [c[:, 1:] for c in frames]  # z, y, x
    g = np.asarray(grid)                   # x, y, z
    for p in params:
        w = np.asarray(p["window_size"][0])  # x, y, z
        full = (g // w) * w
        counts, nxt = [], []
        for c in coords:
            x, y, z = c[:, 2], c[:, 1], c[:, 0]
            ok = (x < full[0]) & (y < full[1]) & (z < full[2])
            win = np.unique(np.stack([z[ok] // w[2], y[ok] // w[1],
                                      x[ok] // w[0]], 1), axis=0)
            counts.append(len(win))
            nxt.append(win)
        caps.append(max(counts))
        if p["name"].endswith("CompressBlock"):
            coords, g = nxt, g // w
    return caps


def ddp_model(kind, bsz, caps):
    """Phase 9b's model on the card for ``bsz`` frames: the tiny f32 one or
    full-width mssvt.yaml (bf16), DropPath off (per-rank generators would
    drop other voxels than one generator over the batch) and each block's
    window cap raised to what the frames need (the frames of a batch share
    it, so a cap that drops windows drops other ones at batch 2 and 4)."""
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.models.model_utils.layers import DropPath

    if kind == "tiny":
        args, n_feat, _ = tiny_setup(17)
        cfg, extra = args[0], args[1:]
        grid, slots = args[3], TINY_SLOTS
    else:
        cfg = load_cfg("tools/cfgs/waymo_models/mssvt.yaml").MODEL
        extra = (3, CLASSES, GRID, VOXEL, PCR)
        n_feat, grid, slots = 5, GRID, WAYMO_SLOTS
    for p, cap in zip(cfg.BACKBONE_3D.PARAMS, caps):
        p["max_num_wins"] = max(int(p["max_num_wins"]), cap)
    if kind == "tiny":
        args = (cfg, *extra[:5], bsz, slots * bsz, 5)
    else:
        args = (cfg, *extra, bsz, slots * bsz, 5)
    model = build_network(*args, num_point_features=n_feat, device="cuda",
                          seed=11)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    return model



def ddp_sgd_step(torch, model, batch, rank=0):
    """One train_step with plain SGD after a warm-up forward and backward
    (the weights and statistics restored after it); (loss, gradient norm,
    gradients as one f32 vector on the CPU, launch counts, ms of the
    synchronised step)."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.parallel import dist
    from mssvt_tpu_torch.runtime.train_utils import forward_backward, train_step

    inner = dist.unwrap(model)
    start = {k: v.detach().clone() for k, v in inner.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(rank)
    forward_backward(model, batch, gen)  # warm-up, then the same start
    inner.load_state_dict(start)
    opt = torch.optim.SGD(model.parameters(), lr=DDP_LR)
    gen = torch.Generator(device="cuda").manual_seed(rank)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = train_step(model, opt, batch, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = grad_vector(torch, dist.unwrap(model)).cpu()
    return (float(loss), grads.norm().item(), grads,
            kernels.launch_counts(), ms)


def ddp_rank_step(kind, shards, caps):
    """Phase 9b's rank body (a spawned process): join the gloo group on
    card 0, one DDP step on this rank's frames."""
    import torch

    from mssvt_tpu_torch.parallel import dist
    from mssvt_tpu_torch.runtime.train_utils import set_deterministic

    rank, world = dist.init_distributed("pytorch", "cuda", backend="gloo",
                                        device_index=0)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        set_deterministic()
        batch = to_device(torch, shards[rank], "cuda")
        model = dist.wrap_ddp(ddp_model(kind, len(batch["gt_boxes"]), caps))
        res = ddp_sgd_step(torch, model, batch, rank)
        if kind != "tiny":
            res = res[:2] + (None,) + res[3:]
        return res + (torch.distributed.get_backend(), world)
    finally:
        dist.shutdown()


def ddp_ranks_check(torch, card):
    """Phase 9b: two gloo ranks on card 0, each one DDP step on its half of
    the batch, against the one-process step on the whole batch: the tiny
    f32 model (2 frames) per parameter, full-width mssvt.yaml bf16 (4
    frames) by loss and gradient norm. Returns {kind: rank launch counts}."""
    import functools

    import numpy as np

    from mssvt_tpu_torch.datasets.synthetic_scene import make_waymo_scale_scene
    from mssvt_tpu_torch.parallel import dist

    out = {}
    for kind in ("tiny", "full"):
        if kind == "tiny":
            args, _, _ = tiny_setup(17)
            rng = np.random.default_rng(5)
            bsz, grid, slots = 2, args[3], TINY_SLOTS
            frames = []
            for b in range(bsz):
                c = np.unique(np.stack([
                    np.full(TINY_VOXELS, b), rng.integers(0, grid[2], TINY_VOXELS),
                    rng.integers(0, grid[1], TINY_VOXELS),
                    rng.integers(0, grid[0], TINY_VOXELS)], 1), axis=0)
                frames.append(c.astype(np.int32))
            packed = np.concatenate(frames)
            n = len(packed)
            scene = {"voxel_coords": packed, "voxel_valid": np.ones(n, bool),
                     "voxels": rng.normal(size=(n, 5, 4)).astype(np.float32),
                     "voxel_num_points": rng.integers(1, 6, n).astype(np.float32)}
            gt = equal_count_gt(np, bsz, (1.0, 18.0), (-8.5, 8.5), 6, 5, 8)
            params = args[0].BACKBONE_3D.PARAMS
        else:
            bsz, grid, slots = BATCH, GRID, WAYMO_SLOTS
            scene, _ = make_waymo_scale_scene(slots * bsz, GRID, seed=4,
                                              batch=bsz)
            gt = equal_count_gt(np, bsz, (-70.0, 70.0), (-70.0, 70.0), 42, 6,
                                64)
            params = load_cfg("tools/cfgs/waymo_models/mssvt.yaml"
                              ).MODEL.BACKBONE_3D.PARAMS
        batch = per_frame_slots(np, scene, bsz, slots)
        batch["gt_boxes"] = gt
        frames = [batch["voxel_coords"][b * slots:(b + 1) * slots]
                  for b in range(bsz)]
        frames = [f[f[:, 0] >= 0] for f in frames]
        caps = window_caps(np, frames, grid, params)
        shards = []
        for r in range(2):
            half = bsz // 2
            sh = {k: np.array(v[r * half * slots:(r + 1) * half * slots])
                  for k, v in batch.items() if k != "gt_boxes"}
            sh["voxel_coords"][:, 0] = np.where(
                sh["voxel_coords"][:, 0] >= 0, sh["voxel_coords"][:, 0] - r * half,
                -1)
            sh["gt_boxes"] = gt[r * half:(r + 1) * half]
            shards.append(sh)
        t0 = time.time()
        ranks = dist.launch_local(functools.partial(
            ddp_rank_step, kind, shards, caps), 2, timeout_s=600)
        rank_s = time.time() - t0
        model = ddp_model(kind, bsz, caps)
        loss1, norm1, g1, counts1, ms1 = ddp_sgd_step(
            torch, model, to_device(torch, batch, "cuda"))
        del model
        torch.cuda.empty_cache()
        (la, na, ga, ca, msa, backend, world), (lb, nb, gb, cb, msb, _, _) = ranks
        if backend != "gloo" or world != 2 or la != lb or na != nb:
            raise AssertionError(f"ddp 9b {kind}: backend {backend}, world "
                                 f"{world}, rank losses {la}/{lb}, norms "
                                 f"{na}/{nb}")
        want = TINY_STEP if kind == "tiny" else DDP_STEP
        for who, c in (("rank 0", ca), ("rank 1", cb), ("one process", counts1)):
            if c != want:
                raise AssertionError(f"ddp 9b {kind} {who}: launches {c} != "
                                     f"{want}")
        rel = abs(la - loss1) / abs(loss1)
        nrel = abs(na - norm1) / norm1
        if kind == "tiny":
            if not torch.equal(ga, gb):
                raise AssertionError("ddp 9b tiny: ranks' gradients differ")
            # the SGD update of each parameter is LR x gradient: the JAX
            # suite's per-leaf DDP tolerance (atol 2e-5, rtol 1e-3 on the
            # updated parameters) on LR x the gradients
            err = (DDP_LR * (ga - g1)).abs()
            bound = 2e-5 + 1e-3 * (DDP_LR * g1).abs()
            if rel > 1e-5 or not bool((err <= bound).all()):
                raise AssertionError(
                    f"ddp 9b tiny: loss {la} vs {loss1} (relative {rel:.3g}), "
                    f"worst update error {err.max().item():.3g}")
            detail = (f"largest update difference "
                      f"{err.max().item():.3g} (bound 2e-5 + 1e-3 x |update|)")
        else:
            if rel > 1e-3 or nrel > 1e-2:
                raise AssertionError(
                    f"ddp 9b full width: loss {la} vs {loss1} (relative "
                    f"{rel:.3g}), gradient norm {na} vs {norm1} ({nrel:.3g})")
            detail = f"window caps a frame {caps}"
        log(f"# ddp 9b {kind}: 2 gloo ranks on cuda:0 (batch {bsz // 2} each) "
            f"vs one process (batch {bsz}): loss {la:.6f} vs {loss1:.6f} "
            f"(relative {rel:.3g}), gradient norm {na:.6g} vs {norm1:.6g} "
            f"(relative {nrel:.3g}); {detail}; rank step {msa:.1f}/{msb:.1f} "
            f"ms, one-process step {ms1:.1f} ms; ranks' launches {ca} (one "
            f"process {counts1}); spawn + step {rank_s:.1f} s [{card}]")
        out[kind] = ca
    return out


# pcdet layout from the flax layout (the inverse of the importer's
# pcdet -> flax transforms, named as in runtime/torch_import.py)
TO_PCDET = {
    "_t_linear": lambda f: f.T,
    "_t_conv2d": lambda f: f.transpose(3, 2, 0, 1),
    "_t_conv1d_k1": lambda f: f.T[:, :, None],
    "_t_deconv2d": lambda f: f[::-1, ::-1].transpose(2, 3, 0, 1),
}


def pcdet_state(np, model, seed):
    """A seeded pcdet-named ``model_state`` for the port ``model``: each
    tensor the importer maps gets a LeCun-scaled (kernels) or small random
    value in pcdet's layout, BatchNorm variances positive."""
    from mssvt_tpu_torch.bridge import to_flax_layout
    from mssvt_tpu_torch.runtime import torch_import as ti

    rng = np.random.default_rng(seed)
    leaves = list(ti.port_leaves(model))
    state, tensors = {}, model.state_dict()
    for key, mod, path in leaves:
        src, tf = ti.flax_to_torch_key(path)
        if src is None:
            continue
        if "LAST" in src:  # a head's output conv follows its conv tiers
            head = path[-2][:-len("_out")]
            tiers = {p[-2] for _, _, p in leaves
                     if p[:-2] == path[:-2] and p[-2].startswith(head + "_conv")}
            src = src.replace("LAST", str(len(tiers)))
        fs = to_flax_layout(mod, path[-1], tensors[key]).shape
        val = rng.normal(size=fs).astype(np.float32)
        if path[-1] == "kernel":
            val /= np.sqrt(np.prod(fs[:-1]))
        elif path[-1] == "var":
            val = 0.5 + np.abs(val)
        elif path[-1] == "scale":
            val = 1.0 + 0.1 * val
        else:
            val *= 0.1
        state[src] = np.array(TO_PCDET[tf.__name__](val) if tf else val,
                              order="C")
    return state


def demo_and_import(torch, card):
    """Phase 9c: tools/demo_torch.py on DEMO_FRAMES .npy frames of the synthetic
    scene (180 000 points, mssvt.yaml's voxelizer) at full width on the
    card, one request a frame; then tools/import_ckpt_torch.py on a seeded
    pcdet-named full-width state dict and one request from the imported
    weights. Returns the launch counts of the phase."""
    import math
    import shutil

    import numpy as np
    import yaml

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.datasets import build_dataset
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.runtime import eval_utils

    cfg_path = pipeline_config()
    cfg = yaml.safe_load(cfg_path.read_text())
    work = ROOT / "output" / "chip_smoke" / "demo"
    shutil.rmtree(work, ignore_errors=True)
    (work / "frames").mkdir(parents=True)
    ds = build_dataset(cfg["DATA_CONFIG"], CLASSES, training=False)
    for i in range(DEMO_FRAMES):
        np.save(work / "frames" / f"{i:06d}.npy", ds._make_scene(i)[0])

    seen = []
    eval_step = eval_utils.eval_step

    def counted(model, batch):
        before = kernels.launch_counts()
        out = eval_step(model, batch)
        after = kernels.launch_counts()
        seen.append({n: after[n] - before[n] for n in after})
        return out

    eval_utils.eval_step = counted
    kernels.reset_launch_counts()
    try:
        demo, importer = load_tool("demo_torch"), load_tool("import_ckpt_torch")
        common = ["--cfg_file", str(cfg_path), "--data_path",
                  str(work / "frames"), "--ext", ".npy"]
        dets, ms = demo.main(common + ["--out_file", str(work / "dets.pkl")])
        # a reference checkpoint: seeded pcdet-named tensors for mssvt.yaml
        model = build_network(load_cfg("tools/cfgs/waymo_models/mssvt.yaml")
                              .MODEL, 3, CLASSES, GRID, VOXEL, PCR, 1, 150_000,
                              5, num_point_features=5, device="cpu")
        state = pcdet_state(np, model, 12)
        del model
        ref = work / "checkpoint_epoch_30.pth"
        torch.save({"epoch": 30, "it": 100, "version": "pcdet",
                    "model_state": {k: torch.as_tensor(v) for k, v in
                                    state.items()}}, ref)
        path, report = importer.main(["--cfg_file", str(cfg_path), "--ckpt",
                                      str(ref), "--out", str(work / "ckpt")])
        imported, ms_imp = demo.main(common[:4] + ["--ext", ".npy",
                                                   "--ckpt", str(path)])
    finally:
        eval_utils.eval_step = eval_step
    counts = kernels.launch_counts()
    if len(seen) != 2 * DEMO_FRAMES or any(s != EXPECTED_LAUNCHES
                                           for s in seen):
        raise AssertionError(f"demo: requests' launches {seen} "
                             f"({2 * DEMO_FRAMES} of {EXPECTED_LAUNCHES} due)")
    for d in dets + imported:
        if not all(np.isfinite(d[k]).all() for k in ("boxes", "scores")):
            raise AssertionError(f"demo: non-finite detections in frame "
                                 f"{d['frame_id']}")
    missing = sorted(report["missing"])
    if (missing != ["backbone_3d.input_proj.bias",
                    "backbone_3d.input_proj.weight"]
            or report["unused"] or report["shape_mismatch"]):
        raise AssertionError(f"import: missing {missing}, unused "
                             f"{report['unused']}, shape mismatches "
                             f"{report['shape_mismatch']}")
    if not math.isfinite(ms) or not (work / "dets.pkl").exists():
        raise AssertionError("demo: no timing or no pickle")
    log(f"# demo 9c: demo_torch.py on {DEMO_FRAMES} synthetic frames "
        f"({len(np.load(work / 'frames' / '000000.npy'))} points each): ms a "
        f"frame (forward between synchronisations, batch 1) "
        f"{[round(d['ms'], 2) for d in dets]}, mean {ms:.2f}; detections "
        f"{[len(d['scores']) for d in dets]}; launches a request {seen[0]} "
        f"[{card}]")
    log(f"# import 9c: import_ckpt_torch.py on a seeded pcdet-named "
        f"mssvt.yaml state dict: {len(report['loaded'])} tensors loaded, "
        f"kept {missing}; one request a frame from the imported weights: "
        f"{[round(d['ms'], 2) for d in imported]} ms, detections "
        f"{[len(d['scores']) for d in imported]} [{card}]")
    return counts


def voxelizer_device_check(torch, card):
    """Phase 9d: voxelize_points_torch on a 180 000-point synthetic frame
    (two scenes of mssvt.yaml's voxelizer config overlaid) on the card against the host C++ voxelizer: the same voxels and counts,
    except where a point's float32 cell (the device's, as JAX's) differs
    from its float64 one (the host's); both timed."""
    import numpy as np
    import yaml

    from mssvt_tpu_torch.datasets import build_dataset
    from mssvt_tpu_torch.ops.voxelize import (
        voxelize_points,
        voxelize_points_torch,
    )

    cfg = yaml.safe_load(pipeline_config().read_text())
    ds = build_dataset(cfg["DATA_CONFIG"], CLASSES, training=False)
    # 180 000 points: two synthetic scenes overlaid
    pts = np.concatenate([ds._make_scene(i)[0] for i in (0, 1)])[:180_000]
    vs, pcr = tuple(ds.voxel_size), tuple(ds.point_cloud_range)
    p, cap = ds.max_points_per_voxel, 2 * len(pts)
    t0 = time.perf_counter()
    hv, hc, hn = voxelize_points(pts, vs, pcr, p, cap)
    host_ms = (time.perf_counter() - t0) * 1e3
    dp = torch.as_tensor(pts, device="cuda")
    valid = torch.ones(len(pts), dtype=torch.bool, device="cuda")
    call = lambda: voxelize_points_torch(dp, valid, vs, pcr, p, cap)
    dev_ms = time_ms(torch, call, reps=10)
    dv, dc, dn, dm = (t.cpu().numpy() for t in call())
    # each point's cell in float32 and in float64
    grid = np.round((np.asarray(pcr[3:]) - np.asarray(pcr[:3]))
                    / np.asarray(vs)).astype(np.int64)
    c32 = np.floor((pts[:, :3] - np.asarray(pcr[:3], np.float32))
                   / np.asarray(vs, np.float32)).astype(np.int64)
    c64 = np.floor((pts[:, :3].astype(np.float64) - np.asarray(pcr[:3]))
                   / np.asarray(vs)).astype(np.int64)
    moved = np.any(c32 != c64, axis=1)
    inside = lambda c: np.all((c >= 0) & (c < grid), axis=1)
    touched = {tuple(c[::-1]) for c in np.concatenate([c32[moved & inside(c32)],
                                                       c64[moved & inside(c64)]])}
    host = {tuple(c): min(int(n), p) for c, n in zip(hc, hn)}
    dev = {tuple(c[1:]): int(n) for c, n in zip(dc[dm], dn[dm])}
    bad = {c for c in set(host) | set(dev)
           if host.get(c) != dev.get(c) and c not in touched}
    if bad or len(dev) < 0.99 * len(host):
        raise AssertionError(f"voxelize_points_torch: {len(bad)} voxels "
                             f"differ from the host voxelizer's beyond the "
                             f"{int(moved.sum())} points whose float32 cell "
                             f"moved")
    nbytes = pts.nbytes + dv.nbytes + dc.nbytes + dn.nbytes + dm.nbytes
    log(f"# voxelize 9d: voxelize_points_torch on {len(pts)} points -> "
        f"{int(dm.sum())} voxels (host C++ {len(host)}); "
        f"{sum(host.get(c) == dev.get(c) for c in host)} voxels equal, "
        f"{int(moved.sum())} points in another float32 than float64 cell; "
        f"card {dev_ms:.3f} ms (CUDA events, 10 calls; {nbytes / 2**20:.1f} "
        f"MiB in and out), host C++ {host_ms:.1f} ms [{card}]")


# -------------------------------------------------------------- phase 10
# SECOND and PointPillar (kitti_models/second.yaml, pointpillar.yaml): no
# TPU kernel stands on their path, so each step and request launches none
KITTI_MODELS = ("second", "pointpillar")
KITTI_STEP = KITTI_REQUEST = launches()
# 10b's DATA_CONFIG: kitti_dataset.yaml's processors (range, 4 point
# features, voxelizer, caps 16 000 / 40 000, world flip/rotation/scaling)
# on synthetic frames: this recipe's 100 000 give ~61 000 points a frame
# inside the range (half ground, a tenth noise, objects)
KITTI_DATA = {"DATASET": "SyntheticDataset", "NUM_FRAMES": 8,
              "POINTS_PER_FRAME": 100_000}
KITTI_BEV = {"second": 128, "pointpillar": 64}  # the 2D backbone's input
KITTI_TINY_GRID = 32  # 10a: 32 x 32 (x 32) cells of 0.4 m


def kitti_tiny(name, seed):
    """10a: ``kitti_models/<name>.yaml`` at narrow widths on a 12.8 m range
    of 32 x 32 (x 32) cells, and a seeded 2-frame scene of up to 256 voxels
    a frame with GT boxes of the three classes: (build args, scene)."""
    import numpy as np

    cfg = load_cfg(f"tools/cfgs/kitti_models/{name}.yaml")
    m, pillar = cfg.MODEL, name == "pointpillar"
    g = KITTI_TINY_GRID
    pcr = (0.0, -6.4, -3.0, 12.8, 6.4, 1.0)
    grid, vs = ((g, g, 1), (0.4, 0.4, 4.0)) if pillar else \
        ((g, g, g), (0.4, 0.4, 0.125))
    if pillar:
        m.VFE.NUM_FILTERS = [16]
        m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    else:
        m.BACKBONE_3D.NUM_FILTERS = [8, 16, 16, 16]
        m.BACKBONE_3D.OUT_CHANNELS = 16
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], NUM_FILTERS=[16, 16],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[16, 16])
    m.POST_PROCESSING.NMS_CONFIG.update(NMS_PRE_MAXSIZE=256,
                                        NMS_POST_MAXSIZE=64)
    rng = np.random.default_rng(seed)
    bsz, slots, pts = 2, 256, 5 if not pillar else 32
    n = 300
    cells = np.unique(np.stack([
        rng.integers(0, bsz, n), rng.integers(0, grid[2], n),
        rng.integers(0, g, n), rng.integers(0, g, n)], 1), axis=0)
    coords = np.full((bsz * slots, 4), -1, np.int32)
    valid = np.zeros(bsz * slots, bool)
    for b in range(bsz):
        cb = cells[cells[:, 0] == b][:slots]
        coords[b * slots:b * slots + len(cb)] = cb
        valid[b * slots:b * slots + len(cb)] = True
    num = (rng.integers(1, pts + 1, bsz * slots) * valid).astype(np.float32)
    mask = np.arange(pts)[None, :] < num[:, None]
    xyz = ((coords[:, None, [3, 2, 1]] + rng.uniform(0, 1, (bsz * slots,
                                                           pts, 3)))
           * vs + pcr[:3])
    voxels = np.concatenate([xyz, rng.uniform(0, 1, (bsz * slots, pts, 1))],
                            -1).astype(np.float32) * mask[..., None]
    gt = np.zeros((bsz, 6, 8), np.float32)
    sizes = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}
    for b in range(bsz):
        for j in range(4):
            cls = j % 3 + 1
            gt[b, j] = [rng.uniform(2, 11), rng.uniform(-4.5, 4.5), -1.0,
                        *sizes[cls], rng.uniform(-np.pi, np.pi), cls]
    scene = {"voxels": voxels, "voxel_num_points": num,
             "voxel_coords": coords, "voxel_valid": valid, "gt_boxes": gt}
    return (cfg, (cfg.MODEL, 3, list(cfg.CLASS_NAMES), grid, vs, pcr, bsz,
                  slots, pts)), scene


def kept_box_sets_error(a, b, relative=False):
    """(boxes kept a frame in total, largest difference) between two
    detectors' outputs compared as sets a frame: the rows (box, score,
    label) of the kept boxes sorted, since NMS keeps equal-score boxes in
    index order and scores equal within rounding may order either way.
    With ``relative`` each difference is over max(1, |b's value|) (refined
    boxes of seeded heads reach hundreds of metres). Inf when the counts
    differ."""
    import numpy as np

    worst, total = 0.0, 0
    for f in range(a["final_mask"].shape[0]):
        rows = []
        for o in (a, b):
            m = o["final_mask"][f].cpu().numpy()
            r = np.concatenate([o["final_boxes"][f].cpu().numpy()[m],
                                o["final_scores"][f].cpu().numpy()[m, None],
                                o["final_labels"][f].cpu().numpy()[m, None]],
                               1).astype(np.float64)
            rows.append(r[np.lexsort(np.round(r, 3).T[::-1])])
        if rows[0].shape != rows[1].shape:
            return total, float("inf")
        total += len(rows[0])
        if len(rows[0]):
            d = np.abs(rows[0] - rows[1])
            if relative:
                d = d / np.maximum(1.0, np.abs(rows[1]))
            worst = max(worst, float(d.max()))
    return total, worst


def kitti_tiny_models(torch, args, scene, seed):
    """10a's model on the CPU and on the card with equal seeded weights:
    its BatchNorm statistics are those of one train-mode forward of the
    scene (momentum 0 for it: with LeCun-initialised sparse convs on a
    sparse scene the features fade by orders of magnitude each layer, and
    scores then tie at 0.5 within rounding), and its classification bias
    is zero, so that boxes pass the score threshold."""
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.models.model_utils.layers import BatchNorm

    cpu = build_network(*args, num_point_features=4, device="cpu", seed=seed)
    bns = [m for m in cpu.modules() if isinstance(m, BatchNorm)]
    moms = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    with torch.no_grad():
        cpu.train()(to_device(torch, scene, "cpu"))
        cpu.dense_head.conv_cls.bias.zero_()
    for m, mom in zip(bns, moms):
        m.momentum = mom
    card = build_network(*args, num_point_features=4, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu.eval(), card


def kitti_tiny_reference(torch):
    """10a: tiny f32 SECOND and PointPillar on the card against the CPU
    plain path on the same weights (``kitti_tiny_models``): the kept boxes
    of each frame, as sets, within 1e-3, then
    one ``train_step`` each (adam_onecycle): the loss within 1e-4 relative
    and the gradient norm within 1e-3; no kernel of K1-K7 launched."""
    import math

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import train_step

    for name in KITTI_MODELS:
        (cfg, args), scene = kitti_tiny(name, 23)
        res = {}
        kernels.reset_launch_counts()
        models = dict(zip(("cpu", "cuda"),
                          kitti_tiny_models(torch, args, scene, 5)))
        for dev, model in models.items():
            batch = to_device(torch, scene, dev)
            with torch.no_grad():
                out = model(batch)
            opt, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                                     total_steps=10, steps_per_epoch=5)
            loss, _ = train_step(model, opt, batch,
                                 torch.Generator(device=dev))
            gnorm = math.sqrt(sum(float((p.grad.double() ** 2).sum())
                                  for p in model.parameters()))
            res[dev] = (out, float(loss), gnorm)
        torch.cuda.synchronize()
        (oc, lc, gc), (og, lg, gg) = res["cpu"], res["cuda"]
        n_kept, err = kept_box_sets_error(oc, og)
        if n_kept == 0 or err > 1e-3:
            raise AssertionError(f"10a {name}: {n_kept} boxes, error {err}")
        rel, grel = abs(lg - lc) / abs(lc), abs(gg - gc) / gc
        if rel > 1e-4 or grel > 1e-3 or not math.isfinite(lg):
            raise AssertionError(f"10a {name}: loss {lg} vs {lc}, gradient "
                                 f"norm {gg} vs {gc}")
        counts = kernels.launch_counts()
        if counts != KITTI_STEP:
            raise AssertionError(f"10a {name}: launches {counts}")
        log(f"# 10a tiny {name} (f32): {n_kept} boxes agree within "
            f"{err:.3g}; one train_step: loss card {lg:.6f} vs CPU "
            f"{lc:.6f} (relative {rel:.3g}), gradient norm {gg:.6g} vs "
            f"{gc:.6g} (relative {grel:.3g}); launches: none")


def kitti_config(name):
    """10b: ``kitti_models/<name>.yaml`` with KITTI_DATA and gt_sampling
    disabled (no db-info file exists), written under output/."""
    import yaml

    cfg = json.loads(json.dumps(load_cfg(f"tools/cfgs/kitti_models/{name}.yaml")))
    cfg["DATA_CONFIG"].update(KITTI_DATA)
    cfg["DATA_CONFIG"]["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = ["gt_sampling"]
    path = ROOT / "output" / "chip_smoke" / "cfgs" / "kitti" / f"{name}_synthetic.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def profile_kitti_request(torch, model, batch, name, card):
    """One request of the trained model, synchronised around the anchor
    post-processing (max over classes, score threshold, greedy rotated
    NMS over NMS_PRE_MAXSIZE candidates a frame): its share of the
    request by the host clock and, under ``torch.profiler``, by device
    kernel time; then the request's peak memory with the pairwise IoU in
    row blocks (``ops.nms.IOU_BLOCK_PAIRS``) and at once."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mssvt_tpu_torch.models.detectors import generic_post
    from mssvt_tpu_torch.ops import nms
    from mssvt_tpu_torch.runtime.eval_utils import eval_step

    post = generic_post.post_process_anchor
    spans = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("anchor_post_process"):
            out = post(*a, **kw)
            torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return out

    generic_post.post_process_anchor = timed
    try:
        eval_step(model, batch)  # warm
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_step(model, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        post_s = spans[-3:]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eval_step(model, batch)
            torch.cuda.synchronize()
    finally:
        generic_post.post_process_anchor = post
    evs = prof.events()
    # the range's device-side annotation spans its kernels: no kernel
    kern = [e for e in evs if "CUDA" in str(getattr(e, "device_type", ""))
            and e.name != "anchor_post_process"
            and not getattr(e, "is_user_annotation", False)]
    dev_all = sum(e.self_device_time_total for e in kern) / 1e3
    spans_ = [e.time_range for e in evs if e.name == "anchor_post_process"
              and "CPU" in str(getattr(e, "device_type", ""))]
    if spans_:  # kernels that started inside the synchronised span
        inside = [e for e in kern
                  if spans_[0].start <= e.time_range.start <= spans_[0].end]
        dev_post = (f"{sum(e.self_device_time_total for e in inside) / 1e3:.3f}"
                    f" ms of them in {len(inside)} post-processing kernels")
    else:
        dev_post = "the post-processing's share not measured (no span)"
    share = [p / w for p, w in zip(post_s, walls)]
    log(f"# 10b {name} request: synchronised {[round(w, 4) for w in walls]} s"
        f", of which the anchor post-processing (NMS) "
        f"{[round(p, 4) for p in post_s]} s = "
        f"{[round(100 * x, 1) for x in share]}% (host clock); profiled: "
        f"device kernels {dev_all:.3f} ms over {len(kern)} kernels, "
        f"{dev_post} [{card}]")
    peaks = {}
    for label, pairs in (("row blocks", nms.IOU_BLOCK_PAIRS),
                         ("at once", 1 << 62)):
        saved, nms.IOU_BLOCK_PAIRS = nms.IOU_BLOCK_PAIRS, pairs
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            eval_step(model, batch)
            torch.cuda.synchronize()
            peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2**30
        finally:
            nms.IOU_BLOCK_PAIRS = saved
    log(f"# 10b {name} request peak above the resident model and batch: "
        f"IoU in row blocks {peaks['row blocks']:.2f} GiB, at once "
        f"{peaks['at once']:.2f} GiB [{card}]")
    return walls, post_s


def kitti_pipeline(torch, card):
    """10b: for SECOND and PointPillar at full KITTI width,
    ``tools/train_torch.py`` in-process for one epoch (2 steps at batch 4)
    and ``tools/test_torch.py`` on its checkpoint (2 requests at batch 4),
    on the card; each step's and request's launches (none), finite losses
    and metrics; prints voxels a frame against the caps, the BEV width,
    each synchronised step and request, the NMS share of a request and the
    peak memory."""
    import math
    import shutil

    import yaml

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.datasets import build_dataset
    from mssvt_tpu_torch.runtime import eval_utils, train_utils

    t_phase = time.time()
    out_root = ROOT / "output" / "chip_smoke" / "kitti_runs"
    shutil.rmtree(out_root, ignore_errors=True)
    os.environ["MSSVT_OUTPUT_ROOT"] = str(out_root)
    train, test = load_tool("train_torch"), load_tool("test_torch")
    train_step, eval_step = train_utils.train_step, eval_utils.eval_step
    try:
        for name in KITTI_MODELS:
            cfg_path = kitti_config(name)
            cfg = yaml.safe_load(cfg_path.read_text())
            seen = {"step": [], "request": []}

            def counted(kind, fn):
                def call(model, *args, **kw):
                    before = kernels.launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(model, *args, **kw)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    after = kernels.launch_counts()
                    batch = args[1] if kind == "step" else args[0]
                    seen[kind].append(({n: after[n] - before[n] for n in after},
                                       batch, dt, model))
                    return out
                return call

            train_utils.train_step = counted("step", train_step)
            eval_utils.eval_step = counted("request", eval_step)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            common = ["--cfg_file", str(cfg_path), "--batch_size", str(BATCH),
                      "--workers", "1", "--extra_tag", "smoke"]
            run = train.main(common + ["--fix_random_seed", "--epochs", "1"])
            train_peak = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            metrics = test.main(common + ["--ckpt", "1"])[1]
            eval_peak = torch.cuda.max_memory_allocated() / 2**30
            seconds = time.time() - t0
            train_utils.train_step, eval_utils.eval_step = train_step, eval_step
            hist = run["history"]
            if len(hist) != 2 or len(seen["step"]) != 2 or \
                    len(seen["request"]) != 2:
                raise AssertionError(f"10b {name}: {len(hist)} steps, "
                                     f"{len(seen['request'])} requests (2, 2)")
            if not all(math.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"10b {name}: losses {hist}")
            bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
            if bad:
                raise AssertionError(f"10b {name}: non-finite metrics {bad}")
            for kind in ("step", "request"):
                for i, (per, *_rest) in enumerate(seen[kind]):
                    if per != KITTI_STEP:
                        raise AssertionError(f"10b {name} {kind} {i}: "
                                             f"launches {per}")
            model = seen["request"][-1][3]
            bev = (model.backbone_3d.num_bev_features if name == "second"
                   else model.map_to_bev.num_bev_features)
            if bev != KITTI_BEV[name] or \
                    model.backbone_2d.block0_conv0.in_channels != bev:
                raise AssertionError(f"10b {name}: BEV width {bev}")
            proc = cfg["DATA_CONFIG"]["DATA_PROCESSOR"][-1]
            caps = proc["MAX_NUMBER_OF_VOXELS"]
            pts = len(build_dataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"],
                                    training=False)._make_scene(0)[0])
            for kind, split in (("step", "train"), ("request", "test")):
                vox = [v for _, b, *_r in seen[kind] for v in
                       b["voxel_valid"].reshape(BATCH, -1).sum(1).tolist()]
                log(f"# 10b {name} {split}: voxels a frame min {min(vox)}, "
                    f"max {max(vox)} against the cap {caps[split]} "
                    f"({len(vox)} frames of ~{pts} points)")
            log(f"# 10b {name}: BEV map {bev} channels into the 2D backbone; "
                f"synchronised steps {[round(s[2], 4) for s in seen['step']]}"
                f" s (losses {[round(h['loss'], 4) for h in hist]}), requests "
                f"{[round(s[2], 4) for s in seen['request']]} s; peak device "
                f"memory train {train_peak:.2f} GiB, eval {eval_peak:.2f} GiB;"
                f" entry points {seconds:.1f} s; launches of K1-K7 "
                f"{sum(sum(p.values()) for p, *_r in seen['step'])} over the"
                f" steps, {sum(sum(p.values()) for p, *_r in seen['request'])}"
                f" over the requests [{card}]")
            profile_kitti_request(torch, model, seen["request"][-1][1], name,
                                  card)
            del model, seen, run
            torch.cuda.empty_cache()
    finally:
        train_utils.train_step, eval_utils.eval_step = train_step, eval_step
        del os.environ["MSSVT_OUTPUT_ROOT"]
    log(f"# 10b: phase {time.time() - t_phase:.1f} s [{card}]")


# -------------------------------------------------------------- phase 11
# the file-backed datasets: seeded trees in WaymoDataset's and
# KittiDataset's on-disk layouts (no dataset file ships with the repo) under
# output/chip_smoke/data/, read through the shipped dataset configs with
# gt_sampling on from a database the port wrote. 11a: waymo_dataset.yaml
# keeps SAMPLED_INTERVAL (train 5, test 1), so 40 train frames give 8 (2
# steps at batch 4) and 8 val frames 2 requests; 11b: 8 train and 4 val
# KITTI frames (2 steps, 1 request).
FILES_DATA = ROOT / "output" / "chip_smoke" / "data"
WAYMO_FILES = dict(train=(["seq_00", "seq_01"], 20), val=(["seq_10"], 8),
                   points=180_000)
KITTI_FILES = dict(train=[f"{i:06d}" for i in range(8)],
                   val=[f"{i:06d}" for i in range(8, 12)], points=120_000)
WAYMO_DB = "pcdet_waymo_dbinfos_train_sampled_1.pkl"


def files_config(model_yaml, data, name, db_info=None):
    """``model_yaml`` with its DATA_CONFIG updated by ``data``, gt_sampling
    left on (reading ``db_info`` if given), written under output/; returns
    (path, config)."""
    import yaml

    cfg = json.loads(json.dumps(load_cfg(model_yaml)))
    cfg["DATA_CONFIG"].update(data)
    aug = cfg["DATA_CONFIG"]["DATA_AUGMENTOR"]
    sampler = aug["AUG_CONFIG_LIST"][0]
    if sampler["NAME"] != "gt_sampling" or \
            "gt_sampling" in aug["DISABLE_AUG_LIST"]:
        raise AssertionError(f"{name}: gt_sampling is not on: {aug}")
    if db_info is not None:
        sampler["DB_INFO_PATH"] = [db_info]
    path = ROOT / "output" / "chip_smoke" / "cfgs" / "files" / f"{name}.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def drive_files_entry_points(torch, cfg_path, out_root, label, batch=BATCH):
    """``tools/train_torch.py`` for one epoch and ``tools/test_torch.py`` on
    its checkpoint at ``batch`` frames, in-process on the card, with the
    launch counts set to 0 just before; each step's and request's launches,
    synchronised seconds and batch, the objects gt_sampling pasted into
    each training frame, the peaks of training and eval, and the models the
    last step and request ran. Returns a dict of those."""
    import math
    import shutil

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.datasets import augmentor
    from mssvt_tpu_torch.runtime import eval_utils, train_utils

    shutil.rmtree(out_root, ignore_errors=True)
    os.environ["MSSVT_OUTPUT_ROOT"] = str(out_root)
    train, test = load_tool("train_torch"), load_tool("test_torch")
    seen = {"step": [], "request": [], "pasted": []}

    def counted(kind, fn):
        def call(model, *args, **kw):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(model, *args, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = kernels.launch_counts()
            batch = args[1] if kind == "step" else args[0]
            seen[kind].append(({n: after[n] - before[n] for n in after},
                               batch, dt))
            seen[f"{kind}_model"] = model
            return out
        return call

    sample = augmentor.DataBaseSampler.__call__

    def pasting(self, data_dict):
        n = len(data_dict["gt_boxes"])
        out = sample(self, data_dict)
        seen["pasted"].append(len(out["gt_boxes"]) - n)
        return out

    train_step, eval_step = train_utils.train_step, eval_utils.eval_step
    train_utils.train_step = counted("step", train_step)
    eval_utils.eval_step = counted("request", eval_step)
    augmentor.DataBaseSampler.__call__ = pasting
    common = ["--cfg_file", str(cfg_path), "--batch_size", str(batch),
              "--workers", "1", "--extra_tag", "smoke"]
    try:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        run = train.main(common + ["--fix_random_seed", "--epochs", "1"])
        seen["train_peak"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        seen["metrics"] = test.main(common + ["--ckpt", "1"])[1]
        seen["eval_peak"] = torch.cuda.max_memory_allocated() / 2**30
        seen["seconds"] = time.time() - t0
        seen["counts"] = kernels.launch_counts()
    finally:
        train_utils.train_step, eval_utils.eval_step = train_step, eval_step
        augmentor.DataBaseSampler.__call__ = sample
        del os.environ["MSSVT_OUTPUT_ROOT"]
    seen["run"] = run
    seen["result"] = run["output_dir"] / "eval" / "epoch_1" / "result.pkl"
    hist = run["history"]
    if len(hist) != 2 or len(seen["step"]) != 2:
        raise AssertionError(f"{label}: {len(hist)} steps (2 due)")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"{label}: losses {hist}")
    bad = {k: v for k, v in seen["metrics"].items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {bad}")
    if not seen["result"].exists():
        raise AssertionError(f"{label}: {seen['result']} was not written")
    if not seen["pasted"] or max(seen["pasted"]) == 0:
        raise AssertionError(f"{label}: gt_sampling pasted nothing "
                             f"{seen['pasted']}")
    return seen


def loader_line(seen, cfg, label, card, batch=BATCH):
    """The loader against the step, voxels a frame against the caps and the
    objects pasted a frame (``# 11a``/``# 11b``/``# 12b`` lines)."""
    run = seen["run"]
    make = run["loader_make_seconds"]
    caps = cfg["DATA_CONFIG"]["DATA_PROCESSOR"][-1]["MAX_NUMBER_OF_VOXELS"]
    for kind, split in (("step", "train"), ("request", "test")):
        vox = [v for _, b, _ in seen[kind]
               for v in b["voxel_valid"].reshape(batch, -1).sum(1).tolist()]
        log(f"# {label} {split}: voxels a frame min {min(vox)}, max "
            f"{max(vox)} against the cap {caps[split]} ({len(vox)} frames)")
    pasted = seen["pasted"]
    log(f"# {label} gt_sampling: objects pasted a frame {pasted} (mean "
        f"{sum(pasted) / len(pasted):.1f})")
    log(f"# {label} train: loader host seconds a batch (file reads, "
        f"gt_sampling, augmentation, voxelizer, collate) "
        f"{[round(x, 4) for x in make]}; the step's wait for it "
        f"{[round(h['data_s'], 4) for h in run['history']]}; synchronised "
        f"step {[round(s[2], 4) for s in seen['step']]} s; losses "
        f"{[round(h['loss'], 4) for h in run['history']]} [{card}]")
    log(f"# {label} eval: {seen['metrics']['sec_per_example'] * 1e3:.2f} ms a "
        f"frame; synchronised requests "
        f"{[round(s[2], 4) for s in seen['request']]} s; peak device memory "
        f"train {seen['train_peak']:.2f} GiB, eval {seen['eval_peak']:.2f} "
        f"GiB [{card}]")


def loader_breakdown(dataset, data_cfg, label, card):
    """The host seconds of BATCH training items of a fresh dataset (file
    reads, no shared-memory cache, as the first epoch) and their collate,
    split by stage: the frame read, each augmentor, each processor."""
    spent = {}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    dataset.get_lidar = timed("read", dataset.get_lidar)
    aug = data_cfg["DATA_AUGMENTOR"]
    names = [c["NAME"] for c in aug["AUG_CONFIG_LIST"]
             if c["NAME"] not in aug["DISABLE_AUG_LIST"]]
    for queue, stages in (
            (dataset.data_augmentor.data_augmentor_queue, names),
            (dataset.data_processor.data_processor_queue,
             [c["NAME"] for c in data_cfg["DATA_PROCESSOR"]])):
        if len(queue) != len(stages):
            raise AssertionError(f"{label}: stages {stages} for {queue}")
        queue[:] = [timed(n, fn) for n, fn in zip(stages, queue)]
    items, per_item = [], []
    t_all = time.perf_counter()
    for i in range(BATCH):
        t0 = time.perf_counter()
        items.append(dataset[i])
        per_item.append(time.perf_counter() - t0)
    timed("collate", dataset.collate_batch)(items)
    total = time.perf_counter() - t_all
    log(f"# {label} loader breakdown: {BATCH} training items "
        f"{[round(t, 4) for t in per_item]} s + collate, {total:.4f} s host: "
        + ", ".join(f"{k} {v:.4f}" for k, v in spent.items())
        + f", the rest {total - sum(spent.values()):.4f} s [{card}]")


def waymo_files_path(torch, card):
    """11a: ``mssvt.yaml`` at full width, bf16, batch 4, trained and served
    from a file-backed ``WaymoDataset`` (NLZ filter, tanh, SAMPLED_INTERVAL,
    gt_sampling from the port's database, the shared-memory cache under
    output/), its official Waymo metrics from ``result.pkl``, the staged
    read against the file read. Returns the launch counts of the phase."""
    import math
    import pickle
    import shutil

    import numpy as np

    from mssvt_tpu_torch.datasets.synthetic_files import write_waymo_tree
    from mssvt_tpu_torch.datasets.waymo import WaymoDataset
    from mssvt_tpu_torch.utils.edict import EasyDict

    t_phase = time.time()
    root = FILES_DATA / "waymo"
    shutil.rmtree(root, ignore_errors=True)
    for seed, split in enumerate(("train", "val")):
        seqs, frames = WAYMO_FILES[split]
        write_waymo_tree(root, {split: seqs}, frames, WAYMO_FILES["points"],
                         seed=seed)
    t_write = time.time() - t_phase
    shm = FILES_DATA / "shm"
    shutil.rmtree(shm, ignore_errors=True)
    # the database the port writes (waymo_dataset.yaml names another file)
    cfg_path, cfg = files_config(
        "tools/cfgs/waymo_models/mssvt.yaml",
        {"DATA_PATH": str(root), "USE_SHARED_MEMORY": True,
         "SHARED_MEMORY_ROOT": str(shm)}, "mssvt_waymo_files", WAYMO_DB)
    data = cfg["DATA_CONFIG"]
    t0 = time.time()
    prep = WaymoDataset(EasyDict(dict(data, USE_SHARED_MEMORY=False)),
                        CLASSES, training=False, seed=0)
    prep.set_split("train")
    prep.include_waymo_data("train")
    prep.create_groundtruth_database(used_classes=CLASSES, split="train",
                                     sampled_interval=1)
    t_db = time.time() - t0
    with open(root / WAYMO_DB, "rb") as f:
        db = pickle.load(f)
    raw = [np.load(root / "waymo_processed_data" / i["point_cloud"][
        "lidar_sequence"] / f"{i['point_cloud']['sample_idx']:04d}.npy")
        for i in prep.infos[::5]]
    kept = [int((r[:, 5] == -1).sum()) for r in raw]
    log(f"# 11a tree: {sum(len(v[0]) * v[1] for v in (WAYMO_FILES['train'], WAYMO_FILES['val']))} "
        f"frames written in {t_write:.1f} s; points a frame in the file "
        f"{min(len(r) for r in raw)}-{max(len(r) for r in raw)}, after the "
        f"no-label-zone filter {min(kept)}-{max(kept)}; GT database "
        f"{ {str(k): len(v) for k, v in db.items()} } objects from "
        f"{len(prep.infos)} frames in {t_db:.1f} s")

    seen = drive_files_entry_points(
        torch, cfg_path, ROOT / "output" / "chip_smoke" / "files_runs", "11a")
    for kind, want in (("step", PIPELINE_STEP), ("request", PIPELINE_REQUEST)):
        if len(seen[kind]) != 2:
            raise AssertionError(f"11a: {len(seen[kind])} {kind}s (2 due)")
        for i, (per, *_r) in enumerate(seen[kind]):
            if per != want:
                raise AssertionError(f"11a {kind} {i}: launches {per} != "
                                     f"{want}")
    loader_line(seen, cfg, "11a", card)
    loader_breakdown(WaymoDataset(EasyDict(dict(data, USE_SHARED_MEMORY=False)),
                                  CLASSES, training=True, seed=0),
                     data, "11a", card)

    with open(seen["result"], "rb") as f:
        dets = pickle.load(f)
    val = WaymoDataset(EasyDict(data), CLASSES, training=False, seed=0)
    if len(dets) != len(val):
        raise AssertionError(f"11a: {len(dets)} results, {len(val)} frames")
    gt_annos = []
    for info in val.infos:
        a = info["annos"]
        keep = np.isin(a["name"], CLASSES)
        gt_annos.append({"boxes": a["gt_boxes_lidar"][keep],
                         "labels": np.array([CLASSES.index(n) + 1
                                             for n in a["name"][keep]])})
    t0 = time.perf_counter()
    report, official = val.evaluation(
        WaymoDataset.generate_prediction_dicts(dets, CLASSES), CLASSES,
        eval_metric="waymo", gt_annos=gt_annos)
    t_official = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, proxy = val.evaluation(dets, CLASSES, gt_annos=gt_annos)
    t_proxy = time.perf_counter() - t0
    keys = [f"OBJECT_TYPE_TYPE_{c}_LEVEL_{lv}/{m}"
            for c in ("VEHICLE", "PEDESTRIAN", "CYCLIST") for lv in (1, 2)
            for m in ("AP", "APH")]
    if sorted(official) != sorted(keys) or not all(
            math.isfinite(official[k]) and 0 <= official[k] <= 1
            for k in keys):
        raise AssertionError(f"11a: official metrics {official}")
    aps = {k: v for k, v in proxy.items() if "_ap_" in k or k == "mAP"}
    if len(aps) != 4 or not all(math.isfinite(v) and 0 <= v <= 1
                                for v in aps.values()):
        raise AssertionError(f"11a: proxy metrics {proxy}")
    log(f"# 11a official Waymo eval (numpy protocol, Hungarian matching): "
        f"{t_official:.2f} s host for {len(dets)} frames of "
        f"{sum(len(d['scores']) for d in dets)} boxes; the KITTI-style "
        f"proxy {t_proxy:.2f} s; metrics (seeded weights, 1 epoch: "
        f"meaningless but finite) "
        f"{ {k.replace('OBJECT_TYPE_TYPE_', ''): round(v, 4) for k, v in official.items()} }, "
        f"proxy { {k: round(v, 4) for k, v in aps.items()} }")

    # a fresh instance reads a frame the training run staged, twice (the
    # shared staging, then its own dict); the file read beside it
    fresh = WaymoDataset(EasyDict(data), CLASSES, training=True, seed=0)
    pc = fresh.infos[0]["point_cloud"]
    seq, idx = pc["lidar_sequence"], pc["sample_idx"]
    if fresh._lidar_cache:
        raise AssertionError("11a: a fresh dataset holds cached frames")
    reads = []
    for _ in range(2):
        t0 = time.perf_counter()
        pts = fresh.get_lidar(seq, idx)
        reads.append((time.perf_counter() - t0) * 1e3)
    plain = WaymoDataset(EasyDict(dict(data, USE_SHARED_MEMORY=False)),
                         CLASSES, training=True, seed=0)
    t0 = time.perf_counter()
    want = plain.get_lidar(seq, idx)
    file_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(pts, want):
        raise AssertionError("11a: the staged frame differs from the file's")
    staged = {d.name: len(list(d.glob("*.npy")))
              for d in sorted((shm / "mssvt_waymo_cache").iterdir())}
    fresh.clean_shared_memory()
    val.clean_shared_memory()
    if list(shm.rglob("*.npy")):
        raise AssertionError("11a: clean_shared_memory left staged files")
    log(f"# 11a shared-memory cache: frames staged {staged}; a "
        f"fresh instance's read of {seq}/{idx:04d} ({len(pts)} points) "
        f"{reads[0]:.2f} ms staged, {reads[1]:.2f} ms from its own dict, "
        f"against {file_ms:.2f} ms from the file (load, NLZ filter, tanh); "
        f"cleaned [{card}]")
    log(f"# 11a: entry points {seen['seconds']:.1f} s; phase "
        f"{time.time() - t_phase:.1f} s [{card}]")
    log(f"# 11a launches: {seen['counts']}")
    return seen["counts"]


def kitti_files_path(torch, card):
    """11b: ``kitti_models/second.yaml`` at its published width, f32, batch
    4, trained and served from a file-backed ``KittiDataset`` (FOV filter,
    labels without DontCare, gt_sampling from ``create_kitti_infos``'s
    database), then the official R40 evaluation of ``result.pkl`` with its
    camera fields; no step or request launches a kernel of K1-K7."""
    import pickle
    import shutil

    from mssvt_tpu_torch.datasets.kitti import KittiDataset, create_kitti_infos
    from mssvt_tpu_torch.datasets.synthetic_files import write_kitti_tree
    from mssvt_tpu_torch.utils.edict import EasyDict

    t_phase = time.time()
    root = FILES_DATA / "kitti"
    shutil.rmtree(root, ignore_errors=True)
    write_kitti_tree(root, KITTI_FILES["train"], KITTI_FILES["val"],
                     KITTI_FILES["points"], seed=0)
    t_write = time.time() - t_phase
    cfg_path, cfg = files_config("tools/cfgs/kitti_models/second.yaml",
                                 {"DATA_PATH": str(root)}, "second_kitti_files")
    data = EasyDict(cfg["DATA_CONFIG"])
    classes = cfg["CLASS_NAMES"]
    t0 = time.time()
    create_kitti_infos(data, classes, root, root)
    t_infos = time.time() - t0
    with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)
    ds = KittiDataset(data, classes, training=False, seed=0)
    fov = []
    for idx in ds.sample_id_list:
        pts = ds.get_lidar(idx)
        fov.append((len(pts), int(ds._fov_flag(pts, ds.get_calib(idx)).sum())))
    log(f"# 11b tree: {len(KITTI_FILES['train']) + len(KITTI_FILES['val'])} "
        f"frames written in {t_write:.1f} s; points a frame in the file "
        f"{min(f[0] for f in fov)}-{max(f[0] for f in fov)}, in the camera's "
        f"view {min(f[1] for f in fov)}-{max(f[1] for f in fov)}; infos and "
        f"GT database ({ {str(k): len(v) for k, v in db.items()} } objects) in "
        f"{t_infos:.1f} s")

    seen = drive_files_entry_points(
        torch, cfg_path, ROOT / "output" / "chip_smoke" / "files_runs", "11b")
    if len(seen["request"]) != 1:
        raise AssertionError(f"11b: {len(seen['request'])} requests (1 due)")
    for kind in ("step", "request"):
        for i, (per, *_r) in enumerate(seen[kind]):
            if per != KITTI_STEP:
                raise AssertionError(f"11b {kind} {i}: launches {per}")
    if seen["counts"] != KITTI_STEP:
        raise AssertionError(f"11b: launches {seen['counts']}")
    loader_line(seen, cfg, "11b", card)
    loader_breakdown(KittiDataset(data, classes, training=True, seed=0),
                     data, "11b", card)

    kitti_official_check(seen["result"], root, ds, classes, "11b")
    log(f"# 11b: entry points {seen['seconds']:.1f} s; launches of K1-K7 "
        f"{sum(seen['counts'].values())}; phase {time.time() - t_phase:.1f} "
        f"s [{card}]")


def kitti_official_check(result, root, ds, classes, label):
    """The official R40 evaluation (bbox, bev, 3d, aos; finite) of a
    ``result.pkl`` against the tree's val infos, then of the val GT boxes
    moved by ~5 cm (nonzero for Car), with its host seconds."""
    import math
    import pickle

    import numpy as np

    from mssvt_tpu_torch.datasets.kitti import generate_kitti_prediction_dict
    from mssvt_tpu_torch.datasets.synthetic_files import KITTI_IMAGE
    from mssvt_tpu_torch.utils.kitti_eval import kitti_official_eval

    with open(result, "rb") as f:
        dets = pickle.load(f)
    with open(root / "kitti_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    if len(dets) != len(infos):
        raise AssertionError(f"{label}: {len(dets)} results, {len(infos)} "
                             "frames")
    det_frames, gt_frames = [], []
    for det, info in zip(dets, infos):
        idx = info["point_cloud"]["lidar_idx"]
        frame = generate_kitti_prediction_dict(
            det["boxes"], det["scores"], det["labels"], classes,
            calib=ds.get_calib(idx), image_shape=KITTI_IMAGE)
        det_frames.append(frame)
        a = info["annos"]
        care = a["name"] != "DontCare"
        gt = {k: a[k][care] for k in ("name", "bbox", "alpha", "occluded",
                                      "truncated")}
        gt["boxes"] = a["gt_boxes_lidar"]
        gt_frames.append(gt)
    t0 = time.perf_counter()
    report, official = kitti_official_eval(det_frames, gt_frames,
                                           classes)
    t_official = time.perf_counter() - t0
    need = {f"{c}_{m}/{d}_R40" for c in classes
            for m in ("bbox", "bev", "3d", "aos")
            for d in ("easy", "moderate", "hard")}
    if set(official) != need or not all(math.isfinite(v)
                                        for v in official.values()):
        raise AssertionError(f"{label}: official metrics {official}")
    # the evaluator on matched boxes too: the val GT boxes moved by ~5 cm
    rng = np.random.default_rng(0)
    near = []
    for gt, info in zip(gt_frames, infos):
        keep = np.isin(gt["name"], classes)  # the model's classes
        boxes = gt["boxes"][keep]
        boxes = boxes + rng.normal(0, 0.05, boxes.shape)
        near.append(generate_kitti_prediction_dict(
            boxes, np.round(rng.uniform(0.2, 1, len(boxes)), 1),
            np.array([classes.index(n) + 1 for n in gt["name"][keep]]),
            classes, calib=ds.get_calib(info["point_cloud"]["lidar_idx"]),
            image_shape=KITTI_IMAGE))
    t0 = time.perf_counter()
    _, matched = kitti_official_eval(near, gt_frames, classes)
    t_matched = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in matched.values()) or \
            matched["Car_3d/moderate_R40"] <= 0:
        raise AssertionError(f"{label}: official metrics on GT boxes "
                             f"{matched}")
    log(f"# {label} official KITTI eval (R40; bbox, bev, 3d, aos): "
        f"{t_official:.2f} s host for {len(dets)} frames of "
        f"{sum(len(d['scores']) for d in dets)} boxes; moderate "
        f"{ {k: round(v, 3) for k, v in official.items() if 'moderate' in k} }"
        f" (seeded weights: meaningless but finite); on the val GT boxes "
        f"moved ~5 cm ({sum(len(d['score']) for d in near)} boxes) "
        f"{t_matched:.2f} s, moderate "
        f"{ {k: round(v, 2) for k, v in matched.items() if 'moderate' in k} }")


# -------------------------------------------------------------- phase 12
# the two-stage voxel family (VoxelRCNN, PartA2, SECONDNetIoU): no TPU
# kernel stands on its path either. 12b trains and serves the two shipped
# configs at the yaml's batch 2 on a KITTI tree of the same seeded writer as
# 11b's, 4 train frames (2 steps) and 2 val frames (1 request).
TWO_STAGE = ("voxel_rcnn_car", "PartA2")
TWO_STAGE_TINY = ("voxel_rcnn_car", "PartA2", "second_iou")
TWO_STAGE_FILES = dict(train=[f"{i:06d}" for i in range(4)],
                       val=[f"{i:06d}" for i in range(4, 6)], points=120_000)
# the tiny KITTI grid's anchor spacing (4 x 4 BEV cells from x 0, y -6.4,
# align_center off)
TINY_ANCHOR_STEP = 12.8 / 3
PROFILE_WARM = 64  # trivial launches opening each profiled session


def two_stage_cfg(name):
    """``kitti_models/<name>.yaml``; for ``second_iou`` (no yaml ships for
    SECONDNetIoU) ``second.yaml`` with its BEV-grid RoI head, whose NMS and
    target settings are ``voxel_rcnn_car.yaml``'s, with the corner loss."""
    if name != "second_iou":
        return load_cfg(f"tools/cfgs/kitti_models/{name}.yaml")
    cfg = load_cfg("tools/cfgs/kitti_models/second.yaml")
    vr = load_cfg("tools/cfgs/kitti_models/voxel_rcnn_car.yaml").MODEL.ROI_HEAD
    cfg.MODEL.NAME = "SECONDNetIoU"
    cfg.MODEL.ROI_HEAD = type(vr)({
        "NAME": "BEVGridRoIHead", "GRID_SIZE": 6, "SHARED_FC": [256, 256],
        "DP_RATIO": 0.3, "NMS_CONFIG": vr.NMS_CONFIG,
        "TARGET_CONFIG": vr.TARGET_CONFIG,
        "LOSS_CONFIG": {"CORNER_LOSS_REGULARIZATION": True,
                        "LOSS_WEIGHTS": {"rcnn_corner_weight": 1.0}}})
    return cfg


def two_stage_tiny(name, seed):
    """12a: ``two_stage_cfg(name)`` at narrow widths (DP_RATIO 0: the card's
    and the CPU's dropout streams differ) on 10a's range and 32^3 grid, and
    a seeded 2-frame scene with GT boxes 0.2-0.4 m off anchors of their
    class (foreground RoIs): (config, build args, scene)."""
    import numpy as np

    (cfg, args), scene = kitti_tiny("second", seed)
    tiny = cfg.MODEL
    full = two_stage_cfg(name)
    m = full.MODEL
    m.BACKBONE_3D.update(NUM_FILTERS=[8, 16, 16, 16], OUT_CHANNELS=16)
    m.BACKBONE_2D = tiny.BACKBONE_2D
    roi = m.ROI_HEAD
    roi.update(SHARED_FC=[16, 16], DP_RATIO=0.0)
    for split in ("TRAIN", "TEST"):  # every anchor a candidate (<= 96)
        roi.NMS_CONFIG[split].update(NMS_PRE_MAXSIZE=128, NMS_POST_MAXSIZE=96)
    roi.TARGET_CONFIG.ROI_PER_IMAGE = 16
    if name == "PartA2":
        m.POINT_HEAD.update(CLS_FC=[8], PART_FC=[8])
        roi.update(CONV_CHANNELS=[8, 8], ROI_AWARE_POOL={"POOL_SIZE": 4})
    elif name == "voxel_rcnn_car":
        roi.GRID_SIZE = 3
        for layer in roi.ROI_GRID_POOL.POOL_LAYERS.values():
            layer.update(MLPS=[[8, 8]], NSAMPLE=[8])
    else:
        roi.GRID_SIZE = 3
    classes = list(full.CLASS_NAMES)
    rng = np.random.default_rng(seed)
    sizes = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}
    z = {1: -1.0, 2: 0.265, 3: 0.265}  # anchor bottom + half height
    gt = np.zeros((2, 6, 8), np.float32)
    for b in range(2):
        for j in range(4):
            cls = 1 + j % len(classes)
            ix, iy = 1 + (j + b) % 2, 1 + (j // 2 + b) % 2
            gt[b, j] = [ix * TINY_ANCHOR_STEP + rng.uniform(0.2, 0.4),
                        -6.4 + iy * TINY_ANCHOR_STEP + rng.uniform(0.2, 0.4),
                        z[cls] + rng.uniform(-0.1, 0.1), *sizes[cls],
                        rng.uniform(-0.2, 0.2) + 1.57 * (j % 2), cls]
    scene = dict(scene, gt_boxes=gt)
    return full, (m, len(classes), classes, *args[3:]), scene


def two_stage_tiny_check(torch, name, seed):
    """12a for one model: tiny, f32, on the card against the CPU plain path
    on the same weights (``kitti_tiny_models``): the RoIs and the refined
    boxes of each frame as sets within 1e-3 of max(1, |value|); one
    ``train_step``: loss within
    1e-4 relative, gradient norm within 1e-3; the card's gradients
    bit-identical when its forward and backward repeat from the same
    weights and batch. Returns the numbers for the log."""
    import copy
    import math

    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import forward_backward, train_step

    cfg, args, scene = two_stage_tiny(name, seed)
    models = dict(zip(("cpu", "cuda"),
                      kitti_tiny_models(torch, args, scene, seed)))
    res = {}
    for dev, model in models.items():
        batch = to_device(torch, scene, dev)
        with torch.no_grad():
            out = model(batch, return_intermediates=True)
        rois = {"final_boxes": out["rois"], "final_mask": out["roi_valid"],
                "final_scores": out["roi_valid"].float(),
                "final_labels": out["roi_valid"].long()}
        snapshot = copy.deepcopy(model)
        opt, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                                 total_steps=10, steps_per_epoch=5)
        loss, tb = train_step(model, opt, batch, torch.Generator(device=dev))
        grads = [p.grad.clone() for p in model.parameters()]
        gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        res[dev] = (out, rois, float(loss), gnorm, tb)
        if dev == "cuda":
            snapshot.zero_grad()
            forward_backward(snapshot, batch, torch.Generator(device=dev))
            same = all(torch.equal(p.grad, g) for p, g in
                       zip(snapshot.parameters(), grads))
            if not same:
                raise AssertionError(f"12a {name}: the repeated backward's "
                                     "gradients differ")
    torch.cuda.synchronize()
    (oc, rc, lc, gc, tbc), (og, rg, lg, gg, _) = res["cpu"], res["cuda"]
    n_rois, err_rois = kept_box_sets_error(rc, rg, relative=True)
    n_kept, err = kept_box_sets_error(oc, og, relative=True)
    if n_rois == 0 or n_kept == 0 or max(err, err_rois) > 1e-3:
        raise AssertionError(f"12a {name}: {n_rois} RoIs (error {err_rois}),"
                             f" {n_kept} refined boxes (error {err})")
    rel, grel = abs(lg - lc) / abs(lc), abs(gg - gc) / gc
    if rel > 1e-4 or grel > 1e-3 or not math.isfinite(lg):
        raise AssertionError(f"12a {name}: loss {lg} vs {lc}, gradient "
                             f"norm {gg} vs {gc}")
    if float(tbc["rcnn_loss_reg"]) <= 0:
        raise AssertionError(f"12a {name}: no foreground RoI ({tbc})")
    return dict(rois=(n_rois, err_rois), kept=(n_kept, err), loss=(lg, lc, rel),
                gnorm=(gg, gc, grel), detector=type(models["cuda"]).__name__)


def two_stage_tiny_reference(torch):
    """12a: ``two_stage_tiny_check`` for the tiny VoxelRCNN, PartA2 and
    SECONDNetIoU, with no kernel of K1-K7 launched."""
    from mssvt_tpu_torch import kernels

    for name in TWO_STAGE_TINY:
        kernels.reset_launch_counts()
        r = two_stage_tiny_check(torch, name, seed=23)
        counts = kernels.launch_counts()
        if counts != KITTI_STEP:
            raise AssertionError(f"12a {name}: launches {counts}")
        log(f"# 12a tiny {r['detector']} (f32): {r['rois'][0]} RoIs and "
            f"{r['kept'][0]} refined boxes agree as sets within "
            f"{max(r['rois'][1], r['kept'][1]):.3g} of max(1, |value|); one "
            f"train_step: loss "
            f"card {r['loss'][0]:.6f} vs CPU {r['loss'][1]:.6f} (relative "
            f"{r['loss'][2]:.3g}), gradient norm {r['gnorm'][0]:.6g} vs "
            f"{r['gnorm'][1]:.6g} (relative {r['gnorm'][2]:.3g}); repeated "
            "backward bit-identical; launches: none")


class Spans:
    """Host-clock and device-time accounting of the two-stage path's
    parts: each wrapped call synchronises the card before and after, runs
    inside ``record_function(label)`` and adds its seconds to ``spent``.
    ``sites`` lists (module, function name, label); by default the voxel
    family's."""

    def __init__(self, torch, sites=None):
        from mssvt_tpu_torch.models.roi_heads import (
            partA2_head,
            roi_head_template,
            voxelrcnn_head,
        )

        self.torch, self.spent, self.live = torch, {}, []
        self.sites = sites or [
            (roi_head_template, "proposal_layer", "proposal NMS"),
            (voxelrcnn_head, "voxel_query", "voxel_query"),
            (partA2_head, "roiaware_pool3d", "roiaware_pool3d")]
        self.saved = [getattr(m, f) for m, f, _ in self.sites]

    def __enter__(self):
        from torch.profiler import record_function

        torch = self.torch
        for (mod, fn, label), orig in zip(self.sites, self.saved):
            def call(*a, _orig=orig, _label=label, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with record_function(_label):
                    out = _orig(*a, **kw)
                    torch.cuda.synchronize()
                self.spent[_label] = self.spent.get(_label, 0.0) + \
                    time.perf_counter() - t0
                if _label == "proposal NMS":
                    self.live.append(out[3].sum(1).tolist())
                return out
            setattr(mod, fn, call)
        return self

    def __exit__(self, *exc):
        for (mod, fn, _), orig in zip(self.sites, self.saved):
            setattr(mod, fn, orig)

    def take(self):
        spent, self.spent = self.spent, {}
        return spent


def profile_two_stage(torch, runs, cfg, label, card, sites=None,
                      phase="12b", kernel_names=(), top=0):
    """One ``train_step`` (a fresh optimizer) and one request, each of
    ``runs[kind]``'s (model, batch), under ``torch.profiler``: device time
    in all, inside the spans of ``sites`` (``Spans``; by default the
    proposal NMS, ``voxel_query`` and ``roiaware_pool3d``: kernels that
    started inside each synchronised span), and of the kernels whose name
    holds each of ``kernel_names`` ((label, substring) pairs). A session
    opened late in a process that has profiled before can miss its first
    ~20–30 launches, so each session first launches ``PROFILE_WARM``
    trivial kernels (the log says how many the trace holds) and counts
    only the kernels that start inside the measured window; the device-side
    annotations of the ``record_function`` ranges are no kernels and are
    left out of every sum. With ``top`` it also prints the ``top`` kernel
    names of each by their summed device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mssvt_tpu_torch.runtime.eval_utils import eval_step
    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import train_step

    (model, batch), (served, request) = runs["step"], runs["request"]
    opt, _ = build_optimizer(cfg["OPTIMIZATION"], model.named_parameters(),
                             total_steps=10, steps_per_epoch=5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    parts = []
    for kind, call in (("step", lambda: train_step(model, opt, batch, gen)),
                       ("request", lambda: eval_step(served.eval(), request))):
        with Spans(torch, sites) as spans, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm = torch.zeros(1, device="cuda")
            for _ in range(PROFILE_WARM):
                warm.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.05)
            with record_function("profiled window"):
                call()
                torch.cuda.synchronize()
        evs = prof.events()
        # each record_function range also appears on the device as a user
        # annotation spanning its kernels: not a kernel, never summed
        labels = {"profiled window", *(lb for _, _, lb in spans.sites)}
        on_device = [e for e in evs
                     if "CUDA" in str(getattr(e, "device_type", ""))]
        device = [e for e in on_device if e.name not in labels and
                  not getattr(e, "is_user_annotation", False)]
        start = min(e.time_range.start for e in evs
                    if e.name == "profiled window" and
                    "CPU" in str(getattr(e, "device_type", "")))
        kern = [e for e in device if e.time_range.start >= start]
        seen_warm = len(device) - len(kern)
        total = sum(e.self_device_time_total for e in kern) / 1e3
        inside = []
        # the host-side span of each call (a label may name several sites)
        for name in dict.fromkeys(lb for _, _, lb in spans.sites):
            rng_ = [e.time_range for e in evs if e.name == name and
                    "CPU" in str(getattr(e, "device_type", ""))]
            ks = [e for e in kern if any(r.start <= e.time_range.start <= r.end
                                         for r in rng_)]
            if rng_:
                inside.append(f"{name} {sum(e.self_device_time_total for e in ks) / 1e3:.3f} ms "
                              f"({len(ks)} kernels, {len(rng_)} calls, host "
                              f"{spans.spent.get(name, 0.0):.4f} s)")
        for klabel, sub in kernel_names:
            ks = [e for e in kern if sub in e.name]
            inside.append(f"{klabel} {sum(e.self_device_time_total for e in ks) / 1e3:.3f} ms "
                          f"({len(ks)} launches)")
        if top:
            by_name = {}
            for e in kern:
                t, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.self_device_time_total / 1e3, n + 1)
            ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
            inside.append("top kernels " + "; ".join(
                f"{name[:60]} {t:.3f} ms x{n}" for name, (t, n) in ranked))
        parts.append(f"{kind}: device kernels {total:.3f} ms over {len(kern)} "
                     f"kernels (the trace holds {seen_warm} of "
                     f"{PROFILE_WARM} warm-up launches; "
                     f"{len(on_device) - len(device)} range annotations "
                     "left out); " + "; ".join(inside))
    log(f"# {phase} {label} profiled (torch.profiler, one {parts[0]}; one "
        f"{parts[1]} [{card}]")


def two_stage_files_path(torch, card):
    """12b: ``voxel_rcnn_car.yaml`` and ``PartA2.yaml`` at their published
    widths (f32) and batch (2), trained for one epoch (2 steps) and served
    (1 request) through the entry points from a file-backed KITTI tree with
    gt_sampling on, then the official R40 evaluation of ``result.pkl``; no
    step or request launches a kernel of K1-K7. Prints voxels a frame
    against the caps, live RoIs a frame, each synchronised step and
    request with the proposal NMS's share, the profiled step and request,
    the peaks and the phase's seconds."""
    import shutil

    from mssvt_tpu_torch.datasets.kitti import KittiDataset, create_kitti_infos
    from mssvt_tpu_torch.datasets.synthetic_files import write_kitti_tree
    from mssvt_tpu_torch.utils.edict import EasyDict

    t_phase = time.time()
    root = FILES_DATA / "kitti_two_stage"
    shutil.rmtree(root, ignore_errors=True)
    write_kitti_tree(root, TWO_STAGE_FILES["train"], TWO_STAGE_FILES["val"],
                     TWO_STAGE_FILES["points"], seed=0)
    prepared = False
    for name in TWO_STAGE:
        t_model = time.time()
        cfg_path, cfg = files_config(f"tools/cfgs/kitti_models/{name}.yaml",
                                     {"DATA_PATH": str(root)},
                                     f"{name}_kitti_files")
        data, classes = EasyDict(cfg["DATA_CONFIG"]), cfg["CLASS_NAMES"]
        if not prepared:  # the infos and GT database hold every class
            create_kitti_infos(data, ["Car", "Pedestrian", "Cyclist"], root,
                               root)
            prepared = True
        bsz = int(cfg["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"])
        label = f"12b {name}"
        with Spans(torch) as spans:
            seen = drive_files_entry_points(
                torch, cfg_path,
                ROOT / "output" / "chip_smoke" / "two_stage_runs" / name,
                label, batch=bsz)
        live = spans.live
        if len(seen["request"]) != 1:
            raise AssertionError(f"{label}: {len(seen['request'])} requests")
        for kind in ("step", "request"):
            for i, (per, *_r) in enumerate(seen[kind]):
                if per != KITTI_STEP:
                    raise AssertionError(f"{label} {kind} {i}: launches {per}")
        if seen["counts"] != KITTI_STEP:
            raise AssertionError(f"{label}: launches {seen['counts']}")
        loader_line(seen, cfg, label, card, batch=bsz)
        nms_cfg = cfg["MODEL"]["ROI_HEAD"]["NMS_CONFIG"]
        log(f"# {label}: live RoIs a frame after the proposal NMS, train "
            f"{live[:len(seen['step'])]} (post {nms_cfg['TRAIN']['NMS_POST_MAXSIZE']}"
            f" of {nms_cfg['TRAIN']['NMS_PRE_MAXSIZE']} candidates), test "
            f"{live[len(seen['step']):]} (post "
            f"{nms_cfg['TEST']['NMS_POST_MAXSIZE']} of "
            f"{nms_cfg['TEST']['NMS_PRE_MAXSIZE']})")
        ds = KittiDataset(data, classes, training=False, seed=0)
        kitti_official_check(seen["result"], root, ds, classes, label)
        # the NMS's share by the host clock: the last step's and request's
        # model and batch again, its proposal_layer calls timed inside
        runs = {kind: (seen[f"{kind}_model"], seen[kind][-1][1])
                for kind in ("step", "request")}
        shares = [nms_share(torch, *runs[kind], cfg, kind) for kind in runs]
        log(f"# {label}: proposal NMS share by the host clock, "
            + "; ".join(shares) + f" [{card}]")
        profile_two_stage(torch, runs, cfg, name, card)
        log(f"# {label}: entry points {seen['seconds']:.1f} s; model "
            f"{time.time() - t_model:.1f} s [{card}]")
        del runs, seen
        torch.cuda.empty_cache()
    log(f"# 12b: phase {time.time() - t_phase:.1f} s [{card}]")


def nms_share(torch, model, batch, cfg, kind, sites=None):
    """Two synchronised steps (a fresh optimizer) or requests of ``model``
    on ``batch``, with the proposal NMS timed inside (``Spans(torch,
    sites)``): 'kind s [...] of which NMS [...] = [...]%'."""
    from mssvt_tpu_torch.runtime.eval_utils import eval_step
    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import train_step

    if kind == "step":
        opt, _ = build_optimizer(cfg["OPTIMIZATION"], model.named_parameters(),
                                 total_steps=10, steps_per_epoch=5)
        gen = torch.Generator(device="cuda").manual_seed(1)
        call = lambda: train_step(model, opt, batch, gen)
    else:
        model.eval()
        call = lambda: eval_step(model, batch)
    walls, nms = [], []
    with Spans(torch, sites) as spans:
        for _ in range(2):
            spans.take()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            nms.append(spans.take().get("proposal NMS", 0.0))
    return (f"{kind} {[round(w, 4) for w in walls]} s, of which NMS "
            f"{[round(x, 4) for x in nms]} s = "
            f"{[round(100 * x / w, 1) for x, w in zip(nms, walls)]}%")


# -------------------------------------------------------------- phase 13
# the point-based two-stage family (PV-RCNN, PV-RCNN++, PointRCNN). K2c runs
# PV-RCNN's keypoint FPS (2 x 16 384 -> 2 048) and PointRCNN's set
# abstractions over more than 256 points (16 384 -> 4 096, 4 096 -> 1 024,
# 1 024 -> 256), K2b PointRCNN's last one (256 -> 64); PV-RCNN++ samples its
# keypoints with the masked sector FPS, plain on the card, and launches no
# kernel. 13b trains and serves the three shipped configs at the yaml's
# batch 2 on a KITTI tree of 11b's seeded writer, 4 train frames (2 steps)
# and 2 val frames (1 request).
POINT_TINY = ("pvrcnn", "pvrcnn_plusplus", "pointrcnn")
POINT_YAMLS = ("pv_rcnn", "pv_rcnn_plusplus", "pointrcnn")
POINT_LAUNCHES = {  # each step and request of 13b
    "pv_rcnn": launches(fps_picks_block=1),
    "pv_rcnn_plusplus": launches(),
    "pointrcnn": launches(fps_picks_block=3, fps_picks_warp=1)}
POINT_FILES = dict(train=[f"{i:06d}" for i in range(4)],
                   val=[f"{i:06d}" for i in range(4, 6)], points=120_000)
POINT_TINY_RANGE = (0.0, -6.4, -2.0, 12.8, 6.4, 2.0)
POINT_TINY_ROWS = 512  # raw point rows a frame of 13a


def point_tiny_cfg(name):
    """13a's configs: the JAX suite's tiny PV-RCNN (FPS keypoints),
    PV-RCNN++ (SPC keypoints, the vector pool) and PointRCNN
    (``tests/test_pvrcnn_pointrcnn.py``), DP_RATIO 0 (the card's and the
    CPU's dropout streams differ); PointRCNN's proposal NMS takes every
    point as a candidate and keeps every box it does not suppress (its
    foreground boxes, at copies of one point, must not fall past a cut by
    score), with the adam_onecycle recipe of ``pv_rcnn.yaml``."""
    from mssvt_tpu_torch.utils.edict import EasyDict

    nms = {"TRAIN": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.8,
                     "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16},
           "TEST": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                    "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16}}
    opt = load_cfg("tools/cfgs/kitti_models/pv_rcnn.yaml").OPTIMIZATION
    if name == "pointrcnn":
        for split in nms.values():
            split.update(NMS_PRE_MAXSIZE=POINT_TINY_ROWS,
                         NMS_POST_MAXSIZE=POINT_TINY_ROWS)
        model = {
            "NAME": "PointRCNN", "MAX_POINTS": POINT_TINY_ROWS,
            "BACKBONE_3D": {"NAME": "PointNet2MSG", "SA_CONFIG": {
                "NPOINTS": [128, 32], "RADIUS": [[0.4, 0.8], [0.8, 1.6]],
                "NSAMPLE": [[8, 8], [8, 8]],
                "MLPS": [[[8, 8], [8, 8]], [[16, 16], [16, 16]]]},
                "FP_MLPS": [[16, 16], [16, 16]]},
            "POINT_HEAD": {"NAME": "PointHeadBox", "CLS_FC": [16],
                           "REG_FC": [16], "MEAN_SIZES": [[3.9, 1.6, 1.56]]},
            "ROI_HEAD": {"NAME": "PointRCNNHead", "NUM_SAMPLED_POINTS": 32,
                         "XYZ_UP_LAYER": [[16, 16]], "SHARED_FC": [32],
                         "NMS_CONFIG": nms,
                         "TARGET_CONFIG": {"ROI_PER_IMAGE": 16}},
            "POST_PROCESSING": {"SCORE_THRESH": 0.1}}
        return EasyDict({"MODEL": model, "OPTIMIZATION": opt})
    anchor = {"class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]],
              "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
              "align_center": False, "feature_map_stride": 8,
              "matched_threshold": 0.6, "unmatched_threshold": 0.45}
    source = {"POOL_RADIUS": [1.6], "NSAMPLE": [8], "MLPS": [[16, 16]]}
    if name == "pvrcnn_plusplus":
        source = {"NAME": "VectorPoolAggregationModuleMSG", "GRID_SIZE": 2,
                  "POOL_RADIUS": [1.6], "NSAMPLE": [16], "MLPS": [[16, 16]]}
    model = {
        "NAME": "PVRCNNPlusPlus" if name == "pvrcnn_plusplus" else "PVRCNN",
        "MAX_POINTS": POINT_TINY_ROWS, "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelBackBone8x",
                        "NUM_FILTERS": [8, 16, 16, 16], "OUT_CHANNELS": 32},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2, 2],
                        "LAYER_STRIDES": [1, 2], "NUM_FILTERS": [16, 32],
                        "UPSAMPLE_STRIDES": [1, 2],
                        "NUM_UPSAMPLE_FILTERS": [16, 16]},
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle", "CLASS_AGNOSTIC": False,
            "USE_DIRECTION_CLASSIFIER": True, "DIR_OFFSET": 0.78539,
            "NUM_DIR_BINS": 2, "ANCHOR_GENERATOR_CONFIG": [anchor],
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
                "code_weights": [1.0] * 7}}},
        "PFE": {"NAME": "VoxelSetAbstraction", "NUM_KEYPOINTS": 64,
                "NUM_OUTPUT_FEATURES": 32,
                "SAMPLE_METHOD": "FPS" if name == "pvrcnn" else "SPC",
                "SPC_SAMPLING": {"NUM_SECTORS": 4,
                                 "SAMPLE_RADIUS_WITH_ROI": 2.4},
                "SA_LAYER": {"raw_points": {"POOL_RADIUS": [0.8],
                                            "NSAMPLE": [8], "MLPS": [[8, 8]]},
                             "x_conv_out": source}},
        "POINT_HEAD": {"NAME": "PointHeadSimple", "CLS_FC": [16]},
        "ROI_HEAD": {"NAME": "PVRCNNHead", "GRID_SIZE": 3, "SHARED_FC": [32],
                     "DP_RATIO": 0.0,
                     "ROI_GRID_POOL": {"POOL_RADIUS": [0.8], "NSAMPLE": [8],
                                       "MLPS": [[16, 16]]},
                     "NMS_CONFIG": nms, "TARGET_CONFIG": {"ROI_PER_IMAGE": 16}},
        "POST_PROCESSING": {"SCORE_THRESH": 0.1}}
    return EasyDict({"MODEL": model, "OPTIMIZATION": opt})


def point_tiny(name, seed):
    """13a: (config, build args, scene): the JAX suite's tiny grid (32^3
    cells of 0.4 x 0.4 x 0.125 m over a 12.8 m range), up to 256 seeded
    voxels and 512 raw point rows a frame (17 padding rows in the second),
    two Car GT boxes a frame. PV-RCNN's boxes lie 0.2-0.4 m off anchors
    (foreground RoIs); PointRCNN's 0.15 m off a point that the frame holds
    8 copies of (its box, the class mean size at the point, is then a
    foreground candidate, and the copies tie exactly on either device, so
    the NMS keeps the first of them on both)."""
    import numpy as np

    cfg = point_tiny_cfg(name)
    pcr = POINT_TINY_RANGE
    grid, vs, bsz, slots = (32, 32, 32), (0.4, 0.4, 0.125), 2, 256
    rng = np.random.default_rng(seed)
    cells = np.unique(np.stack([
        rng.integers(0, bsz, 2 * bsz * slots), rng.integers(0, 32, 2 * bsz * slots),
        rng.integers(0, 16, 2 * bsz * slots),
        rng.integers(0, 16, 2 * bsz * slots)], 1), axis=0)
    coords = np.full((bsz * slots, 4), -1, np.int32)
    valid = np.zeros(bsz * slots, bool)
    for b in range(bsz):
        cb = cells[cells[:, 0] == b][:slots]
        coords[b * slots:b * slots + len(cb)] = cb
        valid[b * slots:b * slots + len(cb)] = True
    voxels = (rng.normal(size=(bsz * slots, 4, 4)) * valid[:, None, None]
              ).astype(np.float32)
    rows = POINT_TINY_ROWS
    pts = np.zeros((bsz * rows, 4), np.float32)
    pvalid = np.zeros(bsz * rows, bool)
    gt = np.zeros((bsz, 6, 8), np.float32)
    for b in range(bsz):
        n, lo = rows - 17 * b, b * rows
        pts[lo:lo + n, :3] = rng.uniform(pcr[:3], pcr[3:], (n, 3))
        pts[lo:lo + n, 3] = rng.uniform(0, 1, n)
        pvalid[lo:lo + n] = True
        for j in range(2):
            if name == "pointrcnn":
                p = pts[lo + 100 * (j + 1)].copy()
                pts[lo + 100 * (j + 1):lo + 100 * (j + 1) + 8] = p
                ctr = p[:3] + np.array([0.15, -0.1, 0.05])
            else:
                ix, iy = 1 + (j + b) % 2, 1 + (j + b + 1) % 2
                ctr = [ix * TINY_ANCHOR_STEP + rng.uniform(0.2, 0.4),
                       -6.4 + iy * TINY_ANCHOR_STEP + rng.uniform(0.2, 0.4),
                       -1.0 + rng.uniform(-0.1, 0.1)]
            gt[b, j] = [*ctr, 3.9, 1.6, 1.56,
                        rng.uniform(-0.1, 0.1) + (1.57 if j and name != "pointrcnn"
                                                  else 0.0), 1]
    scene = {"voxels": voxels,
             "voxel_num_points": np.full(bsz * slots, 3.0, np.float32) * valid,
             "voxel_coords": coords, "voxel_valid": valid, "points": pts,
             "points_valid": pvalid, "gt_boxes": gt}
    args = (cfg.MODEL, 1, ["Car"], grid, vs, pcr, bsz, slots, 4)
    return cfg, args, scene


def point_tiny_models(torch, args, scene, seed):
    """13a's and 14a's model on the CPU and on the card with equal seeded
    weights: BatchNorm statistics from one train-mode forward of the scene
    (as ``kitti_tiny_models``), every class bias of the dense head zero;
    PointRCNN's box output kernel scaled by 0.01 with a cos bias of 1
    (boxes of the class mean size at each point, heading ~0)."""
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.models.model_utils.layers import BatchNorm

    cpu = build_network(*args, num_point_features=4, device="cpu", seed=seed)
    bns = [m for m in cpu.modules() if isinstance(m, BatchNorm)]
    moms = [m.momentum for m in bns]
    with torch.no_grad():
        if hasattr(cpu, "dense_head"):
            for n, p in cpu.dense_head.named_parameters():
                if n.endswith("cls.bias"):
                    p.zero_()
        else:
            out = cpu.point_head.reg_out
            out.weight.mul_(0.01)
            out.bias.zero_()
            out.bias[6] = 1.0
        for m in bns:
            m.momentum = 0.0
        cpu.train()(to_device(torch, scene, "cpu"))
    for m, mom in zip(bns, moms):
        m.momentum = mom
    card = build_network(*args, num_point_features=4, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu.eval(), card


def tiny_card_check(torch, phase, name, cfg, args, scene, seed, need):
    """``phase`` (13a, 14a) for one tiny model of build ``args``: f32, on
    the card against the CPU plain path on the same weights
    (``point_tiny_models``): the detections of each frame as sets within
    1e-3 of max(1, |value|); one ``train_step`` on ``scene``: loss within
    1e-4 relative, gradient norm within 1e-3, the ``tb_dict`` term
    ``need`` positive (foreground RoIs, the depth loss); the card's
    gradients bit-identical when its forward and backward repeat from the
    same weights and batch. Returns the numbers for the log."""
    import copy
    import math

    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import forward_backward, train_step

    models = dict(zip(("cpu", "cuda"),
                      point_tiny_models(torch, args, scene, seed)))
    res = {}
    for dev, model in models.items():
        batch = to_device(torch, scene, dev)
        with torch.no_grad():
            out = model(batch)
        snapshot = copy.deepcopy(model)
        opt, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                                 total_steps=10, steps_per_epoch=5)
        loss, tb = train_step(model, opt, batch, torch.Generator(device=dev))
        grads = [p.grad.clone() for p in model.parameters()]
        gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        res[dev] = (out, float(loss), gnorm, tb)
        if dev == "cuda":
            snapshot.zero_grad()
            forward_backward(snapshot, batch, torch.Generator(device=dev))
            if not all(torch.equal(p.grad, g) for p, g in
                       zip(snapshot.parameters(), grads)):
                raise AssertionError(f"{phase} {name}: the repeated "
                                     "backward's gradients differ")
    torch.cuda.synchronize()
    (oc, lc, gc, tbc), (og, lg, gg, _) = res["cpu"], res["cuda"]
    n_kept, err = kept_box_sets_error(oc, og, relative=True)
    if n_kept == 0 or err > 1e-3:
        raise AssertionError(f"{phase} {name}: {n_kept} detections (error "
                             f"{err})")
    rel, grel = abs(lg - lc) / abs(lc), abs(gg - gc) / gc
    if rel > 1e-4 or grel > 1e-3 or not math.isfinite(lg):
        raise AssertionError(f"{phase} {name}: loss {lg} vs {lc}, gradient "
                             f"norm {gg} vs {gc}")
    if float(tbc.get(need, 0.0)) <= 0:
        raise AssertionError(f"{phase} {name}: {need} is not positive "
                             f"({tbc})")
    return dict(kept=(n_kept, err), loss=(lg, lc, rel), gnorm=(gg, gc, grel),
                detector=type(models["cuda"]).__name__)


def point_tiny_check(torch, name, seed):
    """13a for one model (``tiny_card_check``, with foreground RoIs)."""
    cfg, args, scene = point_tiny(name, seed)
    return tiny_card_check(torch, "13a", name, cfg, args, scene, seed,
                           "rcnn_loss_reg")


def point_tiny_reference(torch):
    """13a: ``point_tiny_check`` for the tiny PV-RCNN, PV-RCNN++ and
    PointRCNN: K2c launched by PV-RCNN and PointRCNN, K2b by PointRCNN, no
    other kernel of K1-K7 by any."""
    from mssvt_tpu_torch import kernels

    for name in POINT_TINY:
        kernels.reset_launch_counts()
        r = point_tiny_check(torch, name, seed=23)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        want = {"pvrcnn": {"fps_picks_block"}, "pvrcnn_plusplus": set(),
                "pointrcnn": {"fps_picks_block", "fps_picks_warp"}}[name]
        if set(counts) != want:
            raise AssertionError(f"13a {name}: launches {counts}")
        log(f"# 13a tiny {name} ({r['detector']}, f32): {r['kept'][0]} "
            f"refined boxes agree as sets within {r['kept'][1]:.3g} of "
            f"max(1, |value|); one train_step: loss card {r['loss'][0]:.6f} "
            f"vs CPU {r['loss'][1]:.6f} (relative {r['loss'][2]:.3g}), "
            f"gradient norm {r['gnorm'][0]:.6g} vs {r['gnorm'][1]:.6g} "
            f"(relative {r['gnorm'][2]:.3g}); repeated backward "
            f"bit-identical; launches (eval, step, repeat) {counts or 'none'}")


def point_sites():
    """``Spans`` sites of 13b: the proposal NMS (PV-RCNN's through
    ``propose``, PointRCNN's own), the ball-query groupings, the vector
    pool, the sector FPS, the 3-NN and the interpolation, and the RoI point
    pool."""
    from mssvt_tpu_torch.models.backbones_3d import pfe, pointnet2_backbone
    from mssvt_tpu_torch.models.detectors import point_rcnn
    from mssvt_tpu_torch.models.roi_heads import pvrcnn_head, roi_head_template

    return [(roi_head_template, "proposal_layer", "proposal NMS"),
            (point_rcnn, "proposal_layer", "proposal NMS"),
            (pfe, "query_and_group", "query_and_group"),
            (pvrcnn_head, "query_and_group", "query_and_group"),
            (pointnet2_backbone, "query_and_group", "query_and_group"),
            (pfe, "vector_pool", "vector_pool"),
            (pfe, "sector_fps", "sector_fps"),
            (pointnet2_backbone, "three_nn", "three_nn"),
            (pointnet2_backbone, "three_interpolate", "three_interpolate"),
            (point_rcnn, "roipoint_pool3d", "roipoint_pool3d")]


def request_fps_check(torch, model, batch, name, card):
    """13b: every FPS call of one request of ``model`` on a full-width
    request's own points (PV-RCNN's keypoints, 2 x 16 384 -> 2 048; PointRCNN's
    four set abstractions, 16 384 -> 4 096, 4 096 -> 1 024, 1 024 -> 256 on
    K2c and 256 -> 64 on K2b) recorded as the model makes it; each call's
    picks, which the kernel made, equal to ``fps_plain``'s on the same card
    planes, and both timed (CUDA events), with the kernel's bound (the planes
    read once, the picks written once, vs ~10 f32 operations a point and
    iteration). One line a call."""
    from mssvt_tpu_torch.kernels import fps, work
    from mssvt_tpu_torch.models.backbones_3d import pfe, pointnet2_backbone
    from mssvt_tpu_torch.runtime.eval_utils import eval_step

    calls, sites = [], (pfe, pointnet2_backbone)
    original = pfe.farthest_point_sample

    def recorded(xyz, npoint):
        picks = original(xyz, npoint)
        calls.append((xyz.detach().float(), int(npoint), picks))
        return picks

    try:
        for mod in sites:
            mod.farthest_point_sample = recorded
        model.eval()
        eval_step(model, batch)
    finally:
        for mod in sites:
            mod.farthest_point_sample = original
    want = {"pv_rcnn": [(16384, 2048)],
            "pointrcnn": [(16384, 4096), (4096, 1024), (1024, 256),
                          (256, 64)]}[name]
    got = [(xyz.shape[1], npoint) for xyz, npoint, _ in calls]
    if got != want:
        raise AssertionError(f"13b {name}: FPS calls (N, npoint) {got} != "
                             f"{want}")
    for xyz, npoint, picks in calls:
        x, y, z = (xyz[..., i].contiguous() for i in range(3))
        b, n = x.shape
        kernel = "K2b" if n <= fps.MAX_N else "K2c"
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        plain = fps.fps_plain(x, y, z, (), npoint)[0]
        end.record()
        torch.cuda.synchronize()
        if not torch.equal(picks, plain):
            raise AssertionError(f"13b {name}: {kernel}'s picks at {b} x {n} "
                                 f"-> {npoint} != fps_plain's")
        ms = time_ms(torch, lambda: fps.fps_picks(x, y, z, npoint), reps=5)
        bound_ms, bound_by = work.fps_picks(x, y, z, npoint).bound()
        log(f"# 13b {name} {kernel} on the request's own points ({b} x {n} "
            f"-> {npoint}): picks equal fps_plain's; ms={ms:.4f} "
            f"plain_ms={start.elapsed_time(end):.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) [{card}]")


def point_files_path(torch, card):
    """13b: ``pv_rcnn.yaml``, ``pv_rcnn_plusplus.yaml`` and ``pointrcnn.yaml``
    at their published widths (f32) and batch (2), trained for one epoch
    (2 steps) and served (1 request) through the entry points from a
    file-backed KITTI tree with gt_sampling on, then the official R40
    evaluation of ``result.pkl``. Each step and request launches K2c/K2b
    as ``POINT_LAUNCHES`` says and nothing else. Prints points a frame
    against MAX_POINTS, live RoIs a frame, each synchronised step and
    request with the proposal NMS's share, the profiled step and request
    of PV-RCNN and PointRCNN (K2c's and K2b's device time, the groupings,
    the 3-NN, the interpolation, the RoI point pool; PV-RCNN++'s ~90 000
    launches a step and a request cost ~25 s to profile, and its sector
    FPS is timed by the host clock), the peaks and the phase's seconds."""
    import shutil

    from mssvt_tpu_torch.datasets.kitti import KittiDataset, create_kitti_infos
    from mssvt_tpu_torch.datasets.synthetic_files import write_kitti_tree
    from mssvt_tpu_torch.utils.edict import EasyDict

    t_phase = time.time()
    root = FILES_DATA / "kitti_point"
    shutil.rmtree(root, ignore_errors=True)
    write_kitti_tree(root, POINT_FILES["train"], POINT_FILES["val"],
                     POINT_FILES["points"], seed=0)
    sites = point_sites()
    kernel_names = (("K2c", "fps_block_kernel"), ("K2b", "fps_kernel"))
    prepared = False
    for name in POINT_YAMLS:
        t_model = time.time()
        cfg_path, cfg = files_config(f"tools/cfgs/kitti_models/{name}.yaml",
                                     {"DATA_PATH": str(root)},
                                     f"{name}_kitti_files")
        data, classes = EasyDict(cfg["DATA_CONFIG"]), cfg["CLASS_NAMES"]
        if not prepared:
            create_kitti_infos(data, ["Car", "Pedestrian", "Cyclist"], root,
                               root)
            prepared = True
        bsz = int(cfg["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"])
        label = f"13b {name}"
        with Spans(torch, sites) as spans:
            seen = drive_files_entry_points(
                torch, cfg_path,
                ROOT / "output" / "chip_smoke" / "point_runs" / name, label,
                batch=bsz)
        want = POINT_LAUNCHES[name]
        if len(seen["request"]) != 1:
            raise AssertionError(f"{label}: {len(seen['request'])} requests")
        for kind in ("step", "request"):
            for i, (per, *_r) in enumerate(seen[kind]):
                if per != want:
                    raise AssertionError(f"{label} {kind} {i}: launches {per}"
                                         f" != {want}")
        loader_line(seen, cfg, label, card, batch=bsz)
        max_points = int(cfg["MODEL"]["MAX_POINTS"])
        pts = [int(v) for kind in ("step", "request") for _, b, _ in seen[kind]
               for v in b["points_valid"].reshape(bsz, -1).sum(1).tolist()]
        live = spans.live
        nms_cfg = cfg["MODEL"]["ROI_HEAD"]["NMS_CONFIG"]
        log(f"# {label}: raw points a frame {pts} against MAX_POINTS "
            f"{max_points}; live RoIs a frame after the proposal NMS, train "
            f"{live[:len(seen['step'])]} (post "
            f"{nms_cfg['TRAIN']['NMS_POST_MAXSIZE']} of "
            f"{nms_cfg['TRAIN']['NMS_PRE_MAXSIZE']} candidates), test "
            f"{live[len(seen['step']):]} (post "
            f"{nms_cfg['TEST']['NMS_POST_MAXSIZE']} of "
            f"{nms_cfg['TEST']['NMS_PRE_MAXSIZE']}); launches a step and a "
            f"request { {k: v for k, v in want.items() if v} or 'none'}; "
            f"sector_fps host {spans.spent.get('sector_fps', 0.0):.4f} s over "
            f"the entry points [{card}]")
        ds = KittiDataset(data, classes, training=False, seed=0)
        kitti_official_check(seen["result"], root, ds, classes, label)
        runs = {kind: (seen[f"{kind}_model"], seen[kind][-1][1])
                for kind in ("step", "request")}
        if name != "pv_rcnn_plusplus":  # its keypoints: the masked FPS
            request_fps_check(torch, *runs["request"], name, card)
        shares = [nms_share(torch, *runs[kind], cfg, kind, sites)
                  for kind in runs]
        log(f"# {label}: proposal NMS share by the host clock, "
            + "; ".join(shares) + f" [{card}]")
        if name != "pv_rcnn_plusplus":  # its sector FPS: ~90 000 launches
            profile_two_stage(torch, runs, cfg, name, card, sites=sites,
                              phase="13b", kernel_names=kernel_names)
        log(f"# {label}: entry points {seen['seconds']:.1f} s; model "
            f"{time.time() - t_model:.1f} s [{card}]")
        del runs, seen
        torch.cuda.empty_cache()
    log(f"# 13b: phase {time.time() - t_phase:.1f} s [{card}]")


# -------------------------------------------------------------- phase 14
# the last three families: CaDDN (the camera branch: DepthFFN, the
# frustum-to-voxel sampler, Conv2DCollapse), CT3D_3CAT (the CT3D head's
# point sampling and transformer) and AnchorHeadMulti with ATSS. No TPU
# kernel stands on their path, and every step and request is checked to
# launch none. 14a: the JAX suite's tiny models on the card against the
# CPU; 14b: ct3d_3cat.yaml at published width on a KITTI tree of 11b's
# seeded writer; 14c: CaDDN.yaml at published width on seeded in-memory
# camera batches (neither package reads images from files).
LATE_TINY = ("caddn", "ct3d", "second_multi")
LATE_FILES = dict(train=[f"{i:06d}" for i in range(4)],
                  val=[f"{i:06d}" for i in range(4, 6)], points=120_000)
CADDN_IMAGE = (375, 1242)  # KITTI's image rows and columns
CADDN_GRID = (280, 376, 25)  # CaDDN.yaml's range over its 0.16 m voxels
CADDN_BATCH = 4  # CaDDN.yaml's BATCH_SIZE_PER_GPU
CADDN_DEPTH_PIXELS = 20_000  # seeded depth pixels a frame (~4% of them)


def late_tiny(name, seed):
    """14a: (config with MODEL and OPTIMIZATION, build args, scene). caddn:
    ``tests/test_model_forward.py``'s tiny CaDDN on two frames of a camera
    looking down lidar +x (the second yawed), depth maps with holes, GT
    boxes and 2D boxes; ct3d: ``tests/test_ct3d.py``'s tiny CT3D_3CAT on
    13a's scene (512 raw points a frame, GT boxes near anchors);
    second_multi: 10a's tiny SECOND with an AnchorHeadMulti of two groups
    (Car; Pedestrian and Cyclist) and the ATSS assigner, a Car and a
    Pedestrian a frame each holding an anchor centre."""
    import numpy as np

    from mssvt_tpu_torch.utils.edict import EasyDict

    rng = np.random.default_rng(seed)
    if name == "second_multi":
        (cfg, args), scene = kitti_tiny("second", seed)
        head = cfg.MODEL.DENSE_HEAD
        cfg.MODEL.DENSE_HEAD = EasyDict({
            "NAME": "AnchorHeadMulti", "USE_DIRECTION_CLASSIFIER": True,
            "DIR_OFFSET": 0.78539, "NUM_DIR_BINS": 2,
            "SHARED_CONV_NUM_FILTER": 16,
            "RPN_HEAD_CFGS": [{"HEAD_CLS_NAME": ["Car"]},
                              {"HEAD_CLS_NAME": ["Pedestrian", "Cyclist"]}],
            "TARGET_ASSIGNER_CONFIG": {"NAME": "ATSSTargetAssigner",
                                       "TOPK": 9},
            "ANCHOR_GENERATOR_CONFIG": head.ANCHOR_GENERATOR_CONFIG,
            "LOSS_CONFIG": head.LOSS_CONFIG})
        gt = np.zeros_like(scene["gt_boxes"])
        for b in range(2):
            off = rng.uniform(-0.1, 0.1, 2)
            gt[b, 0] = [4.5 + off[0], 2.3 + off[1], -1.0, 3.9, 1.6, 1.56,
                        0.3, 1]
            gt[b, 1] = [8.7 + off[1], -2.0 + off[0], 0.265, 0.8, 0.6, 1.73,
                        -0.5, 2]
        return cfg, args, dict(scene, gt_boxes=gt)
    if name == "ct3d":
        _, _, scene = point_tiny("pvrcnn", seed)
        nms = {"TRAIN": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.8,
                         "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16},
               "TEST": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                        "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16}}
        tiny = point_tiny_cfg("pvrcnn").MODEL
        model = {
            "NAME": "CT3D_3CAT", "MAX_POINTS": POINT_TINY_ROWS,
            "VFE": {"NAME": "MeanVFE"}, "BACKBONE_3D": tiny.BACKBONE_3D,
            "BACKBONE_2D": tiny.BACKBONE_2D, "DENSE_HEAD": tiny.DENSE_HEAD,
            "ROI_HEAD": {
                "NAME": "CT3DHead",
                "Transformer": {"num_queries": 1, "hidden_dim": 32,
                                "num_points": 16, "nheads": 2,
                                "enc_layers": 1, "dec_layers": 1,
                                "dim_feedforward": 32, "dropout": 0.0},
                "NMS_CONFIG": nms, "TARGET_CONFIG": {"ROI_PER_IMAGE": 16},
                "LOSS_CONFIG": {"CORNER_LOSS_REGULARIZATION": True,
                                "LOSS_WEIGHTS": {"rcnn_corner_weight": 1.0}}},
            "POST_PROCESSING": {"SCORE_THRESH": 0.1, "CAT_THRE": {
                "Car": 0.0, "Ped": 0.0, "Cyc": 0.0}}}
        opt = load_cfg("tools/cfgs/kitti_models/ct3d_3cat.yaml").OPTIMIZATION
        args = (EasyDict(model), 1, ["Car"], (32, 32, 32), (0.4, 0.4, 0.125),
                POINT_TINY_RANGE, 2, 256, 4)
        return EasyDict({"MODEL": model, "OPTIMIZATION": opt}), args, scene
    anchor = {"class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]],
              "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
              "align_center": False, "feature_map_stride": 1,
              "matched_threshold": 0.6, "unmatched_threshold": 0.45}
    model = {
        "NAME": "CaDDN",
        "VFE": {"NAME": "ImageVFE",
                "FFN": {"DDN_CFG": {"NUM_CHANNELS": 8, "NUM_BLOCKS": 2}},
                "DISCRETIZE": {"DEPTH_MIN": 2.0, "DEPTH_MAX": 20.0,
                               "NUM_BINS": 16}, "LOSS_WEIGHT": 3.0},
        "MAP_TO_BEV": {"NAME": "Conv2DCollapse", "NUM_BEV_FEATURES": 16},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [2],
                        "LAYER_STRIDES": [2], "NUM_FILTERS": [16],
                        "UPSAMPLE_STRIDES": [2], "NUM_UPSAMPLE_FILTERS": [16]},
        "DENSE_HEAD": {"NAME": "AnchorHeadSingle",
                       "USE_DIRECTION_CLASSIFIER": False,
                       "ANCHOR_GENERATOR_CONFIG": [anchor],
                       "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                           "cls_weight": 1.0, "loc_weight": 2.0,
                           "code_weights": [1.0] * 7}}},
        "POST_PROCESSING": {"SCORE_THRESH": 0.1, "NMS_CONFIG": {
            "NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7, "NMS_PRE_MAXSIZE": 32,
            "NMS_POST_MAXSIZE": 16}}}
    l2c = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2i = np.zeros((2, 3, 4), np.float32)
    for i in range(2):
        a = 0.15 * i
        yaw = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]], np.float32)
        l2c[i, :3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]],
                                  np.float32) @ yaw
        c2i[i, 0, 0] = c2i[i, 1, 1] = 30.0
        c2i[i, :2, 2] = (32.0, 24.0)
        c2i[i, 2, 2] = 1.0
    depth = rng.uniform(2, 18, (2, 48, 64)).astype(np.float32)
    depth[:, ::3] = 0.0
    gt = np.zeros((2, 3, 8), np.float32)
    gt[0, 0] = [6, 0, -1, 3.9, 1.6, 1.56, 0.2, 1]
    gt[0, 1] = [9.5, 3.0, -1, 3.9, 1.6, 1.56, 1.4, 1]
    gt[1, 0] = [4.3, -2.2, -1, 3.9, 1.6, 1.56, -0.3, 1]
    scene = {"images": rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32),
             "trans_lidar_to_cam": l2c, "trans_cam_to_img": c2i,
             "depth_maps": depth, "gt_boxes": gt,
             "gt_boxes2d": np.array([[[10, 8, 40, 30], [30, 2, 60, 20]],
                                     [[0, 0, 20, 47], [0, 0, 0, 0]]],
                                    np.float32)}
    opt = load_cfg("tools/cfgs/kitti_models/CaDDN.yaml").OPTIMIZATION
    args = (EasyDict(model), 1, ["Car"], (16, 16, 4), (0.8, 0.8, 1.0),
            (0.0, -6.4, -2.0, 12.8, 6.4, 2.0), 2, 64, 1)
    return EasyDict({"MODEL": model, "OPTIMIZATION": opt}), args, scene


def late_tiny_check(torch, name, seed):
    """14a for one model (``tiny_card_check``): CT3D with foreground RoIs,
    CaDDN with its depth loss, the multi head's second group with a
    loss."""
    cfg, args, scene = late_tiny(name, seed)
    need = {"ct3d": "rcnn_loss_reg", "caddn": "depth_loss",
            "second_multi": "rpn_head1_loss"}[name]
    return tiny_card_check(torch, "14a", name, cfg, args, scene, seed, need)


def late_tiny_reference(torch):
    """14a: ``late_tiny_check`` for the tiny CaDDN, CT3D_3CAT and SECOND
    with AnchorHeadMulti/ATSS, with no kernel of K1-K7 launched."""
    from mssvt_tpu_torch import kernels

    for name in LATE_TINY:
        kernels.reset_launch_counts()
        r = late_tiny_check(torch, name, seed=23)
        counts = kernels.launch_counts()
        if counts != KITTI_STEP:
            raise AssertionError(f"14a {name}: launches {counts}")
        log(f"# 14a tiny {name} ({r['detector']}, f32): {r['kept'][0]} "
            f"detections agree as sets within {r['kept'][1]:.3g} of max(1, "
            f"|value|); one train_step: loss card {r['loss'][0]:.6f} vs CPU "
            f"{r['loss'][1]:.6f} (relative {r['loss'][2]:.3g}), gradient "
            f"norm {r['gnorm'][0]:.6g} vs {r['gnorm'][1]:.6g} (relative "
            f"{r['gnorm'][2]:.3g}); repeated backward bit-identical; "
            "launches: none")


def ct3d_sites():
    """``Spans`` sites of 14b: the proposal NMS, the CT3D head's RoI point
    sampling and its transformer."""
    from mssvt_tpu_torch.models.model_utils import ctrans
    from mssvt_tpu_torch.models.roi_heads import ct3d_head, roi_head_template

    return [(roi_head_template, "proposal_layer", "proposal NMS"),
            (ct3d_head, "sample_roi_points", "sample_roi_points"),
            (ctrans.CTransformer, "forward", "CTransformer")]


def ct3d_files_path(torch, card):
    """14b: ``ct3d_3cat.yaml`` at its published widths (f32) at batch 2 (the
    yaml says 4; 12b's and 13b's batch), with ``MODEL.MAX_POINTS`` (16 384)
    passed to the DATA_CONFIG as ``pv_rcnn.yaml`` sets it (the yaml leaves
    it out, so its dataset would yield no raw points), trained for one
    epoch (2 steps) and served (1 request) through the entry points from a
    file-backed KITTI tree with gt_sampling on, then the official R40
    evaluation of ``result.pkl``; no step or request launches a kernel of
    K1-K7. Prints raw points and live RoIs a frame, each synchronised step
    and request with the proposal NMS's share, the profiled step and
    request (the NMS, the RoI point sampling and the transformer), the
    peaks and the phase's seconds."""
    import shutil

    from mssvt_tpu_torch.datasets.kitti import KittiDataset, create_kitti_infos
    from mssvt_tpu_torch.datasets.synthetic_files import write_kitti_tree
    from mssvt_tpu_torch.utils.edict import EasyDict

    t_phase = time.time()
    root = FILES_DATA / "kitti_ct3d"
    shutil.rmtree(root, ignore_errors=True)
    write_kitti_tree(root, LATE_FILES["train"], LATE_FILES["val"],
                     LATE_FILES["points"], seed=0)
    model_yaml = "tools/cfgs/kitti_models/ct3d_3cat.yaml"
    max_points = int(load_cfg(model_yaml).MODEL.MAX_POINTS)
    cfg_path, cfg = files_config(model_yaml, {"DATA_PATH": str(root),
                                              "MAX_POINTS": max_points},
                                 "ct3d_3cat_kitti_files")
    data, classes = EasyDict(cfg["DATA_CONFIG"]), cfg["CLASS_NAMES"]
    create_kitti_infos(data, ["Car", "Pedestrian", "Cyclist"], root, root)
    label, bsz, sites = "14b ct3d_3cat", 2, ct3d_sites()
    with Spans(torch, sites) as spans:
        seen = drive_files_entry_points(
            torch, cfg_path, ROOT / "output" / "chip_smoke" / "ct3d_runs",
            label, batch=bsz)
    if len(seen["request"]) != 1:
        raise AssertionError(f"{label}: {len(seen['request'])} requests")
    for kind in ("step", "request"):
        for i, (per, *_r) in enumerate(seen[kind]):
            if per != KITTI_STEP:
                raise AssertionError(f"{label} {kind} {i}: launches {per}")
    loader_line(seen, cfg, label, card, batch=bsz)
    pts = [int(v) for kind in ("step", "request") for _, b, _ in seen[kind]
           for v in b["points_valid"].reshape(bsz, -1).sum(1).tolist()]
    live, nms_cfg = spans.live, cfg["MODEL"]["ROI_HEAD"]["NMS_CONFIG"]
    log(f"# {label}: raw points a frame {pts} against MAX_POINTS "
        f"{max_points}; live RoIs a frame after the proposal NMS, train "
        f"{live[:len(seen['step'])]} (post "
        f"{nms_cfg['TRAIN']['NMS_POST_MAXSIZE']} of "
        f"{nms_cfg['TRAIN']['NMS_PRE_MAXSIZE']} candidates), test "
        f"{live[len(seen['step']):]} (post "
        f"{nms_cfg['TEST']['NMS_POST_MAXSIZE']} of "
        f"{nms_cfg['TEST']['NMS_PRE_MAXSIZE']}); host seconds over the "
        "entry points: " + ", ".join(f"{k} {v:.4f}"
                                     for k, v in spans.spent.items())
        + f" [{card}]")
    ds = KittiDataset(data, classes, training=False, seed=0)
    kitti_official_check(seen["result"], root, ds, classes, label)
    runs = {kind: (seen[f"{kind}_model"], seen[kind][-1][1])
            for kind in ("step", "request")}
    shares = [nms_share(torch, *runs[kind], cfg, kind, sites)
              for kind in runs]
    log(f"# {label}: proposal NMS share by the host clock, "
        + "; ".join(shares) + f" [{card}]")
    profile_two_stage(torch, runs, cfg, "ct3d_3cat", card, sites=sites,
                      phase="14b", top=5)
    log(f"# 14b: phase {time.time() - t_phase:.1f} s (entry points "
        f"{seen['seconds']:.1f} s) [{card}]")
    del runs, seen
    torch.cuda.empty_cache()


def caddn_config():
    """``CaDDN.yaml`` with its BEV backbone's first stride 2 (pcdet's
    CaDDN.yaml's, LAYER_STRIDES [2, 2]): as shipped, strides [1, 2] with
    upsampling [1, 2] leave the map at stride 1 (376 x 280 x 6 = 631 680
    predictions) while the anchors are laid at stride 2 (157 920), and both
    packages fail at the decode (tests/test_torch_caddn.py). Every width
    stays the yaml's."""
    cfg = load_cfg("tools/cfgs/kitti_models/CaDDN.yaml")
    cfg.MODEL.BACKBONE_2D.LAYER_STRIDES = [2, 2]
    return cfg


def caddn_batches(np, n, seed, bsz=CADDN_BATCH):
    """``n`` seeded in-memory CaDDN batches of ``bsz`` frames: images;
    the KITTI tree's calibration (``synthetic_files.KITTI_CALIB``: R0_rect
    x Tr_velo_to_cam, and P2); 8 GT boxes a frame in front of the camera
    (the three classes' sizes) and their 2D boxes
    (``kitti.boxes_camera_to_imageboxes``); a sparse depth map of
    CADDN_DEPTH_PIXELS seeded pixels a frame from 1 to 60 m (some outside
    [DEPTH_MIN, DEPTH_MAX])."""
    from mssvt_tpu_torch.datasets.kitti import (
        Calibration,
        boxes_camera_to_imageboxes,
        boxes_lidar_to_camera,
    )
    from mssvt_tpu_torch.datasets.synthetic_files import KITTI_CALIB

    path = FILES_DATA / "caddn" / "calib.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(KITTI_CALIB)
    calib = Calibration(path)
    r0 = np.eye(4)
    r0[:3, :3] = calib.R0
    v2c = np.vstack([calib.V2C, [0, 0, 0, 1]])
    l2c = (r0 @ v2c).astype(np.float32)
    rng = np.random.default_rng(seed)
    h, w = CADDN_IMAGE
    sizes = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}
    out = []
    for _ in range(n):
        gt = np.zeros((bsz, 8, 8), np.float32)
        box2d = np.zeros((bsz, 8, 4), np.float32)
        depth = np.zeros((bsz, h, w), np.float32)
        for b in range(bsz):
            for j in range(8):
                c = 1 + j % 3
                x = rng.uniform(6, 40)
                gt[b, j] = [x, rng.uniform(-0.3, 0.3) * x,
                            sizes[c][2] / 2 - 1.7, *sizes[c],
                            rng.uniform(-np.pi, np.pi), c]
            box2d[b] = boxes_camera_to_imageboxes(
                boxes_lidar_to_camera(gt[b, :, :7], calib), calib,
                CADDN_IMAGE)
            px = rng.integers(0, h * w, CADDN_DEPTH_PIXELS)
            depth[b].reshape(-1)[px] = rng.uniform(1.0, 60.0, len(px))
        out.append({
            "images": rng.uniform(0, 1, (bsz, h, w, 3)).astype(np.float32),
            "trans_lidar_to_cam": np.tile(l2c, (bsz, 1, 1)),
            "trans_cam_to_img": np.tile(calib.P2.astype(np.float32),
                                        (bsz, 1, 1)),
            "depth_maps": depth, "gt_boxes": gt, "gt_boxes2d": box2d})
    return out


def caddn_sites():
    """``Spans`` sites of 14c: the camera branch's DepthFFN and sampler
    (per frame), the collapse, the BEV backbone, the anchor head's maps
    and the post-processing (the score threshold and NMS)."""
    from mssvt_tpu_torch.models.backbones_2d import base_bev_backbone, map_to_bev
    from mssvt_tpu_torch.models.backbones_3d import image_vfe
    from mssvt_tpu_torch.models.dense_heads import anchor_head
    from mssvt_tpu_torch.models.detectors import generic_post

    return [(image_vfe.DepthFFN, "forward", "DepthFFN"),
            (image_vfe.ImageVFE, "sample_frame", "sampler"),
            (map_to_bev.Conv2DCollapse, "forward", "Conv2DCollapse"),
            (base_bev_backbone.BaseBEVBackbone, "forward", "BEV backbone"),
            (anchor_head.AnchorHeadSingle, "forward", "anchor head"),
            (generic_post, "post_process_anchor", "post_process_anchor")]


def caddn_path(torch, card):
    """14c: ``CaDDN.yaml`` (``caddn_config``) at its published widths (a
    280 x 376 x 25 camera grid, 64 FFN channels, 80 depth bins, 375 x 1242
    images), f32, at the yaml's batch 4, seeded weights (for the request
    the class bias zero, as 10a's, so that anchors pass the score
    threshold and the NMS takes NMS_PRE_MAXSIZE candidates, as a trained
    model's would): 2 ``train_step``s
    and 1 request (``eval_step``) on seeded in-memory batches, each
    checked to launch no kernel of K1-K7; finite losses (with the depth
    loss) and detections of the expected shapes. Prints each synchronised
    step and request, the parts' host seconds, the profiled step and
    request (the parts' device time: their forward kernels), the peaks and
    the phase's seconds."""
    import math

    import numpy as np

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.runtime.eval_utils import eval_step
    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import train_step

    t_phase = time.time()
    label = "14c CaDDN"
    cfg = caddn_config()
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vs = tuple(dc.DATA_PROCESSOR[-1].VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    if grid != CADDN_GRID:
        raise AssertionError(f"{label}: grid {grid}")
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                          grid, vs, pcr, CADDN_BATCH, 16_000, 5,
                          num_point_features=4, device="cuda", seed=0)
    batches = [to_device(torch, b, "cuda")
               for b in caddn_batches(np, 3, seed=0)]
    opt, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                             total_steps=10, steps_per_epoch=5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps, losses, spent = [], [], []
    sites = caddn_sites()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with Spans(torch, sites) as spans:
        for batch in batches[:2]:
            spans.take()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, tb = train_step(model, opt, batch, gen)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            losses.append({k: round(float(v), 5) for k, v in
                           dict(tb, loss=loss).items()})
            spent.append(spans.take())
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        model.eval()
        with torch.no_grad():  # scores ~0.5: the NMS takes its candidates
            model.dense_head.conv_cls.bias.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boxes, scores, labels_, mask = eval_step(model, batches[2])
        torch.cuda.synchronize()
        request = time.perf_counter() - t0
        spent.append(spans.take())
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    counts = kernels.launch_counts()
    if counts != KITTI_STEP:
        raise AssertionError(f"{label}: launches {counts}")
    if not all(math.isfinite(v) for rec in losses for v in rec.values()) or \
            not all(rec["depth_loss"] > 0 for rec in losses):
        raise AssertionError(f"{label}: losses {losses}")
    post = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    if boxes.shape != (CADDN_BATCH, post, 7) or \
            not bool(torch.isfinite(boxes).all()) or \
            not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"{label}: detections {tuple(boxes.shape)}")
    log(f"# {label}: grid {grid} x {model.vfe.ffn.feat_head.out_channels} "
        f"channels, {model.vfe.n_bins} bins, images {CADDN_IMAGE}, batch "
        f"{CADDN_BATCH}, BEV backbone strides "
        f"{list(cfg.MODEL.BACKBONE_2D.LAYER_STRIDES)}, anchors "
        f"{model.dense_head.anchors.shape[0]}; synchronised steps "
        f"{[round(s, 4) for s in steps]} s, request {request:.4f} s; losses "
        f"{losses}; detections kept a frame {mask.sum(1).tolist()}; launches "
        f"none; peak device memory train {train_peak:.2f} GiB, request "
        f"{eval_peak:.2f} GiB [{card}]")
    for kind, rec in zip(("step 1", "step 2", "request"), spent):
        log(f"# {label} {kind} host seconds inside the parts (synchronised): "
            + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()) + f" [{card}]")
    runs = {"step": (model, batches[0]), "request": (model, batches[2])}
    profile_two_stage(torch, runs, cfg, "CaDDN", card, sites=sites,
                      phase="14c", top=8)
    log(f"# 14c: phase {time.time() - t_phase:.1f} s [{card}]")
    del model, opt, batches, runs
    torch.cuda.empty_cache()


# -------------------------------------------------------------- phase 15
# the bench, its tools and the convergence gate
BENCH_KEYS = {"metric", "value", "unit", "mfu", "sync_ms_per_frame",
              "sync_ms_per_frame_median", "train_ms_per_step",
              "train_ms_per_frame", "train_compile_s", "device"}
ABLATE_ITERS = 3  # 15c: timed requests a cut
BENCH_TIMEOUT = 600


def bench_phase(torch, card):
    """15a: ``bench_torch.py --profile`` in a subprocess, its JSON line
    checked, then the top families of its traces."""
    import contextlib
    import io
    import math

    trace_dir = ROOT / "output" / "chip_smoke" / "bench_profile"
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "--profile",
         str(trace_dir)], cwd=str(ROOT), capture_output=True, text=True,
        timeout=BENCH_TIMEOUT)
    for line in res.stderr.splitlines():
        if line.startswith("#"):
            log(f"# 15a bench_torch {line[2:]}")
    if res.returncode != 0:
        raise AssertionError(f"15a: bench_torch.py exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    if len(lines) != 1 or set(out) != BENCH_KEYS:
        raise AssertionError(f"15a: bench_torch.py printed {lines}")
    if out["metric"] != "e2e_inference_fps_single_chip" or \
            not 0 < out["mfu"] <= 1 or \
            not math.isfinite(out["train_ms_per_step"]) or \
            out["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"15a: bench_torch.py's line {out}")
    log(f"# 15a bench_torch.py --profile: {json.dumps(out)} "
        f"({time.time() - t0:.1f} s) [{card}]")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        load_tool("profile_top_ops_torch").main(
            [str(trace_dir), "--group", "--n", "8"])
    for line in buf.getvalue().splitlines():
        log(f"# 15a profile {line}")
    return out


def convergence_phase(torch, card):
    """15b: the golden scene's 120 adam_onecycle steps on the card and the
    JAX test's gate (loss tail < 0.5 x head, recall >= 0.5)."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.runtime import convergence

    t0 = time.time()
    kernels.reset_launch_counts()
    result = convergence.train_golden(
        "cuda", on_step=lambda i, loss: log(f"# 15b step {i}: loss {loss:.6f}")
        if i % 10 == 0 or i == convergence.STEPS - 1 else None)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if not {"fill", "fps", "attention", "attention_bwd"} <= set(counts):
        raise AssertionError(f"15b: launches {counts}")
    head, tail = convergence.gate(result)
    log(f"# 15b convergence: loss head (mean of the first 5) {head:.6f}, "
        f"tail (last 5) {tail:.6f} = {tail / head:.4f} x head (gate < 0.5); "
        f"recall {result['recall']:.3f} (gate >= 0.5; {result['detections']} "
        f"detections, {result['gt']} GT boxes); launches {counts}; "
        f"{time.time() - t0:.1f} s [{card}]")
    return result


def ablate_phase(torch, card):
    """15c: the ``none`` and ``attn`` cuts at full width with their
    launches checked, and the K3 microbench (the tools' JSON lines go to
    ``#`` lines: the last lines of stdout are the contract's)."""
    import contextlib
    import io

    t0 = time.time()
    tool = load_tool("ablate_e2e_torch")
    run = (*tool.setup(BATCH, device="cuda"), False)
    per = {n: v * ABLATE_ITERS for n, v in EXPECTED_LAUNCHES.items() if v}
    ms, buf = {}, io.StringIO()
    with contextlib.redirect_stdout(buf):
        for name, want in (("none", per),
                           ("attn", {k: v for k, v in per.items()
                                     if k != "attention"})):
            ms[name], got = tool.measure(name, run, n_iter=ABLATE_ITERS)
            if got != want:
                raise AssertionError(f"15c {name}: launches {got} != {want}")
        del run
        torch.cuda.empty_cache()
        load_tool("bench_attn_kernel_torch").main(["--iters", "5"])
    for line in buf.getvalue().splitlines():
        log(f"# 15c {line}")
    log(f"# 15c ablate: none {ms['none']:.3f}, attn {ms['attn']:.3f} ms a "
        f"frame ({ABLATE_ITERS} requests at batch {BATCH}; no attention "
        f"launch under the attn cut); phase 15c {time.time() - t0:.1f} s "
        f"[{card}]")
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 5
def main_path(torch, model, scenes):
    """One warm-up request, then REQUESTS requests cycling the scenes, each
    with its launch counts checked. Returns (launch counts of the measured
    requests, their host-clock times in ms)."""
    from mssvt_tpu_torch import kernels

    with torch.no_grad():
        model(scenes[-1])  # warm-up
    times, prev = [], None
    kernels.reset_launch_counts()
    for i in range(REQUESTS):
        seed = i % len(scenes)
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(scenes[seed])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        after = kernels.launch_counts()
        per = {n: after[n] - before[n] for n in after}
        if per != EXPECTED_LAUNCHES:
            raise AssertionError(f"request {i}: launches {per} != "
                                 f"{EXPECTED_LAUNCHES}")
        mask = out["final_mask"]
        for key in ("final_boxes", "final_scores"):
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"request {i}: non-finite {key}")
        for name, t in out["pred_dicts"][0].items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"request {i}: non-finite head map {name}")
        if out["final_boxes"].shape[:2] != mask.shape or mask.shape[0] != BATCH:
            raise AssertionError(f"request {i}: unexpected output shape")
        if prev is not None and torch.equal(prev, out["final_scores"]):
            raise AssertionError("identical outputs for different scenes")
        prev = out["final_scores"]
        log(f"# request {i} (scene seed {seed}, batch {BATCH}): {ms:.1f} ms, "
            f"kept boxes per frame {mask.sum(dim=1).tolist()}, launches {per}")
    return kernels.launch_counts(), times


def log_launch_times(prof, label, key):
    """Device time of each launch whose kernel name holds ``key``, in order."""
    evs = sorted((e for e in prof.events()
                  if "CUDA" in str(getattr(e, "device_type", "")) and key in e.name),
                 key=lambda e: e.time_range.start)
    ms = [e.self_device_time_total / 1e3 for e in evs]
    log(f"# profile: {label} launches in order: "
        + ", ".join(f"{t:.3f}" for t in ms) + f" ms (sum {sum(ms):.3f})")


def profile_request(torch, model, scene, request_ms):
    """Device time by kernel name for one request (after the main path),
    the headline number of a request; the busy share divides it by the
    median unprofiled request time, since the profiler itself slows the
    host."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            model(scene)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    total = sum(e.self_device_time_total for e in events) / 1e3
    log(f"# headline: one request, device kernels {total:.3f} ms = "
        f"{100 * total / request_ms:.1f}% of the median request time "
        f"{request_ms:.1f} ms (wall under the profiler {wall_ms:.1f} ms)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    for label, key in (("attention (K3)", "attention_kernel"),
                       ("ffn (K4)", "ffn_mma_kernel"), ("fps (K2)", "fps_kernel"),
                       ("fill (K1)", "::fill_kernel<")):
        log_launch_times(prof, f"{label} in one request", key)


# -------------------------------------------------------------- phase 6a
def grad_vector(torch, model):
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .detach().float().reshape(-1)
                      for p in model.parameters()])


def small_train_reference(torch, ref_compat_keys=True):
    """mssvt_tiny.yaml, one f32 training step: CUDA kernels (K5 for the
    attention backward; K6/K7 where nq >= 8 with ``ref_compat_keys`` off)
    vs the plain versions on the CPU."""
    import numpy as np

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.runtime.train_utils import forward_backward

    args, n_feat, scene = tiny_setup(17, with_gt=True,
                                     ref_compat_keys=ref_compat_keys)
    label = "small training reference" + ("" if ref_compat_keys else
                                          ", ref_compat_keys off")
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_network(*args, num_point_features=n_feat, device=dev,
                              seed=11)
        kernels.reset_launch_counts()
        loss, _ = forward_backward(model, to_device(torch, scene, dev),
                                   torch.Generator(device=dev).manual_seed(0))
        res[dev] = (float(loss), grad_vector(torch, model).cpu(),
                    kernels.launch_counts())
    torch.cuda.synchronize()
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, counts) = res["cpu"], res["cuda"]
    ran = (counts["attention_bwd"] == 2 if ref_compat_keys else
           counts["attention_bwd"] == 0 and counts["attention_qk_bwd"] >= 1
           and counts["attention_qk"] == counts["attention_qk_bwd"])
    if not ran or not np.isfinite(l_gpu):
        raise AssertionError(f"{label}: launches {counts}, loss {l_gpu}")
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    norm = g_cpu.norm().item()
    gerr = (g_gpu - g_cpu).abs().max().item()
    if rel > 1e-4 or not gerr <= 1e-3 * norm:
        raise AssertionError(f"{label}: loss {l_gpu} vs "
                             f"{l_cpu}, gradient error {gerr} (norm {norm})")
    log(f"# {label} (mssvt_tiny.yaml, f32): loss card "
        f"{l_gpu:.6f} vs CPU {l_cpu:.6f} (relative {rel:.3g}); largest "
        f"gradient difference {gerr:.3g} = {gerr / norm:.3g} of the global "
        f"norm {norm:.4g}; launches {counts}")


# -------------------------------------------------------------- phase 6b
BWD_PARTS = (("pre-pass", "live_"), ("per-window", "attn_"),
             ("weight product", "wgrad_"), ("final sums", "finalize_"))


def profile_bwd_call(torch, name, call):
    """Device time of each launch inside one K5 or K7 call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    ms = {label: 0.0 for label, _ in BWD_PARTS}
    other = 0.0
    for e in prof.key_averages():
        t = e.self_device_time_total / 1e3
        for label, key in BWD_PARTS:
            if key in e.key:
                ms[label] += t
                break
        else:
            other += t
    parts = ", ".join(f"{label} {t:.3f} ms" for label, t in ms.items() if t)
    log(f"# profile: one {name} call on the card: {parts}; other device "
        f"work of the wrapper {other:.3f} ms")


def capture_block0_backward(torch, model, batch, gen):
    """One training forward and backward, recording K5's call with the
    most windows (block 0)."""
    from mssvt_tpu_torch.kernels import attention_bwd
    from mssvt_tpu_torch.runtime.train_utils import forward_backward

    orig = attention_bwd.fused_window_attention_assembled_bwd
    box = {}

    def rec(*a, **k):
        if "a" not in box or a[0].shape[0] > box["a"][0].shape[0]:
            box["a"], box["k"] = a, k
        return orig(*a, **k)

    attention_bwd.fused_window_attention_assembled_bwd = rec
    try:
        model.zero_grad()
        forward_backward(model, batch, gen)
        torch.cuda.synchronize()
    finally:
        attention_bwd.fused_window_attention_assembled_bwd = orig
    model.zero_grad()
    return box["a"], box["k"]


def bwd_kernel_phase(torch, a, k, profiled=False):
    from mssvt_tpu_torch.kernels import attention, attention_bwd, work

    kern = attention_bwd.fused_window_attention_assembled_bwd
    plain = attention.attention_bwd_plain
    flat = lambda r: [(n, t) for n, t in zip(
        ("dwin1", "dk2", "dq_ext", "dpad_row", "dpos_base", "dpos_w",
         "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwp", "dbp"),
        (*r[:6], *r[6])) if t is not None]
    with torch.no_grad():
        got = flat(kern(*a, **k))
        again = flat(kern(*a, **k))
        want = flat(plain(*a, **k))
        torch.cuda.synchronize()
        err = worst = 0.0
        dbv = dict(want)["dbv"].float().abs().max().item()
        for (name, g), (_, ag), (_, w) in zip(got, again, want):
            if not torch.equal(g, ag):
                raise AssertionError(f"attention_bwd: {name} differs on a "
                                     "repeated call")
            g, w = g.float(), w.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"attention_bwd: non-finite {name}")
            e = (g - w).abs().max().item()
            # dbk is analytically zero (softmax rows are shift-invariant, so
            # each row of dS sums to zero): rounding noise on both sides,
            # held against max |dbv|, a sum over the same tokens
            scale = dbv if name == "dbk" else w.abs().max().item()
            err, worst = max(err, e), max(worst, e / max(scale, 1e-30))
            if e > BF16_TOL * max(scale, 1e-6):
                raise AssertionError(f"attention_bwd: {name} max abs error "
                                     f"{e} > {BF16_TOL} x max |plain| {scale}")
        log(f"# attention_bwd: max abs error {err:.4g}; worst cotangent "
            f"error relative to its max |plain|: {worst:.4g} (limit "
            f"{BF16_TOL:.4g}); {len(got)} cotangents, bit-identical on a "
            "repeated call")
        del got, again, want
        ms = time_ms(torch, lambda: kern(*a, **k), reps=5, warm=1)
        if profiled:
            profile_bwd_call(torch, "attention_bwd", lambda: kern(*a, **k))
        plain_ms = time_ms(torch, lambda: plain(*a, **k), reps=1, warm=1)
    log_plan("attention_bwd", attention_bwd.kernel_plan(*asm_layout(a, k)),
             "per-window kernel")
    bound_ms, bound_by = work.attention_bwd(*a, **k).bound()
    shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]
    log(f"# kernel attention_bwd: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={err:.3g} "
        f"inputs={shapes} num_valid={int(k['num_valid'])}")
    return kernel_row("attention_bwd", err, ms, plain_ms, bound_ms, bound_by)


# -------------------------------------------------------------- phase 7b
def capture_block0_qk_backward(torch, model, batch, gen, others=None):
    """One flag-off training forward and backward, recording K7's call with
    the most windows (block 0); its inputs are K6's too. Every call's inputs
    are appended to the list ``others``, if given."""
    from mssvt_tpu_torch.kernels import attention_qk_bwd
    from mssvt_tpu_torch.runtime.train_utils import forward_backward

    orig = attention_qk_bwd.fused_window_attention_bwd
    box = {}

    def rec(*a, **k):
        if "a" not in box or a[0].shape[0] > box["a"][0].shape[0]:
            box["a"], box["k"] = a, k
        if others is not None:
            others.append((a, k))
        return orig(*a, **k)

    attention_qk_bwd.fused_window_attention_bwd = rec
    try:
        model.zero_grad()
        forward_backward(model, batch, gen)
        torch.cuda.synchronize()
    finally:
        attention_qk_bwd.fused_window_attention_bwd = orig
    model.zero_grad()
    return box["a"], box["k"]


def qk_kernel_phase(torch, a, k, profiled=False, others=()):
    """K6 and K7 against their plain versions on block 0's inputs; K6 is
    also held against its plain version, and timed, on the inputs of the
    calls in ``others`` with fewer windows (the later blocks)."""
    from mssvt_tpu_torch.kernels import attention_qk, attention_qk_bwd, work

    query, keys, proj, key_bias, g = a
    nw = g.shape[0]
    live = work.live_windows(g)
    fkw = dict(num_heads=k["num_heads"], scale=k["scale"],
               compute_dtype=k["compute_dtype"])
    fwd = lambda fn: fn(query, keys, proj, key_bias, **fkw)
    bwd = lambda fn: fn(*a, **k)
    flat = lambda r: list(zip(
        ("dq", "dk", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwp", "dbp"),
        (*r[:2], *r[2])))
    rows = {}
    fb_ms, fb_by = work.attention_qk(query, keys, proj, key_bias,
                                     **fkw).bound()
    bb_ms, bb_by = work.attention_qk_bwd(*a, **k).bound()
    with torch.no_grad():
        got = fwd(attention_qk.fused_window_attention)
        want = fwd(attention_qk.attention_qk_plain)
        torch.cuda.synchronize()
        err = compare("attention_qk", got, want, a, k, torch)
        del got, want
        ms = time_ms(torch, lambda: fwd(attention_qk.fused_window_attention),
                     reps=10, warm=2)
        plain_ms = time_ms(torch, lambda: fwd(attention_qk.attention_qk_plain),
                           reps=3, warm=1)
        rows["attention_qk"] = kernel_row("attention_qk", err, ms, plain_ms,
                                          fb_ms, fb_by)
        log(f"# kernel attention_qk: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={fb_ms:.4f} ({fb_by}) max_abs_err={err:.3g} "
            f"query={tuple(query.shape)} keys={tuple(keys.shape)}")
        log_plan("attention_qk", attention_qk.kernel_plan(
            query.shape[1], keys.shape[1], query.shape[2], k["num_heads"]))
        for (q2, keys2, proj2, kb2, _), kw2 in sorted(
                others, key=lambda c: -c[0][0].shape[0]):
            if q2.shape[0] < nw:
                fwd2 = lambda fn: fn(
                    q2, keys2, proj2, kb2, num_heads=kw2["num_heads"],
                    scale=kw2["scale"], compute_dtype=kw2["compute_dtype"])
                compare("attention_qk",
                        fwd2(attention_qk.fused_window_attention),
                        fwd2(attention_qk.attention_qk_plain), a, k, torch)
                ms2 = time_ms(
                    torch, lambda: fwd2(attention_qk.fused_window_attention),
                    reps=10, warm=2)
                log(f"# kernel attention_qk at a later block: ms={ms2:.4f} "
                    f"query={tuple(q2.shape)} keys={tuple(keys2.shape)}")

        got = flat(bwd(attention_qk_bwd.fused_window_attention_bwd))
        again = flat(bwd(attention_qk_bwd.fused_window_attention_bwd))
        want = flat(bwd(attention_qk_bwd.attention_qk_bwd_plain))
        torch.cuda.synchronize()
        walked = int(attention_qk_bwd.last_list[-1])
        if walked != live:
            raise AssertionError(f"attention_qk_bwd: walked {walked} windows, "
                                 f"{live} have a nonzero g")
        log(f"# attention_qk_bwd: the per-window kernel walked {walked} of "
            f"{nw} windows (those whose g has a nonzero element)")
        err = worst = 0.0
        dbv = dict(want)["dbv"].float().abs().max().item()
        for (name, gt), (_, ag), (_, wt) in zip(got, again, want):
            if not torch.equal(gt, ag):
                raise AssertionError(f"attention_qk_bwd: {name} differs on "
                                     "a repeated call")
            gt, wt = gt.float(), wt.float()
            if not torch.isfinite(gt).all():
                raise AssertionError(f"attention_qk_bwd: non-finite {name}")
            e = (gt - wt).abs().max().item()
            # dbk is analytically zero: held against max |dbv| (see 6b)
            scale = dbv if name == "dbk" else wt.abs().max().item()
            err, worst = max(err, e), max(worst, e / max(scale, 1e-30))
            if e > BF16_TOL * max(scale, 1e-6):
                raise AssertionError(
                    f"attention_qk_bwd: {name} max abs error {e} > "
                    f"{BF16_TOL} x max |plain| {scale}")
        log(f"# attention_qk_bwd: max abs error {err:.4g}; worst cotangent "
            f"error relative to its max |plain|: {worst:.4g} (limit "
            f"{BF16_TOL:.4g}); {len(got)} cotangents, bit-identical on a "
            "repeated call")
        del got, again, want
        ms = time_ms(torch,
                     lambda: bwd(attention_qk_bwd.fused_window_attention_bwd),
                     reps=5, warm=1)
        if profiled:
            profile_bwd_call(
                torch, "attention_qk_bwd",
                lambda: bwd(attention_qk_bwd.fused_window_attention_bwd))
        plain_ms = time_ms(torch,
                           lambda: bwd(attention_qk_bwd.attention_qk_bwd_plain),
                           reps=1, warm=1)
    log_plan("attention_qk_bwd", attention_qk_bwd.kernel_plan(
        query.shape[1], keys.shape[1], query.shape[2], k["num_heads"]),
        "per-window kernel")
    rows["attention_qk_bwd"] = kernel_row("attention_qk_bwd", err, ms,
                                          plain_ms, bb_ms, bb_by)
    log(f"# kernel attention_qk_bwd: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bb_ms:.4f} ({bb_by}) max_abs_err={err:.3g} "
        f"g={tuple(g.shape)}")
    return rows


# -------------------------------------------------------------- phase 6c
BACKBONE_GRADS = ("ms_attn.to_q", "ms_attn.to_kv", "ms_attn.proj",
                  "pos_proj.proj0", "linear1", "linear2")


def check_step_grads(torch, model, i):
    """Finite gradient for every parameter; nonzero ones for the 3D
    backbone's attention, position and FFN parameters and the head;
    returns the global gradient norm."""
    nonzero = {k: False for k in BACKBONE_GRADS + ("dense_head",)}
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"step {i}: no finite gradient for {name}")
        if p.grad.abs().max().item() > 0:
            for key in nonzero:
                if name.startswith("backbone_3d.") and key in name or \
                        name.startswith(key):
                    nonzero[key] = True
    missing = [k for k, v in nonzero.items() if not v]
    if missing:
        raise AssertionError(f"step {i}: zero gradients for {missing}")
    norm = grad_vector(torch, model).norm().item()
    if not (norm > 0 and norm < float("inf")):
        raise AssertionError(f"step {i}: gradient norm {norm}")
    return norm


def train_path(torch, model, optimizer, scenes, gen, expected, label="train"):
    """One warm-up train_step, then TRAIN_STEPS train_steps cycling the
    scenes, then the first measured step's forward and backward again from
    the same weights, batch and generator state: the gradients must repeat
    bit for bit. Returns (launch counts of the measured steps, their
    host-clock times in ms)."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.runtime.train_utils import forward_backward, train_step

    train_step(model, optimizer, scenes[-1], gen)  # warm-up
    start = ({k: v.detach().clone() for k, v in model.state_dict().items()},
             gen.get_state())
    grads1, times = None, []
    kernels.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        seed = i % len(scenes)
        scene = scenes[seed]
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tb = train_step(model, optimizer, scene, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        after = kernels.launch_counts()
        per = {n: after[n] - before[n] for n in after}
        if per != expected:
            raise AssertionError(f"{label} step {i}: launches {per} != "
                                 f"{expected}")
        if not torch.isfinite(loss):
            raise AssertionError(f"{label} step {i}: loss {loss.item()}")
        norm = check_step_grads(torch, model, i)
        if i == 0:
            grads1 = [p.grad.clone() for p in model.parameters()]
        log(f"# {label} step {i} (scene seed {seed}, batch {BATCH}): {ms:.1f} ms, "
            f"loss {loss.item():.4f} (hm {tb['hm_loss_head_0'].item():.4f}, "
            f"loc {tb['loc_loss_head_0'].item():.4f}), gradient norm "
            f"{norm:.4g}, launches {per}")
    counts = kernels.launch_counts()
    model.load_state_dict(start[0])
    gen.set_state(start[1])
    model.zero_grad()
    forward_backward(model, scenes[0], gen)
    torch.cuda.synchronize()
    same = all(torch.equal(p.grad, g) for p, g in zip(model.parameters(),
                                                      grads1))
    if not same:
        raise AssertionError(f"{label} step 0 repeated: gradients differ")
    log(f"# {label} step 0 repeated from the same weights, batch and generator "
        f"state: bit-identical gradients over {len(grads1)} parameters")
    return counts, times


def profile_train_step(torch, model, optimizer, scene, gen, step_ms, label,
                       forward_kernel):
    """Device time of one more train step (the headline number of a step),
    its busy share of the median step, and the device time of each launch
    of its attention forward and of K2 (``forward_kernel``: label, name)."""
    from torch.profiler import ProfilerActivity, profile

    from mssvt_tpu_torch.runtime.train_utils import train_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(model, optimizer, scene, gen)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    total = sum(e.self_device_time_total for e in events) / 1e3
    log(f"# headline: one {label} step, device kernels {total:.3f} ms = "
        f"{100 * total / step_ms:.1f}% of the median step time {step_ms:.1f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    log_launch_times(prof, f"{forward_kernel[0]} in one train step",
                     forward_kernel[1])
    log_launch_times(prof, "fps (K2) in one train step", "fps_kernel")
    log_launch_times(prof, "fill (K1) in one train step", "::fill_kernel<")


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    if not (ROOT / "mssvt_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo (mssvt_tpu_torch "
              "missing next to this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    log(f"# card: {card}")
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; TF32 off for matmul and cuDNN")

    from mssvt_tpu_torch.datasets.synthetic_scene import make_waymo_scale_scene
    from mssvt_tpu_torch.kernels import _lib
    from mssvt_tpu_torch.models import build_network

    t0 = time.time()
    _lib.lib()
    log(f"# kernel build: {time.time() - t0:.1f} s "
        f"(nvcc {' '.join(_lib.NVCC_FLAGS)}; fresh build: "
        f"{_lib.BUILD_SECONDS is not None})")
    from mssvt_tpu_torch.ops import voxelize

    t0 = time.time()
    voxelize.host_library()
    log(f"# host voxelizer build: {time.time() - t0:.1f} s "
        f"(g++ {' '.join(voxelize.GXX_FLAGS)})")

    small_reference(torch)

    cfg = load_cfg("tools/cfgs/waymo_models/mssvt.yaml")
    max_voxels = 90_000 * BATCH
    model = build_network(cfg.MODEL, 3, CLASSES, GRID, VOXEL, PCR, BATCH,
                          max_voxels, 5, num_point_features=5, device="cuda",
                          seed=0)
    scenes = []
    for seed in range(3):
        scene, n = make_waymo_scale_scene(max_voxels, GRID, seed=seed,
                                          batch=BATCH)
        scenes.append(to_device(torch, scene, "cuda"))
        log(f"# scene {seed}: {n} voxels over {BATCH} frames")

    captured = capture_first_calls(torch, model, scenes[0])
    rows = kernel_phase(torch, captured)
    fps_planes = tuple(captured["fps"][0][:3])  # block 0: (192 000, 96)
    rows.update(fps_picks_phase(torch, fps_planes))
    del captured
    torch.cuda.empty_cache()

    counts, request_times = main_path(torch, model, scenes)
    log(f"# inference: requests {stats_line(request_times)}")
    for name, n in EXPECTED_LAUNCHES.items():
        if n:
            rows[name]["launches"] = counts[name]
            if counts[name] == 0:
                raise AssertionError(f"kernel {name} was not launched on "
                                     "the main path")
    profile_request(torch, model, scenes[0], median(request_times))
    log(f"# inference: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # cuDNN deterministic for the training phases (6 and 7): their repeated
    # backward must give bit-identical gradients
    from mssvt_tpu_torch.runtime.train_utils import set_deterministic

    set_deterministic()
    small_train_reference(torch)

    from mssvt_tpu_torch.datasets.synthetic_scene import add_synth_gt
    from mssvt_tpu_torch.runtime.optimization import build_optimizer

    for i, scene in enumerate(scenes):
        scene["gt_boxes"] = torch.as_tensor(
            add_synth_gt({}, BATCH, seed=i)["gt_boxes"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, k = capture_block0_backward(torch, model, scenes[0], gen)
    rows["attention_bwd"] = bwd_kernel_phase(torch, a, k,
                                             "--profile" in argv)
    del a, k
    torch.cuda.empty_cache()

    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                                   total_steps=TRAIN_STEPS + 2, steps_per_epoch=1)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_counts, step_times = train_path(torch, model, optimizer, scenes, gen,
                                          TRAIN_LAUNCHES)
    log(f"# training: steps {stats_line(step_times)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in TRAIN_LAUNCHES:
        if TRAIN_LAUNCHES[name] and train_counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "training path")
    rows["attention_bwd"]["launches"] = train_counts["attention_bwd"]
    profile_train_step(torch, model, optimizer, scenes[1], gen,
                       median(step_times), "pad-key",
                       ("attention (K3)", "attention_kernel"))
    del model, optimizer
    torch.cuda.empty_cache()

    # phases 7a-7d: ref_compat_keys off (K6/K7), and the FPS entry point
    small_train_reference(torch, ref_compat_keys=False)
    cfg = load_cfg("tools/cfgs/waymo_models/mssvt.yaml", ref_compat_keys=False)
    model = build_network(cfg.MODEL, 3, CLASSES, GRID, VOXEL, PCR, BATCH,
                          max_voxels, 5, num_point_features=5, device="cuda",
                          seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    qk_calls = []
    a, k = capture_block0_qk_backward(torch, model, scenes[0], gen, qk_calls)
    rows.update(qk_kernel_phase(torch, a, k, "--profile" in argv, qk_calls))
    del a, k, qk_calls
    torch.cuda.empty_cache()
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                                   total_steps=TRAIN_STEPS + 2, steps_per_epoch=1)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    off_counts, off_times = train_path(torch, model, optimizer, scenes, gen,
                                       FLAG_OFF_LAUNCHES,
                                       "train (ref_compat_keys off)")
    log(f"# training, ref_compat_keys off: steps {stats_line(off_times)}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    profile_train_step(torch, model, optimizer, scenes[1], gen,
                       median(off_times), "flag-off",
                       ("attention_qk (K6)", "attention_qk_kernel"))
    sampling_counts = sampling_path(torch, fps_planes)
    del model, optimizer
    torch.cuda.empty_cache()

    pipeline_counts, pipeline_steps = pipeline_path(torch, card)
    for name in set(PIPELINE_STEP) | set(PIPELINE_REQUEST):
        if (PIPELINE_STEP[name] or PIPELINE_REQUEST[name]) and \
                pipeline_counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "pipeline path")
    torch.cuda.empty_cache()

    # phase 9: data parallel (9a: the entry points under DDP on NCCL at
    # world 1; 9b: two gloo ranks on this card against one process)
    ddp_counts = ddp_pipeline(torch, card, pipeline_steps[:2])
    for name in set(DDP_STEP) | set(DDP_REQUEST):
        if (DDP_STEP[name] or DDP_REQUEST[name]) and ddp_counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "data-parallel path")
    torch.cuda.empty_cache()
    ddp_ranks_check(torch, card)
    # phase 9c-9d: the demo, the pcdet importer, the on-device voxelizer
    demo_counts = demo_and_import(torch, card)
    for name, n in EXPECTED_LAUNCHES.items():
        if n and demo_counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "demo")
    voxelizer_device_check(torch, card)
    # phase 10: SECOND and PointPillar (no kernel of K1-K7 on their path)
    kitti_tiny_reference(torch)
    kitti_pipeline(torch, card)
    torch.cuda.empty_cache()
    # phase 11: the file-backed datasets (11a Waymo with mssvt.yaml, 11b
    # KITTI with SECOND)
    files_counts = waymo_files_path(torch, card)
    for name in set(PIPELINE_STEP) | set(PIPELINE_REQUEST):
        if (PIPELINE_STEP[name] or PIPELINE_REQUEST[name]) and \
                files_counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "file-backed path")
    torch.cuda.empty_cache()
    kitti_files_path(torch, card)
    torch.cuda.empty_cache()
    # phase 12: the two-stage voxel family (no kernel of K1-K7 on its path)
    two_stage_tiny_reference(torch)
    two_stage_files_path(torch, card)
    torch.cuda.empty_cache()
    # phase 13: the point-based two-stage family (K2c and K2b on its FPS)
    t13 = time.time()
    point_tiny_reference(torch)
    point_files_path(torch, card)
    log(f"# 13: phase {time.time() - t13:.1f} s [{card}]")
    torch.cuda.empty_cache()
    # phase 14: CaDDN, CT3D_3CAT and AnchorHeadMulti/ATSS (no kernel of
    # K1-K7 on their path)
    t14 = time.time()
    late_tiny_reference(torch)
    ct3d_files_path(torch, card)
    caddn_path(torch, card)
    log(f"# 14: phase {time.time() - t14:.1f} s [{card}]")
    torch.cuda.empty_cache()
    # phase 15: the bench, its tools and the convergence gate
    t15 = time.time()
    bench_phase(torch, card)
    convergence_phase(torch, card)
    ablate_phase(torch, card)
    log(f"# 15: phase {time.time() - t15:.1f} s [{card}]")
    for name, counts_ in (("attention_qk", off_counts),
                          ("attention_qk_bwd", off_counts),
                          ("fps_picks_warp", sampling_counts),
                          ("fps_picks_block", sampling_counts)):
        if counts_[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on its "
                                 "path")
        rows[name]["launches"] = counts_[name]
    missing = [n for n in KERNEL_NAMES
               if n not in rows or not rows[n]["launches"]]
    if missing:
        raise AssertionError(f"kernels without a row or a launch: {missing}")
    log(f"# total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [rows[n] for n in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
