#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mssvt_tpu_torch``) on one card.

Run from the repo root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--profile]

Phases (any failed check raises and the script exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build from ``mssvt_tpu_torch/csrc`` (nvcc, sm_90a);
3. small-input reference: ``mssvt_tiny.yaml`` in f32 on the card (CUDA
   kernels) against the same seeded weights on the CPU (the kernels' plain
   versions, which the CPU tests hold against the JAX package);
4. per kernel, at ``mssvt.yaml`` block-0 shapes on inputs the port itself
   produced from a synthetic Waymo-scale scene: the CUDA kernel against its
   plain version on the card (fill and FPS exactly, attention and FFN within
   the bf16 tolerance below), both timed with CUDA events;
5. the main path: ``mssvt.yaml`` CenterPoint, full width, bf16, seeded
   random weights, answering 3 requests (3 distinct scenes of batch 4),
   with the kernel launch counts of every request checked;
6a. small-input training reference: one f32 ``mssvt_tiny.yaml`` training
   step on the card against the CPU plain path (loss within 1e-4 relative,
   every gradient within 1e-3 of the global gradient norm);
6b. K5, the attention backward, at ``mssvt.yaml`` block-0 shapes on the
   inputs of a full-width training forward and backward: the CUDA kernel
   against its plain version (each cotangent within the bf16 tolerance),
   both timed with CUDA events;
6c. the training path: 3 ``train_step``s of ``mssvt.yaml`` at full width,
   bf16, batch 4 on 3 scenes with seeded GT boxes, ``adam_onecycle`` with
   ``GRAD_NORM_CLIP: 10``: finite loss and gradient norm, a finite gradient
   for every parameter, nonzero ones for the 3D backbone's attention,
   position and FFN parameters and the head, the launch counts of every
   step; then step 1's forward and backward again from the same weights,
   batch and DropPath generator state, with bit-identical gradients.

With ``--profile`` one more request and one more training step run under
``torch.profiler`` and the device time per kernel name is printed (top
entries, and their sum as a share of the mean unprofiled request or step
time).

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
MEM_BPS = 3.35e12     # H100 SXM HBM3 bytes/s
BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
# bf16 keeps 8 significant bits. Kernel and plain version round the same
# intermediates to bf16 but sum in another order, so an intermediate can
# land one bf16 ulp apart and carry that through the next product; the
# outputs must agree to 2^-5 of their largest magnitude.
BF16_TOL = 2.0 ** -5
EXPECTED_LAUNCHES = {"fill": 5, "fps": 3, "attention": 3, "attention_bwd": 0,
                     "ffn": 3}
TRAIN_LAUNCHES = {"fill": 5, "fps": 3, "attention": 3, "attention_bwd": 3,
                  "ffn": 0}
TRAIN_STEPS = 3
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


def to_device(torch, scene, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in scene.items()}


def load_cfg(name):
    from mssvt_tpu_torch.config import cfg_from_yaml_file
    from mssvt_tpu_torch.utils.edict import EasyDict

    return cfg_from_yaml_file(str(ROOT / name), EasyDict())


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


def tiny_setup(seed, with_gt=False):
    """mssvt_tiny.yaml and a seeded 2-frame scene of up to 1024 voxels
    (with GT boxes for training): (cfg, build_network args, scene)."""
    import numpy as np

    cfg = load_cfg("tools/cfgs/synthetic_models/mssvt_tiny.yaml")
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
}


def capture_first_calls(torch, model, batch):
    """Run one forward, recording each inference kernel wrapper's first call
    (block 0 for all four)."""
    from mssvt_tpu_torch import kernels

    captured, saved = {}, {}
    for name in KERNEL_FUNCS:
        mod = kernels.KERNELS[name]
        fname = KERNEL_FUNCS[name][0]
        orig = getattr(mod, fname)
        saved[name] = orig

        def rec(*a, _n=name, _f=orig, **k):
            captured.setdefault(_n, (a, k))
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


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(name, a, k, torch):
    """(bound_ms, bound_by) for this call's data: bytes that must move
    (inputs once, outputs once; rows past num_valid are not read) over HBM
    rate vs the operations over the peak rate of their type."""
    if name == "fill":
        box, offs, cap = a[0], a[1], a[2]
        nw, kk = box.shape
        nv = int(k["num_valid"])
        cv = k["own_slab"][1] if k.get("own_slab") else 0
        by = nv * kk * 4 + nw * (2 * cap + cv + 8) * 4
        ops = nv * kk * 4  # load, compare, rank, store per entry (int32)
        return max(by / MEM_BPS, ops / F32_FLOPS) * 1e3, "bytes"
    if name == "fps":
        x, aux, npoint = a[0], a[3], a[4]
        rows, n = x.shape
        nv, half = int(k["num_valid"]), int(k["nw_half"])
        live = 2 * nv if half else nv
        planes = 3 + len(aux)
        by = live * n * 4 * planes + rows * npoint * 4 * (1 + planes)
        ops = live * (npoint - 1) * n * 10  # 3 sub, 3 mul, 2 add, min, cmp
        t_by, t_op = by / MEM_BPS, ops / F32_FLOPS
        return max(t_by, t_op) * 1e3, "bytes" if t_by >= t_op else "operations"
    if name == "attention":
        win1, k2, fps1 = a[0], a[1], a[2]
        nw, n1cap, d = win1.shape
        nk1, nk2 = fps1.shape[1], k2.shape[1]
        nkt = nk1 + nk2
        heads = k["num_heads"]
        nq = int(k["nq"]) if k["q_prefix"] else a[4].shape[1]
        nv = int(k["num_valid"])
        ph = d // sum(heads)
        mac_proj = sum((ph * h) ** 2 for h in heads)  # per token, one matrix
        macs = ((nq + 2 * nkt) * mac_proj + nq * mac_proj
                + 2 * sum(heads) * nq * (nkt // len(heads)) * ph)
        flops = 2 * macs * nv
        per_win = (n1cap * d * 2 + nk2 * d * 2 + nk1 * 5 + nq * 4
                   + (0 if k["q_prefix"] else nq * d * 2)
                   + 4 * 3 * (nkt + nq) + d * 2 + nkt * 4
                   + (d * 2 if k.get("pad_row") is not None else 0))
        by = nv * per_win + nw * nq * d * 2 + 4 * d * d * 2
        t_by, t_op = by / MEM_BPS, flops / BF16_FLOPS
        return max(t_by, t_op) * 1e3, "bytes" if t_by >= t_op else "operations"
    x, w1 = a[0], a[3]
    v, c = x.shape
    f = w1.shape[1]
    by = 2 * _nbytes(x) + 2 * c * f * 2
    flops = 4 * v * c * f
    t_by, t_op = by / MEM_BPS, flops / BF16_FLOPS
    return max(t_by, t_op) * 1e3, "bytes" if t_by >= t_op else "operations"


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
        bound_ms, bound_by = bound(name, a, k, torch)
        rows[name] = dict(
            name=name, route="cuda",
            source=f"mssvt_tpu_torch/csrc/{name}.cu",
            replaces=TPU_COUNTERPART[name], launches=None,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None)
        shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]
        log(f"# kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={err:.3g} "
            f"inputs={shapes}")
        del got, want
    return rows


# --------------------------------------------------------------- phase 5
def main_path(torch, model, scenes):
    from mssvt_tpu_torch import kernels

    outs, times = [], []
    kernels.reset_launch_counts()
    for i, scene in enumerate(scenes):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(scene)
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
        log(f"# request {i} (scene seed {i}, batch {BATCH}): {ms:.1f} ms, "
            f"kept boxes per frame {mask.sum(dim=1).tolist()}, launches {per}")
        outs.append(out)
    counts = kernels.launch_counts()
    for a, b in zip(outs, outs[1:]):
        if torch.equal(a["final_scores"], b["final_scores"]):
            raise AssertionError("identical outputs for different scenes")
    return counts, sum(times) / len(times)


def profile_request(torch, model, scene, request_ms):
    """Device time by kernel name for one request (after the main path);
    the busy share divides it by the mean unprofiled request time, since the
    profiler itself slows the host."""
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
    log(f"# profile: one request, device kernels {total:.1f} ms = "
        f"{100 * total / request_ms:.1f}% of the mean request time "
        f"{request_ms:.1f} ms (wall under the profiler {wall_ms:.1f} ms)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


# -------------------------------------------------------------- phase 6a
def grad_vector(torch, model):
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .detach().float().reshape(-1)
                      for p in model.parameters()])


def small_train_reference(torch):
    """mssvt_tiny.yaml, one f32 training step: CUDA kernels (K5 for the
    attention backward) vs the plain versions on the CPU."""
    import numpy as np

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.runtime.train_utils import forward_backward

    args, n_feat, scene = tiny_setup(17, with_gt=True)
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
    if counts["attention_bwd"] != 2 or not np.isfinite(l_gpu):
        raise AssertionError(f"small training reference: launches {counts}, "
                             f"loss {l_gpu}")
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    norm = g_cpu.norm().item()
    gerr = (g_gpu - g_cpu).abs().max().item()
    if rel > 1e-4 or not gerr <= 1e-3 * norm:
        raise AssertionError(f"small training reference: loss {l_gpu} vs "
                             f"{l_cpu}, gradient error {gerr} (norm {norm})")
    log(f"# small training reference (mssvt_tiny.yaml, f32): loss card "
        f"{l_gpu:.6f} vs CPU {l_cpu:.6f} (relative {rel:.3g}); largest "
        f"gradient difference {gerr:.3g} = {gerr / norm:.3g} of the global "
        f"norm {norm:.4g}; launches {counts}")


# -------------------------------------------------------------- phase 6b
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


def bwd_bound(a, k):
    """(bound_ms, bound_by) for one K5 call: inputs of live windows read
    once, every output written once, vs its block-diagonal products (the
    forward recompute, the backward and the full (D, D) weight products)
    at the bf16 tensor-core peak."""
    win1, k2, fps1 = a[0], a[1], a[2]
    nw, n1cap, d = win1.shape
    nk1, nk2 = fps1.shape[1], k2.shape[1]
    nkt = nk1 + nk2
    heads = k["num_heads"]
    nq = int(k["nq"]) if k["q_prefix"] else a[4].shape[1]
    nv = int(k["num_valid"])
    ph = d // sum(heads)
    nk = nkt // len(heads)
    mac_proj = sum((ph * h) ** 2 for h in heads)  # per token, one matrix
    attn = sum(heads) * nq * nk * ph              # one per-head product
    macs = ((nq + 2 * nkt) * mac_proj + 2 * attn       # forward recompute
            + nq * mac_proj + 4 * attn                 # dO, dA, dV, dQ, dK
            + (nq + 2 * nkt) * mac_proj                # dQ3, dK3
            + (2 * nq + 2 * nkt) * d * d)              # dW (full D x D)
    flops = 2 * macs * nv
    per_win = (n1cap * d * 2 + nk2 * d * 2 + nk1 * 5 + nq * 4
               + (0 if k["q_prefix"] else nq * d * 2)
               + 4 * 3 * (nkt + nq) + d * 2 + nkt * 4 + d * 2 + nq * d * 2)
    outs = nw * (n1cap * d * 2 + nk2 * d * 2 + 2 * d * 2
                 + (0 if k["q_prefix"] else nq * d * 2))
    by = nv * per_win + 4 * d * d * 2 + outs + (4 * d * d + 7 * d) * 4
    t_by, t_op = by / MEM_BPS, flops / BF16_FLOPS
    return max(t_by, t_op) * 1e3, "bytes" if t_by >= t_op else "operations"


def bwd_kernel_phase(torch, a, k):
    from mssvt_tpu_torch.kernels import attention, attention_bwd

    kern = attention_bwd.fused_window_attention_assembled_bwd
    plain = attention.attention_bwd_plain
    flat = lambda r: [(n, t) for n, t in zip(
        ("dwin1", "dk2", "dq_ext", "dpad_row", "dpos_base", "dpos_w",
         "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwp", "dbp"),
        (*r[:6], *r[6])) if t is not None]
    with torch.no_grad():
        got = flat(kern(*a, **k))
        want = flat(plain(*a, **k))
        torch.cuda.synchronize()
        err = worst = 0.0
        dbv = dict(want)["dbv"].float().abs().max().item()
        for (name, g), (_, w) in zip(got, want):
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
            f"{BF16_TOL:.4g}); {len(got)} cotangents")
        del got, want
        ms = time_ms(torch, lambda: kern(*a, **k), reps=5, warm=1)
        plain_ms = time_ms(torch, lambda: plain(*a, **k), reps=1, warm=1)
    bound_ms, bound_by = bwd_bound(a, k)
    shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]
    log(f"# kernel attention_bwd: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={err:.3g} "
        f"inputs={shapes} num_valid={int(k['num_valid'])}")
    return dict(name="attention_bwd", route="cuda",
                source="mssvt_tpu_torch/csrc/attention_bwd.cu",
                replaces=TPU_COUNTERPART["attention_bwd"], launches=None,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


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


def train_path(torch, model, optimizer, scenes, gen):
    """TRAIN_STEPS train_steps on distinct scenes, then step 1's forward
    and backward again from the same weights, batch and generator state:
    the gradients must repeat bit for bit. Returns (launch counts, mean
    step ms)."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.runtime.train_utils import forward_backward, train_step

    start = ({k: v.detach().clone() for k, v in model.state_dict().items()},
             gen.get_state())
    grads1, times = None, []
    kernels.reset_launch_counts()
    for i, scene in enumerate(scenes):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tb = train_step(model, optimizer, scene, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        times.append(ms)
        after = kernels.launch_counts()
        per = {n: after[n] - before[n] for n in after}
        if per != TRAIN_LAUNCHES:
            raise AssertionError(f"step {i}: launches {per} != {TRAIN_LAUNCHES}")
        if not torch.isfinite(loss):
            raise AssertionError(f"step {i}: loss {loss.item()}")
        norm = check_step_grads(torch, model, i)
        if i == 0:
            grads1 = [p.grad.clone() for p in model.parameters()]
        log(f"# train step {i} (scene seed {i}, batch {BATCH}): {ms:.1f} ms, "
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
        raise AssertionError("step 1 repeated: gradients differ")
    log(f"# step 1 repeated from the same weights, batch and generator "
        f"state: bit-identical gradients over {len(grads1)} parameters")
    return counts, sum(times) / len(times)


def profile_train_step(torch, model, optimizer, scene, gen, step_ms):
    """Device-busy share of one more train step."""
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
    log(f"# profile: one train step, device kernels {total:.1f} ms = "
        f"{100 * total / step_ms:.1f}% of the mean step time {step_ms:.1f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


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
    del captured
    torch.cuda.empty_cache()

    counts, request_ms = main_path(torch, model, scenes)
    for name, row in rows.items():
        row["launches"] = counts[name]
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    if "--profile" in argv:
        profile_request(torch, model, scenes[0], request_ms)
    log(f"# inference: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    small_train_reference(torch)

    from mssvt_tpu_torch.datasets.synthetic_scene import add_synth_gt
    from mssvt_tpu_torch.runtime.optimization import build_optimizer

    for i, scene in enumerate(scenes):
        scene["gt_boxes"] = torch.as_tensor(
            add_synth_gt({}, BATCH, seed=i)["gt_boxes"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, k = capture_block0_backward(torch, model, scenes[0], gen)
    rows["attention_bwd"] = bwd_kernel_phase(torch, a, k)
    del a, k
    torch.cuda.empty_cache()

    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                                   total_steps=TRAIN_STEPS, steps_per_epoch=1)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_counts, step_ms = train_path(torch, model, optimizer, scenes, gen)
    log(f"# training: mean step {step_ms:.1f} ms over {TRAIN_STEPS} steps; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    for name in TRAIN_LAUNCHES:
        if TRAIN_LAUNCHES[name] and train_counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "training path")
    rows["attention_bwd"]["launches"] = train_counts["attention_bwd"]
    if "--profile" in argv:
        profile_train_step(torch, model, optimizer, scenes[1], gen, step_ms)
    log(f"# total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
