"""Closed-loop inference: one request in flight, as OpenPCDet's eval loop
(``runtime/eval_utils.eval_step``) sends them. Each request is a batch of
the traffic's distinct batches, cycled, through the detector's eval
forward; every frame's boxes, scores, labels and mask are read back to the
host inside the window.

Set-up: the inputs from the seed (host, then moved once), the plain
reference and the benchmark's weights on the device, the program's model
with those weights, one warm request for each distinct batch. The window
runs requests until ``seconds`` have passed; ``infer_frames_per_s`` is the
frames whose detections reached the host over the window's seconds. With
``trace`` a few requests after the window run under ``torch.profiler``
(ranges around each request, the 3-D backbone and the post-processing,
whose host time is also taken between two synchronisations). Then the
program is freed and, for a sample of the distinct batches drawn from the
seed, the reference's ``judge`` holds the outputs the timed requests
produced (the modules its ``capture`` names, kept by forward hooks, and the
detections read back) against its own, stage by stage; those numbers
decide ``correct``."""

from __future__ import annotations

import gc
import math
import os
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import flops, program, trace, weights, work

PROFILED_REQUESTS = 3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Capture:
    """Forward hooks that keep the outputs of the modules at ``paths`` (the
    reference's ``capture``) for the batches in ``keep``, the latest request
    of each (references, no copies)."""

    def __init__(self, model, paths, keep):
        self.current = None
        self.keep = set(keep)
        self.got = {}
        self.handles = [_module(model, p).register_forward_hook(
            self._hook(p)) for p in paths]

    def _hook(self, path):
        def hook(module, args, out):
            if self.current in self.keep:
                self.got.setdefault(self.current, {})[path] = out
        return hook

    def close(self):
        for h in self.handles:
            h.remove()


def _module(model, path):
    for p in path.split("."):
        model = getattr(model, p)
    return model


class Spans:
    """``record_function`` ranges around the 3-D backbone and the
    post-processing calls, the latter also timed on the host between two
    synchronisations (profiled requests only)."""

    def __init__(self, model, post_calls, device):
        self.post_s = []
        self.undo = []
        self.open = []
        self.handles = [
            model.backbone_3d.register_forward_pre_hook(self._enter),
            model.backbone_3d.register_forward_hook(self._exit)]
        for dotted in post_calls:
            owner, attr = program.resolve(model, dotted)
            orig = getattr(owner, attr)
            own = attr in vars(owner)
            setattr(owner, attr, self._timed(orig, device))
            self.undo.append((owner, attr, orig, own))

    def _enter(self, module, args):
        rf = torch.profiler.record_function("bench.backbone_3d")
        rf.__enter__()
        self.open.append(rf)

    def _exit(self, module, args, out):
        self.open.pop().__exit__(None, None, None)

    def _timed(self, fn, device):
        def call(*a, **k):
            _sync(device)
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.post"):
                out = fn(*a, **k)
            _sync(device)
            self.post_s.append(time.perf_counter() - t0)
            return out
        return call

    def close(self):
        for h in self.handles:
            h.remove()
        for owner, attr, orig, own in self.undo:
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)


def _host(out):
    return tuple(o.cpu() for o in out)


def run(ctx):
    cell, device, batch = ctx.cell, ctx.device, ctx.cell.batch
    config = ctx.config
    phases = {}
    t = time.perf_counter()
    phases["imports"] = t - ctx.t0

    def phase(name):
        nonlocal t
        _sync(device)
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    gen, ref = cell.generator(), cell.reference()
    host_batches, live = gen.make(cell.traffic["params"], config, batch,
                                  ctx.seed)
    batches = [program.to_device(b, device) for b in host_batches]
    # the window cycles the batches in an order drawn from the seed; the
    # check takes the first ``check_batches`` of it (served first)
    order = _order(ctx.seed, len(batches))
    sample = sorted(order[:int(cell.own["check_batches"])])
    phase("inputs")
    ref_model = ref.build(config, batch, device)
    made = weights.make(ref_model, ctx.seed, device, batches[0], ref.forward)
    phase("weights")
    model = program.build(config, batch, device, made)
    phase("program")
    cap = Capture(model, ref.capture(ref_model), () if ctx.control else sample)
    for i, b in enumerate(batches):  # every shape this traffic uses
        cap.current = i
        _host(program.request(model, b))
    phase("warm-up")
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    setup_s = time.perf_counter() - ctx.t0

    served, n, times = {}, 0, []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    now = t0
    while n == 0 or now < deadline:
        i = order[n % len(order)]
        cap.current = i
        served[i] = _host(program.request(model, batches[i]))
        n += 1
        last, now = now, time.perf_counter()
        times.append(now - last)
    window_s = now - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = {"setup_s": setup_s, "phases": phases,
           "infer_frames_per_s": n * batch / window_s,
           "attempted": n, "failed": 0, "memory_peak_bytes": peak,
           "live_voxels": live, "window_s": window_s,
           "request_s": times}
    t = time.perf_counter()
    if ctx.trace:
        out["trace"] = _profile(model, batches, config, device, cap)
        out["trace"].update(frames_per_s=out["infer_frames_per_s"],
                            batch=batch,
                            peak_flops=work.PEAK_FLOPS[config["precision"]])
    cap.close()
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phase("profile" if ctx.trace else "release")

    if ctx.trace:  # the benchmark's own FLOP count of the profiled batches
        counts = []
        for i in range(out["trace"]["requests"]):
            with flops.counting(ref_model) as cnt:
                ref.forward(ref_model, batches[i])
            counts.append(cnt)
        out["trace"]["flops_per_frame"] = (sum(c.flops for c in counts)
                                           / (len(counts) * batch))
        out["trace"]["k3_bound_ms"] = sum(c.k3_bound_ms for c in counts)
        phase("count")

    judged = [i for i in sample if i in served]
    numbers = {k: 0.0 if judged else math.inf for k in ref.NUMBERS}
    for i in judged:
        got, dets = cap.got.get(i), served[i]
        if ctx.control:  # the reference one precision below stands in
            stand_in = Capture(ref_model, ref.capture(ref_model), (i,))
            stand_in.current = i
            with ctx.control():
                o = ref.forward(ref_model, batches[i])
            stand_in.close()
            got = stand_in.got[i]
            dets = _host((o["final_boxes"], o["final_scores"],
                          o["final_labels"], o["final_mask"]))
        for k, v in ref.judge(ref_model, batches[i], got, dets).items():
            numbers[k] = max(numbers[k], v)
        cap.got.pop(i, None)
    phase("check")
    out["numbers"] = numbers
    return out


def _order(seed, n):
    """The distinct batches' order in the window, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    return [int(i) for i in rng.permutation(n)]


def _profile(model, batches, config, device, cap):
    """Profile a few requests after the window: the trace's events and the
    post-processing spans."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans = Spans(model, config.get("post_calls", ()), device)
    k = min(PROFILED_REQUESTS, len(batches))
    try:
        with profile(activities=acts) as prof:
            for i in range(k):
                cap.current = i
                with record_function("bench.request"):
                    _host(program.request(model, batches[i]))
            _sync(device)
    finally:
        spans.close()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace.load(path)
    finally:
        os.unlink(path)
    return {"events": events, "requests": k, "post_s": spans.post_s}
