"""Reading a ``torch.profiler`` chrome trace: device events, their union,
the kernels launched inside a host range, kernel families and the idle
gaps. The family grouping is a frozen copy of the port's
``tools/profile_top_ops_torch.py``."""

from __future__ import annotations

import collections
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# (family, regex on the event name), first match wins: the port's kernels
# before the library families (K5/K7's wgrad kernels are no cuDNN wgrad)
FAMILIES = (
    ("K1 fill", r"\bfill_kernel\b"),
    ("K2c fps_block", r"\bfps_block_kernel\b"),
    ("K2/K2b fps", r"\bfps_kernel\b"),
    ("K3 attention", r"\battention_kernel\b"),
    ("K4 ffn", r"\bffn_(mma|fma)_kernel\b"),
    ("K5 attention_bwd", r"\battn_bwd_kernel\b"),
    ("K6 attention_qk", r"\battention_qk_kernel\b"),
    ("K7 attention_qk_bwd", r"\b(attn_qk_bwd|live_flags|live_list)_kernel\b"),
    ("K5/K7 weight product and sums",
     r"\b(wgrad_(wgmma|fma)|finalize)_kernel\b"),
    ("memcpy", r"^Memcpy|^Memset|memcpy|memset|CatArrayBatchedCopy"),
    ("cuDNN conv", r"conv|cudnn|fprop|dgrad|wgrad|nchwToNhwc|nhwcToNchw"),
    ("cuBLAS GEMM", r"gemm|gemv|cutlass|cublas|xmma|Kernel2|nvjet"),
    ("index", r"index|gather|scatter|take|put_kernel"),
    ("reduce", r"reduce|Reduce|softmax|norm_kernel|argmax|topk|sort|scan"),
    ("elementwise", r"elementwise|Elementwise"),
)


def family(name):
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


def load(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def complete(events):
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device(events, cats=DEVICE_CATS):
    return [e for e in complete(events) if e.get("cat") in cats]


def ranges(events, name):
    """(start, end) in us of the host ranges called ``name``."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in complete(events)
                  if e.get("cat") in HOST_CATS and e.get("name") == name)


def clip(intervals, window):
    lo, hi = window
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def union(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def window(events, name):
    """The span from the first range ``name`` to the end of the last."""
    rs = ranges(events, name)
    return (rs[0][0], rs[-1][1]) if rs else None


def busy(events, win):
    return union(clip([(e["ts"], e["ts"] + e["dur"]) for e in device(events)],
                      win))


def launched_within(events, host_ranges, cats=("kernel",)):
    """Device events whose launch (the runtime call of the same
    correlation id) starts inside one of ``host_ranges``."""
    launch = {}
    for e in complete(events):
        if e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = e["ts"]
    starts = [s for s, _ in host_ranges]
    out = []
    for e in device(events, cats):
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = _bisect(starts, t)
        if i >= 0 and t <= host_ranges[i][1]:
            out.append(e)
    return out


def _bisect(starts, t):
    lo, hi = 0, len(starts)
    while lo < hi:
        mid = (lo + hi) // 2
        if starts[mid] <= t:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


def top_families(events, win, n=10):
    """[[family, seconds]] of the device events inside ``win``."""
    tot = collections.Counter()
    for e in device(events):
        s, t = e["ts"], e["ts"] + e["dur"]
        if t > win[0] and s < win[1]:
            tot[family(e.get("name", ""))] += (min(t, win[1])
                                               - max(s, win[0])) / 1e6
    return [[k, v] for k, v in tot.most_common(n)]


def idle_gaps(events, win, n=10, min_us=5.0):
    """[[host activity, seconds]]: the device's idle time inside ``win``,
    each gap named by the outermost host op running at its start, inside
    the innermost ``bench.`` range."""
    dev = sorted((max(e["ts"], win[0]), min(e["ts"] + e["dur"], win[1]))
                 for e in device(events)
                 if e["ts"] + e["dur"] > win[0] and e["ts"] < win[1])
    gaps, end = [], win[0]
    for s, e in dev:
        if s - end >= min_us:
            gaps.append((end, s))
        end = max(end, e)
    if win[1] - end >= min_us:
        gaps.append((end, win[1]))
    host = sorted(((e["ts"], e["ts"] + e["dur"], e.get("name", ""),
                    e.get("cat")) for e in complete(events)
                   if e.get("cat") in HOST_CATS), key=lambda h: h[0])
    starts = [h[0] for h in host]
    tot = collections.Counter()
    for g0, g1 in gaps:
        label, scope = "host (no op)", ""
        i = _bisect(starts, g0)
        outer = None
        # the covering ranges: scan back over the ranges started before g0
        for h in host[max(0, i - 4000):i + 1][::-1]:
            if h[1] >= g0:
                if h[2].startswith("bench."):
                    scope = scope or h[2]
                elif h[3] == "cpu_op":
                    outer = h[2]
        if outer:
            label = outer
        tot[f"{scope}/{label}" if scope else label] += (g1 - g0) / 1e6
    return [[k, v] for k, v in tot.most_common(n)]
