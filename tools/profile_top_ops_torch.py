"""Top-op tables from the ``torch.profiler`` chrome traces that
``bench_torch.py --profile DIR`` writes (the counterpart of
``tools/profile_top_ops.py``, which reads JAX's xplane traces).

    python tools/profile_top_ops_torch.py DIR_OR_TRACE [--n 40] [--group]
        [--match REGEX] [--host]

Reads every ``*.json`` under DIR (or the one trace named) and, for each,
sums the device events' durations by name (kernels, memcpy and memset
activities), prints the top ``--n`` and the device-busy share of the traced
window: the union of the device events' intervals over the span from the
trace's first event to its last, which says how far the host holds the card
back. ``--group`` collapses the names into families: the port's kernels by
their CUDA names (K1 fill, K2/K2b fps, K2c fps_block, K3 attention, K4 ffn,
K5 attention_bwd, K6 attention_qk, K7 attention_qk_bwd, and the weight
product with its sums that K5 and K7 share), cuBLAS GEMM (``nvjet_*``
under CUDA 12.8), cuDNN conv, elementwise, index, reduce, memcpy (with
``torch.cat``'s copies), other. ``--host`` sums the host's aten
ops (``cpu_op`` events, inclusive of the ops they call) instead: what to
read where the card idles.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
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
    ("K5/K7 weight product and sums", r"\b(wgrad_(wgmma|fma)|finalize)_kernel\b"),
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


def traces(path):
    path = Path(path)
    found = sorted(path.rglob("*.json")) if path.is_dir() else [path]
    if not found:
        raise SystemExit(f"no *.json trace under {path}")
    return found


def busy_ms(intervals):
    """Length of the union of (start, end) intervals (us) in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def summarise(events, host=False, match=None, group=False):
    """(totals {key: ms}, counts {key: n}, selected ms, device busy ms,
    window ms) of one trace's events."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    picked = [e for e in spans if e.get("cat") == "cpu_op"] if host else device
    totals, counts = collections.Counter(), collections.Counter()
    selected = 0.0
    for e in picked:
        name = e.get("name", "")
        if match and not re.search(match, name):
            continue
        key = family(name) if group and not host else name
        ms = e["dur"] / 1e3
        totals[key] += ms
        counts[key] += 1
        selected += ms
    window = 0.0
    if spans:
        window = (max(e["ts"] + e["dur"] for e in spans)
                  - min(e["ts"] for e in spans)) / 1e3
    busy = busy_ms((e["ts"], e["ts"] + e["dur"]) for e in device)
    return totals, counts, selected, busy, window


def report(path, args):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    totals, counts, selected, busy, window = summarise(
        events, args.host, args.match, args.group)
    what = "host aten ops (inclusive)" if args.host else "device events"
    print(f"# {path}: {what} {selected:.3f} ms"
          f"{f' matching {args.match!r}' if args.match else ''}; device busy "
          f"{busy:.3f} of the traced window's {window:.3f} ms "
          f"({100 * busy / window if window else 0.0:.1f}%)")
    width = max((len(k[:120]) for k, _ in totals.most_common(args.n)),
                default=10)
    for name, ms in totals.most_common(args.n):
        share = 100 * ms / selected if selected else 0.0
        print(f"{ms:10.3f} ms {share:5.1f}%  x{counts[name]:<6d} "
              f"{name[:120]:<{width}}")
    return totals, busy, window


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a trace or a directory of traces")
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--group", action="store_true",
                    help="collapse device event names into families")
    ap.add_argument("--match", default=None,
                    help="only events whose name matches this regex")
    ap.add_argument("--host", action="store_true",
                    help="the host's aten ops instead of the device events")
    args = ap.parse_args(argv)
    return {str(p): report(p, args) for p in traces(args.trace)}


if __name__ == "__main__":
    main()
