"""Each per-layer reader on a small hand-made chrome trace."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spec, trace


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# two requests of batch 2 over [0, 1000) us: 600 us of device time in
# 5 kernels, of which K3 100 us; the backbone range launches 2 kernels
EVENTS = [
    ev("bench.request", "user_annotation", 0, 500),
    ev("bench.request", "user_annotation", 500, 500),
    ev("bench.backbone_3d", "user_annotation", 10, 200),
    ev("bench.post", "user_annotation", 300, 150),
    ev("aten::nonzero", "cpu_op", 300, 150),
    ev("cudaLaunchKernel", "cuda_runtime", 20, 5, 1),
    ev("cudaLaunchKernel", "cuda_runtime", 30, 5, 2),
    ev("cudaLaunchKernel", "cuda_runtime", 250, 5, 3),
    ev("cudaLaunchKernel", "cuda_runtime", 600, 5, 4),
    ev("cudaLaunchKernel", "cuda_runtime", 700, 5, 5),
    ev("void attention_kernel<bf16>(Args)", "kernel", 40, 100, 1),
    ev("vectorized_elementwise_kernel", "kernel", 140, 100, 2),
    ev("index_elementwise_kernel", "kernel", 260, 40, 3),
    ev("reduce_kernel", "kernel", 610, 160, 4),
    ev("ampere_gemm", "kernel", 780, 200, 5),
]


def rec(**kw):
    base = dict(events=EVENTS, requests=2, batch=2, post_s=[0.001, 0.003],
                frames_per_s=40.0, flops_per_frame=2e12,
                peak_flops=989e12, k3_bound_ms=0.05)
    base.update(kw)
    return SimpleNamespace(**base)


def reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name,want", [
    ("device_idle_pct.infer", 100 * (1 - 600 / 1000)),
    ("launches_per_frame.infer", 5 / 4),
    ("backbone_device_ms.infer", 0.2 / 4),
    ("post_host_ms.infer", 1e3 * 0.004 / 4),
    ("mfu.infer", 100 * 2e12 * 40 / 989e12),
    ("k3_roofline_pct.infer", 100 * 0.05 / 0.1),
])
def test_reader(name, want):
    assert reader(name).read(rec()) == pytest.approx(want)


def test_readers_with_nothing_to_read_return_none():
    empty = rec(events=[ev("bench.request", "user_annotation", 0, 10)],
                post_s=[], k3_bound_ms=0.0, flops_per_frame=0.0)
    for name in ("launches_per_frame.infer", "backbone_device_ms.infer",
                 "post_host_ms.infer", "mfu.infer", "k3_roofline_pct.infer"):
        assert reader(name).read(empty) is None, name


def test_breakdown():
    win = trace.window(EVENTS, "bench.request")
    assert win == (0, 1000)
    assert trace.busy(EVENTS, win) == 600
    fams = dict(trace.top_families(EVENTS, win))
    assert fams["K3 attention"] == pytest.approx(1e-4)
    assert fams["cuBLAS GEMM"] == pytest.approx(2e-4)
    gaps = dict(trace.idle_gaps(EVENTS, win))
    assert sum(gaps.values()) == pytest.approx(400e-6)
    # each gap is named by what the host ran at its start
    assert gaps["bench.post/aten::nonzero"] == pytest.approx(310e-6)
