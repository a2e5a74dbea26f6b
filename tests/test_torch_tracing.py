"""The port's stage spans (``runtime/tracing.py``) on the tiny voxel
detectors, and the benchmark's five readers of them on a hand-made chrome
trace."""

import contextlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import spec, trace
from mssvt_tpu_torch.models import build_network
from mssvt_tpu_torch.runtime import tracing
from mssvt_tpu_torch.runtime.eval_utils import eval_step
from mssvt_tpu_torch.utils.edict import EasyDict
from test_model_forward import (
    BATCH,
    GRID,
    MAX_PTS,
    MAX_VOXELS,
    PC_RANGE,
    VOXEL_SIZE,
    synthetic_batch,
    tiny_model_cfg,
)
from test_parta2 import parta2_cfg
from test_second_pointpillar import make_batch as second_batch
from test_torch_ct3d import ct3d_batch, ct3d_cfg
from test_torch_pvrcnn import PAIRS as PVRCNN_CFGS
from test_torch_pvrcnn import point_batch
from test_torch_roi import build_kw, make_batch, second_iou_cfg
from test_torch_second import _build_kw as second_kw
from test_torch_second import _cfg as second_cfg
from test_voxel_rcnn import voxelrcnn_cfg

STAGES = ("vfe", "backbone_3d", "map_to_bev", "backbone_2d", "head", "post")
KEYS = ("voxels", "voxel_num_points", "voxel_coords", "voxel_valid")


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    model = build_network(
        EasyDict(tiny_model_cfg()), 2, ["Car", "Ped"], GRID, VOXEL_SIZE,
        PC_RANGE, BATCH, MAX_VOXELS, MAX_PTS, num_point_features=5,
        device="cpu")
    b = synthetic_batch(np.random.default_rng(1))
    return model, {k: torch.as_tensor(np.array(b[k])) for k in KEYS}


def _two_stage(cfg, batch):
    """A tiny two-stage detector of the RoI harness's sizes (seeded
    weights) and its batch as tensors."""
    model = build_network(EasyDict(json.loads(json.dumps(cfg))), **build_kw(),
                          num_point_features=4, device="cpu")
    return model, {k: torch.as_tensor(v) for k, v in batch.items()}


# each voxel family's tiny config and batch, as its own test builds them
VOXEL_DETECTORS = {
    "SECONDNet": lambda: (
        build_network(EasyDict(second_cfg("second")),
                      **second_kw("second"), num_point_features=4,
                      device="cpu"),
        {k: torch.as_tensor(v) for k, v in
         second_batch(np.random.default_rng(0)).items()}),
    "SECONDNetIoU": lambda: _two_stage(
        second_iou_cfg(), make_batch(np.random.default_rng(0))),
    "VoxelRCNN": lambda: _two_stage(voxelrcnn_cfg(),
                                    make_batch(np.random.default_rng(0))),
    "PVRCNN": lambda: _two_stage(PVRCNN_CFGS["pvrcnn"](), point_batch()),
    "PartA2": lambda: _two_stage(parta2_cfg(),
                                 make_batch(np.random.default_rng(0))),
    "CT3D_3CAT": lambda: _two_stage(ct3d_cfg(),
                                    ct3d_batch(np.random.default_rng(0))),
}


def profiled_request(model, batch, tmp_path):
    """``eval_step`` under ``torch.profiler``: (detections, trace events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = eval_step(model, batch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, trace.load(path)


def span_names(events):
    return sorted(e["name"] for e in trace.complete(events)
                  if e.get("cat") in trace.HOST_CATS
                  and e["name"].startswith(tracing.PREFIX))


# the spans a two-stage family opens inside ``mssvt.post`` after the NMS, in
# order
SECOND_STAGE = {"SECONDNetIoU": ("roi_head",), "VoxelRCNN": ("roi_head",),
                "PVRCNN": ("keypoints", "pfe", "roi_head"),
                "PartA2": ("roi_head",), "CT3D_3CAT": ("roi_head",)}
# the ball queries of a request (one ``mssvt.ball_query`` each): the tiny
# PV-RCNN's raw-point and sparse-source pooling in ``mssvt.pfe`` and its
# RoI-grid pooling in ``mssvt.roi_head``, one radius each
BALL_QUERIES = {"PVRCNN": 3}


def _inside(inner, outer):
    return any(s <= inner[0] and inner[1] <= e for s, e in outer)


@pytest.mark.parametrize("name", ["CenterPoint"] + sorted(VOXEL_DETECTORS))
def test_request_makes_seven_spans_in_order(name, tiny, tmp_path):
    """The request and its six stages, in order and disjoint, for every
    voxel detector; the one NMS call's ``mssvt.nms`` nests in
    ``mssvt.post``, the sparse-conv tables' ``mssvt.spconv_rules`` in
    ``mssvt.backbone_3d``; a two-stage family's second-stage spans
    (``mssvt.roi_head``, after PV-RCNN's ``mssvt.keypoints`` and
    ``mssvt.pfe``) follow the NMS inside ``mssvt.post``, in order and
    disjoint; PV-RCNN's ball queries each open ``mssvt.ball_query`` inside
    ``mssvt.pfe`` or ``mssvt.roi_head``."""
    model, batch = tiny if name == "CenterPoint" else VOXEL_DETECTORS[name]()
    _, events = profiled_request(model, batch, tmp_path)
    inner = SECOND_STAGE.get(name, ())
    want = ["mssvt." + s for s in ("request",) + STAGES + ("nms",) + inner]
    names = span_names(events)
    rules = names.count("mssvt.spconv_rules")
    queries = BALL_QUERIES.get(name, 0)
    assert names == sorted(want + ["mssvt.spconv_rules"] * rules
                           + ["mssvt.ball_query"] * queries)
    second = [r for s in ("pfe", "roi_head")
              for r in trace.ranges(events, "mssvt." + s)]
    assert all(_inside(r, second)
               for r in trace.ranges(events, "mssvt.ball_query"))
    assert (rules > 0) == (name != "CenterPoint")
    (req,) = trace.ranges(events, "mssvt.request")
    stages = [trace.ranges(events, "mssvt." + s)[0] for s in STAGES]
    assert req[0] <= stages[0][0] and stages[-1][1] <= req[1]
    for (_, end), (start, _) in zip(stages, stages[1:]):
        assert end <= start
    (nms,) = trace.ranges(events, "mssvt.nms")
    assert stages[-1][0] <= nms[0] and nms[1] <= stages[-1][1]
    post = [nms] + [trace.ranges(events, "mssvt." + s)[0] for s in inner]
    for (_, end), (start, _) in zip(post, post[1:]):
        assert end <= start
    assert post[-1][1] <= stages[-1][1]
    for start, end in trace.ranges(events, "mssvt.spconv_rules"):
        assert stages[1][0] <= start and end <= stages[1][1]


@pytest.fixture(scope="module")
def pointrcnn():
    """The benchmark's rehearsal PointRCNN (pcdet's RoI head) on the CPU,
    seeded weights, and one batch of its traffic."""
    reh = json.loads(json.dumps(spec.load_json(
        spec.BENCH / "rehearsal" / "pointrcnn-kitti.json")))
    data = reh["data"]
    model = build_network(
        EasyDict(reh["MODEL"]), 3, reh["class_names"],
        tuple(data["grid_size"]), tuple(data["voxel_size"]),
        tuple(data["point_cloud_range"]), 2, data["max_voxels_per_frame"],
        data["max_points_per_voxel"], num_point_features=4, device="cpu")
    from benchmark.traffic import kitti_points_scene

    host, _ = kitti_points_scene.make(
        dict(reh["traffic"]["params"], distinct_batches=1), reh, 2, 7)
    return model, {k: torch.as_tensor(v) for k, v in host[0].items()}


def test_pointrcnn_request_spans_in_order(pointrcnn, tmp_path):
    """PointRCNN's request opens ``mssvt.backbone_3d``, ``mssvt.head`` and
    ``mssvt.post`` in order and disjoint inside ``mssvt.request``; each of
    ``PointNet2MSG``'s four set abstractions opens ``mssvt.sa`` and each of
    its four feature propagations ``mssvt.fp``, in order inside
    ``mssvt.backbone_3d``; the proposals' ``mssvt.nms`` and then
    ``mssvt.roi_head`` lie inside ``mssvt.post``; each ball query opens
    ``mssvt.ball_query``, two in each ``mssvt.sa`` (a radius each) and two
    in ``mssvt.roi_head`` (the head's first two levels)."""
    model, batch = pointrcnn
    _, events = profiled_request(model, batch, tmp_path)
    names = span_names(events)
    assert names == sorted(["mssvt.request", "mssvt.backbone_3d",
                            "mssvt.head", "mssvt.post", "mssvt.nms",
                            "mssvt.roi_head"] + ["mssvt.sa"] * 4
                           + ["mssvt.fp"] * 4 + ["mssvt.ball_query"] * 10)
    queries = trace.ranges(events, "mssvt.ball_query")
    for sa in trace.ranges(events, "mssvt.sa"):
        assert sum(_inside(q, [sa]) for q in queries) == 2
    assert sum(_inside(q, trace.ranges(events, "mssvt.roi_head"))
               for q in queries) == 2
    (req,) = trace.ranges(events, "mssvt.request")
    stages = [trace.ranges(events, "mssvt." + s)[0]
              for s in ("backbone_3d", "head", "post")]
    assert req[0] <= stages[0][0] and stages[-1][1] <= req[1]
    levels = (trace.ranges(events, "mssvt.sa")
              + trace.ranges(events, "mssvt.fp"))
    for outer, inner in [(stages[0], levels),
                         (stages[2], [trace.ranges(events, "mssvt.nms")[0],
                                      trace.ranges(events,
                                                   "mssvt.roi_head")[0]])]:
        assert outer[0] <= inner[0][0] and inner[-1][1] <= outer[1]
        for (_, end), (start, _) in zip(inner, inner[1:]):
            assert end <= start
    for (_, end), (start, _) in zip(stages, stages[1:]):
        assert end <= start


def test_no_record_function_without_a_profiler(tiny, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    eval_step(*tiny)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError):
            tracing.span("request")


def test_spans_change_no_output(tiny, tmp_path, monkeypatch):
    got, events = profiled_request(*tiny, tmp_path)
    monkeypatch.setattr(tracing, "span",
                        lambda name: contextlib.nullcontext())
    want, plain = profiled_request(*tiny, tmp_path)
    assert span_names(plain) == []
    assert len(span_names(events)) == 8  # the request, six stages, the NMS
    assert int(want[3].sum()) > 0  # some boxes kept
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the readers --------------------------------------------------------------


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def host(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


# one request of 2 frames in [0, 1000) us. Launches (correlation id: launch
# time -> device interval): 1 vfe 25 -> [30, 50); 2 backbone 70 -> [100,
# 300); 11 backbone 390 -> [400, 405), run inside map_to_bev; 3 map_to_bev
# 410 -> [410, 430); 4 backbone_2d 460 -> [460, 520); 5 head 560 -> [560,
# 600); 9 post 700 -> [700, 720); 6 before the request's span 2 -> [3, 8);
# 12 a HtoD copy 15 -> [15, 18); 7 a DtoH copy 610 -> [612, 615), then its
# stream sync; a device sync at 800; 10 a memset 960 -> [960, 970); the
# readback's sync at 995, outside ``mssvt.request``. 4 500 host ops inside
# ``mssvt.post`` before its longest idle gap.
EVENTS = [
    host("bench.request", 0, 1000),
    host("mssvt.request", 10, 980),
    host("mssvt.vfe", 20, 40),
    host("mssvt.backbone_3d", 60, 340),
    host("mssvt.map_to_bev", 400, 50),
    host("mssvt.backbone_2d", 450, 100),
    host("mssvt.head", 550, 50),
    host("mssvt.post", 600, 350),
    ev("cudaLaunchKernel", "cuda_runtime", 2, 1, 6),
    ev("cudaMemcpyAsync", "cuda_runtime", 15, 1, 12),
    ev("cudaLaunchKernel", "cuda_runtime", 25, 1, 1),
    ev("cudaLaunchKernel", "cuda_runtime", 70, 1, 2),
    ev("cudaLaunchKernel", "cuda_runtime", 390, 1, 11),
    ev("cudaLaunchKernel", "cuda_runtime", 410, 1, 3),
    ev("cudaLaunchKernel", "cuda_runtime", 460, 1, 4),
    ev("cudaLaunchKernel", "cuda_runtime", 560, 1, 5),
    ev("cudaMemcpyAsync", "cuda_runtime", 610, 5, 7),
    ev("cudaStreamSynchronize", "cuda_runtime", 616, 2, 8),
    ev("cudaLaunchKernel", "cuda_runtime", 700, 1, 9),
    ev("cudaDeviceSynchronize", "cuda_runtime", 800, 20, 13),
    ev("cudaMemsetAsync", "cuda_runtime", 960, 1, 10),
    ev("cudaStreamSynchronize", "cuda_runtime", 995, 2, 14),
    ev("voxel_mean_kernel", "kernel", 30, 20, 1),
    ev("attention_kernel", "kernel", 100, 200, 2),
    ev("gather_kernel", "kernel", 400, 5, 11),
    ev("scatter_kernel", "kernel", 410, 20, 3),
    ev("cudnn_conv_kernel", "kernel", 460, 60, 4),
    ev("cudnn_conv_kernel", "kernel", 560, 40, 5),
    ev("nms_kernel", "kernel", 700, 20, 9),
    ev("fill_kernel", "kernel", 3, 5, 6),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 15, 3, 12),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 612, 3, 7),
    ev("Memset (Device)", "gpu_memset", 960, 10, 10),
] + [ev("aten::__ior__", "cpu_op", 620 + 0.015 * i, 0.01)
     for i in range(4500)]


def rec(events=EVENTS):
    return SimpleNamespace(events=events, requests=1, batch=2)


def reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py")


READINGS = {
    # kernels launched in map_to_bev, backbone_2d, head: 20 + 60 + 40 us
    "bev_head_device_ms.infer": 120 / 2e3,
    # [60, 400) less [100, 300)
    "backbone_idle_ms.infer": (340 - 200) / 2e3,
    # [600, 950) less the copy's 3 and the kernel's 20 us
    "post_idle_ms.infer": (350 - 23) / 2e3,
    # [0, 1000) less the stages' [20, 950) and [3, 8), [15, 18), [960, 970)
    "unstaged_idle_ms.infer": (1000 - 930 - 5 - 3 - 10) / 2e3,
    # the DtoH copy with its stream sync, and the device sync
    "host_syncs_per_frame.infer": 2 / 2,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader(name):
    assert reader(name).read(rec()) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_without_program_spans_returns_none(name):
    bare = [e for e in EVENTS if not e["name"].startswith("mssvt.")]
    assert reader(name).read(rec(bare)) is None


def test_stage_idle_and_unstaged_idle_add_up_to_the_window_idle():
    win = trace.window(EVENTS, "bench.request")
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in trace.device(EVENTS)]
    staged = sum(r[1] - r[0] - trace.union(trace.clip(dev, r))
                 for s in STAGES for r in trace.ranges(EVENTS, "mssvt." + s))
    unstaged = reader("unstaged_idle_ms.infer").read(rec()) * 2e3
    assert staged + unstaged == pytest.approx(
        win[1] - win[0] - trace.busy(EVENTS, win))


def test_no_sync_in_the_request_reads_zero():
    quiet = [e for e in EVENTS if "Synchronize" not in e["name"]
             and "DtoH" not in e["name"]]
    assert reader("host_syncs_per_frame.infer").read(rec(quiet)) == 0.0
