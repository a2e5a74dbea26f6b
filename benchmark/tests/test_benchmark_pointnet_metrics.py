"""The readers of ``pointrcnn-kitti-infer-b2``'s spans and FPS kernels
(``sa_device_ms.infer``, ``fp_device_ms.infer``,
``fps_roofline_pct.infer``) and ``harness/pointnet_fps.py``'s count, on a
hand-made trace."""

from types import SimpleNamespace

import pytest

from benchmark.harness import pointnet_fps, spec, work

CONFIG = spec.load_json(spec.BENCH / "configs" / "pointrcnn-kitti.json")


def _ev(name, cat, ts, dur, corr=None, grid=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
        if grid is not None:
            e["args"]["grid"] = [grid, 1, 1]
    return e


BLOCK = "void (anonymous namespace)::fps_block_kernel<512, 1, true>(float " \
        "const*, float const*, float const*, int, int, int*, int)"
WARP = "void (anonymous namespace)::fps_kernel<32, 8, false>(Planes, int)"


def _events(grids=(2, 2, 2, 200)):
    """One request of 2 frames in [0, 1000) us: four ``mssvt.sa`` spans
    launching K2c three times and K2b once (10, 20, 30, 40 us) and a gather
    (5 us), two ``mssvt.fp`` spans launching a gemm (7 us) and a reduce
    (9 us), then ``mssvt.roi_head`` launching K2c (50 us) and K2b (60 us),
    one launch outside every span."""
    ev = [_ev("bench.request", "user_annotation", 0, 1000),
          _ev("mssvt.backbone_3d", "user_annotation", 10, 400),
          _ev("mssvt.post", "user_annotation", 500, 400),
          _ev("mssvt.roi_head", "user_annotation", 600, 200)]
    kernels = [(BLOCK, 10, grids[0]), (BLOCK, 20, grids[1]),
               (BLOCK, 30, grids[2]), (WARP, 40, None)]
    corr = 1
    for i, (name, dur, grid) in enumerate(kernels):
        t = 20 + 50 * i
        ev.append(_ev("mssvt.sa", "user_annotation", t, 40))
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", t + 1, 1, corr))
        ev.append(_ev(name, "kernel", t + 2, dur, corr, grid))
        corr += 1
    ev.append(_ev("cudaLaunchKernel", "cuda_runtime", 25, 1, corr))
    ev.append(_ev("gather_kernel", "kernel", 26, 5, corr))
    corr += 1
    for i, (name, dur) in enumerate([("gemm_kernel", 7),
                                     ("reduce_kernel", 9)]):
        t = 250 + 50 * i
        ev.append(_ev("mssvt.fp", "user_annotation", t, 40))
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", t + 1, 1, corr))
        ev.append(_ev(name, "kernel", t + 2, dur, corr))
        corr += 1
    for t, name, dur, grid in [(610, BLOCK, 50, grids[3]),
                               (700, WARP, 60, None)]:
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", t, 1, corr))
        ev.append(_ev(name, "kernel", t + 1, dur, corr, grid))
        corr += 1
    ev.append(_ev("cudaLaunchKernel", "cuda_runtime", 950, 1, corr))
    ev.append(_ev("elementwise_kernel", "kernel", 951, 8, corr))
    return ev


def _reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py")


def _rec(events, requests=1, batch=2):
    return SimpleNamespace(events=events, requests=requests, batch=batch)


@pytest.mark.parametrize("name,want", [
    ("sa_device_ms.infer", (10 + 20 + 30 + 40 + 5) / 1e3 / 2),
    ("fp_device_ms.infer", (7 + 9) / 1e3 / 2)])
def test_span_readers(name, want):
    """Kernels launched inside the spans over the frames; nothing to read
    without the spans."""
    reader = _reader(name)
    assert reader.read(_rec(_events())) == pytest.approx(want)
    span = "mssvt." + name.split("_")[0]
    bare = [e for e in _events() if e["name"] != span]
    assert reader.read(_rec(bare)) is None


def test_pointnet_fps_levels_and_work():
    """The cell's six FPS calls a request of 2 frames: the backbone's four
    (16 384 -> 4 096 -> 1 024 -> 256 -> 64, a row a frame) and the RoI
    head's two (200 rows of 512 -> 128 -> 32; the third level groups all);
    K2c's rows are the calls over more than 256 points; each call's bound
    its operations over the f32 rate (the bytes are far below)."""
    levels = pointnet_fps.levels(CONFIG, 2)
    assert levels == [(2, 16384, 4096), (2, 4096, 1024), (2, 1024, 256),
                      (2, 256, 64), (200, 512, 128), (200, 128, 32)]
    assert pointnet_fps.block_rows(CONFIG, 2) == [2, 2, 2, 200]
    ws = pointnet_fps.work(CONFIG, 2)
    assert ws[0].ops == 2 * 16384 * 4095 * 10
    assert ws[0].nbytes == 3 * 2 * 16384 * 4 + 2 * 4096 * 4
    assert ws[4].ops == 200 * 512 * 127 * 10
    assert all(w.bound()[1] == "operations" for w in ws)
    assert ws[0].bound()[0] == pytest.approx(ws[0].ops / work.F32_FLOPS * 1e3)


def test_fps_roofline_reader():
    """Every FPS call's bound at the configuration's sizes over the K2c and
    K2b launches' device time (210 us)."""
    reader = _reader("fps_roofline_pct.infer")
    bound = sum(w.bound()[0] for w in pointnet_fps.work(CONFIG, 2))
    assert reader.read(_rec(_events())) == pytest.approx(
        100.0 * bound / 0.210)
    plain = [e for e in _events() if "fps_" not in e["name"]]
    assert reader.read(_rec(plain)) is None


@pytest.mark.parametrize("grids,reads", [
    ((2, 2, 2, 200), True), ((200, 2, 2, 2), True), ((2, 2, 2, 2), False),
    ((None,) * 4, True)],
    ids=["config_rows", "any_order", "other_rows", "no_grids"])
def test_fps_roofline_reader_holds_the_grids(grids, reads):
    """Where the trace gives K2c's grids (a CTA a row) they must be the
    configuration's rows, else the reader reads nothing."""
    got = _reader("fps_roofline_pct.infer").read(_rec(_events(grids)))
    assert (got is not None) == reads


def test_fps_roofline_reader_counts_the_calls():
    """A launch too many or too few (another configuration's calls) reads
    nothing; two requests read as one."""
    reader = _reader("fps_roofline_pct.infer")
    events = _events()
    extra = _ev(WARP, "kernel", 960, 5, 99)
    assert reader.read(_rec(events + [extra])) is None
    dropped = [e for e in events if not (e["name"] == WARP
                                         and e["ts"] == 701)]
    assert reader.read(_rec(dropped)) is None
    shifted = [dict(e, ts=e["ts"] + 1000) for e in events]
    both = reader.read(_rec(events + shifted, requests=2))
    assert both == pytest.approx(reader.read(_rec(events)))
