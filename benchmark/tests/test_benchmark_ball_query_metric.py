"""The reader of the program's ball-query spans
(``ball_query_device_ms.infer``) on a hand-made trace: ``mssvt.ball_query``
ranges nested in a set abstraction's ``mssvt.sa`` and in
``mssvt.roi_head``."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spec

BALL = "void (anonymous namespace)::ball_query_kernel(float const*, Strides" \
       ", float const*, Strides, unsigned char const*, long long, long " \
       "long, int, int, int, float, int*, unsigned char*)"
BLOCK = "void (anonymous namespace)::fps_block_kernel<512, 1, true>(float " \
        "const*, float const*, float const*, int, int, int*, int)"


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(spans=True):
    """One request of 2 frames in [0, 1000) us: ``mssvt.sa`` [20, 120)
    launching K2c (10 us) at 21, then two ``mssvt.ball_query`` ranges in it
    launching the kernel at 41 (3 us) and 61 (4 us) and a gather (5 us) at
    81 outside them; ``mssvt.roi_head`` [600, 800) with one
    ``mssvt.ball_query`` launching the kernel at 651 (6 us); a launch at
    950 outside every span."""
    ev = [_ev("bench.request", "user_annotation", 0, 1000),
          _ev("mssvt.backbone_3d", "user_annotation", 10, 400),
          _ev("mssvt.sa", "user_annotation", 20, 100),
          _ev("mssvt.post", "user_annotation", 500, 400),
          _ev("mssvt.roi_head", "user_annotation", 600, 200)]
    launches = [(21, BLOCK, 10, False), (41, BALL, 3, True),
                (61, BALL, 4, True), (81, "gather_kernel", 5, False),
                (651, BALL, 6, True), (950, "elementwise_kernel", 8, False)]
    for corr, (t, name, dur, nested) in enumerate(launches, start=1):
        if nested and spans:
            ev.append(_ev("mssvt.ball_query", "user_annotation", t - 1, 10))
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", t, 1, corr))
        ev.append(_ev(name, "kernel", t + 1, dur, corr))
    return ev


def _reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py")


def _rec(events, requests=1, batch=2):
    return SimpleNamespace(events=events, requests=requests, batch=batch)


def test_ball_query_reader():
    """The kernels launched inside the ``mssvt.ball_query`` ranges, nested
    in ``mssvt.sa`` or in ``mssvt.roi_head``, over the frames; the
    enclosing ``mssvt.sa`` counts them too."""
    reader = _reader("ball_query_device_ms.infer")
    assert reader.read(_rec(_events())) == pytest.approx(
        (3 + 4 + 6) / 1e3 / 2)
    assert reader.read(_rec(_events(), requests=2)) == pytest.approx(
        (3 + 4 + 6) / 1e3 / 4)
    sa = _reader("sa_device_ms.infer").read(_rec(_events()))
    assert sa == pytest.approx((10 + 3 + 4 + 5) / 1e3 / 2)


def test_ball_query_reader_without_the_span():
    """Nothing to read where no ``mssvt.ball_query`` range was recorded (a
    program whose ball query opens none), though its kernels ran."""
    reader = _reader("ball_query_device_ms.infer")
    assert reader.read(_rec(_events(spans=False))) is None
