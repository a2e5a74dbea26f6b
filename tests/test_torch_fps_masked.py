"""The masked FPS (PV-RCNN++'s sector FPS) on the CPU: the port's plain
loop (``kernels/fps.py`` ``fps_masked_plain``, which CPU tensors take and
the card's kernel is held to) against a numpy loop of the same semantics,
row by row; rows that share a frame's planes; ``ops.sampling.sector_fps``
against the benchmark's frozen copy of its earlier form; and the kernel's
work formula against the benchmark's copy. The kernel itself is held to
the plain loop on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from benchmark.harness import sector_fps as bench_sector_fps
from benchmark.harness import spec
from benchmark.reference.detector.ops import sampling as frozen
from mssvt_tpu_torch import kernels
from mssvt_tpu_torch.kernels import fps, work
from mssvt_tpu_torch.ops import sampling


def numpy_masked_fps(x, y, z, valid, npoint):
    """One row: invalid points at -1, the first pick the first valid point
    (0 where none is), float32 distances, the first maximum."""
    md = np.where(valid, np.float32(1e10), np.float32(-1)).astype(np.float32)
    last = int(np.argmax(valid)) if valid.any() else 0
    picks = [last]
    for _ in range(1, npoint):
        dx, dy, dz = x - x[last], y - y[last], z - z[last]
        d = dx * dx + dy * dy + dz * dz
        md = np.minimum(md, np.where(valid, d, np.float32(-1)))
        last = int(np.argmax(md))
        picks.append(last)
    return picks


def _rows(kind, rows, n, rng):
    """(planes (3, rows, n) float32, valid (rows, n)) of a case."""
    if kind == "ties":  # small integers: many exact ties
        planes = rng.integers(-3, 4, (3, rows, n)).astype(np.float32)
    else:
        planes = rng.normal(size=(3, rows, n)).astype(np.float32) * 10
    valid = rng.random((rows, n)) < 0.3
    if kind == "empty":
        valid[0] = False  # a sector without a point
    elif kind == "few":
        valid[:] = False
        valid[:, rng.integers(0, n, 5)] = True  # fewer than the quota
    elif kind == "all":
        valid[:] = True
    return planes, valid


@pytest.mark.parametrize("kind", ["empty", "few", "all", "ties", "mixed"])
def test_plain_masked_fps_matches_a_numpy_loop(kind):
    rng = np.random.default_rng(len(kind))
    planes, valid = _rows(kind, 4, 97, rng)
    got = fps.fps_picks_masked(*(torch.as_tensor(p) for p in planes),
                               torch.as_tensor(valid), 40)
    assert got.dtype == torch.int32 and got.shape == (4, 40)
    for r in range(4):
        want = numpy_masked_fps(planes[0, r], planes[1, r], planes[2, r],
                                valid[r], 40)
        assert got[r].tolist() == want, (kind, r)
    if kind == "empty":
        assert got[0].tolist() == [0] * 40
    if kind == "few":  # past the valid points the tail repeats indices
        assert set(got[0].tolist()) == set(np.flatnonzero(valid[0]).tolist())


def test_rows_share_their_frames_planes():
    """Row ``r`` of (R, N) flags reads frame ``r % F`` of (F, N) planes: the
    picks of the planes repeated R / F times."""
    rng = np.random.default_rng(3)
    planes = torch.as_tensor(rng.normal(size=(3, 2, 64)).astype(np.float32))
    valid = torch.as_tensor(rng.random((6, 64)) < 0.5)
    got = fps.fps_picks_masked(*planes, valid, 12)
    want = fps.fps_picks_masked(*(p.repeat(3, 1) for p in planes), valid, 12)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sectors,npoint", [(6, 64), (1, 32), (4, 30)])
def test_sector_fps_matches_its_frozen_form(sectors, npoint):
    """``sector_fps``, whose sectors now read their frame's planes, picks
    what the frozen copy of its earlier form (the points expanded a sector)
    picks; no kernel is counted on the CPU."""
    rng = np.random.default_rng(sectors)
    xyz = torch.as_tensor(rng.normal(size=(2, 700, 3)).astype(np.float32)
                          * 20)
    valid = torch.as_tensor(rng.random((2, 700)) < 0.6)
    valid[1, :350] = False  # whole sectors without a valid point
    kernels.reset_launch_counts()
    got = sampling.sector_fps(xyz, valid, npoint, sectors)
    assert torch.equal(got, frozen.sector_fps(xyz, valid, npoint, sectors))
    assert not any(kernels.launch_counts().values())


def test_work_formula_is_the_benchmarks():
    """``kernels/work.fps_masked`` of the cell's two passes equals the
    benchmark's frozen formula (``harness/sector_fps.py``) at the
    configuration's rows, points and picks, each point of a frame valid in
    one sector row (the first pass) and every row valid (the second)."""
    config = spec.load_json(spec.BENCH / "configs" / "pvrcnnpp-kitti.json")
    bench = bench_sector_fps.work(config, 2)
    shapes = [(2, 12, 16384, 342), (2, 2, 2052, 2048)]
    for (f, rows, n, picks), w in zip(shapes, bench):
        x = torch.empty(f, n, device="meta")
        per = rows // f  # rows a frame: point j valid in row j % per
        valid = (torch.arange(n)[None] % per
                 == torch.arange(rows)[:, None] % per)
        got = work.fps_masked(x, x, x, valid, picks)
        assert (got.ops, got.nbytes, got.peak) == (w.ops, w.nbytes, w.peak)
    ms, by = bench[0].bound()
    assert by == "operations" and 0.0016 < ms < 0.0018
