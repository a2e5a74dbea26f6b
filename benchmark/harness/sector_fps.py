"""The work of PV-RCNN++'s sector FPS a request, for its roofline share:
the two passes of the masked FPS kernel (``csrc/fps.cu``
``fps_masked_kernel``) at a configuration's sizes. The first pass takes
``NUM_SECTORS`` rows a frame over the frame's ``MAX_POINTS`` points and
picks ``ceil(NUM_KEYPOINTS / NUM_SECTORS)`` in each; the second one row a
frame over the sectors' picks and keeps ``NUM_KEYPOINTS``. Each pass reads
its frames' x, y, z planes (f32) and its rows' valid flags (a byte a
point) once and writes its picks (int32) once; an iteration costs 10 f32
operations a valid point (3 sub, 3 mul, 2 add, min, compare). A frame's
points are valid in one sector row each, so the first pass's operations
count the frame's points once, not once a row; every row of the second
is valid. Bounds as ``work.py``'s: the bytes over the memory rate
against the operations over the f32 rate, whichever is larger."""

from __future__ import annotations

from benchmark.harness.work import F32_FLOPS, Work


def masked_fps(frames, rows, n, picks, points):
    """``rows`` rows over ``frames`` frames of ``n`` points, ``picks`` a
    row, ``points`` valid (row, point) pairs in all."""
    return Work(0, points * (picks - 1) * 10,
                3 * frames * n * 4 + rows * n + rows * picks * 4, F32_FLOPS)


def sizes(config):
    """(points a frame, keypoints, sectors, picks a sector)."""
    model = config["MODEL"]
    n = int(model["MAX_POINTS"])
    k = int(model["PFE"]["NUM_KEYPOINTS"])
    s = int(model["PFE"]["SPC_SAMPLING"]["NUM_SECTORS"])
    return n, k, s, -(-k // s)


def work(config, batch):
    """[Work of the sector pass, Work of the union pass] of one request of
    ``batch`` frames."""
    n, k, s, quota = sizes(config)
    return [masked_fps(batch, batch * s, n, quota, batch * n),
            masked_fps(batch, batch, s * quota, k, batch * s * quota)]
