"""The work of a point-based detector's farthest-point sampling a request,
for its roofline share: every FPS call of PointRCNN at a configuration's
sizes. The backbone's set abstractions run one row a frame over the
frame's ``MAX_POINTS`` points, then over the level before's picks
(``BACKBONE_3D.SA_CONFIG.NPOINTS``); the RoI head's run one row a RoI
(``NMS_POST_MAXSIZE`` a frame) over ``ROI_POINT_POOL.NUM_SAMPLED_POINTS``
points, then over the level before's picks (``ROI_HEAD.SA_CONFIG.NPOINTS``;
a level of -1 groups all its points and samples none). A row of ``n``
points and ``npoint`` picks (``csrc/fps.cu``: K2b where ``n`` is at most
256, else K2c) reads its x, y, z planes (f32) once and writes its picks
(int32) once; each of its ``npoint - 1`` iterations costs 10 f32
operations a point (3 sub, 3 mul, 2 add, min, compare), every row's
points all live. Bounds as ``work.py``'s: the bytes over the memory rate
against the operations over the f32 rate, whichever is larger."""

from __future__ import annotations

from benchmark.harness.work import F32_FLOPS, Work

WARP_MAX_N = 256  # K2b's rows; K2c above (kernels/fps.py MAX_N)


def fps(rows, n, npoint):
    """``rows`` rows of ``n`` points, ``npoint`` picks a row."""
    return Work(0, rows * n * (npoint - 1) * 10,
                3 * rows * n * 4 + rows * npoint * 4, F32_FLOPS)


def levels(config, batch):
    """[(rows, n, npoint)] of every FPS call of one request of ``batch``
    frames, the backbone's first."""
    model = config["MODEL"]
    out = []
    n = int(model["MAX_POINTS"])
    for npoint in model["BACKBONE_3D"]["SA_CONFIG"]["NPOINTS"]:
        out.append((batch, n, int(npoint)))
        n = int(npoint)
    roi = model["ROI_HEAD"]
    rows = batch * int(roi["NMS_CONFIG"]["TEST"]["NMS_POST_MAXSIZE"])
    n = int(roi["ROI_POINT_POOL"]["NUM_SAMPLED_POINTS"])
    for npoint in roi["SA_CONFIG"]["NPOINTS"]:
        if int(npoint) < 0:
            break
        out.append((rows, n, int(npoint)))
        n = int(npoint)
    return out


def work(config, batch):
    """[Work of each FPS call] of one request of ``batch`` frames."""
    return [fps(*lv) for lv in levels(config, batch)]


def block_rows(config, batch):
    """The rows (CTAs, one a row) of the K2c launches of one request."""
    return sorted(rows for rows, n, _ in levels(config, batch)
                  if n > WARP_MAX_N)
