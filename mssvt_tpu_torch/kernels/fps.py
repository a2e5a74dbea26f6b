"""K2, K2b, K2c: farthest-point sampling over coordinate planes.

K2 (:func:`fps_select`), with selections, replaces ``farthest_point_sample_planes_pallas_t_sel``
(``mssvt_tpu/ops/pallas_fps.py``). Per row of the (B, N) x/y/z planes: the
first pick is index 0, the min-distance cache starts at 1e10, each next pick
is the argmax of the cache (ties to the lowest index), with squared
distances ``(x-lx)^2 + (y-ly)^2 + (z-lz)^2`` in f32. Returns the picks
(B, npoint) int32 and the values of every plane (x, y, z, *aux) at the
picks, each (B, npoint) f32. With ``nw_half`` and ``num_valid`` the rows are
two stacked halves of ``nw_half`` rows, each with a live prefix of
``num_valid`` rows; dead rows return zeros.

K2b (:func:`fps_picks_warp`) and K2c (:func:`fps_picks_block`) are the
selection-free forms: the picks only, no aux planes, no dead rows. K2b
replaces ``farthest_point_sample_planes_pallas_t`` (the transposed layout
JAX takes on the TPU) with K2's loop (a group of lanes a row), N <= 256; K2c
replaces ``farthest_point_sample_planes_pallas`` (the row layout, any N)
with one CTA per row, N <= 16 384: each thread keeps a contiguous run of 16
points and their min-distances in registers (x, y, z in shared memory above
N = 8 192), a warp's first maximum is a max of the min-distances' bits, and
one barrier an iteration lets every warp reduce the warps' winners itself.
:func:`fps_picks` chooses by N.

The masked FPS (:func:`fps_picks_masked`, no TPU kernel: the JAX package's
``farthest_point_sample_masked`` is a plain loop) is K2c's loop over rows
with valid flags, PV-RCNN++'s sectorised keypoint sampling: an invalid
point keeps min-distance -1, the first pick is the row's first valid point,
and past the valid points the picks repeat. Its rows may share planes: row
``r`` reads frame ``r % F`` of (F, N) planes, so the sectors of a frame read
the frame's points once.

CUDA tensors go to ``csrc/fps.cu``; CPU tensors to :func:`fps_plain`. The
distances are built from single rounded operations, so all three kernels'
picks equal the plain version's exactly.
"""

from __future__ import annotations

import torch

from . import _lib, work

launches = 0        # K2
launches_warp = 0   # K2b
launches_block = 0  # K2c
launches_masked = 0  # the masked FPS
MAX_N = 256            # a group of lanes a row (K2, K2b)
MAX_N_BLOCK = 16384    # one CTA per row (K2c)
MAX_PLANES = 8


def _dead_rows(b, num_valid, nw_half, device):
    r = torch.arange(b, device=device)
    if nw_half:
        r = torch.where(r < nw_half, r, r - nw_half)
    return r >= num_valid


def fps_plain(x, y, z, aux, npoint: int, num_valid=None, nw_half: int = 0):
    """Plain PyTorch version (same contract as :func:`fps_select`)."""
    planes = [p.float() for p in (x, y, z, *aux)]
    x, y, z = planes[:3]
    b, _ = x.shape
    min_dist = torch.full_like(x, 1e10)
    last = torch.zeros((b, 1), dtype=torch.long, device=x.device)
    picks = []
    for i in range(npoint):
        picks.append(last)
        if i == npoint - 1:
            break
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        min_dist = torch.minimum(min_dist, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(min_dist, dim=1, keepdim=True)
    idx = torch.cat(picks, dim=1)
    sels = [p.gather(1, idx) for p in planes]
    idx = idx.to(torch.int32)
    if num_valid is not None:
        dead = _dead_rows(b, num_valid, nw_half, x.device)[:, None]
        idx = torch.where(dead, 0, idx)
        sels = [torch.where(dead, 0.0, s) for s in sels]
    return idx, tuple(sels)


@work.counted("fps", work.fps_select)
def fps_select(x, y, z, aux, npoint: int, num_valid=None, nw_half: int = 0):
    """FPS picks and the selected plane values (see module docstring)."""
    global launches
    if x.device.type == "cpu":
        return fps_plain(x, y, z, aux, npoint, num_valid, nw_half)
    planes = [x, y, z, *aux]
    b, n = x.shape
    dev = x.device
    for i, p in enumerate(planes):
        _lib.require(p, f"plane {i}", torch.float32, (b, n), dev)
    if not (0 < n <= MAX_N) or len(planes) > MAX_PLANES or npoint < 1:
        raise ValueError(f"fps: N={n} must be in (0, {MAX_N}], "
                         f"at most {MAX_PLANES} planes, npoint >= 1")
    if nw_half and 2 * nw_half != b:
        raise ValueError("nw_half must be half the rows")
    nv = None
    if num_valid is not None:
        nv = torch.as_tensor(num_valid, device=dev).to(torch.int32).reshape(1)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=dev)
    sels = torch.empty((len(planes), b, npoint), dtype=torch.float32,
                       device=dev)
    err = _lib.lib().mssvt_fps(
        _lib.ptr_array(planes), len(planes), b, n, int(npoint), int(nw_half),
        _lib.ptr(nv), idx.data_ptr(), sels.data_ptr(), _lib.stream_ptr(x))
    _lib.check(err, "mssvt_fps")
    launches += 1
    return idx, tuple(sels.unbind(0))


def _picks(x, y, z, npoint, entry, max_n):
    b, n = x.shape
    for i, p in enumerate((x, y, z)):
        _lib.require(p, f"plane {i}", torch.float32, (b, n), x.device)
    if not (0 < n <= max_n) or npoint < 1:
        raise ValueError(f"{entry}: N={n} must be in (0, {max_n}], "
                         "npoint >= 1")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=x.device)
    err = getattr(_lib.lib(), entry)(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), b, n, int(npoint),
        idx.data_ptr(), _lib.stream_ptr(x))
    _lib.check(err, entry)
    return idx


@work.counted("fps_picks_warp", work.fps_picks)
def fps_picks_warp(x, y, z, npoint: int):
    """K2b: (B, N <= 256) f32 planes -> (B, npoint) int32 picks."""
    global launches_warp
    if x.device.type == "cpu":
        return fps_plain(x, y, z, (), npoint)[0]
    idx = _picks(x, y, z, npoint, "mssvt_fps_picks_warp", MAX_N)
    launches_warp += 1
    return idx


@work.counted("fps_picks_block", work.fps_picks)
def fps_picks_block(x, y, z, npoint: int):
    """K2c: (B, N <= 16 384) f32 planes -> (B, npoint) int32 picks."""
    global launches_block
    if x.device.type == "cpu":
        return fps_plain(x, y, z, (), npoint)[0]
    idx = _picks(x, y, z, npoint, "mssvt_fps_picks_block", MAX_N_BLOCK)
    launches_block += 1
    return idx


def fps_masked_plain(x, y, z, valid, npoint: int):
    """Plain version of :func:`fps_picks_masked`: a loop of a few small
    launches an iteration."""
    rows, f = valid.shape[0], x.shape[0]
    x, y, z = (p.float().repeat(rows // f, 1) for p in (x, y, z))
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)  # first valid
    neg = torch.full((), -1.0, device=x.device)
    min_dist = torch.where(valid, torch.full((), 1e10, device=x.device), neg)
    last = first
    picks = [first]
    for _ in range(1, npoint):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        d = dx * dx + dy * dy + dz * dz
        min_dist = torch.minimum(min_dist, torch.where(valid, d, neg))
        last = torch.argmax(min_dist, dim=1, keepdim=True)
        picks.append(last)
    return torch.cat(picks, dim=1).to(torch.int32)


@work.counted("fps_picks_masked", work.fps_masked)
def fps_picks_masked(x, y, z, valid, npoint: int):
    """The masked FPS: (F, N <= 16 384) f32 planes and (R, N) bool valid
    flags, R a multiple of F (row ``r`` reads frame ``r % F``) -> (R,
    npoint) int32 picks. Invalid points keep min-distance -1, the first
    pick is the row's first valid point (0 where none is), ties go to the
    lowest index."""
    global launches_masked
    if x.device.type == "cpu":
        return fps_masked_plain(x, y, z, valid, npoint)
    f, n = x.shape
    rows = valid.shape[0]
    for i, p in enumerate((x, y, z)):
        _lib.require(p, f"plane {i}", torch.float32, (f, n), x.device)
    _lib.require(valid, "valid", torch.bool, (rows, n), x.device)
    if not (0 < n <= MAX_N_BLOCK) or npoint < 1 or rows % f:
        raise ValueError(f"fps_picks_masked: N={n} must be in (0, "
                         f"{MAX_N_BLOCK}], npoint >= 1, rows ({rows}) a "
                         f"multiple of the frames ({f})")
    idx = torch.empty((rows, npoint), dtype=torch.int32, device=x.device)
    err = _lib.lib().mssvt_fps_picks_masked(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), valid.data_ptr(), f, rows,
        n, int(npoint), idx.data_ptr(), _lib.stream_ptr(x))
    _lib.check(err, "mssvt_fps_picks_masked")
    launches_masked += 1
    return idx


def fps_picks(x, y, z, npoint: int):
    """Selection-free FPS: K2b for N <= 256, K2c above it (CUDA tensors);
    the plain version for CPU tensors."""
    fn = fps_picks_warp if x.shape[1] <= MAX_N else fps_picks_block
    return fn(x, y, z, npoint)
