"""Host point-cloud voxelization with spconv-compatible semantics (the port's
copy of ``voxelize_points`` in ``mssvt_tpu/ops/voxelize.py``).

Replaces the reference's CPU spconv ``VoxelGeneratorWrapper``
(ref: pcdet/datasets/processor/data_processor.py:15-60): points are walked in
input order; a voxel is registered at its first point; each voxel keeps its
first ``max_points_per_voxel`` points; the first ``max_voxels`` voxels (by
first appearance) are kept.

:func:`voxelize_points` runs the C++ voxelizer
(``mssvt_tpu_torch/csrc/host/voxelizer.cpp``), which ``g++`` builds at its
first call into ``build/kernels/host/`` at the repo root (a content hash of
the source and flags names the library); it raises when that build fails.
:func:`voxelize_points_numpy` is its plain version (vectorised numpy), which
the tests hold the C++ against; ``use_native=False`` selects it. Both compute
every point's cell in float64 from float32 points, so they agree bit for bit.
Nothing is built at import.

:func:`voxelize_points_torch` is the on-device counterpart of the JAX
package's ``voxelize_points_jax``: tensors in, static shapes out, voxels in
sorted-key order; it finds the same voxel set and counts as the host
version wherever float32 and float64 cells agree.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..utils.device import device_constant

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host" / "voxelizer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels" / "host"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIB = None


def _build() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    so = BUILD_DIR / f"libmssvt_host_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: concurrent first calls (test
    # workers, loader threads of other processes) never load a partial file
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"voxelizer build failed ({' '.join(cmd)}): "
                           f"{exc}; pass use_native=False for the numpy "
                           "version") from exc
    if res.returncode != 0:
        raise RuntimeError(f"voxelizer build failed ({' '.join(cmd)}):\n"
                           f"{res.stderr}\npass use_native=False for the "
                           "numpy version")
    tmp.replace(so)
    return so


def host_library():
    """The ctypes handle of the C++ voxelizer, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            lib.voxelize.restype = ctypes.c_int32
            lib.voxelize.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _LIB = lib
        return _LIB


def voxelize_points(points: np.ndarray, voxel_size, point_cloud_range,
                    max_points_per_voxel: int, max_voxels: int,
                    use_native: bool = True):
    """Host voxelization.

    Args:
        points: (N, C) array, columns [x, y, z, ...] (taken as float32).
        voxel_size: (vx, vy, vz).
        point_cloud_range: (x0, y0, z0, x1, y1, z1).
        use_native: the C++ voxelizer (default; raises if it cannot be
            built) or, with False, :func:`voxelize_points_numpy`.

    Returns:
        voxels: (V, max_points_per_voxel, C) float32, zero padded.
        coords: (V, 3) int32 (z, y, x), the reference's order.
        num_points: (V,) int32.
    """
    if not use_native:
        return voxelize_points_numpy(points, voxel_size, point_cloud_range,
                                     max_points_per_voxel, max_voxels)
    lib = host_library()
    points = np.ascontiguousarray(points, np.float32)
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError(f"points must be (N, C >= 3), got {points.shape}")
    n, c = points.shape
    vs = np.ascontiguousarray(voxel_size, np.float64)
    pcr = np.ascontiguousarray(point_cloud_range, np.float64)
    if vs.shape != (3,) or pcr.shape != (6,):
        raise ValueError("voxel_size needs 3 values and point_cloud_range 6")
    voxels = np.zeros((max_voxels, max_points_per_voxel, c), np.float32)
    coords = np.zeros((max_voxels, 3), np.int32)
    counts = np.zeros((max_voxels,), np.int32)
    num = lib.voxelize(
        points.ctypes.data, n, c, vs.ctypes.data, pcr.ctypes.data,
        max_points_per_voxel, max_voxels,
        voxels.ctypes.data, coords.ctypes.data, counts.ctypes.data,
    )
    return voxels[:num], coords[:num], counts[:num]


def voxelize_points_numpy(points: np.ndarray, voxel_size, point_cloud_range,
                          max_points_per_voxel: int, max_voxels: int):
    """The plain (vectorised numpy) version of :func:`voxelize_points`."""
    points = np.asarray(points, np.float32)
    vs = np.asarray(voxel_size, np.float64)
    pcr = np.asarray(point_cloud_range, np.float64)
    grid = np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int64)  # (nx, ny, nz)

    xyz = points[:, :3].astype(np.float64)
    idx = np.floor((xyz - pcr[:3]) / vs).astype(np.int64)  # (N, 3) xyz
    in_range = np.all((idx >= 0) & (idx < grid), axis=1)
    pts = points[in_range]
    idx = idx[in_range]
    if len(pts) == 0:
        c = points.shape[1]
        return (
            np.zeros((0, max_points_per_voxel, c), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0,), np.int32),
        )

    keys = (idx[:, 2] * grid[1] + idx[:, 1]) * grid[0] + idx[:, 0]  # z-major

    # first-appearance voxel ordering (spconv semantics)
    _, first_pos, inverse = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first_pos, kind="stable")  # unique-id -> appearance rank
    rank_of_unique = np.empty_like(order)
    rank_of_unique[order] = np.arange(len(order))
    vox_of_point = rank_of_unique[inverse]  # (N,) appearance-ordered voxel id

    # within-voxel point rank (stable)
    perm = np.argsort(vox_of_point, kind="stable")
    sorted_vox = vox_of_point[perm]
    group_start = np.zeros(len(order), np.int64)
    starts = np.flatnonzero(np.diff(sorted_vox, prepend=-1))
    group_start[sorted_vox[starts]] = starts
    rank_sorted = np.arange(len(pts)) - group_start[sorted_vox]
    rank = np.empty(len(pts), np.int64)
    rank[perm] = rank_sorted

    num_voxels = min(len(order), max_voxels)
    keep = (vox_of_point < num_voxels) & (rank < max_points_per_voxel)

    c = points.shape[1]
    voxels = np.zeros((num_voxels, max_points_per_voxel, c), np.float32)
    voxels[vox_of_point[keep], rank[keep]] = pts[keep]
    num_points = np.bincount(
        vox_of_point[keep], minlength=num_voxels
    ).astype(np.int32)

    # coords in appearance order, (z, y, x)
    first_point = np.empty(len(order), np.int64)
    first_point[vox_of_point] = np.arange(len(pts))  # any point of the voxel
    coords = idx[first_point[:num_voxels]][:, ::-1].astype(np.int32)  # zyx
    return voxels, coords, num_points


def voxelize_points_torch(points, valid, voxel_size, point_cloud_range,
                          max_points_per_voxel: int, max_voxels: int):
    """On-device voxelization of tensors (torch counterpart of
    ``voxelize_points_jax``; static shapes, no host sync).

    Voxels come in sorted-key order (z, then y, then x), not the host
    version's first-appearance order, and each keeps its first
    ``max_points_per_voxel`` points in input order; MeanVFE does not depend
    on the order. Cells are computed in float32, as the JAX version does.
    No Pallas kernel stands behind the JAX version, so this is plain torch
    (a stable sort, a cumulative sum and scatters).

    Args:
        points: (N, C) padded points; valid: (N,) bool.

    Returns:
        voxels (max_voxels, P, C), coords (max_voxels, 4) = (0, z, y, x)
        int32 (batch column zero; -1 past the live voxels), num_points
        (max_voxels,) int32, vmask (max_voxels,) bool.
    """
    dev = points.device
    vs = device_constant(np.asarray(voxel_size, np.float32), dev)
    pcr = device_constant(np.asarray(point_cloud_range, np.float32), dev)
    grid = np.round((np.asarray(point_cloud_range[3:])
                     - np.asarray(point_cloud_range[:3]))
                    / np.asarray(voxel_size)).astype(np.int64)
    nx, ny, nz = (int(g) for g in grid)
    n = points.shape[0]

    idx = torch.floor((points[:, :3] - pcr[:3]) / vs).to(torch.int64)
    dims = device_constant(np.asarray([nx, ny, nz], np.int64), dev)
    ok = valid & ((idx >= 0) & (idx < dims)).all(dim=1)
    big = nx * ny * nz
    key = torch.where(ok, (idx[:, 2] * ny + idx[:, 1]) * nx + idx[:, 0], big)

    skey, order = torch.sort(key, stable=True)
    pos = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = skey[1:] != skey[:-1]
    first &= skey < big
    vox_id = torch.cumsum(first.to(torch.int64), 0) - 1
    pt_rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    keep = (skey < big) & (vox_id < max_voxels) & (pt_rank < max_points_per_voxel)
    dest_v = torch.where(keep, vox_id, max_voxels)
    dest_p = torch.where(keep, pt_rank, 0)

    voxels = torch.zeros((max_voxels + 1, max_points_per_voxel,
                          points.shape[1]), dtype=points.dtype, device=dev)
    voxels[dest_v, dest_p] = points[order]  # dropped points: the spare row
    num_points = torch.zeros(max_voxels + 1, dtype=torch.int64, device=dev)
    num_points.index_add_(0, dest_v, torch.ones_like(dest_v))
    vkeys = torch.full((max_voxels + 1,), big, dtype=torch.int64, device=dev)
    vkeys.scatter_reduce_(0, dest_v, skey, reduce="amin")
    vkeys = vkeys[:max_voxels]
    vmask = vkeys < big
    kk = torch.where(vmask, vkeys, 0)
    coords = torch.stack([torch.zeros_like(kk), kk // (nx * ny),
                          (kk // nx) % ny, kk % nx], dim=-1)
    coords = torch.where(vmask[:, None], coords, -1).to(torch.int32)
    return (voxels[:max_voxels], coords,
            num_points[:max_voxels].to(torch.int32), vmask)
