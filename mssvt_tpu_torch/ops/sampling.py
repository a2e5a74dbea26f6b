"""Point sampling, grouping and interpolation (torch counterpart of
``mssvt_tpu/ops/sampling.py``), channel-last throughout.

The FPS of the MsSVT blocks runs as the K2 kernel
(:func:`farthest_point_sample_planes_select` -> ``kernels/fps.py``); the
rest are plain tensor ops. ``group_features_paired`` and
``writeback_inverse_paired`` carry their forward only here: their
row-gather backward comes with training.
"""

from __future__ import annotations

import torch

from ..kernels import fps as fps_kernel


def farthest_point_sample_planes(x, y, z, npoint: int):
    """Plain FPS on (B, N) coordinate planes -> (B, npoint) int32: first
    pick 0, min-dist starts at 1e10, argmax ties to the lowest index."""
    return fps_kernel.fps_plain(x, y, z, (), npoint)[0]


def farthest_point_sample_planes_select(x, y, z, aux, npoint: int,
                                        num_valid=None, nw_half: int = 0):
    """FPS picks plus the values of (x, y, z, *aux) at the picks, each
    (B, npoint) f32 (aux planes must be f32-exact, e.g. buffer rows)."""
    return fps_kernel.fps_select(x, y, z, tuple(aux), npoint,
                                 num_valid=num_valid, nw_half=nw_half)


def three_interp_weights_planes(ux, uy, uz, kx, ky, kz, dtype=torch.float32):
    """Dense (B, n, m) 3-NN inverse-distance interpolation matrix.

    Squared distances use the expansion u^2 + k^2 - 2uk (clamped at 0); the
    three nearest are taken in lexicographic (distance, index) order, and the
    weights are 1 / max(sqrt(d2), 1e-10) normalised over the three -- inverse
    L2 distance, as the reference block computes them."""
    u2 = ux * ux + uy * uy + uz * uz
    k2 = kx * kx + ky * ky + kz * kz
    cross = (ux[:, :, None] * kx[:, None, :] + uy[:, :, None] * ky[:, None, :]
             + uz[:, :, None] * kz[:, None, :])
    d2 = torch.clamp(u2[:, :, None] + k2[:, None, :] - 2.0 * cross, min=0.0)
    m = kx.shape[1]
    work = d2
    picked = []
    for _ in range(min(3, m)):
        i_k = torch.argmin(work, dim=-1, keepdim=True)  # first minimum
        d_k = torch.gather(work, -1, i_k)
        picked.append((i_k, d_k))
        work = work.scatter(-1, i_k, float("inf"))
    wgt = [1.0 / torch.clamp(torch.sqrt(d_k), min=1e-10) for _, d_k in picked]
    wsum = wgt[0]
    for w in wgt[1:]:
        wsum = wsum + w
    idx = torch.cat([i for i, _ in picked], dim=-1)
    val = torch.cat([w / wsum for w in wgt], dim=-1).to(dtype)
    w3 = torch.zeros(d2.shape, dtype=dtype, device=d2.device)
    return w3.scatter(-1, idx, val)  # the three indices are distinct


def gather_along_batch(values, idx):
    """(B, N, ...) values by (B, M) indices -> (B, M, ...)."""
    extra = values.ndim - 2
    ix = idx.long().reshape(idx.shape + (1,) * extra).expand(
        *idx.shape, *values.shape[2:])
    return torch.gather(values, 1, ix)


def group_features(features, idx):
    """Rows of flat (V, C) features at (..., n) global indices; -1 (and
    any index >= V) gives a zero row (routed to an appended zero row)."""
    v = features.shape[0]
    padded = torch.cat([features, features.new_zeros((1, features.shape[1]))])
    safe = torch.where((idx >= 0) & (idx < v), idx, v).long()
    return padded[safe]


def group_features_paired(features, ind, win_row, slot, inv_valid):
    """Forward of the JAX ``group_features_paired`` (the inverse map only
    shapes its backward)."""
    del win_row, slot, inv_valid
    return group_features(features, ind)


def writeback_inverse_paired(upd_fea, shortcut, ind, win_row, slot,
                             inv_valid):
    """Each voxel takes its updated row from (window, slot); voxels in no
    live slot keep ``shortcut``. Forward of the JAX op of the same name."""
    del ind
    nw_b, n1b, c = upd_fea.shape
    pos = (win_row.long() * n1b + slot.long()).clamp(0, nw_b * n1b - 1)
    rows = upd_fea.reshape(-1, c)[pos].to(shortcut.dtype)
    return torch.where(inv_valid[:, None], rows, shortcut)
