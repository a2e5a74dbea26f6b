"""Point sampling, grouping and interpolation (torch counterpart of
``mssvt_tpu/ops/sampling.py``), channel-last throughout.

The FPS of the MsSVT blocks runs as the K2 kernel
(:func:`farthest_point_sample_planes_select` -> ``kernels/fps.py``); the
rest are plain tensor ops.

Backward forms. The JAX package's gradients are deterministic, and so are
these, bit for bit from one run to the next:

- ``group_features_paired`` / ``writeback_inverse_paired`` are autograd
  Functions whose backward is a row gather (each voxel occupies at most one
  (window, slot) address), as in JAX: no sum at all.
- The many-to-one gathers (:func:`group_features`, whose rows are keys of
  up to 9 windows, and :func:`gather_along_batch`) sum their backward with
  ``index_put_(accumulate=True)``, the backward of advanced indexing
  ``x[idx]``. On CUDA that always runs PyTorch's sort-based kernel: a
  stable sort of the indices, then each destination row's contributions
  summed in that order by one thread, the same order on every run (PyTorch
  lists it among the deterministic operations; on the CPU it sums with
  atomics unless ``torch.use_deterministic_algorithms`` is on). That kernel
  sums a row's duplicates serially, so no row may collect thousands: empty
  picks go to distinct scratch rows, and the row every window of a frame
  takes (the MsSVT block's pad row) is a one-hot product instead.
  ``torch.gather``/``take_along_dim`` (backward ``scatter_add_``) and
  ``index_select`` (backward ``index_add_``) sum with float atomics on
  CUDA, in an order that changes between runs, so the training path does
  not use them where a row can be picked twice.
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
    """(B, N, ...) values by (B, M) indices -> (B, M, ...). Advanced
    indexing: its backward is the sorted, deterministic ``index_put_``
    (see the module note)."""
    rows = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[rows, idx.long()]


class _GroupFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, idx):
        v = features.shape[0]
        padded = torch.cat([features, features.new_zeros((1, features.shape[1]))])
        safe = torch.where((idx >= 0) & (idx < v), idx, v).long()
        ctx.save_for_backward(safe)
        ctx.v = v
        return padded[safe]

    @staticmethod
    def backward(ctx, g):
        (safe,) = ctx.saved_tensors
        v, c = ctx.v, g.shape[-1]
        flat = safe.reshape(-1)
        # empty picks go to distinct scratch rows past v (not all to one
        # zero row, whose thousands of duplicates the sorted kernel would
        # sum serially); valid rows collect their few picks in index order
        dest = torch.where(flat < v, flat,
                           v + torch.arange(flat.numel(), device=flat.device))
        dx = g.new_zeros((v + flat.numel(), c))
        dx.index_put_((dest,), g.reshape(-1, c), accumulate=True)
        return dx[:v], None


def group_features(features, idx):
    """Rows of flat (V, C) features at (..., n) global indices; -1 (and
    any index >= V) gives a zero row. A row may be picked several times (a
    voxel is a key of up to 9 windows); the backward sums its picks with
    the sorted, deterministic ``index_put_`` (see the module note)."""
    return _GroupFeatures.apply(features, idx)


class _GroupFeaturesPaired(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, ind, win_row, slot, inv_valid):
        ctx.save_for_backward(win_row, slot, inv_valid)
        ctx.meta = (tuple(ind.shape), features.dtype)
        return group_features(features, ind)

    @staticmethod
    def backward(ctx, g):
        win_row, slot, inv_valid = ctx.saved_tensors
        (nw, cap), dtype = ctx.meta
        pos = (win_row.long() * cap + slot.long()).clamp(0, nw * cap - 1)
        rows = g.reshape(-1, g.shape[-1])[pos]
        dx = torch.where(inv_valid[:, None], rows, torch.zeros((), dtype=g.dtype,
                                                               device=g.device))
        return dx.to(dtype), None, None, None, None


def group_features_paired(features, ind, win_row, slot, inv_valid):
    """:func:`group_features` whose backward is a row gather, not a sum.

    Requires the partial-permutation property of the win1 buffers
    (``gather_window_voxels(return_inverse=True)``): ``ind[w, s] == v`` iff
    ``inv_valid[v] & win_row[v] == w & slot[v] == s``. Each voxel then has
    at most one contribution, so ``dx[v] = g[win_row[v], slot[v]]`` (zero
    where ``inv_valid`` is False)."""
    return _GroupFeaturesPaired.apply(features, ind, win_row, slot, inv_valid)


class _WritebackInversePaired(torch.autograd.Function):
    @staticmethod
    def forward(ctx, upd_fea, shortcut, ind, win_row, slot, inv_valid):
        nw_b, n1b, c = upd_fea.shape
        pos = (win_row.long() * n1b + slot.long()).clamp(0, nw_b * n1b - 1)
        rows = upd_fea.reshape(-1, c)[pos].to(shortcut.dtype)
        ctx.save_for_backward(ind, inv_valid)
        ctx.dtypes = (upd_fea.dtype, shortcut.dtype)
        return torch.where(inv_valid[:, None], rows, shortcut)

    @staticmethod
    def backward(ctx, gy):
        ind, inv_valid = ctx.saved_tensors
        u_dtype, s_dtype = ctx.dtypes
        v = gy.shape[0]
        gpad = torch.cat([gy, gy.new_zeros((1, gy.shape[1]))])
        safe = torch.where((ind >= 0) & (ind < v), ind, v).long()
        d_upd = gpad[safe].to(u_dtype)
        zero = torch.zeros((), dtype=gy.dtype, device=gy.device)
        d_short = torch.where(inv_valid[:, None], zero, gy).to(s_dtype)
        return d_upd, d_short, None, None, None, None


def writeback_inverse_paired(upd_fea, shortcut, ind, win_row, slot,
                             inv_valid):
    """Each voxel takes its updated row from (window, slot); voxels in no
    live slot keep ``shortcut``. The backward is a row gather too:
    ``d_upd[w, s] = gy[ind[w, s]]`` (zero where ``ind < 0``) and
    ``d_shortcut = gy`` where no slot took the voxel (same property as
    :func:`group_features_paired`)."""
    return _WritebackInversePaired.apply(upd_fea, shortcut, ind, win_row,
                                         slot, inv_valid)
