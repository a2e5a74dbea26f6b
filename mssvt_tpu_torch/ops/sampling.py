"""Point sampling, grouping and interpolation (torch counterpart of
``mssvt_tpu/ops/sampling.py``), channel-last throughout.

The FPS of the MsSVT blocks runs as the K2 kernel
(:func:`farthest_point_sample_planes_select` -> ``kernels/fps.py``), the
selection-free :func:`farthest_point_sample_planes` (and the point
detectors' :func:`farthest_point_sample` over it) as K2b/K2c, and the
padding-aware :func:`farthest_point_sample_masked` (its invalid rows keep
min-distance -1 and its first pick is the first valid row; PV-RCNN++'s
:func:`sector_fps`) as the masked FPS kernel; the rest are plain tensor
ops.

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
- Where one row may collect thousands of live picks (the RoI heads' grid
  points over overlapping RoIs, ``voxel_query``'s padding), the gather is
  :func:`gather_rows`, whose backward is :func:`segment_sum`: a stable
  sort of the picks by row, then sums over fixed blocks of the sorted
  picks by one batched product with each block's same-row mask, the
  block-crossing partials carried to the next level; a fixed tree of
  parallel sums, the same order on every run.
"""

from __future__ import annotations

import math

import torch

from ..kernels import fps as fps_kernel


def farthest_point_sample_planes(x, y, z, npoint: int):
    """FPS on (B, N) coordinate planes -> (B, npoint) int32: first pick 0,
    min-dist starts at 1e10, argmax ties to the lowest index. CUDA tensors
    run the K2b kernel (N <= 256) or K2c (above it); CPU tensors the plain
    version."""
    return fps_kernel.fps_picks(x.float().contiguous(), y.float().contiguous(),
                                z.float().contiguous(), npoint)


def farthest_point_sample(xyz, npoint: int):
    """FPS over (B, N, 3) points (padding rows included: JAX's semantics,
    they sit at the origin) -> (B, npoint) int32, through
    :func:`farthest_point_sample_planes`: K2b for N <= 256, K2c for N <=
    16 384 on the card; above K2c's limit a CUDA tensor raises (K2c's
    wrapper names the limit; no quiet fallback to the plain loop)."""
    x, y, z = xyz.detach().float().unbind(-1)
    return farthest_point_sample_planes(x, y, z, npoint)


def farthest_point_sample_masked(xyz, valid, npoint: int):
    """FPS that prefers valid rows: invalid rows keep min-distance -1, the
    first pick is the first valid row; past the valid rows the tail repeats
    indices the caller masks with ``valid[idx]``. (F, N, 3) points, (R, N)
    bool with R a multiple of F (row ``r`` takes frame ``r % F``'s points)
    -> (R, npoint) int32. CUDA tensors run the masked FPS kernel (one CTA a
    row, N <= 16 384), CPU tensors its plain loop
    (``kernels/fps.py``)."""
    planes = xyz.detach().float().permute(2, 0, 1).contiguous()
    return fps_kernel.fps_picks_masked(planes[0], planes[1], planes[2],
                                       valid.contiguous(), npoint)


def sample_points_with_roi(points_xyz, points_valid, rois, roi_valid,
                           sample_radius: float):
    """The (B, N) validity of the points within ``sample_radius`` plus the
    half-diagonal of a valid RoI's centre (ref:
    voxel_set_abstraction.py:78-121); a frame without a valid RoI keeps
    its mask. Distances from the coordinate planes (no (B, N, R, 3)
    temporary)."""
    d2 = None
    for i in range(3):
        d = points_xyz[..., i][:, :, None] - rois[..., i][:, None, :]
        d2 = d * d if d2 is None else d2 + d * d
    half = torch.sqrt(rois[..., 3] * rois[..., 3] + rois[..., 4] * rois[..., 4]
                      + rois[..., 5] * rois[..., 5]) / 2
    near = (torch.sqrt(d2) < (half[:, None, :] + sample_radius)) \
        & roi_valid[:, None, :]
    has_roi = roi_valid.any(dim=-1, keepdim=True)
    return points_valid & torch.where(has_roi, near.any(dim=-1), True)


def sector_fps(points_xyz, points_valid, npoint: int, num_sectors: int):
    """Sectorised FPS (ref: voxel_set_abstraction.py:45-75): a masked FPS
    of ``ceil(npoint / num_sectors)`` picks in each azimuth sector, then
    one over the union cut to ``npoint`` -> (B, npoint) int32. The sectors'
    FPS runs as one call, the sectors' rows stacked sector-major (row ``k *
    B + b``: sector ``k`` of frame ``b``, which reads frame ``b``'s points;
    each row is independent, so the picks are those of one FPS a
    sector)."""
    if num_sectors <= 1:
        return farthest_point_sample_masked(points_xyz, points_valid, npoint)
    b, n, _ = points_xyz.shape
    s = int(num_sectors)
    quota = -(-npoint // s)
    xyz = points_xyz.detach().float()
    az = torch.atan2(xyz[..., 1], xyz[..., 0])
    sector = torch.clamp(((az + math.pi) / (2 * math.pi) * s).to(torch.int32),
                         0, s - 1)
    arange = torch.arange(s, device=xyz.device, dtype=torch.int32)
    v = points_valid[None] & (sector[None] == arange[:, None, None])
    idx = farthest_point_sample_masked(xyz, v.reshape(s * b, n),
                                       quota).reshape(s, b, quota)
    cvalid = torch.gather(v, 2, idx.long())
    cand = idx.permute(1, 0, 2).reshape(b, s * quota)
    cvalid = cvalid.permute(1, 0, 2).reshape(b, s * quota)
    final = farthest_point_sample_masked(gather_batch_rows(xyz, cand), cvalid,
                                         npoint)
    return torch.gather(cand, 1, final.long())


def three_nn(unknown, known, known_valid=None):
    """The 3 nearest ``known`` points of each ``unknown`` point: squared
    distances (B, n, 3) ascending, ties to the lower index, and their
    indices (B, n, 3) int32 (ref: interpolate_gpu.cu:16-57; fewer than 3
    candidates pad with index 0 at 1e38).

    JAX's formula, |u|^2 + |k|^2 - 2 u.k clamped at 0, each three-term sum
    in f32 left to right from the coordinate planes: never a matmul, so no
    TF32 on the card, and the same bits on the CPU and the card. XLA rounds
    its dot and its sums in orders of its own, which depend on the fusion
    around them, so a pick may differ from JAX's where two candidates lie
    within rounding of each other (a near-tie). The expansion cancels where
    an unknown point is a known one (a feature propagation's points hold
    the coarser level's): here |u|^2 and u.u round alike and d2 is exactly
    0, as pcdet's kernel (which subtracts) gives, where XLA leaves rounding
    noise of ~1e-7 |u|^2 whose inverse square root weighs that neighbour."""
    ux, uy, uz = unknown.detach().float().unbind(-1)
    kx, ky, kz = known.detach().float().unbind(-1)
    u2 = ux * ux + uy * uy + uz * uz
    k2 = kx * kx + ky * ky + kz * kz
    cross = (ux[:, :, None] * kx[:, None, :] + uy[:, :, None] * ky[:, None, :]
             + uz[:, :, None] * kz[:, None, :])
    work = torch.clamp(u2[:, :, None] + k2[:, None, :] - 2.0 * cross, min=0.0)
    del cross
    if known_valid is not None:
        work = torch.where(known_valid[:, None, :], work,
                           torch.full((), float("inf"), device=work.device))
    n_pick = min(3, known.shape[1])
    picked_d, picked_i = [], []
    for j in range(n_pick):
        i_j = torch.argmin(work, dim=-1, keepdim=True)  # the first minimum
        picked_d.append(work.gather(-1, i_j))
        picked_i.append(i_j)
        if j < n_pick - 1:
            work = work.scatter(-1, i_j, float("inf"))
    for _ in range(3 - n_pick):
        picked_d.append(torch.full_like(picked_d[0], 1e38))
        picked_i.append(torch.zeros_like(picked_i[0]))
    return (torch.cat(picked_d, dim=-1),
            torch.cat(picked_i, dim=-1).to(torch.int32))


def three_interpolate(features, idx, weight):
    """Weighted sum of 3 neighbours' features: (B, m, C) features at (B, n,
    3) indices with (B, n, 3) weights -> (B, n, C) (ref:
    interpolate_gpu.cu:84-107). A gather form (JAX builds a dense (B, n, m)
    weight matrix): the three rows summed in pick order, the features'
    backward through :func:`gather_batch_rows` (deterministic, however many
    picks a row collects)."""
    rows = gather_batch_rows(features, idx)  # (B, n, 3, C)
    w = weight.to(rows.dtype)
    return (rows[:, :, 0] * w[:, :, 0, None] + rows[:, :, 1] * w[:, :, 1, None]
            + rows[:, :, 2] * w[:, :, 2, None])


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


def gather_batch_rows(values, idx):
    """(B, N, ...) values at (B, ...) indices in [0, N) -> (B, ..., ...)
    through :func:`gather_rows` (the backward a deterministic
    :func:`segment_sum`, parallel however many picks a row collects): the
    training gathers of the point detectors, whose rows may collect
    thousands of picks."""
    b, n = values.shape[:2]
    flat = values.reshape(b * n, -1)
    base = torch.arange(b, device=idx.device).view((b,) + (1,) * (idx.ndim - 1))
    out = gather_rows(flat, idx.long() + base * n)
    return out.reshape(tuple(idx.shape) + tuple(values.shape[2:]))


def gather_along_batch(values, idx):
    """(B, N, ...) values by (B, M) indices -> (B, M, ...). Advanced
    indexing: its backward is the sorted, deterministic ``index_put_``
    (see the module note), one kernel that sums a row's picks serially.
    Only for gathers whose rows collect a bounded few picks: the MsSVT
    blocks' window takes (a window's FPS picks repeat a slot at most
    ``key_num_sample`` times; the even-cell run's clamped tail at most
    ``nq``). Where a row may collect thousands (the point detectors'
    groupings, padding picks of row 0), use :func:`gather_batch_rows`,
    whose :func:`segment_sum` backward adds a sort and a blocked product
    to every call but stays parallel. Moving the MsSVT takes to it is not
    measured yet (ROADMAP Queue 3)."""
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


SEGMENT_BLOCK = 32  # sorted picks a block of :func:`segment_sum`


def segment_sum(rows, values, num_rows: int):
    """Sum (N, C) ``values`` into (num_rows, C) by their (N,) ``rows`` (each
    in [0, num_rows)), deterministically and without a serial loop over a
    row's picks: a stable sort by row, then levels of blocks of
    :data:`SEGMENT_BLOCK` sorted picks. In a block, one product with the
    same-row mask gives every pick its row's sum within the block; a row
    whose picks all lie inside one block, past its first row and before
    its last, is written out, and each block carries its first and its last
    row's partial sums (in order, so still sorted) to the next level, until
    one block holds them all. Summed in f32 at least."""
    t = SEGMENT_BLOCK
    dt = torch.promote_types(values.dtype, torch.float32)
    c = values.shape[1]
    rows = rows.reshape(-1).long()
    order = torch.sort(rows, stable=True)[1]
    keys, vals = rows[order], values.reshape(-1, c)[order].to(dt)
    out = vals.new_zeros((num_rows + 1, c))  # num_rows: the dump row
    while keys.shape[0]:
        n = keys.shape[0]
        pad = (-n) % t
        if pad:
            keys = torch.cat([keys, keys.new_full((pad,), num_rows)])
            vals = torch.cat([vals, vals.new_zeros((pad, c))])
        nb = keys.shape[0] // t
        k = keys.view(nb, t)
        same = (k[:, :, None] == k[:, None, :]).to(dt)
        s = torch.bmm(same, vals.view(nb, t, c))  # (nb, t, c)
        first = torch.ones_like(k, dtype=torch.bool)
        first[:, 1:] = k[:, 1:] != k[:, :-1]
        head, tail = k[:, :1], k[:, -1:]
        if nb == 1:  # every row complete: write each at its first pick
            done = first
        else:
            done = first & (k != head) & (k != tail)
        out[torch.where(done, k, num_rows).reshape(-1)] = s.reshape(-1, c)
        if nb == 1:
            break
        single = head[:, 0] == tail[:, 0]
        keys = torch.stack([head[:, 0], tail[:, 0]], 1).reshape(-1)
        vals = torch.stack([s[:, 0], torch.where(single[:, None], 0.0,
                                                 s[:, -1])], 1).reshape(-1, c)
    return out[:num_rows]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.meta = (values.shape[0], values.dtype)
        return values[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        v, dtype = ctx.meta
        c = g.shape[-1]
        dx = segment_sum(idx, g.reshape(-1, c), v)
        return dx.to(dtype), None


def gather_rows(values, idx):
    """Rows of (V, C) ``values`` at (...) indices in [0, V) -> (..., C).
    The backward sums each row's picks with :func:`segment_sum`
    (deterministic, parallel however many picks a row collects)."""
    return _GatherRows.apply(values, idx)
