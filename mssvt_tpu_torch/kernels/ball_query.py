"""PointNet++'s ball query: the first ``nsample`` support points in index
order that are valid and lie inside a radius of each query.

Replaces no TPU kernel (the JAX package's ``ball_query``,
``mssvt_tpu/ops/pointnet2.py``, is plain jnp). Given support points (B, N,
3) f32, queries (B, M, 3) f32 and optional valid flags (B, N) bool, it
returns idx (B, M, nsample) int32, the first ``nsample`` points with
``d2 < radius ** 2`` (``d2 = ((qx-px)^2 + (qy-py)^2) + (qz-pz)^2``, each
operation rounded in f32, the bound rounded to f32), the unfilled slots
repeating slot 0 and every slot 0 for a query that found none, and empty
(B, M) bool.

CUDA tensors go to ``csrc/ball_query.cu`` (a warp walks its queries' support
points once, 32 a step, and stops at ``nsample`` hits; one launch a call);
CPU tensors to :func:`ball_query_plain`, the dense (B, M, N) mask and its
first hits (:func:`first_hits`). The kernel's rounding is the plain
version's, so the two give the same bits.
"""

from __future__ import annotations

import torch

from . import _lib, work

launches = 0


def first_hits(mask, k: int):
    """(..., N) bool -> (..., k) int32: the indices of the first ``k`` set
    entries in index order, -1 past the last one. The running count of set
    entries (int32) is nondecreasing, so the j-th is the first position
    where it reaches j + 1 (``torch.searchsorted``): no scatter, every slot
    written once."""
    n = mask.shape[-1]
    count = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    want = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(count, want.expand(mask.shape[:-1] + (k,))
                             .contiguous(), out_int32=True)
    return torch.where(pos < n, pos, -1)


def ball_query_plain(radius: float, nsample: int, xyz, new_xyz,
                     xyz_valid=None):
    """Plain PyTorch version (same contract as :func:`ball_query`). The
    squared distances come from the coordinate planes in JAX's order of
    operations, with no (..., 3) difference tensor."""
    d2 = None
    for i in range(3):
        d = new_xyz[..., i].detach()[:, :, None] - xyz[..., i].detach()[:, None, :]
        d2 = d * d if d2 is None else d2 + d * d
    del d
    in_ball = d2 < radius ** 2  # the bound rounded to f32, as JAX's
    del d2
    if xyz_valid is not None:
        in_ball &= xyz_valid[:, None, :]
    idx = first_hits(in_ball, nsample)
    empty = idx[..., 0] < 0
    first = torch.where(empty, 0, idx[..., 0])
    return torch.where(idx >= 0, idx, first[..., None]), empty


def kernel_inputs(nsample, xyz, new_xyz, xyz_valid):
    """The checks in front of the kernel: (B, N, M), or a raise on what the
    kernel does not take."""
    for t, name in ((xyz, "xyz"), (new_xyz, "new_xyz")):
        if not isinstance(t, torch.Tensor) or t.dim() != 3 \
                or t.shape[-1] != 3:
            raise ValueError(f"ball_query: {name} must be (B, *, 3)")
        if t.dtype != torch.float32:
            raise TypeError(f"ball_query: {name} dtype {t.dtype}, expected "
                            "torch.float32")
    b, n = xyz.shape[:2]
    if new_xyz.shape[0] != b or new_xyz.device != xyz.device:
        raise ValueError("ball_query: xyz and new_xyz differ in frames or "
                         "device")
    if xyz_valid is not None and (
            xyz_valid.dtype != torch.bool
            or tuple(xyz_valid.shape) != (b, n)
            or xyz_valid.device != xyz.device):
        raise ValueError(f"ball_query: xyz_valid must be ({b}, {n}) bool on "
                         f"{xyz.device}")
    if int(nsample) < 1:
        raise ValueError(f"ball_query: nsample {nsample} must be >= 1")
    return b, n, new_xyz.shape[1]


@work.counted("ball_query", work.ball_query)
def ball_query(radius: float, nsample: int, xyz, new_xyz, xyz_valid=None):
    """(B, N, 3) support points, (B, M, 3) queries, f32, optional (B, N)
    valid flags -> idx (B, M, nsample) int32, empty (B, M) bool (see the
    module docstring). The inputs may be strided views."""
    global launches
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz, xyz_valid)
    b, n, m = kernel_inputs(nsample, xyz, new_xyz, xyz_valid)
    ns = int(nsample)
    idx = torch.empty((b, m, ns), dtype=torch.int32, device=xyz.device)
    empty = torch.empty((b, m), dtype=torch.bool, device=xyz.device)
    if b * m == 0:
        return idx, empty
    vs = (0, 0) if xyz_valid is None else xyz_valid.stride()
    err = _lib.lib().mssvt_ball_query(
        xyz.data_ptr(), *xyz.stride(), new_xyz.data_ptr(), *new_xyz.stride(),
        _lib.ptr(xyz_valid), *vs, b, n, m, ns, float(radius) ** 2,
        idx.data_ptr(), empty.data_ptr(), _lib.stream_ptr(xyz))
    _lib.check(err, "mssvt_ball_query")
    launches += 1
    return idx, empty
