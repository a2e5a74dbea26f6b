"""Sparse 3D convolution by sorted-key gather (torch counterpart of
``mssvt_tpu/ops/sparse_conv.py``; the spconv library's role in the
reference's SECOND family).

- Submanifold conv: output sites = input sites. One lookup of every
  (voxel, kernel offset) neighbour key against the sorted index gives a
  (V, K) neighbour-row table, then one ``(V, K*Cin) @ (K*Cin, Cout)``
  product a layer.
- Strided conv: spconv's output sites, enumerated statically per input
  site (at most ceil(k/s) candidates a dimension), deduplicated by the
  sort + prefix-sum compaction, then a neighbour table looked up from the
  output sites.

Absent neighbours (-1) read a zero row appended past the features, so no
live row is read for them. The backward of :func:`sparse_conv` gathers too:
the input cotangent of row i sums, over the offsets k, the output
cotangent of the output row that read row i through offset k (the
transposed table: the submanifold table flipped along K, or
:func:`build_inverse_neighbor_table` for a strided layer), so no row
collects the absent pairs and the sums are deterministic.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.index import (
    VoxelIndex,
    delinearize_key,
    linearize_coords,
    lookup,
    unique_compact,
)


def _kernel_offsets(kernel_size: Sequence[int]) -> np.ndarray:
    """(K, 3) zyx offsets in [0, k), row-major (z, y, x) as spconv's
    kernel layout; ``kernel_size`` is (x, y, z)."""
    kz, ky, kx = kernel_size[2], kernel_size[1], kernel_size[0]
    return np.asarray([(z, y, x) for z in range(kz) for y in range(ky)
                       for x in range(kx)], np.int32)


def _zyx(t, device):
    """An (x, y, z) triple as a (3,) zyx int64 tensor."""
    return torch.tensor([t[2], t[1], t[0]], dtype=torch.int64, device=device)


def _with_batch(b, zyx):
    """(V, 1) batch column beside (V, K, 3) zyx -> (V, K, 4) coords."""
    return torch.cat([b[:, None, :].expand(-1, zyx.shape[1], 1), zyx], dim=-1)


def build_subm_neighbor_table(coords, valid, index: VoxelIndex, spatial_shape,
                              kernel_size=(3, 3, 3)):
    """Neighbour rows (V, K) of a submanifold conv, -1 where absent; the
    centre offset maps to the site itself."""
    dev = coords.device
    offs = torch.as_tensor(_kernel_offsets(kernel_size), device=dev).long()
    half = torch.tensor([(kernel_size[2] - 1) // 2, (kernel_size[1] - 1) // 2,
                         (kernel_size[0] - 1) // 2], device=dev)
    c = coords.long()
    nb = c[:, None, 1:4] + (offs - half)[None]
    keys = linearize_coords(_with_batch(c[:, 0:1], nb), spatial_shape,
                            valid=valid[:, None])
    return lookup(index, keys)


def _gather_rows(features, rows):
    """(V_out, K, C) rows of ``features``; -1 reads a zero row."""
    v = features.shape[0]
    padded = torch.cat([features, features.new_zeros((1, features.shape[1]))])
    return padded[torch.where(rows >= 0, rows.long(), v)]


class _SparseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, weights, rows, rows_t_fn):
        vo, k = rows.shape
        cin = features.shape[1]
        gathered = _gather_rows(features, rows).reshape(vo, k * cin)
        out = gathered @ weights.reshape(k * cin, -1)
        ctx.save_for_backward(gathered, weights)
        ctx.rows_t_fn = rows_t_fn
        ctx.cin = cin
        return out

    @staticmethod
    def backward(ctx, g):
        gathered, weights = ctx.saved_tensors
        k, cin, cout = weights.shape
        dx = dw = None
        if ctx.needs_input_grad[0]:
            rows_t = ctx.rows_t_fn()  # (V_in, K): output row read by (i, k)
            gg = _gather_rows(g, rows_t)  # (V_in, K, Cout)
            dx = torch.einsum("vko,kio->vi", gg, weights)
        if ctx.needs_input_grad[1]:
            dw = (gathered.t() @ g).reshape(k, cin, cout)
        return dx, dw, None, None


def sparse_conv(features, rows, weights, rows_t_fn):
    """:func:`subm_conv_apply` with the gather backward of the module note;
    ``rows_t_fn()`` returns the transposed (V_in, K) table and is called
    only by the backward."""
    return _SparseConv.apply(features, weights, rows, rows_t_fn)


def subm_conv_apply(features, neighbor_rows, weights):
    """(V_in, Cin) features, (V_out, K) neighbour rows and (K, Cin, Cout)
    weights -> (V_out, Cout) in the features' dtype (a plain autograd
    graph; the layers use :func:`sparse_conv`)."""
    vo, k = neighbor_rows.shape
    cin = features.shape[1]
    gathered = _gather_rows(features, neighbor_rows).reshape(vo, k * cin)
    return (gathered @ weights.reshape(k * cin, -1)).to(features.dtype)


def downsample_output_sites(coords, valid, spatial_shape, kernel_size, stride,
                            padding, max_out: int):
    """spconv's output-site set of a strided sparse conv: an output o
    covers input i (a dimension) when ``0 <= i + p - o*s <= k-1``. Returns
    (out_coords (max_out, 4), out_valid, out_spatial_shape); sites past
    ``max_out`` (the largest keys) are dropped."""
    ks, st, pd = list(kernel_size), list(stride), list(padding)
    out_shape = tuple((dim + 2 * pd[i] - ks[i]) // st[i] + 1
                      for i, dim in enumerate(int(s) for s in spatial_shape))
    if any(s <= 0 for s in out_shape):
        raise ValueError(
            f"strided sparse conv collapses spatial shape {spatial_shape} -> "
            f"{out_shape} (kernel {kernel_size}, stride {stride}, padding "
            f"{padding}); increase the grid or adjust the layer")
    n_cand = [int(np.ceil(ks[i] / st[i])) for i in range(3)]
    cands = np.asarray([(dz, dy, dx) for dx in range(n_cand[0])
                        for dy in range(n_cand[1]) for dz in range(n_cand[2])],
                       np.int64)
    dev = coords.device
    c = coords.long()
    p_zyx, s_zyx, k_zyx = (_zyx(t, dev) for t in (pd, st, ks))
    base = torch.div(c[:, 1:4] + p_zyx, s_zyx, rounding_mode="floor")
    oz = base[:, None, :] - torch.as_tensor(cands, device=dev)[None]
    j = (c[:, 1:4] + p_zyx)[:, None, :] - oz * s_zyx
    cover = ((j >= 0) & (j <= k_zyx - 1)).all(dim=-1)
    keys = linearize_coords(_with_batch(c[:, 0:1], oz), out_shape,
                            valid=cover & valid[:, None]).reshape(-1)
    out_keys, out_valid, _ = unique_compact(keys, max_out)
    return delinearize_key(out_keys, out_shape), out_valid, out_shape


def build_strided_neighbor_table(in_coords, in_valid, in_index: VoxelIndex,
                                 in_spatial_shape, out_coords, out_valid,
                                 kernel_size, stride, padding):
    """Neighbour rows (V_out, K) into the INPUT features: input site
    ``out * s - p + offset``."""
    dev = out_coords.device
    offs = torch.as_tensor(_kernel_offsets(kernel_size), device=dev).long()
    s_zyx, p_zyx = _zyx(stride, dev), _zyx(padding, dev)
    c = out_coords.long()
    nb = c[:, None, 1:4] * s_zyx + offs[None] - p_zyx
    keys = linearize_coords(_with_batch(c[:, 0:1], nb), in_spatial_shape,
                            valid=out_valid[:, None])
    return lookup(in_index, keys)


def build_inverse_neighbor_table(fine_coords, fine_valid,
                                 coarse_index: VoxelIndex,
                                 coarse_spatial_shape, kernel_size, stride,
                                 padding):
    """Neighbour rows (V_fine, K) into the COARSE features, the transposed
    direction of :func:`build_strided_neighbor_table`: for fine site f and
    offset k the coarse site ``(f + p - k) / s`` where the division is
    exact, -1 where absent or inexact."""
    dev = fine_coords.device
    offs = torch.as_tensor(_kernel_offsets(kernel_size), device=dev).long()
    s_zyx, p_zyx = _zyx(stride, dev), _zyx(padding, dev)
    c = fine_coords.long()
    num = c[:, None, 1:4] + p_zyx - offs[None]
    exact = (torch.remainder(num, s_zyx) == 0).all(dim=-1) \
        & (num >= 0).all(dim=-1)
    coarse = torch.div(num, s_zyx, rounding_mode="floor")
    keys = linearize_coords(_with_batch(c[:, 0:1], coarse),
                            coarse_spatial_shape,
                            valid=exact & fine_valid[:, None])
    return lookup(coarse_index, keys)
