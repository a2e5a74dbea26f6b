"""Linearized voxel keys and the sort-free dense dedup (torch).

Counterpart of ``mssvt_tpu/core/index.py``. Keys fold the batch index in as
the highest digit (``((b*X + x)*Y + y)*Z + z``); invalid or out-of-range
coordinates map to :data:`INVALID_KEY`. All shapes are static: padded rows
are routed to a scratch slot past the end of each table and sliced off,
which is what JAX's ``mode="drop"`` scatters do implicitly.
"""

from __future__ import annotations

import torch

INVALID_KEY = 2**31 - 1


def linearize_coords(coords: torch.Tensor, spatial_shape, valid=None):
    """(..., 4) int (b, z, y, x) -> (...,) int32 keys, INVALID_KEY where the
    coordinate is out of bounds or ``valid`` is False."""
    x_max, y_max, z_max = (int(s) for s in spatial_shape)
    b, z, y, x = coords[..., 0], coords[..., 1], coords[..., 2], coords[..., 3]
    ok = ((b >= 0) & (x >= 0) & (x < x_max) & (y >= 0) & (y < y_max)
          & (z >= 0) & (z < z_max))
    if valid is not None:
        ok = ok & valid
    key = ((b.long() * x_max + x) * y_max + y) * z_max + z
    return torch.where(ok, key, INVALID_KEY).to(torch.int32)


def delinearize_key(keys: torch.Tensor, spatial_shape):
    """Inverse of :func:`linearize_coords`; invalid keys give all -1."""
    x_max, y_max, z_max = (int(s) for s in spatial_shape)
    valid = keys != INVALID_KEY
    k = torch.where(valid, keys, 0).long()
    z = k % z_max
    k = k // z_max
    y = k % y_max
    k = k // y_max
    x = k % x_max
    b = k // x_max
    coords = torch.stack([b, z, y, x], dim=-1).to(torch.int32)
    return torch.where(valid[..., None], coords, -1)


def unique_compact_dense(keys: torch.Tensor, capacity: int, n_cells: int,
                         return_ranks: bool = False):
    """Ascending unique keys in [0, n_cells) compacted into ``capacity``
    slots (INVALID_KEY padded) by an occupancy scatter + cumsum.

    Returns (out_keys, out_valid, num_unique[, ranks]); ``ranks`` is each
    input key's row in the compacted output (-1 if invalid or overflowed).
    The compaction writes each key at its rank with an exact scatter-max
    (duplicates write identical values), as the JAX version does.
    """
    dev = keys.device
    valid = keys != INVALID_KEY
    safe = torch.where(valid, keys.long(), n_cells)  # n_cells = scratch slot
    occ = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    occ.index_fill_(0, safe, 1)
    occ = occ[:n_cells]
    slot = torch.cumsum(occ, 0, dtype=torch.int32) - 1
    num_unique = occ.sum().to(torch.int32)
    krank = slot[safe.clamp(max=n_cells - 1)]
    keep = valid & (krank < capacity)
    dest = torch.where(keep, krank, capacity).long()
    out = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    out = out.scatter_reduce(0, dest, torch.where(valid, keys, -1), "amax")
    out_keys = out[:capacity]
    out_valid = out_keys >= 0
    out_keys = torch.where(out_valid, out_keys, INVALID_KEY)
    if return_ranks:
        ranks = torch.where(keep, krank, -1).to(torch.int32)
        return out_keys, out_valid, num_unique, ranks
    return out_keys, out_valid, num_unique


def build_dense_row_table(coords, valid, spatial_shape, batch_size: int):
    """Dense cell -> row table over a small key space; -1 for empty cells."""
    x_max, y_max, z_max = (int(s) for s in spatial_shape)
    n_cells = batch_size * x_max * y_max * z_max
    keys = linearize_coords(coords, spatial_shape, valid)
    n = keys.shape[0]
    safe = torch.where(keys != INVALID_KEY, keys.long(), n_cells)
    table = torch.full((n_cells + 1,), -1, dtype=torch.int32,
                       device=coords.device)
    table[safe] = torch.arange(n, dtype=torch.int32, device=coords.device)
    return table[:n_cells]
