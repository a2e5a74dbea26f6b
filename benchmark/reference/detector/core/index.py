"""Linearized voxel keys and the sort-free dense dedup (torch).

Counterpart of ``mssvt_tpu/core/index.py``. Keys fold the batch index in as
the highest digit (``((b*X + x)*Y + y)*Z + z``); invalid or out-of-range
coordinates map to :data:`INVALID_KEY`. All shapes are static: padded rows
are routed to a scratch slot past the end of each table and sliced off,
which is what JAX's ``mode="drop"`` scatters do implicitly.

The sorted-key index (:class:`VoxelIndex`, :func:`build_index`,
:func:`lookup`) and the sort-based :func:`unique_compact` serve the sparse
convolutions; the MsSVT path uses the dense tables below and never sorts.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

INVALID_KEY = 2**31 - 1


def _check_key_capacity(batch_size: int, spatial_shape) -> None:
    """Raise when the linearised key space of ``batch_size`` grids of
    ``spatial_shape`` (x, y, z) does not fit below :data:`INVALID_KEY`."""
    x, y, z = (int(s) for s in spatial_shape)
    total = batch_size * x * y * z
    if total >= INVALID_KEY:
        raise ValueError(
            f"linearized key space {total} overflows int32 "
            f"(batch_size={batch_size}, spatial_shape={spatial_shape}); "
            "reduce grid size or batch, or shard the batch across devices")


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


def lookup_dense(table, query_keys):
    """Row of each query key (any shape) in a :func:`build_dense_row_table`
    table: -1 for an empty cell, a negative or out-of-range key, or
    INVALID_KEY."""
    n_cells = table.shape[0]
    q = query_keys.long()
    oob = (q < 0) | (q >= n_cells) | (q == INVALID_KEY)
    got = table[q.clamp(0, n_cells - 1)]
    return torch.where(oob, -1, got).to(torch.int32)


@dataclass(frozen=True)
class VoxelIndex:
    """Sorted (key, row) pairs over the padded voxel set of a whole batch:
    ``sorted_keys`` (V,) int32 ascending with the INVALID_KEY padding last,
    ``sorted_rows`` (V,) int32 the row of each key in the flat arrays."""

    sorted_keys: torch.Tensor
    sorted_rows: torch.Tensor


def build_index(coords, valid, spatial_shape) -> VoxelIndex:
    """The sorted-key index of (V, 4) (b, z, y, x) coords (one stable sort:
    padding rows keep their row order behind the live keys, as JAX's
    ``argsort`` does)."""
    keys = linearize_coords(coords, spatial_shape, valid)
    sorted_keys, order = torch.sort(keys, stable=True)
    return VoxelIndex(sorted_keys, order.to(torch.int32))


def lookup(index: VoxelIndex, query_keys):
    """Row of each query key (any shape) by binary search, -1 if absent."""
    sk = index.sorted_keys
    n = sk.shape[0]
    pos = torch.searchsorted(sk, query_keys.contiguous(), side="left")
    pos = pos.clamp(0, n - 1)
    found = (sk[pos] == query_keys) & (query_keys != INVALID_KEY)
    return torch.where(found, index.sorted_rows[pos], -1).to(torch.int32)


def unique_compact(keys, capacity: int):
    """Ascending unique valid keys of (n,) ``keys`` in ``capacity`` slots
    (INVALID_KEY padded; beyond ``capacity`` the largest are dropped).
    Returns (out_keys, out_valid, num_unique), ``num_unique`` counted before
    the truncation. Overflowing keys go to a dump slot at ``capacity`` that
    is sliced off (JAX's ``mode="drop"``)."""
    sorted_keys, _ = torch.sort(keys)
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first &= sorted_keys != INVALID_KEY
    slot = torch.cumsum(first.to(torch.int64), 0) - 1
    num_unique = first.sum().to(torch.int32)
    dest = torch.where(first & (slot < capacity), slot, capacity)
    out = torch.full((capacity + 1,), INVALID_KEY, dtype=torch.int32,
                     device=keys.device)
    out[dest] = sorted_keys.to(torch.int32)
    out_keys = out[:capacity]
    return out_keys, out_keys != INVALID_KEY, num_unique
