"""Window partitioning and mixed-scale voxel gathering (torch).

Counterpart of ``mssvt_tpu/ops/window.py``, restricted to the own-cell
gather path that the MsSVT blocks run:

1. :func:`window_partition` dedups non-empty windows by a dense occupancy
   scatter + cumsum (ascending (batch, x, y, z) key order) and returns each
   voxel's window row.
2. :func:`gather_window_voxels` scatters every voxel once into its window
   cell (a dense (cells, cell_vol) table, or per window row for
   single-scale blocks), row-gathers each window's D neighbour cells into
   the (NW, K) box table, and compacts it to the fixed-capacity buffers with
   the fill kernel (``kernels/fill.py``). The odd/even/win1 buffers are
   contiguous runs of the win2 buffer (:func:`_derive_from_win2`). With a
   bijective cell decomposition (every shipped configuration: win2 / win1
   odd per dimension) the fill reads the box in its source layout
   (``order``) and the voxel -> (window, slot) inverse map reads the fill's
   own-cell rank slab; otherwise the box is permuted to table order by
   ``col_src`` first, and the counts and the inverse map come from the box's
   occupancy, as in JAX.

The host-side query tables (:func:`build_query_tables`) are numpy, built once
per block. The own-cell path needs a batch size and buffers that are runs of
win2. Everything else takes the candidate-scatter gather
(:func:`_gather_candidates`, the JAX package's ``MSSVT_PALLAS=off`` path):
each voxel enumerates the windows whose gather box may hold it, and
per-window ranks in table order place it, with the same fill semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.index import (
    INVALID_KEY,
    build_dense_row_table,
    delinearize_key,
    linearize_coords,
    unique_compact_dense,
)
from ..kernels import fill as fill_kernel
from ..kernels.fill import PACK5_ZERO
from ..utils.device import device_constant

# Buffer ids for the two-window gather
ODD, EVEN, WIN1, WIN2 = 0, 1, 2, 3


@dataclass(frozen=True)
class QueryTables:
    """Chebyshev-sorted gather offset tables and their own-cell
    decomposition (see the JAX package's ``QueryTables``)."""

    offsets: np.ndarray       # (K, 3) int32 xyz offsets from the window centre
    eligibility: np.ndarray   # (K, 4) bool: buffers (odd, even, win1, win2)
    num_odd: int
    num_even: int
    single_scale: bool
    off_min: np.ndarray = None
    off_max: np.ndarray = None
    pos_lut: np.ndarray = None  # (Ox, Oy, Oz) table position of an offset
    deltas: np.ndarray = None   # (D, 3) int32 xyz window deltas
    col_src: np.ndarray = None  # (K,) int32 source column of table entry k
    k_own_lut: np.ndarray = None  # (cell_vol,) table position, -1 absent
    inv_src: np.ndarray = None  # (D*cell_vol,) table position per source col
    d0: int = 0                 # index of the (0, 0, 0) delta


def _chebyshev_sorted_offsets(size) -> np.ndarray:
    xs, ys, zs = (np.arange(s) for s in size)
    grid = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
    offsets = grid - np.asarray(size, np.int64) // 2
    order = np.argsort(np.abs(offsets).max(axis=-1), kind="stable")
    return offsets[order].astype(np.int32)


def _candidate_window_deltas(win1_size, off_min, off_max) -> np.ndarray:
    """Window deltas whose cells cover the gather box, (dx, dz) outer and dy
    inner (the JAX package's order, which fixes the source column layout)."""
    rngs = []
    for dim in range(3):
        w = int(win1_size[dim])
        d_lo = int(np.ceil((0 - w // 2 - int(off_max[dim])) / w))
        d_hi = int(np.floor(((w - 1) - w // 2 - int(off_min[dim])) / w))
        rngs.append(range(d_lo, d_hi + 1))
    return np.asarray(
        [(dx, dy, dz) for dx in rngs[0] for dz in rngs[2] for dy in rngs[1]],
        np.int32)


def _with_cells(offsets, elig, num_odd, num_even, single, win1_size):
    off_min = offsets.min(axis=0).astype(np.int32)
    off_max = offsets.max(axis=0).astype(np.int32)
    rel = offsets - off_min
    pos_lut = np.full(tuple(off_max - off_min + 1), -1, np.int32)
    pos_lut[rel[:, 0], rel[:, 1], rel[:, 2]] = np.arange(len(offsets))
    ws = np.asarray([int(s) for s in win1_size], np.int64)
    deltas = _candidate_window_deltas(win1_size, off_min, off_max)
    dmap = {tuple(d): i for i, d in enumerate(deltas.tolist())}
    cell_vol = int(ws.prod())
    abs_cell = offsets.astype(np.int64) + ws // 2
    d = np.floor_divide(abs_cell, ws)
    local = abs_cell - d * ws
    di = np.asarray([dmap[tuple(r)] for r in d.tolist()], np.int64)
    lid = (local[:, 0] * ws[1] + local[:, 1]) * ws[2] + local[:, 2]
    col_src = (di * cell_vol + lid).astype(np.int32)
    k_own = np.full((cell_vol,), -1, np.int32)
    center = (d == 0).all(axis=1)
    k_own[lid[center]] = np.arange(len(offsets), dtype=np.int32)[center]
    inv_src = None
    if len(offsets) == deltas.shape[0] * cell_vol:
        inv = np.full(deltas.shape[0] * cell_vol, -1, np.int64)
        inv[col_src] = np.arange(len(offsets))
        if (inv >= 0).all():
            inv_src = inv.astype(np.int32)
    return QueryTables(offsets, elig, num_odd, num_even, single, off_min,
                       off_max, pos_lut, deltas, col_src, k_own, inv_src,
                       int(dmap.get((0, 0, 0), 0)))


def build_query_tables(win1_size, win2_size=None, cbs_mode: str = "odd_even",
                       parts=None) -> QueryTables:
    """Gather tables for one block: offsets concatenated in traversal order
    (odd, even, rest of win1, win2-only), each part nearest-first.
    ``parts`` optionally supplies the four ordered offset arrays."""
    win1_size = tuple(int(s) for s in win1_size)
    if win2_size is None:
        offsets = (_chebyshev_sorted_offsets(win1_size) if parts is None
                   else np.asarray(parts["win1"], np.int32))
        elig = np.zeros((offsets.shape[0], 4), bool)
        elig[:, WIN1] = True
        return _with_cells(offsets, elig, 0, 0, True, win1_size)

    win2_size = tuple(int(s) for s in win2_size)
    if any((win2_size[i] - win1_size[i]) % 2 for i in range(3)):
        raise ValueError(f"win2-win1 must be even per dim, got {win1_size}, {win2_size}")
    if cbs_mode != "odd_even":
        raise NotImplementedError(cbs_mode)
    if parts is None:
        offsets = _chebyshev_sorted_offsets(win2_size)
        lo = np.array([-(win1_size[i] // 2) for i in range(3)])
        hi = np.array([win1_size[i] // 2 + (1 - win1_size[i] % 2)
                       for i in range(3)])
        in_win1 = np.all((offsets >= lo) & (offsets <= hi), axis=-1)
        odd = in_win1 & (offsets[:, 0] % 2 == 1) & (offsets[:, 1] % 2 == 1)
        even = in_win1 & (offsets[:, 0] % 2 == 0) & (offsets[:, 1] % 2 == 0)
        rest1 = in_win1 & ~(odd | even)
        part_list = [offsets[odd], offsets[even], offsets[rest1],
                     offsets[~in_win1]]
    else:
        part_list = [np.asarray(parts[k], np.int32)
                     for k in ("odd", "even", "win1", "win2")]
    sizes = [p.shape[0] for p in part_list]
    cat = np.concatenate(part_list, axis=0)
    elig = np.zeros((cat.shape[0], 4), bool)
    o_end = sizes[0]
    e_end = o_end + sizes[1]
    r_end = e_end + sizes[2]
    elig[:o_end, ODD] = True
    elig[o_end:e_end, EVEN] = True
    elig[:r_end, WIN1] = True
    elig[:, WIN2] = True
    return _with_cells(cat, elig, int(sizes[0]), int(sizes[1]), False,
                       win1_size)


def pack_offsets5(offsets: np.ndarray) -> np.ndarray:
    """(K, 3) small offsets -> one int32 per row (5-bit biased per axis)."""
    o = np.asarray(offsets, np.int64)
    assert np.abs(o).max() < 16, "offset exceeds 5-bit packing"
    return (((o[:, 0] + 16) << 10) | ((o[:, 1] + 16) << 5)
            | (o[:, 2] + 16)).astype(np.int32)


def unpack_planes(p: torch.Tensor):
    """Packed 5-bit offsets -> three int32 component planes."""
    return ((p >> 10) & 31) - 16, ((p >> 5) & 31) - 16, (p & 31) - 16


def _window_coords(coords, win_size):
    """(b, z, y, x) voxel coords -> (b, z, y, x) coords of their window."""
    wx, wy, wz = (int(s) for s in win_size)
    return torch.stack([coords[:, 0], coords[:, 1] // wz, coords[:, 2] // wy,
                        coords[:, 3] // wx], dim=1)


def window_partition(coords, valid, spatial_shape, win_size,
                     max_windows: int, batch_size: int,
                     return_ranks: bool = False):
    """Dedup non-empty windows into ``max_windows`` rows.

    Returns (win_coords (max_windows, 4) int32 (b, z, y, x) in window units,
    win_valid, win_grid, num_windows[, ranks]); ``ranks`` is each voxel's
    window row (-1 if dropped)."""
    wx, wy, wz = (int(s) for s in win_size)
    x_max, y_max, z_max = (int(s) for s in spatial_shape)
    win_grid = (x_max // wx, y_max // wy, z_max // wz)
    wkeys = linearize_coords(_window_coords(coords, win_size), win_grid, valid)
    n_cells = batch_size * win_grid[0] * win_grid[1] * win_grid[2]
    out_keys, out_valid, num_windows, ranks = unique_compact_dense(
        wkeys, max_windows, n_cells, return_ranks=True)
    win_coords = delinearize_key(out_keys, win_grid)
    if return_ranks:
        return win_coords, out_valid, win_grid, num_windows, ranks
    return win_coords, out_valid, win_grid, num_windows


def _derive_from_win2(ind2, coordp2, odd_cnt, even_cnt, win1_cnt, names,
                      caps):
    """odd/win1 are prefixes of the win2 buffer; even is the run starting at
    the window's odd count. Slots past each buffer's count are emptied."""
    cap2 = ind2.shape[1]
    out = {}
    for name in names:
        cap = int(caps[name])
        j = torch.arange(cap, device=ind2.device)
        if name == "win2":
            out[name] = {"ind": ind2, "coordp": coordp2, "mask": ind2 < 0}
            continue
        if name in ("odd", "win1"):
            cnt = odd_cnt if name == "odd" else win1_cnt
            live = j[None, :] < cnt[:, None]
            ind, cp = ind2[:, :cap], coordp2[:, :cap]
        else:
            live = j[None, :] < even_cnt[:, None]
            pos = (odd_cnt[:, None] + j[None, :]).clamp(0, cap2 - 1).long()
            ind = torch.take_along_dim(ind2, pos, dim=1)
            cp = torch.take_along_dim(coordp2, pos, dim=1)
        ind = torch.where(live, ind, -1)
        out[name] = {"ind": ind, "coordp": torch.where(live, cp, PACK5_ZERO),
                     "mask": ind < 0}
        if name == "even":
            out[name]["start"] = odd_cnt
    return out


def _own_cell_inverse(win_key, win_valid, own_key, lid, valid, tables, cap1,
                      cap2, n_cells, rank_own, box, win_row_v=None):
    """voxel -> (window row, win1 slot): a voxel's fill rank among its own
    window's cells is its win1 slot (win1 cells precede win2-only cells).
    The rank comes from the fill's own-cell slab ``rank_own`` or, without
    one, from an exclusive scan of ``box`` (table order) read at the
    voxel's own table position."""
    nw = win_valid.shape[0]
    if win_row_v is None:
        wsafe = torch.where(win_key != INVALID_KEY, win_key.long(), n_cells)
        cell_rows = torch.full((n_cells + 1,), -1, dtype=torch.int32,
                               device=lid.device)
        cell_rows[wsafe] = torch.arange(nw, dtype=torch.int32,
                                        device=lid.device)
        cell_rows[n_cells] = -1
        own_cell = torch.where(own_key != INVALID_KEY, own_key.long(),
                               n_cells)
        win_row_v = cell_rows[own_cell]
    row = win_row_v.clamp(min=0).long()
    if rank_own is not None:
        k_own = lid
        flat = row * rank_own.shape[1] + lid.long()
        slot_v = rank_own.reshape(-1)[flat].to(torch.int32)
    else:
        k_own = device_constant(tables.k_own_lut, lid.device)[lid.long()]
        occ = (box >= 0).to(torch.int32)
        rank = torch.cumsum(occ, 1, dtype=torch.int32) - occ
        flat = row * box.shape[1] + k_own.clamp(min=0).long()
        slot_v = rank.reshape(-1)[flat]
    inv_valid = (valid & (win_row_v >= 0) & (k_own >= 0)
                 & (slot_v < min(cap1, cap2)))
    return {"win_row": win_row_v, "slot": slot_v, "valid": inv_valid}


def _derivable(tables, caps, names):
    """Whether every requested buffer is a run of the win2 buffer (odd and
    win1 prefixes, even the run from the window's odd count)."""
    if tables.single_scale:
        return True
    return (all(int(caps[n]) <= int(caps["win2"]) for n in names)
            and ("even" not in names
                 or int(caps["even"]) + tables.num_odd <= int(caps["win2"])))


def _window_rows(win_coords, win_valid, win_grid, keys, batch_size):
    """Row of the window of each key (-1: no such window): a dense table
    over the window grid with a batch size, else a search in the sorted
    window keys."""
    if batch_size is not None:
        table = build_dense_row_table(win_coords, win_valid, win_grid,
                                      batch_size)
        n = table.shape[0]
        ok = (keys >= 0) & (keys < n) & (keys != INVALID_KEY)
        return torch.where(ok, table[keys.long().clamp(0, n - 1)], -1)
    wkeys = linearize_coords(win_coords, win_grid, win_valid)
    sorted_keys, order = torch.sort(wkeys)
    pos = torch.searchsorted(sorted_keys, keys).clamp(max=len(wkeys) - 1)
    hit = (sorted_keys[pos] == keys) & (keys != INVALID_KEY)
    return torch.where(hit, order[pos].to(torch.int32), -1)


def _gather_candidates(win_coords, win_valid, coords, valid, win_grid,
                       win1_size, tables, caps, names, batch_size,
                       return_inverse):
    """The candidate-scatter gather (``mssvt_tpu/ops/window.py``'s path
    with ``MSSVT_PALLAS=off``): each voxel looks up the windows of its D
    candidate deltas and its table position in each (``pos_lut``); a
    (window, position) occupancy table and its exclusive scan along the
    table give each hit its fill rank, and each hit is written to its slot.
    Buffers that are runs of win2 are derived from it (with the inverse
    map); otherwise each buffer has its own scan over its eligible
    positions. Plain tensor ops: no Pallas kernel stands behind this path."""
    dev = coords.device
    ws = torch.tensor([int(s) for s in win1_size], device=dev)
    deltas = device_constant(tables.deltas, dev, torch.int64)
    d, k_total = deltas.shape[0], tables.offsets.shape[0]
    nw, v = win_coords.shape[0], coords.shape[0]
    vox_xyz = coords[:, [3, 2, 1]].long()
    cand_w = (torch.where(valid[:, None], vox_xyz, 0) // ws)[:, None, :] \
        + deltas[None]
    cand = torch.cat([coords[:, None, 0:1].long().expand(v, d, 1),
                      cand_w.flip(-1)], dim=-1)
    keys = linearize_coords(cand, win_grid, valid=valid[:, None])
    win_row = _window_rows(win_coords, win_valid, win_grid, keys, batch_size)
    rel = vox_xyz[:, None, :] - (cand_w * ws + ws // 2) \
        - device_constant(tables.off_min, dev, torch.int64)
    dims = torch.tensor(tables.pos_lut.shape, device=dev)
    in_box = ((rel >= 0) & (rel < dims)).all(dim=-1)
    rel = torch.minimum(rel.clamp(min=0), dims - 1)
    k = device_constant(tables.pos_lut, dev, torch.int64)[
        rel[..., 0], rel[..., 1], rel[..., 2]]
    ok = ((win_row >= 0) & in_box & (k >= 0) & valid[:, None]).reshape(-1)

    # one cell of the (NW, K) table a hit (a grid cell holds one voxel);
    # rejected candidates go to the spare cell nw * K
    win_flat = win_row.reshape(-1).long()
    k_flat = k.clamp(min=0).reshape(-1)
    spare = nw * k_total
    cell = torch.where(ok, win_flat * k_total + k_flat, spare)
    vox_rows = torch.arange(v, device=dev)[:, None].expand(v, d).reshape(-1)
    occ = torch.zeros(spare + 1, dtype=torch.int64, device=dev)
    occ[cell] = 1
    occ = occ[:spare].view(nw, k_total)
    elig = device_constant(tables.eligibility, dev)
    offs_packed = device_constant(pack_offsets5(tables.offsets), dev)

    def ranks(hits):  # exclusive scan along the table, read at each hit
        scan = torch.cumsum(hits, dim=1) - hits
        return scan.reshape(-1)[cell.clamp(max=spare - 1)]

    def place(keep, rank, cap):
        dest = torch.where(keep, win_flat * cap + rank, nw * cap)
        ind = torch.full((nw * cap + 1,), -1, dtype=torch.int32, device=dev)
        pos = torch.full((nw * cap + 1,), -1, dtype=torch.int64, device=dev)
        ind[dest] = vox_rows.to(torch.int32)
        pos[dest] = k_flat
        ind, pos = ind[:-1].view(nw, cap), pos[:-1].view(nw, cap)
        coordp = torch.where(ind >= 0, offs_packed[pos.clamp(min=0)],
                             PACK5_ZERO)
        return ind, coordp

    if not tables.single_scale and _derivable(tables, caps, names):
        cap2 = int(caps["win2"])
        rank = ranks(occ)
        ind2, coordp2 = place(ok & (rank < cap2), rank, cap2)
        cnt = [(occ * elig[None, :, c]).sum(dim=1) for c in (ODD, EVEN, WIN1)]
        out = _derive_from_win2(ind2, coordp2, *cnt, names, caps)
        if return_inverse:
            # a win1 hit's win2 rank is its win1 slot (win1 cells come first)
            cap1 = int(caps["win1"])
            keep = ok & elig[k_flat, WIN1] & (rank < min(cap1, cap2))
            inv = torch.full((v + 1,), -1, dtype=torch.int64, device=dev)
            inv[torch.where(keep, vox_rows, v)] = \
                win_flat * cap1 + rank.clamp(max=cap1 - 1)
            inv = inv[:v]
            out["inv_win1"] = {
                "win_row": torch.where(inv >= 0, inv // cap1, -1).to(torch.int32),
                "slot": torch.where(inv >= 0, inv % cap1, 0).to(torch.int32),
                "valid": inv >= 0}
        return out
    cols = {"odd": ODD, "even": EVEN, "win1": WIN1, "win2": WIN2}
    out = {}
    for name in names:
        col, cap = cols[name], int(caps[name])
        rank = ranks(occ * elig[None, :, col])
        ind, coordp = place(ok & elig[k_flat, col] & (rank < cap), rank, cap)
        out[name] = {"ind": ind, "coordp": coordp, "mask": ind < 0}
    return out


def neighbour_windows(win_coords, tables: QueryTables):
    """(NW, D, 4) (b, z, y, x) of each window's D candidate windows: the
    window's batch, its (z, y, x) plus each delta. The deltas are reversed
    to (dz, dy, dx) once and cached on the device, so the call copies
    nothing from the host (a list index would, and a CUDA graph cannot
    capture that copy)."""
    deltas = device_constant(tables.deltas[:, ::-1], win_coords.device,
                             win_coords.dtype)
    nw, d = win_coords.shape[0], deltas.shape[0]
    return torch.cat([win_coords[:, None, 0:1].expand(nw, d, 1),
                      win_coords[:, None, 1:4] + deltas[None]], dim=-1)


def gather_window_voxels(win_coords, win_valid, coords, valid, spatial_shape,
                         win1_size, tables: QueryTables, max_num_win1: int,
                         max_num_win2: Optional[int] = None,
                         max_num_odd: Optional[int] = None,
                         max_num_even: Optional[int] = None,
                         batch_size: Optional[int] = None,
                         buffers: Optional[Tuple[str, ...]] = None,
                         return_inverse: bool = False, num_valid=None,
                         voxel_win_row=None):
    """Per-window fixed-capacity buffers of voxel rows (``ind``, -1 empty),
    packed offsets from the window-centre voxel (``coordp``,
    :data:`PACK5_ZERO` empty) and ``mask`` (True = empty slot), for each
    requested buffer; plus ``inv_win1`` with ``return_inverse`` (on the
    candidate-scatter path only where the buffers derive from win2, as in
    JAX)."""
    wx, wy, wz = (int(s) for s in win1_size)
    x_max, y_max, z_max = (int(s) for s in spatial_shape)
    win_grid = (x_max // wx, y_max // wy, z_max // wz)
    if tables.single_scale:
        caps = {"win1": max_num_win1}
        names = ("win1",)
    else:
        caps = {"odd": tables.num_odd if max_num_odd is None else max_num_odd,
                "even": (tables.num_even if max_num_even is None
                         else max_num_even),
                "win1": max_num_win1, "win2": max_num_win2}
        names = tuple(buffers) if buffers is not None else (
            "odd", "even", "win1", "win2")
    if not _derivable(tables, caps, names) or batch_size is None \
            or tables.col_src is None:
        return _gather_candidates(win_coords, win_valid, coords, valid,
                                  win_grid, win1_size, tables, caps, names,
                                  batch_size, return_inverse)

    dev = coords.device
    cv = wx * wy * wz
    nw = win_coords.shape[0]
    v = coords.shape[0]
    gx, gy, gz = win_grid
    n_cells = batch_size * gx * gy * gz
    lid = ((coords[:, 3] % wx) * wy + (coords[:, 2] % wy)) * wz \
        + (coords[:, 1] % wz)
    vox = torch.arange(v, dtype=torch.int32, device=dev)
    own_key = inv_win_key = None
    if tables.single_scale and voxel_win_row is not None:
        # windows ARE the cells: scatter each voxel into its window's row
        row = torch.where(voxel_win_row >= 0, voxel_win_row, nw).long()
        box = torch.full(((nw + 1) * cv,), -1, dtype=torch.int32, device=dev)
        box[row * cv + lid.long()] = vox
        box = box.view(nw + 1, cv)[:nw]
    else:
        own_key = linearize_coords(_window_coords(coords, win1_size),
                                   win_grid, valid)
        inv_win_key = linearize_coords(win_coords, win_grid, win_valid)
        # row n_cells is never written (invalid neighbours read it); invalid
        # voxels go to the scratch row n_cells + 1
        row = torch.where(own_key != INVALID_KEY, own_key.long(), n_cells + 1)
        table = torch.full(((n_cells + 2) * cv,), -1, dtype=torch.int32,
                           device=dev)
        table[row * cv + lid.long()] = vox
        table = table.view(n_cells + 2, cv)
        nbr = neighbour_windows(win_coords, tables)
        d = nbr.shape[1]
        nbr_key = linearize_coords(nbr, win_grid, valid=win_valid[:, None])
        nbr_row = torch.where(nbr_key != INVALID_KEY, nbr_key.long(), n_cells)
        box = table[nbr_row].reshape(nw, d * cv)

    order = tables.inv_src
    if order is None:  # non-bijective: permute the box to table order
        box = box[:, device_constant(tables.col_src, dev, torch.int64)]
    offs_packed = pack_offsets5(tables.offsets)
    cap2 = int(caps["win1"] if tables.single_scale else caps["win2"])
    want_extras = order is not None and (not tables.single_scale
                                         or return_inverse)
    own_slab = (tables.d0 * cv, cv) if want_extras else None
    elig = None
    if want_extras and not tables.single_scale:
        elig = tables.eligibility[:, [ODD, EVEN, WIN1]].astype(
            np.float32)[np.asarray(order, np.int64)]
    outs = fill_kernel.fill_capacity_buffer(box, offs_packed, cap2, order=order,
                                own_slab=own_slab, elig=elig,
                                num_valid=num_valid)
    ind2, off2 = outs[0], outs[1]
    rank_own = outs[2] if want_extras else None

    def inverse(cap1):
        return _own_cell_inverse(inv_win_key, win_valid, own_key, lid, valid,
                                 tables, cap1, cap2, n_cells, rank_own, box,
                                 win_row_v=voxel_win_row)

    if tables.single_scale:
        out = {"win1": {"ind": ind2, "coordp": off2, "mask": ind2 < 0}}
        if return_inverse:
            out["inv_win1"] = inverse(int(caps["win1"]))
        return out
    if want_extras:
        cnt = outs[3]
    else:
        cnt = ((box >= 0).float() @ device_constant(
            tables.eligibility[:, [ODD, EVEN, WIN1]].astype(np.float32),
            dev)).to(torch.int32)
    out = _derive_from_win2(ind2, off2, cnt[:, 0], cnt[:, 1], cnt[:, 2],
                            names, caps)
    if return_inverse:
        out["inv_win1"] = inverse(int(caps["win1"]))
    return out
