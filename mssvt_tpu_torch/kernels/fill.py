"""K1: per-window capacity fill of the gather box table.

Replaces ``fill_capacity_buffer`` (``mssvt_tpu/ops/pallas_fill.py``). For
each window row of the (NW, K) box table (voxel row per gather cell, -1
empty, columns in the source layout whose column s holds table position
``order[s]``), hit number r in table order (nearest first) lands in slot r
of the (NW, cap) outputs: the voxel row and the packed offset of its table
position. Hits past ``cap`` are dropped. With ``own_slab=(s0, cv)`` it also
returns the exclusive table-order rank of source columns [s0, s0+cv) (the
window's own cells) and, with ``elig``, the per-buffer hit counts (NW, 8).
Rows at or past ``num_valid`` return -1 / PACK5_ZERO / 0.

CUDA tensors go to ``csrc/fill.cu``; CPU tensors to :func:`fill_plain`. The
kernel's persistent CTAs copy the static per-position table (source column,
packed offset, eligibility lane masks; :func:`kernel_table`, built once per
table and device) into shared memory, stage each live row whole with
16-byte ``cp.async`` into a two-row ring per warp, scan it from shared
memory and write every output row whole, 16 bytes a lane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant
from . import _lib

# 5-bit-biased pack of offset (0, 0, 0): the offset buffers' padding value
PACK5_ZERO = (16 << 10) | (16 << 5) | 16

launches = 0


def _table_consts(k, offs_packed, order, elig):
    """Per-table-position constants: source column, packed offset, and the
    eligibility bits of that column (bit e = buffer e)."""
    src_of = (np.arange(k, dtype=np.int64) if order is None
              else np.argsort(np.asarray(order, np.int64)))
    offs_t = np.asarray(offs_packed, np.int32)
    bits = np.zeros(k, np.int64)
    if elig is not None:
        e = np.asarray(elig) != 0
        for j in range(e.shape[1]):
            bits |= e[src_of, j].astype(np.int64) << j
    return src_of, offs_t, bits.astype(np.int32)


def fill_plain(box, offs_packed, cap, order=None, own_slab=None, elig=None,
               num_valid=None):
    """Plain PyTorch version (same contract as :func:`fill_capacity_buffer`)."""
    nw, k = box.shape
    dev = box.device
    src_of, offs_t, _ = _table_consts(k, offs_packed, order, None)
    box_t = box[:, device_constant(src_of, dev)] if order is not None else box
    occ = box_t >= 0
    occi = occ.to(torch.int32)
    rank = torch.cumsum(occi, 1, dtype=torch.int32) - occi
    keep = occ & (rank < cap)
    rows = torch.arange(nw, device=dev)[:, None]
    dest = torch.where(keep, rows * cap + rank, nw * cap).reshape(-1)
    vox = torch.full((nw * cap + 1,), -1, dtype=torch.int32, device=dev)
    vox[dest] = box_t.reshape(-1)
    off = torch.full((nw * cap + 1,), PACK5_ZERO, dtype=torch.int32,
                     device=dev)
    off[dest] = device_constant(offs_t, dev).expand(nw, k).reshape(-1)
    outs = [vox[:nw * cap].view(nw, cap), off[:nw * cap].view(nw, cap)]
    if own_slab is not None:
        s0, cv = (int(v) for v in own_slab)
        rank_src = (rank[:, device_constant(np.asarray(order, np.int64), dev)]
                    if order is not None else rank)
        outs.append(rank_src[:, s0:s0 + cv].contiguous())
        cnt = torch.zeros((nw, 8), dtype=torch.int32, device=dev)
        if elig is not None:
            occ_src = box >= 0
            e = device_constant(np.asarray(elig) != 0, dev)
            for j in range(e.shape[1]):
                cnt[:, j] = (occ_src & e[None, :, j]).sum(1, dtype=torch.int32)
        outs.append(cnt)
    if num_valid is not None:
        live = (torch.arange(nw, device=dev) < num_valid)[:, None]
        empty = [-1, PACK5_ZERO, 0, 0]
        outs = [torch.where(live, o, e) for o, e in zip(outs, empty)]
    return tuple(outs)


_TABLES = {}


def _content(values, dtype):
    a = np.ascontiguousarray(np.asarray(values, dtype))
    return a.shape, a.tobytes()


def kernel_table(k, offs_packed, order, elig, device):
    """(table, ne): the kernel's per-position constants as one int32 device
    tensor, K source columns, K packed offsets, then per chunk of 32 table
    positions 8 lane masks (bit l of mask e: position chunk * 32 + l is
    eligible for buffer e), and ne, the number of eligibility columns. The
    tables are fixed per block, so each is built and uploaded once per
    (K, offsets, order, eligibility, device)."""
    key = (k, _content(offs_packed, np.int32),
           None if order is None else _content(order, np.int64),
           None if elig is None else _content(np.asarray(elig) != 0, bool),
           str(device))
    hit = _TABLES.get(key)
    if hit is not None:
        return hit
    src_of, offs_t, _ = _table_consts(k, offs_packed, order, None)
    chunks = (k + 31) // 32
    masks = np.zeros((chunks, 8), np.uint64)
    ne = 0
    if elig is not None:
        e = np.asarray(elig) != 0
        ne = e.shape[1]
        et = np.zeros((chunks * 32, ne), np.uint64)
        et[:k] = e[src_of]
        lanes = np.uint64(1) << np.arange(32, dtype=np.uint64)
        masks[:, :ne] = (et.reshape(chunks, 32, ne) * lanes[None, :, None]).sum(1)
    tab = np.concatenate([src_of.astype(np.int32), offs_t.astype(np.int32),
                          masks.astype(np.uint32).reshape(-1).view(np.int32)])
    hit = (torch.as_tensor(tab).to(device), ne)
    _TABLES[key] = hit
    return hit


def kernel_plan(k, cap, cv=0):
    """(shared-memory bytes of one CTA, CTAs an SM, registers a thread,
    warps a CTA) of the kernel for a table of K entries a row, from the CUDA
    occupancy API and the kernel's attributes."""
    out = (_lib.CI * 4)()
    _lib.check(_lib.lib().mssvt_fill_plan(int(k), int(cap), int(cv), out),
               "mssvt_fill_plan")
    return tuple(out)


def fill_capacity_buffer(box, offs_packed, cap, order=None, own_slab=None,
                         elig=None, num_valid=None):
    """Nearest-first capacity fill. Returns (vox (NW, cap) int32 -1 padded,
    off (NW, cap) int32 PACK5_ZERO padded[, rank_own (NW, cv), cnt (NW, 8)])."""
    global launches
    if box.device.type == "cpu":
        return fill_plain(box, offs_packed, cap, order, own_slab, elig,
                          num_valid)
    nw, k = box.shape
    dev = box.device
    _lib.require(box, "box", torch.int32)
    if len(offs_packed) != k or (order is not None and len(order) != k):
        raise ValueError("offs_packed/order must have one entry per column")
    if elig is not None and np.asarray(elig).shape[1] > 8:
        raise ValueError("at most 8 eligibility columns")
    tab, ne = kernel_table(k, offs_packed, order, elig, dev)
    nv = None
    if num_valid is not None:
        nv = _lib.require(torch.as_tensor(num_valid, device=dev)
                          .to(torch.int32).reshape(1), "num_valid",
                          device=dev)
    vox = torch.empty((nw, cap), dtype=torch.int32, device=dev)
    off = torch.empty((nw, cap), dtype=torch.int32, device=dev)
    rank_own = cnt = None
    s0 = cv = 0
    if own_slab is not None:
        s0, cv = (int(v) for v in own_slab)
        if not 0 <= s0 <= s0 + cv <= k:
            raise ValueError("own_slab outside the table")
        rank_own = torch.empty((nw, cv), dtype=torch.int32, device=dev)
        cnt = torch.empty((nw, 8), dtype=torch.int32, device=dev)
    err = _lib.lib().mssvt_fill(
        box.data_ptr(), nw, k, int(cap), tab.data_ptr(), ne, s0, cv,
        _lib.ptr(nv), vox.data_ptr(), off.data_ptr(), _lib.ptr(rank_own),
        _lib.ptr(cnt), _lib.stream_ptr(box))
    _lib.check(err, "mssvt_fill")
    launches += 1
    if own_slab is None:
        return vox, off
    return vox, off, rank_own, cnt
