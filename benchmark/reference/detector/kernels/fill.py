"""K1's plain version (frozen copy of ``fill_plain``): the per-window
capacity fill of the gather box table, nearest table position first."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant

# 5-bit-biased pack of offset (0, 0, 0): the offset buffers' padding value
PACK5_ZERO = (16 << 10) | (16 << 5) | 16



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



def fill_capacity_buffer(box, offs_packed, cap, order=None, own_slab=None,
                         elig=None, num_valid=None):
    """Nearest-first capacity fill, always the plain version."""
    return fill_plain(box, offs_packed, cap, order, own_slab, elig,
                      num_valid)
