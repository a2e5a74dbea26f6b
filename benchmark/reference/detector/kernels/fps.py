"""K2's plain version (frozen copy of ``fps_plain``): farthest-point
sampling over coordinate planes."""

from __future__ import annotations

import torch


MAX_N = 256            # a group of lanes a row (K2, K2b)
MAX_N_BLOCK = 16384    # one CTA per row (K2c)
MAX_PLANES = 8


def _dead_rows(b, num_valid, nw_half, device):
    r = torch.arange(b, device=device)
    if nw_half:
        r = torch.where(r < nw_half, r, r - nw_half)
    return r >= num_valid


def fps_plain(x, y, z, aux, npoint: int, num_valid=None, nw_half: int = 0):
    """Plain PyTorch version (same contract as :func:`fps_select`)."""
    planes = [p.float() for p in (x, y, z, *aux)]
    x, y, z = planes[:3]
    b, _ = x.shape
    min_dist = torch.full_like(x, 1e10)
    last = torch.zeros((b, 1), dtype=torch.long, device=x.device)
    picks = []
    for i in range(npoint):
        picks.append(last)
        if i == npoint - 1:
            break
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        min_dist = torch.minimum(min_dist, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(min_dist, dim=1, keepdim=True)
    idx = torch.cat(picks, dim=1)
    sels = [p.gather(1, idx) for p in planes]
    idx = idx.to(torch.int32)
    if num_valid is not None:
        dead = _dead_rows(b, num_valid, nw_half, x.device)[:, None]
        idx = torch.where(dead, 0, idx)
        sels = [torch.where(dead, 0.0, s) for s in sels]
    return idx, tuple(sels)



def fps_select(x, y, z, aux, npoint: int, num_valid=None, nw_half: int = 0):
    """FPS picks and the selected plane values, always the plain version."""
    return fps_plain(x, y, z, aux, npoint, num_valid, nw_half)


def fps_picks(x, y, z, npoint: int):
    """Selection-free FPS, always the plain version."""
    return fps_plain(x, y, z, (), npoint)[0]
