"""K3: mixed-scale window attention with the K/Q assembly fused in.

Replaces ``fused_window_attention_assembled``
(``mssvt_tpu/ops/pallas_attention.py``), forward only. Per window, in the
compute dtype ``T`` (bf16 for ``mssvt.yaml``, f32 for the f32 configs):

- k1 = the ``fps1`` picks from ``win1_fea`` (a zero row where ``k_mask1``
  is set or the pick is out of range); with ``pad_row`` the masked picks
  carry the window's ``pad_row`` instead;
- pos(rel) = relu(rx*w0 + ry*w1 + rz*w2 + pos_base), each op rounded to T;
- k = concat(k1, k2_fea) + pos(k_rel); q = win1_fea[:, :nq] * q_keep (or
  ``q_ext`` * q_keep) + pos(q_rel);
- block-diagonal q/k/v projections (f32 accumulation, + bias, rounded to T);
- per head: scores against its own group's key stripe, * scale + key_bias,
  softmax in f32 (max-subtracted, denominator + 1e-30), weights rounded to
  T, value product in f32;
- output projection (f32 accumulation + bias) in the output dtype.

Windows at or past ``num_valid`` return zeros. Callers apply their query
mask afterwards, as the JAX module does.

CUDA tensors go to ``csrc/attention.cu``; CPU tensors to
:func:`attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

launches = 0
MAX_GROUPS = 4


def _assemble(win1, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
              pos_base, pos_w, pad_row, nq, q_prefix, t):
    n1cap = win1.shape[1]
    pick_ok = (~k_mask1) & (fps1 >= 0) & (fps1 < n1cap)
    take = torch.take_along_dim(
        win1, fps1.clamp(0, n1cap - 1).long()[..., None], dim=1)
    k1 = torch.where(pick_ok[..., None], take, torch.zeros((), dtype=t,
                                                           device=win1.device))
    if pad_row is not None:
        k1 = torch.where(k_mask1[..., None], pad_row.to(t)[:, None, :], k1)
    w0, w1, w2 = (pos_w.to(t)[i] for i in range(3))
    base = pos_base.to(t)[:, None, :]

    def pos(rel):
        rx, ry, rz = (r.to(t)[..., None] for r in rel)
        return torch.relu(rx * w0 + ry * w1 + rz * w2 + base)

    k3 = torch.cat([k1, k2_fea.to(t)], dim=1) + pos(k_rel)
    q_raw = win1[:, :nq] if q_prefix else q_ext.to(t)
    q3 = q_raw * q_keep.to(t)[..., None] + pos(q_rel)
    return q3, k3


def attention_plain(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel,
                    q_rel, pos_base, pos_w, proj, key_bias, num_heads, scale,
                    q_prefix, nq=0, pad_row=None, num_valid=None,
                    compute_dtype=None):
    """Plain PyTorch version (same contract as :func:`fused_window_attention_assembled`)."""
    t = compute_dtype or win1_fea.dtype
    nw, _, d = win1_fea.shape
    nq = int(nq) if q_prefix else q_ext.shape[1]
    q3, k3 = _assemble(win1_fea.to(t), k2_fea, fps1, k_mask1, q_ext, q_keep,
                       k_rel, q_rel, pos_base, pos_w, pad_row, nq, q_prefix, t)
    wq, bq, wk, bk, wv, bv, wp, bp = (p.to(t).float() for p in proj)
    q = (q3.float() @ wq + bq).to(t).float()
    k = (k3.float() @ wk + bk).to(t).float()
    v = (k3.float() @ wv + bv).to(t).float()
    groups = len(num_heads)
    ph = d // sum(num_heads)
    nk = k3.shape[1] // groups
    bias = key_bias.float()
    outs = []
    h = 0
    for g, heads in enumerate(num_heads):
        ks = slice(g * nk, (g + 1) * nk)
        for _ in range(heads):
            cs = slice(h * ph, (h + 1) * ph)
            s = q[:, :, cs] @ k[:, ks, cs].transpose(1, 2)
            s = s * scale + bias[:, None, ks]
            e = torch.exp(s - s.amax(dim=2, keepdim=True))
            a = e / (e.sum(dim=2, keepdim=True) + 1e-30)
            outs.append(a.to(t).float() @ v[:, ks, cs])
            h += 1
    o = torch.cat(outs, dim=2).to(t).float()
    out = (o @ wp + bp).to(win1_fea.dtype)
    if num_valid is not None:
        live = torch.arange(nw, device=out.device) < num_valid
        out = torch.where(live[:, None, None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def fused_window_attention_assembled(
        win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
        pos_base, pos_w, proj, key_bias, num_heads, scale, q_prefix, nq=0,
        pad_row=None, num_valid=None, compute_dtype=None):
    """(NW, nq, D) window attention from the raw gather products."""
    global launches
    if win1_fea.device.type == "cpu":
        return attention_plain(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep,
                               k_rel, q_rel, pos_base, pos_w, proj, key_bias,
                               num_heads, scale, q_prefix, nq, pad_row,
                               num_valid, compute_dtype)
    t = compute_dtype or win1_fea.dtype
    if t not in (torch.bfloat16, torch.float32) or win1_fea.dtype != t:
        raise TypeError("attention kernel: win1_fea and compute dtype must "
                        "both be bfloat16 or both float32")
    dev = win1_fea.device
    nw, n1cap, d = win1_fea.shape
    nk1 = fps1.shape[1]
    nk2 = k2_fea.shape[1]
    nk_tot = nk1 + nk2
    nq = int(nq) if q_prefix else q_ext.shape[1]
    groups = len(num_heads)
    if (groups > MAX_GROUPS or d % 32 or d > 256 or d % sum(num_heads)
            or nk_tot % groups or nq < 1):
        raise ValueError(f"attention kernel: unsupported layout d={d} "
                         f"heads={num_heads} nk={nk_tot} nq={nq}")
    req = _lib.require
    req(win1_fea, "win1_fea", t, (nw, n1cap, d), dev)
    req(k2_fea, "k2_fea", t, (nw, nk2, d), dev)
    req(fps1, "fps1", torch.int32, (nw, nk1), dev)
    req(k_mask1, "k_mask1", torch.bool, (nw, nk1), dev)
    if not q_prefix:
        req(q_ext, "q_ext", t, (nw, nq, d), dev)
    req(q_keep, "q_keep", torch.float32, (nw, nq), dev)
    for r in k_rel:
        req(r, "k_rel", torch.float32, (nw, nk_tot), dev)
    for r in q_rel:
        req(r, "q_rel", torch.float32, (nw, nq), dev)
    req(pos_base, "pos_base", t, (nw, d), dev)
    req(pos_w, "pos_w", t, (3, d), dev)
    for i, p in enumerate(proj):
        req(p, f"proj[{i}]", t, (d, d) if i % 2 == 0 else (d,), dev)
    req(key_bias, "key_bias", torch.float32, (nw, nk_tot), dev)
    if pad_row is not None:
        req(pad_row, "pad_row", t, (nw, d), dev)
    nv = None
    if num_valid is not None:
        nv = torch.as_tensor(num_valid, device=dev).to(torch.int32).reshape(1)
    out = torch.empty((nw, nq, d), dtype=t, device=dev)
    wq, bq, wk, bk, wv, bv, wp, bp = proj
    ptrs = _lib.ptr_array([
        win1_fea, k2_fea, fps1, k_mask1, None if q_prefix else q_ext, q_keep,
        *k_rel, *q_rel, pos_base, pos_w, wq, wk, wv, wp, bq, bk, bv, bp,
        key_bias, pad_row, nv, out])
    heads = list(num_heads) + [0] * (MAX_GROUPS - groups)
    dims = (ctypes.c_int * 12)(nw, n1cap, nk1, nk2, nq, d, groups,
                               int(bool(q_prefix)), *heads)
    err = _lib.lib().mssvt_attention(ptrs, dims, float(scale),
                                     int(t == torch.bfloat16),
                                     _lib.stream_ptr(win1_fea))
    _lib.check(err, "mssvt_attention")
    launches += 1
    return out
