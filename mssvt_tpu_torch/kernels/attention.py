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

CUDA tensors go to ``csrc/attention.cu`` (which also gets the four weights
transposed: its tensor-core path reads them as [output][input] channel);
CPU tensors to
:func:`attention_plain`. The module also holds :func:`attention_bwd_plain`,
the plain version of K5, the backward (``kernels/attention_bwd.py``), and
the two per-window cores on assembled tokens that those share with the plain
versions of K6/K7 (``kernels/attention_qk.py``, ``attention_qk_bwd.py``):
:func:`attention_core_plain` and :func:`attention_core_bwd_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

launches = 0
MAX_GROUPS = 4


def _assemble(win1, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
              pos_base, pos_w, pad_row, nq, q_prefix, t):
    """(q3, k3, zq, zk): assembled tokens and the pre-relu position
    activations (the backward's relu masks), all in ``t``."""
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

    def pre(rel):
        rx, ry, rz = (r.to(t)[..., None] for r in rel)
        return rx * w0 + ry * w1 + rz * w2 + base

    zk, zq = pre(k_rel), pre(q_rel)
    k3 = torch.cat([k1, k2_fea.to(t)], dim=1) + torch.relu(zk)
    q_raw = win1[:, :nq] if q_prefix else q_ext.to(t)
    q3 = q_raw * q_keep.to(t)[..., None] + torch.relu(zq)
    return q3, k3, zq, zk


def attention_core_plain(q3, k3, proj, key_bias, num_heads, scale, t,
                         out_dtype):
    """The per-window attention from assembled tokens ``q3`` (NW, nq, D) and
    ``k3`` (NW, nk_tot, D) in the compute dtype ``t``: block-diagonal
    projections rounded to ``t``, per-head softmax in f32 over the head
    group's own key stripe, weights rounded to ``t``, output projection.
    Shared by the plain versions of K3 and K6."""
    d = q3.shape[2]
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
    return (o @ wp + bp).to(out_dtype)


def attention_core_bwd_plain(q3, k3, proj, key_bias, gf, num_heads, scale, t):
    """The backward of :func:`attention_core_plain` for the output cotangent
    ``gf`` (f32 values already rounded to ``t``), step by step as JAX's
    ``_bwd_qstk_core`` / ``_finish_bwd`` (``mssvt_tpu/ops/pallas_attention.py``):
    ``dO``, ``dS`` and ``dQ/dK/dV`` before the raw-token products are rounded
    to ``t``; the bias cotangents sum the unrounded f32 ``dQ/dK/dV`` and
    ``gf``. Returns ``(dq3, dk3, dproj)``: the raw tokens' cotangents in f32
    (callers round them) and ``dproj = (dwq, dbq, ..., dwp, dbp)`` in f32
    (full (D, D) weight cotangents). Shared by the plain versions of K5 and
    K7."""
    d = q3.shape[2]
    wq, bq, wk, bk, wv, bv, wp, bp = (p.to(t).float() for p in proj)
    q = (q3.float() @ wq + bq).to(t).float()
    k = (k3.float() @ wk + bk).to(t).float()
    v = (k3.float() @ wv + bv).to(t).float()
    groups = len(num_heads)
    ph = d // sum(num_heads)
    nk = k3.shape[1] // groups
    bias = key_bias.float()
    do1 = (gf @ wp.t()).to(t).float()
    o1 = torch.zeros_like(gf)
    dq = torch.zeros_like(gf)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(k)
    h = 0
    for gi, heads in enumerate(num_heads):
        ks = slice(gi * nk, (gi + 1) * nk)
        for _ in range(heads):
            cs = slice(h * ph, (h + 1) * ph)
            s = q[:, :, cs] @ k[:, ks, cs].transpose(1, 2) * scale \
                + bias[:, None, ks]
            e = torch.exp(s - s.amax(dim=2, keepdim=True))
            a = e / (e.sum(dim=2, keepdim=True) + 1e-30)
            ab = a.to(t).float()
            o1[:, :, cs] = ab @ v[:, ks, cs]
            da = do1[:, :, cs] @ v[:, ks, cs].transpose(1, 2)
            dv[:, ks, cs] = ab.transpose(1, 2) @ do1[:, :, cs]
            rs = (da * a).sum(dim=2, keepdim=True)
            ds = (a * (da - rs) * scale).to(t).float()
            dq[:, :, cs] = ds @ k[:, ks, cs]
            dk[:, ks, cs] = ds.transpose(1, 2) @ q[:, :, cs]
            h += 1
    dq_pb, dk_pb, dv_pb = (x.to(t).float() for x in (dq, dk, dv))

    def wgrad(x, dy):  # sum over windows and tokens of x^T dy, f32
        return x.float().reshape(-1, d).t() @ dy.reshape(-1, d)

    dproj = (wgrad(q3, dq_pb), dq.sum(dim=(0, 1)),
             wgrad(k3, dk_pb), dk.sum(dim=(0, 1)),
             wgrad(k3, dv_pb), dv.sum(dim=(0, 1)),
             wgrad(o1.to(t), gf), gf.sum(dim=(0, 1)))
    dq3 = dq_pb @ wq.t()
    dk3 = dk_pb @ wk.t() + dv_pb @ wv.t()
    return dq3, dk3, dproj


def attention_plain(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel,
                    q_rel, pos_base, pos_w, proj, key_bias, num_heads, scale,
                    q_prefix, nq=0, pad_row=None, num_valid=None,
                    compute_dtype=None):
    """Plain PyTorch version (same contract as :func:`fused_window_attention_assembled`)."""
    t = compute_dtype or win1_fea.dtype
    nw = win1_fea.shape[0]
    nq = int(nq) if q_prefix else q_ext.shape[1]
    q3, k3, _, _ = _assemble(win1_fea.to(t), k2_fea, fps1, k_mask1, q_ext,
                             q_keep, k_rel, q_rel, pos_base, pos_w, pad_row,
                             nq, q_prefix, t)
    out = attention_core_plain(q3, k3, proj, key_bias, num_heads, scale, t,
                               win1_fea.dtype)
    if num_valid is not None:
        live = torch.arange(nw, device=out.device) < num_valid
        out = torch.where(live[:, None, None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def attention_bwd_plain(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep,
                        k_rel, q_rel, pos_base, pos_w, proj, key_bias, g,
                        num_heads, scale, q_prefix, nq=0, pad_row=None,
                        num_valid=None, compute_dtype=None):
    """Plain PyTorch version of K5, the backward of
    :func:`fused_window_attention_assembled` for the output cotangent ``g``
    (NW, nq, D). It repeats the JAX backward step by step
    (``_attn_assembled_bwd_body`` and ``_bwd_qstk_core`` in
    ``mssvt_tpu/ops/pallas_attention.py``), rounding to the compute dtype
    where that does, rather than differentiating :func:`attention_plain`.

    Returns ``(dwin1, dk2, dq_ext, dpad_row, dpos_base, dpos_w, dproj)`` with
    ``dproj = (dwq, dbq, dwk, dbk, dwv, dbv, dwp, dbp)`` (full (D, D) weight
    cotangents, summed in f32); ``dq_ext`` is None when ``q_prefix``. Each
    cotangent has its primal's dtype. Windows at or past ``num_valid`` get
    zero cotangents and add nothing to the sums."""
    t = compute_dtype or win1_fea.dtype
    f32 = torch.float32
    nw, n1cap, _ = win1_fea.shape
    nk1 = fps1.shape[1]
    nq = int(nq) if q_prefix else q_ext.shape[1]
    q3, k3, zq, zk = _assemble(win1_fea.to(t), k2_fea, fps1, k_mask1, q_ext,
                               q_keep, k_rel, q_rel, pos_base, pos_w, pad_row,
                               nq, q_prefix, t)
    gf = g.to(t).float()
    if num_valid is not None:
        live = torch.arange(nw, device=g.device) < num_valid
        gf = gf * live[:, None, None].to(f32)
    dq3, dk3, dproj = attention_core_bwd_plain(q3, k3, proj, key_bias, gf,
                                               num_heads, scale, t)
    dq3, dk3 = dq3.to(t), dk3.to(t)
    zero = torch.zeros((), dtype=t, device=g.device)
    dzk = torch.where(zk.float() > 0, dk3, zero).float()
    dzq = torch.where(zq.float() > 0, dq3, zero).float()
    dbase = dzk.sum(dim=1) + dzq.sum(dim=1)
    dposw = torch.stack([
        (rk.to(t).float()[:, None, :] @ dzk)[:, 0].sum(dim=0)
        + (rq.to(t).float()[:, None, :] @ dzq)[:, 0].sum(dim=0)
        for rk, rq in zip(k_rel, q_rel)])
    dk1 = dk3[:, :nk1].float()
    slot = torch.arange(n1cap, device=g.device)
    oh = ((fps1[:, :, None] == slot) & ~k_mask1[:, :, None]).to(f32)
    dwin1 = oh.transpose(1, 2) @ dk1
    dpad = None
    if pad_row is not None:
        dpad = (k_mask1[:, :, None].to(f32) * dk1).sum(dim=1).to(pad_row.dtype)
    dq_raw = (dq3 * q_keep.to(t)[..., None]).float()
    dqext = None
    if q_prefix:
        dwin1[:, :nq] += dq_raw
    else:
        dqext = dq_raw.to(q_ext.dtype)
    dproj = tuple(dp.to(p.dtype) for dp, p in zip(dproj, proj))
    return (dwin1.to(win1_fea.dtype), dk3[:, nk1:].to(k2_fea.dtype), dqext,
            dpad, dbase.to(pos_base.dtype), dposw.to(pos_w.dtype), dproj)


def kernel_inputs(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel,
                  q_rel, pos_base, pos_w, proj, key_bias, num_heads, q_prefix,
                  nq, pad_row, num_valid, compute_dtype, name):
    """Checks what the assembled-attention kernels (K3 and its backward K5)
    take and raises on the rest; returns (compute dtype, nq, the 25 input
    tensors in the order the C entries read them, the 12 layout dims). The
    projections may come in any float dtype; the kernels read them rounded
    to the compute dtype, as JAX's kernels do."""
    t = compute_dtype or win1_fea.dtype
    if t not in (torch.bfloat16, torch.float32) or win1_fea.dtype != t:
        raise TypeError(f"{name} kernel: win1_fea and compute dtype must "
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
        raise ValueError(f"{name} kernel: unsupported layout d={d} "
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
    proj = tuple(p.to(t).contiguous() for p in proj)  # any float dtype
    for i, p in enumerate(proj):
        req(p, f"proj[{i}]", t, (d, d) if i % 2 == 0 else (d,), dev)
    req(key_bias, "key_bias", torch.float32, (nw, nk_tot), dev)
    if pad_row is not None:
        req(pad_row, "pad_row", t, (nw, d), dev)
    nv = None
    if num_valid is not None:
        nv = torch.as_tensor(num_valid, device=dev).to(torch.int32).reshape(1)
    wq, bq, wk, bk, wv, bv, wp, bp = proj
    tensors = [win1_fea, k2_fea, fps1, k_mask1, None if q_prefix else q_ext,
               q_keep, *k_rel, *q_rel, pos_base, pos_w, wq, wk, wv, wp, bq, bk,
               bv, bp, key_bias, pad_row, nv]
    dims = [nw, n1cap, nk1, nk2, nq, d, groups, int(bool(q_prefix))]
    dims += list(num_heads) + [0] * (MAX_GROUPS - groups)
    return t, nq, tensors, dims


def kernel_plan(n1cap, nk1, nk2, nq, d, num_heads, bf16=True,
                entry="mssvt_attention_plan"):
    """(shared-memory bytes, CTAs per SM, registers a thread) of K3's
    kernel (or, by ``entry``, K5's per-window kernel) at a layout."""
    heads = list(num_heads) + [0] * (MAX_GROUPS - len(num_heads))
    return _lib.kernel_plan(
        entry, [0, n1cap, nk1, nk2, nq, d, len(num_heads), 1, *heads], bf16)


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
    t, nq, tensors, dims = kernel_inputs(
        win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
        pos_base, pos_w, proj, key_bias, num_heads, q_prefix, nq, pad_row,
        num_valid, compute_dtype, "attention")
    nw, _, d = win1_fea.shape
    out = torch.empty((nw, nq, d), dtype=t, device=win1_fea.device)
    err = _lib.lib().mssvt_attention(
        _lib.ptr_array(tensors + [out] + _lib.transposed(tensors[14:18])),
        (ctypes.c_int * len(dims))(*dims), float(scale),
        int(t == torch.bfloat16), _lib.stream_ptr(win1_fea))
    _lib.check(err, "mssvt_attention")
    launches += 1
    return out
