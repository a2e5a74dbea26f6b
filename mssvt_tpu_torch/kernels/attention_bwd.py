"""K5: the backward of the assembled window attention (K3), and the autograd
Function that pairs the two.

Replaces ``_asm_attn_bwd_impl`` (``mssvt_tpu/ops/pallas_attention.py``,
kernel ``_attn_assembled_bwd_kernel`` -> ``_attn_assembled_bwd_body`` /
``_bwd_qstk_core``), the backward of the custom VJP ``_asm_attn_train``.
It recomputes the assembly and the attention from the saved inputs and
returns the cotangents of ``win1_fea``, ``k2_fea``, ``q_ext``, ``pad_row``,
``pos_base``, ``pos_w`` and the eight projection tensors; masks, picks, rel
planes, ``q_keep``, ``key_bias`` and ``num_valid`` get none (they derive
from integer voxel coordinates in the MsSVT block).

CUDA tensors go to ``csrc/attention_bwd.cu`` (three launches that count as
one: the per-window backward, a split-K weight-gradient product, a fixed
order sum of the partials); CPU tensors to
:func:`~mssvt_tpu_torch.kernels.attention.attention_bwd_plain`. The cross
window sums (dW, db, dpos_w) take no float atomics, so a repeated call
gives bit-identical results.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from . import _lib, work
from . import attention

launches = 0
# Fixed reduction layout (independent of the card, so sums repeat exactly):
# per-window CTAs walk windows w = b, b + NCTA, ...; the weight product
# splits its token range into NSPLIT slices.
NCTA = 1024
NSPLIT = 32


def kernel_plan(n1cap, nk1, nk2, nq, d, num_heads, bf16=True):
    """(shared-memory bytes, CTAs per SM, registers a thread) of K5's
    per-window kernel."""
    return attention.kernel_plan(n1cap, nk1, nk2, nq, d, num_heads, bf16,
                                 "mssvt_attention_bwd_plan")


@work.counted("attention_bwd", work.attention_bwd)
def fused_window_attention_assembled_bwd(
        win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
        pos_base, pos_w, proj, key_bias, g, num_heads, scale, q_prefix, nq=0,
        pad_row=None, num_valid=None, compute_dtype=None):
    """Cotangents ``(dwin1, dk2, dq_ext, dpad_row, dpos_base, dpos_w,
    dproj)`` of :func:`attention.fused_window_attention_assembled` for the
    output cotangent ``g`` (same contract as ``attention_bwd_plain``)."""
    args = (win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
            pos_base, pos_w, proj, key_bias, g, num_heads, scale, q_prefix,
            nq, pad_row, num_valid, compute_dtype)
    if win1_fea.device.type == "cpu":
        return attention.attention_bwd_plain(*args)
    return _launch(*args)[0]


def _launch(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
            pos_base, pos_w, proj, key_bias, g, num_heads, scale, q_prefix,
            nq, pad_row, num_valid, compute_dtype):
    """Launches K5 on CUDA tensors; returns (the cotangents, ``os``). ``os``
    (NW, nq, D) is the rounded attention output that the backward recomputed,
    the operand of the out-projection's weight product (rows of windows at or
    past ``num_valid`` are not written)."""
    global launches
    nw, n1cap, d = win1_fea.shape
    # The kernel reads a pad row and a live-window count. Without a pad row
    # the masked picks are zero rows, which a zero pad row gives exactly
    # (its cotangent is dropped); without num_valid every window is live.
    no_pad = pad_row is None
    if no_pad:
        pad_row = torch.zeros((nw, d), dtype=compute_dtype or win1_fea.dtype,
                              device=win1_fea.device)
    if num_valid is None:
        num_valid = nw
    t, nq, tensors, dims = attention.kernel_inputs(
        win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
        pos_base, pos_w, proj, key_bias, num_heads, q_prefix, nq, pad_row,
        num_valid, compute_dtype, "attention_bwd")
    dev = win1_fea.device
    nk2 = k2_fea.shape[1]
    nk_tot = fps1.shape[1] + nk2
    _lib.require(g, "g", t, (nw, nq, d), dev)

    def empty(*shape, dtype=t):
        return torch.empty(shape, dtype=dtype, device=dev)

    dwin1, dk2, dpad, dbase = (empty(nw, n1cap, d), empty(nw, nk2, d),
                               empty(nw, d), empty(nw, d))
    dqext = None if q_prefix else empty(nw, nq, d)
    # weight-product operands: per live window its q/k tokens, the rounded
    # projected cotangents and the rounded attention output
    xq, xk, dqs, dks, dvs, os_ = (empty(nw, nq, d), empty(nw, nk_tot, d),
                                  empty(nw, nq, d), empty(nw, nk_tot, d),
                                  empty(nw, nk_tot, d), empty(nw, nq, d))
    ncta = min(nw, NCTA)
    wpart = empty(4, NSPLIT, d, d, dtype=torch.float32)
    cpart = empty(max(ncta, 1), 7, d, dtype=torch.float32)
    dw = empty(4, d, d, dtype=torch.float32)
    db = empty(4, d, dtype=torch.float32)
    dposw = empty(3, d, dtype=torch.float32)
    wts = _lib.transposed(tensors[14:17])
    ptrs = _lib.ptr_array(tensors + [
        g, dwin1, dk2, dqext, dpad, dbase,
        xq, xk, dqs, dks, dvs, os_, wpart, cpart, dw, db, dposw, *wts])
    dims = (ctypes.c_int * (len(dims) + 2))(*dims, NSPLIT, ncta)
    err = _lib.lib().mssvt_attention_bwd(ptrs, dims, float(scale),
                                         int(t == torch.bfloat16),
                                         _lib.stream_ptr(win1_fea))
    _lib.check(err, "mssvt_attention_bwd")
    launches += 1
    dproj = tuple(x.to(p.dtype) for x, p in zip(
        (dw[0], db[0], dw[1], db[1], dw[2], db[2], dw[3], db[3]), proj))
    return (dwin1, dk2, dqext, None if no_pad else dpad, dbase,
            dposw.to(pos_w.dtype), dproj), os_


class AssembledAttention(torch.autograd.Function):
    """Differentiable assembled attention: K3 forward, K5 backward.

    Like JAX's custom VJP ``_asm_attn_train`` it saves its inputs, not the
    activations, and the backward recomputes. Tensors are passed flat:
    ``apply(static, win1_fea, k2_fea, q_ext, pos_base, pos_w, pad_row,
    wq, bq, wk, bk, wv, bv, wp, bp, fps1, k_mask1, q_keep, krx, kry, krz,
    qrx, qry, qrz, key_bias, num_valid)`` with ``static = (num_heads,
    scale, q_prefix, nq, compute_dtype)``. The projections come in the
    parameters' dtype (f32): the kernels read them rounded to the compute
    dtype, and their cotangents come back in f32, as in JAX.
    """

    @staticmethod
    def forward(ctx, static, win1_fea, k2_fea, q_ext, pos_base, pos_w,
                pad_row, wq, bq, wk, bk, wv, bv, wp, bp, fps1, k_mask1,
                q_keep, krx, kry, krz, qrx, qry, qrz, key_bias, num_valid):
        num_heads, scale, q_prefix, nq, t = static
        ctx.static = static
        ctx.save_for_backward(win1_fea, k2_fea, q_ext, pos_base, pos_w,
                              pad_row, wq, bq, wk, bk, wv, bv, wp, bp, fps1,
                              k_mask1, q_keep, krx, kry, krz, qrx, qry, qrz,
                              key_bias, num_valid)
        return attention.fused_window_attention_assembled(
            win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, (krx, kry, krz),
            (qrx, qry, qrz), pos_base, pos_w, (wq, bq, wk, bk, wv, bv, wp, bp),
            key_bias,
            num_heads=num_heads, scale=scale, q_prefix=q_prefix, nq=nq,
            pad_row=pad_row, num_valid=num_valid, compute_dtype=t)

    @staticmethod
    def backward(ctx, g):
        num_heads, scale, q_prefix, nq, t = ctx.static
        (win1_fea, k2_fea, q_ext, pos_base, pos_w, pad_row, wq, bq, wk, bk,
         wv, bv, wp, bp, fps1, k_mask1, q_keep, krx, kry, krz, qrx, qry, qrz,
         key_bias, num_valid) = ctx.saved_tensors
        # looked up on the module at call time, so that a wrapper installed
        # on it (launch capture) sees the call
        bwd = sys.modules[__name__].fused_window_attention_assembled_bwd
        dwin1, dk2, dqext, dpad, dbase, dposw, dproj = bwd(
            win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, (krx, kry, krz),
            (qrx, qry, qrz), pos_base, pos_w, (wq, bq, wk, bk, wv, bv, wp, bp),
            key_bias, g.to(t).contiguous(), num_heads=num_heads, scale=scale,
            q_prefix=q_prefix, nq=nq, pad_row=pad_row, num_valid=num_valid,
            compute_dtype=t)
        return (None, dwin1, dk2, dqext, dbase, dposw, dpad, *dproj,
                *([None] * 11))
