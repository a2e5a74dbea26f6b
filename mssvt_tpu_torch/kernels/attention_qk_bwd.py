"""K7: the backward of the window attention on pre-assembled tokens (K6),
and the autograd Function that pairs the two.

Replaces ``_fused_attention_bwd_impl`` (``mssvt_tpu/ops/pallas_attention.py``,
kernel ``_attn_bwd_kernel`` -> ``_bwd_qstk_core`` / ``_finish_bwd``), the
backward of the custom VJP ``_fused_attention``. It recomputes the attention
from the saved inputs and returns ``dq`` (query's dtype), ``dk`` (keys'
dtype) and the eight projection cotangents, summed in f32; ``key_bias`` (a
mask) gets none.

CUDA tensors go to ``csrc/attention_qk_bwd.cu`` (launches that count as
one: a pre-pass that lists the windows whose ``g`` has a nonzero element and
zeroes ``dq``/``dk`` of the others, the per-window backward over the listed
windows, a split-K weight-gradient product over their rows, a fixed order
sum of the partials); CPU tensors to :func:`attention_qk_bwd_plain`. A
window with ``g = 0`` contributes exact zeros to every cotangent, so the
list changes no result. The sums over windows (dW, db) take no float
atomics, so a repeated call gives bit-identical results.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from . import _lib
from . import attention_qk
from .attention import attention_core_bwd_plain
from .attention_bwd import NCTA, NSPLIT

launches = 0
# the last call's window list on the card: its last element is the number
# of windows the per-window kernel walked
last_list = None


def attention_qk_bwd_plain(query, keys, proj, key_bias, g, num_heads, scale,
                           compute_dtype=None):
    """Plain PyTorch version of K7: ``(dq, dk, dproj)`` for the output
    cotangent ``g`` (NW, nq, D), JAX's backward step by step
    (:func:`~mssvt_tpu_torch.kernels.attention.attention_core_bwd_plain`)
    rather than a differentiated :func:`attention_qk.attention_qk_plain`.
    ``dproj = (dwq, dbq, dwk, dbk, dwv, dbv, dwp, dbp)`` in the projections'
    dtypes, summed in f32."""
    t = compute_dtype or query.dtype
    dq3, dk3, dproj = attention_core_bwd_plain(
        query.to(t), keys.to(t), proj, key_bias, g.to(t).float(), num_heads,
        scale, t)
    dproj = tuple(dp.to(p.dtype) for dp, p in zip(dproj, proj))
    return dq3.to(query.dtype), dk3.to(keys.dtype), dproj


def kernel_plan(nq, nk_tot, d, num_heads, bf16=True):
    """(shared-memory bytes, CTAs per SM, registers a thread) of K7's
    per-window kernel."""
    return attention_qk.kernel_plan(nq, nk_tot, d, num_heads, bf16,
                                    "mssvt_attention_qk_bwd_plan")


def fused_window_attention_bwd(query, keys, proj, key_bias, g, num_heads,
                               scale, compute_dtype=None):
    """Cotangents ``(dq, dk, dproj)`` of
    :func:`attention_qk.fused_window_attention` for the output cotangent
    ``g`` (same contract as :func:`attention_qk_bwd_plain`)."""
    global launches, last_list
    if query.device.type == "cpu":
        return attention_qk_bwd_plain(query, keys, proj, key_bias, g,
                                      num_heads, scale, compute_dtype)
    t, tensors, dims = attention_qk.kernel_inputs(
        query, keys, proj, key_bias, num_heads, compute_dtype,
        "attention_qk_bwd")
    dev = query.device
    nw, nq, d = query.shape
    nk_tot = keys.shape[1]
    _lib.require(g, "g", t, (nw, nq, d), dev)

    def empty(*shape, dtype=t):
        return torch.empty(shape, dtype=dtype, device=dev)

    dq, dk = empty(nw, nq, d), empty(nw, nk_tot, d)
    # weight-product operands: per listed window the rounded projected
    # cotangents and the rounded attention output (the raw tokens and g are
    # the inputs)
    dqs, dks, dvs, os_ = (empty(nw, nq, d), empty(nw, nk_tot, d),
                          empty(nw, nk_tot, d), empty(nw, nq, d))
    ncta = min(nw, NCTA)
    wpart = empty(4, NSPLIT, d, d, dtype=torch.float32)
    cpart = empty(max(ncta, 1), 4, d, dtype=torch.float32)
    dw = empty(4, d, d, dtype=torch.float32)
    db = empty(4, d, dtype=torch.float32)
    wts = _lib.transposed(tensors[2:5])
    flags = empty(nw, dtype=torch.int32)
    last_list = empty(nw + 1, dtype=torch.int32)
    ptrs = _lib.ptr_array(tensors + [g, dq, dk, dqs, dks, dvs, os_, wpart,
                                     cpart, dw, db, *wts, flags, last_list])
    dims = (ctypes.c_int * (len(dims) + 2))(*dims, NSPLIT, ncta)
    err = _lib.lib().mssvt_attention_qk_bwd(ptrs, dims, float(scale),
                                            int(t == torch.bfloat16),
                                            _lib.stream_ptr(query))
    _lib.check(err, "mssvt_attention_qk_bwd")
    launches += 1
    dproj = tuple(x.to(p.dtype) for x, p in zip(
        (dw[0], db[0], dw[1], db[1], dw[2], db[2], dw[3], db[3]), proj))
    return dq, dk, dproj


class FusedAttention(torch.autograd.Function):
    """Differentiable attention on assembled tokens: K6 forward, K7
    backward. Like JAX's custom VJP ``_fused_attention`` it saves its
    inputs, not the activations, and the backward recomputes.
    ``apply(static, query, keys, wq, bq, wk, bk, wv, bv, wp, bp, key_bias)``
    with ``static = (num_heads, scale, compute_dtype)``. The projections
    come in the parameters' dtype (f32): the kernels read them rounded to
    the compute dtype, and their cotangents come back in f32, as in JAX.
    """

    @staticmethod
    def forward(ctx, static, query, keys, wq, bq, wk, bk, wv, bv, wp, bp,
                key_bias):
        num_heads, scale, t = static
        ctx.static = static
        ctx.save_for_backward(query, keys, wq, bq, wk, bk, wv, bv, wp, bp,
                              key_bias)
        return attention_qk.fused_window_attention(
            query, keys, (wq, bq, wk, bk, wv, bv, wp, bp), key_bias,
            num_heads=num_heads, scale=scale, compute_dtype=t)

    @staticmethod
    def backward(ctx, g):
        num_heads, scale, t = ctx.static
        query, keys, *proj, key_bias = ctx.saved_tensors
        # looked up on the module at call time, so that a wrapper installed
        # on it (launch capture) sees the call
        bwd = sys.modules[__name__].fused_window_attention_bwd
        dq, dk, dproj = bwd(query, keys, tuple(proj), key_bias,
                            g.to(t).contiguous(), num_heads=num_heads,
                            scale=scale, compute_dtype=t)
        return (None, dq, dk, *dproj, None)
