"""K6: mixed-scale window attention on pre-assembled query and key tokens.

Replaces ``fused_window_attention`` (``mssvt_tpu/ops/pallas_attention.py``,
``_fused_attention_fwd_impl`` / ``_attn_kernel``), the forward of JAX's
custom VJP ``_fused_attention``. Per window, in the compute dtype ``T``:

- ``query`` (NW, nq, D), ``keys`` (NW, nk_tot, D) and the four block
  diagonal (D, D) weights and (D,) biases are rounded to T;
- q/k/v projections (f32 accumulation, + bias, rounded to T);
- per head: scores against its own group's key stripe, * scale + key_bias
  (NW, nk_tot) f32, softmax in f32 (max-subtracted, denominator + 1e-30),
  weights rounded to T, value product in f32;
- output projection (f32 accumulation + bias) in ``query.dtype``.

It has no ``num_valid``: every window is computed, as in JAX. Callers apply
their query mask afterwards.

CUDA tensors go to ``csrc/attention_qk.cu`` (K3's per-window forward on
tokens copied from device memory; it also gets the four weights transposed);
CPU tensors to :func:`attention_qk_plain`. The
backward, K7, is ``kernels/attention_qk_bwd.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib, work
from .attention import MAX_GROUPS, attention_core_plain

launches = 0


def attention_qk_plain(query, keys, proj, key_bias, num_heads, scale,
                       compute_dtype=None):
    """Plain PyTorch version (same contract as :func:`fused_window_attention`)."""
    t = compute_dtype or query.dtype
    return attention_core_plain(query.to(t), keys.to(t), proj, key_bias,
                                num_heads, scale, t, query.dtype)


def kernel_inputs(query, keys, proj, key_bias, num_heads, compute_dtype, name):
    """Checks what the pre-assembled attention kernels (K6 and its backward
    K7) take and raises on the rest; returns (compute dtype, the 11 input
    tensors in the order the C entries read them, the 9 layout dims). The
    projections may come in any float dtype; the kernels read them rounded
    to the compute dtype, as JAX's kernels do."""
    t = compute_dtype or query.dtype
    if t not in (torch.bfloat16, torch.float32) or query.dtype != t \
            or keys.dtype != t:
        raise TypeError(f"{name} kernel: query, keys and compute dtype must "
                        "all be bfloat16 or all float32")
    dev = query.device
    nw, nq, d = query.shape
    nk_tot = keys.shape[1]
    groups = len(num_heads)
    if (groups > MAX_GROUPS or d % 32 or d > 256 or d % sum(num_heads)
            or nk_tot % groups or nq < 1):
        raise ValueError(f"{name} kernel: unsupported layout d={d} "
                         f"heads={num_heads} nk={nk_tot} nq={nq}")
    req = _lib.require
    req(query, "query", t, (nw, nq, d), dev)
    req(keys, "keys", t, (nw, nk_tot, d), dev)
    req(key_bias, "key_bias", torch.float32, (nw, nk_tot), dev)
    proj = tuple(p.to(t).contiguous() for p in proj)  # any float dtype
    for i, p in enumerate(proj):
        req(p, f"proj[{i}]", t, (d, d) if i % 2 == 0 else (d,), dev)
    for x, n in ((query, "query"), (keys, "keys")):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {n} must be 16-byte aligned")
    wq, bq, wk, bk, wv, bv, wp, bp = proj
    tensors = [query, keys, wq, wk, wv, wp, bq, bk, bv, bp, key_bias]
    dims = [nw, nq, nk_tot, d, groups]
    dims += list(num_heads) + [0] * (MAX_GROUPS - groups)
    return t, tensors, dims


def kernel_plan(nq, nk_tot, d, num_heads, bf16=True,
                entry="mssvt_attention_qk_plan"):
    """(shared-memory bytes, CTAs per SM, registers a thread) of K6's
    kernel (or, by ``entry``, K7's per-window kernel) at a layout."""
    heads = list(num_heads) + [0] * (MAX_GROUPS - len(num_heads))
    return _lib.kernel_plan(entry, [0, nq, nk_tot, d, len(num_heads), *heads],
                            bf16)


@work.counted("attention_qk", work.attention_qk)
def fused_window_attention(query, keys, proj, key_bias, num_heads, scale,
                           compute_dtype=None):
    """(NW, nq, D) window attention from assembled query and key tokens."""
    global launches
    if query.device.type == "cpu":
        return attention_qk_plain(query, keys, proj, key_bias, num_heads,
                                  scale, compute_dtype)
    t, tensors, dims = kernel_inputs(query, keys, proj, key_bias, num_heads,
                                     compute_dtype, "attention_qk")
    out = torch.empty_like(query)
    err = _lib.lib().mssvt_attention_qk(
        _lib.ptr_array(tensors + [out] + _lib.transposed(tensors[2:6])),
        (ctypes.c_int * len(dims))(*dims), float(scale),
        int(t == torch.bfloat16), _lib.stream_ptr(query))
    _lib.check(err, "mssvt_attention_qk")
    launches += 1
    return out
