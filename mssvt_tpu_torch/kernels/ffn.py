"""K4: fused residual LayerNorm FFN tail of an MsSVT block.

Replaces ``fused_residual_ffn`` (``mssvt_tpu/ops/pallas_ffn.py``):
``out = x + W2 @ relu(W1 @ LN(x) + b1) + b2`` with LayerNorm statistics in
f32 (eps 1e-6), the LayerNorm output and the hidden activation rounded to
the compute dtype, and both products accumulated in f32.

The compute dtype is the model's: bf16 at ``mssvt.yaml``, which is exactly
the TPU kernel (it always rounds to bf16), and f32 at the f32 configs, which
is exactly the JAX CPU path (flax LayerNorm + Dense chain). Weights keep the
flax (in, out) layout.

CUDA tensors go to ``csrc/ffn.cu``; CPU tensors to :func:`ffn_plain`. In
bf16 the kernel is built for the repo's widths, ``BF16_WIDTHS`` ((C, F) of
``mssvt.yaml`` and ``mssvt_tiny.yaml``): a persistent CTA keeps both weights
in its shared memory, which holds no wider pair beside its row tiles. f32
takes any C % 32 == 0 <= 256 and F % 32 == 0 <= 1024.
"""

from __future__ import annotations

import torch

from . import _lib

launches = 0
BF16_WIDTHS = ((128, 256), (64, 128))  # (C, F) the bf16 kernel is built for


def ffn_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6,
              compute_dtype=None):
    """Plain PyTorch version (same contract as :func:`fused_residual_ffn`)."""
    t = compute_dtype or x.dtype
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=1, keepdim=True)
    ln = (c * torch.rsqrt(var + eps) * ln_scale.float()
          + ln_bias.float()).to(t).float()
    h = torch.relu(ln @ w1.to(t).float() + b1.float()).to(t).float()
    y = h @ w2.to(t).float() + b2.float()
    return (xf + y).to(x.dtype)


def fused_residual_ffn(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6,
                       compute_dtype=None):
    """x (V, C) -> x + FFN(LN(x)), in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return ffn_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                         compute_dtype)
    t = compute_dtype or x.dtype
    if t not in (torch.bfloat16, torch.float32) or x.dtype != t:
        raise TypeError("ffn kernel: x and compute dtype must both be "
                        "bfloat16 or both float32")
    v, c = x.shape
    f = w1.shape[1]
    dev = x.device
    if t == torch.bfloat16 and (c, f) not in BF16_WIDTHS:
        raise ValueError(f"ffn kernel: bf16 widths C={c} F={f} are not "
                         f"among {BF16_WIDTHS}")
    if c % 32 or c > 256 or f % 32 or f > 1024:
        raise ValueError(f"ffn kernel: unsupported widths C={c} F={f}")
    req = _lib.require
    req(x, "x", t, (v, c), dev)
    req(w1, "w1", t, (c, f), dev)
    req(w2, "w2", t, (f, c), dev)
    if any(p.data_ptr() % 16 for p in (x, w1, w2)):
        raise ValueError("ffn kernel: x, w1 and w2 must be 16-byte aligned")
    for name, p, n in (("ln_scale", ln_scale, c), ("ln_bias", ln_bias, c),
                       ("b1", b1, f), ("b2", b2, c)):
        req(p, name, torch.float32, (n,), dev)
    out = torch.empty_like(x)
    err = _lib.lib().mssvt_ffn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), v, c, f,
        float(eps), int(t == torch.bfloat16), _lib.stream_ptr(x))
    _lib.check(err, "mssvt_ffn")
    launches += 1
    return out


def kernel_plan(c=128, f=256):
    """(shared-memory bytes, CTAs per SM, registers a thread) of the bf16
    kernel at widths (C, F), from the CUDA occupancy API."""
    out = (_lib.CI * 3)()
    _lib.check(_lib.lib().mssvt_ffn_plan(int(c), int(f), out),
               "mssvt_ffn_plan")
    return out[0], out[1], out[2]
