"""K4's plain version (frozen copy of ``ffn_plain``): the residual
LayerNorm FFN tail of an MsSVT block."""

from __future__ import annotations

import torch




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
    """x (V, C) -> x + FFN(LN(x)), always the plain version."""
    return ffn_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                     compute_dtype)
