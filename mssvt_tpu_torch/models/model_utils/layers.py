"""Small shared layers (torch counterpart of
``mssvt_tpu/models/model_utils/layers.py`` plus the flax-layout basics).

Parameters are kept in float32 and cast to the module's compute ``dtype`` at
call time, as flax's ``dtype=`` policy does. Submodule names follow the flax
parameter paths so that ``bridge.load_flax_variables`` can walk them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def kernel(self):
        """The flax-layout (in, out) kernel in the compute dtype."""
        return self.weight.t().to(self.compute_dtype).contiguous()


class LayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics, output in ``dtype`` (flax default eps
    1e-6)."""

    def __init__(self, channels, eps=1e-6, dtype=torch.float32):
        super().__init__(channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the channels of an NCHW tensor with flax's semantics
    and parameter names: ``scale``/``bias`` parameters, ``mean``/``var``
    running statistics, and flax's ``momentum`` (the running average keeps
    ``momentum`` of its old value).

    In training the batch statistics are taken in f32 over N*H*W as flax
    does (``var = max(0, E[x^2] - E[x]^2)``, the biased variance), the input
    is normalised with them, and the running statistics are updated with
    the same biased variance (``F.batch_norm`` would update ``var`` with
    the unbiased one)."""

    def __init__(self, channels, eps, momentum=0.99, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.eps = eps
        self.momentum = momentum
        self.compute_dtype = dtype

    def forward(self, x):
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
            mul = torch.rsqrt(var + self.eps) * self.scale
            y = (xf - mean[:, None, None]) * mul[:, None, None] \
                + self.bias[:, None, None]
            return y.to(self.compute_dtype)
        a = self.scale * torch.rsqrt(self.var + self.eps)
        b = self.bias - self.mean * a
        return (x.float() * a[:, None, None] + b[:, None, None]).to(
            self.compute_dtype)


class Conv2d(nn.Conv2d):
    """NCHW convolution computing in ``dtype`` (flax ``nn.Conv``; the
    bridge converts HWIO kernels to OIHW)."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Stride-s, kernel-s transposed convolution in ``dtype`` (flax
    ``nn.ConvTranspose``; the bridge flips flax's kernel spatially)."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), b,
                                  self.stride, self.padding)


class DropPath(nn.Module):
    """Stochastic depth per leading-axis row; identity at eval. The keep
    mask is drawn from the ``torch.Generator`` the caller passes (it must
    live on ``x``'s device), so a run repeats when the generator does."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return x * mask.to(x.dtype) / keep


class PosProjection(nn.Module):
    """Position-embedding MLP over (rel_xyz ++ window_center_xyz): one
    Dense+ReLU (two-scale blocks) or two (``deep``, compress blocks)."""

    def __init__(self, channels, deep=False, dtype=torch.float32):
        super().__init__()
        self.deep = deep
        self.compute_dtype = dtype
        self.proj0 = Dense(6, channels, dtype=dtype)
        if deep:
            self.proj1 = Dense(channels, channels, dtype=dtype)

    def rel_kernel(self):
        """(3, C) relative-coordinate rows of the shallow kernel."""
        assert not self.deep
        return self.proj0.kernel()[:3].contiguous()

    def base_from_centers(self, cx, cy, cz):
        """Pre-relu per-window centre half: stack(c) @ W[3:] + b, (NW, C)."""
        assert not self.deep
        dt = self.compute_dtype
        ctr = torch.stack([cx, cy, cz], dim=-1).to(dt)
        return ctr @ self.proj0.kernel()[3:] + self.proj0.bias.to(dt)

    def deep_from_planes(self, rx, ry, rz, cx, cy, cz):
        """Deep-path embedding from (NW, n) relative-coordinate planes plus
        per-window centres, without the (NW, n, 6) stack."""
        assert self.deep
        dt = self.compute_dtype
        w = self.proj0.kernel()
        base = torch.stack([cx, cy, cz], dim=-1).to(dt) @ w[3:] \
            + self.proj0.bias.to(dt)
        x = torch.relu(rx[..., None].to(dt) * w[0] + ry[..., None].to(dt) * w[1]
                       + rz[..., None].to(dt) * w[2] + base[:, None, :])
        return torch.relu(self.proj1(x))
