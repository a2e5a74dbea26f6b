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
    """BatchNorm over the channels of an NCHW tensor (or, with
    ``channels_last``, of the last axis of any tensor, as flax's default
    ``axis=-1``) with flax's semantics and parameter names: ``scale``/
    ``bias`` parameters, ``mean``/``var`` running statistics, and flax's
    ``momentum`` (the running average keeps ``momentum`` of its old value).

    In training the batch statistics are taken in f32 over every other
    axis as flax does (``var = max(0, E[x^2] - E[x]^2)``, the biased
    variance), the input is normalised with them, and the running
    statistics are updated with the same biased variance (``F.batch_norm``
    would update ``var`` with the unbiased one), in one process."""

    def __init__(self, channels, eps, momentum=0.99, dtype=torch.float32,
                 channels_last=False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.eps = eps
        self.momentum = momentum
        self.compute_dtype = dtype
        self.channels_last = channels_last

    def _layout(self, x):
        """(axes reduced over, view of a (C,) vector against ``x``)."""
        if self.channels_last:
            return tuple(range(x.ndim - 1)), lambda v: v
        return (0, 2, 3), lambda v: v[:, None, None]

    def forward(self, x):
        dims, per_c = self._layout(x)
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=dims)
            mean2 = (xf * xf).mean(dim=dims)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            self._update_running(mean, var)
            mul = torch.rsqrt(var + self.eps) * self.scale
            y = (xf - per_c(mean)) * per_c(mul) + per_c(self.bias)
            return y.to(self.compute_dtype)
        a = self.scale * torch.rsqrt(self.var + self.eps)
        b = self.bias - self.mean * a
        return (x.float() * per_c(a) + per_c(b)).to(self.compute_dtype)

    def _update_running(self, mean, var):
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the valid rows of a padded (V, C) array (the sparse
    convolutions' norm layer; flax momentum 0.99, epsilon 1e-3 by
    default): the statistics count only the rows where ``valid`` is set,
    the variance ``E[x^2] - E[x]^2`` is clipped at 0, and the output
    (f32, as the JAX module's) is multiplied by ``valid``."""

    def __init__(self, channels, eps=1e-3, momentum=0.99):
        super().__init__(channels, eps, momentum)

    def forward(self, x, valid):
        w = valid.to(torch.float32)[:, None]
        if self.training:
            xf = x.float()
            sums = torch.cat([w.sum(0), (xf * w).sum(0),
                              (xf * xf * w).sum(0)])
            n = torch.clamp(sums[0], min=1.0)
            c = x.shape[-1]
            mean = sums[1:1 + c] / n
            var = torch.clamp(sums[1 + c:] / n - mean * mean, min=0.0)
            self._update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return y * w


def same_pads(sizes, kernel_size, stride, dilation):
    """flax/XLA ``SAME`` padding of each spatial axis: ``total =
    max((ceil(n/s) - 1) * s + (k - 1) * d + 1 - n, 0)``, the lower side
    the smaller half."""
    pads = []
    for n, k, s, d in zip(sizes, kernel_size, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


class Conv2d(nn.Conv2d):
    """NCHW convolution computing in ``dtype`` (flax ``nn.Conv``; the
    bridge converts HWIO kernels to OIHW). ``padding="SAME"`` pads as flax
    does (:func:`same_pads`, which may be asymmetric: (0, 1) for a 3x3
    stride-2 conv over an even size), any other padding as
    ``nn.Conv2d``."""

    def __init__(self, *args, dtype=torch.float32, padding=0, **kw):
        self.flax_same = padding == "SAME"
        super().__init__(*args, padding=0 if self.flax_same else padding,
                         **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        if self.flax_same:
            pads = same_pads(x.shape[2:], self.kernel_size, self.stride,
                             self.dilation)
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x, self.weight.to(dt), b)


class Conv3d(nn.Conv3d):
    """flax ``nn.Conv`` over (N, D, H, W, C) channels-last grids with its
    default ``SAME`` padding (the lower side gets the smaller half, as
    XLA pads), computing in ``dtype`` (the bridge converts DHWIO kernels to
    OIDHW)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 bias=True, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=0, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        pads = same_pads(x.shape[1:4], self.kernel_size, self.stride,
                         self.dilation)
        x = x.to(dt).permute(0, 4, 1, 2, 3)
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv3d(x, self.weight.to(dt), b, self.stride)
        return y.permute(0, 2, 3, 4, 1)


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


def keep_mask(shape, keep, generator, device):
    """A Bernoulli(``keep``) bool mask of ``shape`` drawn from
    ``generator``: every DropPath and Dropout draw of the port goes through
    it, in the order the JAX modules draw theirs."""
    if generator is None:
        raise ValueError("a random mask in training needs a torch.Generator")
    return torch.rand(shape, generator=generator, device=device) < keep


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
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = keep_mask(shape, keep, generator, x.device)
        return x * mask.to(x.dtype) / keep


def dropout(x, rate, training, generator):
    """flax ``nn.Dropout``: in training, ``x / (1 - rate)`` where a
    Bernoulli(1 - rate) mask is set, else 0; identity at eval or rate 0
    (no draw)."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


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

    def forward(self, x):
        """The embedding of (..., 6) inputs (rel xyz ++ window centre xyz)."""
        x = torch.relu(self.proj0(x))
        if self.deep:
            x = torch.relu(self.proj1(x))
        return x

    def from_planes(self, rx, ry, rz, cx, cy, cz):
        """Shallow-path embedding from (NW, n) relative-coordinate planes
        and per-window centres (NW,): ``forward`` of the stacked (NW, n, 6)
        input without building it (the centre half is a per-window base)."""
        assert not self.deep, "from_planes is the shallow (two-scale) path"
        dt = self.compute_dtype
        w = self.proj0.kernel()
        base = self.base_from_centers(cx, cy, cz)
        return torch.relu(rx[..., None].to(dt) * w[0]
                          + ry[..., None].to(dt) * w[1]
                          + rz[..., None].to(dt) * w[2] + base[:, None, :])

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
