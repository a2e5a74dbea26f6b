"""The control of the correctness check: the plain reference computed in
the precision just below the one a configuration states. For ``bfloat16``
that is fp8: every matrix product and convolution reads its two matrix
operands rounded to ``float8_e4m3fn`` with a per-tensor scale (the
largest magnitude onto 448, as fp8 training and serving recipes scale),
and computes in float32."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
E4M3_MAX = 448.0
# op -> positions of its two matrix operands
PRODUCTS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2),
            aten.baddbmm: (1, 2), aten.convolution: (0, 1)}


def fp8(t):
    if not isinstance(t, torch.Tensor) or not t.is_floating_point():
        return t
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(t.dtype)


class Fp8Products(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        pos = PRODUCTS.get(func.overloadpacket)
        if pos is not None:
            args = list(args)
            for i in pos:
                args[i] = fp8(args[i])
        return func(*args, **(kwargs or {}))


def below(precision):
    """A context under which the reference computes one step below
    ``precision``."""
    if precision == "bfloat16":
        return Fp8Products()
    raise ValueError(f"no control for precision {precision!r}")
