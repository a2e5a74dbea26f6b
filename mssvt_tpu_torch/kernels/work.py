"""The work of one call of each kernel, and a context that tallies a run's
FLOPs.

One copy of the per-call formulas serves ``chip_smoke.py`` (each kernel
row's ``bound_ms``), ``tools/bench_attn_kernel_torch.py`` (K3's bound) and
the counting context below (``bench_torch.py``'s ``mfu``). Each formula
takes its wrapper's own arguments and returns a :class:`Work`.

FLOPs are counted as ``torch.utils.flop_counter.FlopCounterMode`` counts an
aten product: 2 per multiply-add of a matrix product or a convolution, and
nothing for elementwise work. K1 (fill) and the FPS kernels therefore count
no FLOPs; their bounds divide their elementwise operations by the f32 rate.
A kernel's FLOPs are the products of the function it computes: the
block-diagonal projections and per-head products of the live windows
(``num_valid``; for K7 the windows whose cotangent has a nonzero element),
not the dense (D, D) products over every window that the plain versions
compute.

Bounds: the bytes that a call must move (each input read once, each output
written once; rows past ``num_valid`` are not read) over the card's memory
rate, against its operations over the peak rate of their type, whichever
is larger (H100 SXM, NVIDIA's data sheet: 3.35 TB/s, 989 TFLOP/s dense
bf16, 67 TFLOP/s f32 outside the tensor cores).

Counting: inside ``with counting() as tally`` a ``FlopCounterMode`` counts
the aten products of whatever runs (the BEV convolutions, the head, the
3-NN interpolation's product), and every call of a wrapper decorated with
:func:`counted` adds its formula's FLOPs under its kernel's name. The aten
products counted while a wrapper ran (its plain version, for CPU tensors)
are taken back out, so a run counts the same work whether the kernels or
their plain versions ran. A formula that reads ``num_valid`` or a
cotangent's live windows syncs with the card, so count in a run of its own,
never in a timed one.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import NamedTuple

MEM_BPS = 3.35e12     # H100 SXM HBM3 bytes/s
BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores


class Work(NamedTuple):
    flops: int    # the products' FLOPs, as FlopCounterMode counts them
    ops: int      # the operations the bound divides by ``peak``
    nbytes: int   # each input read once, each output written once
    peak: float   # FLOP/s of the type of ``ops``

    def bound(self):
        """(bound_ms, "bytes" or "operations")."""
        t_by, t_op = self.nbytes / MEM_BPS, self.ops / self.peak
        return max(t_by, t_op) * 1e3, "bytes" if t_by >= t_op else "operations"


def _count(num_valid, default):
    return default if num_valid is None else int(num_valid)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def fill(box, offs_packed, cap, order=None, own_slab=None, elig=None,
         num_valid=None):
    """K1: the live rows' table entries read; both (NW, cap) outputs, the
    own slab's ranks and the counts written; 4 int32 operations an entry
    (load, compare, rank, store)."""
    nw, k = box.shape
    nv = _count(num_valid, nw)
    cv = own_slab[1] if own_slab else 0
    ops = nv * k * 4
    return Work(0, ops, nv * k * 4 + nw * (2 * int(cap) + cv + 8) * 4,
                F32_FLOPS)


def fps_select(x, y, z, aux, npoint, num_valid=None, nw_half=0):
    """K2: the live rows' planes read, picks and selections written; 10 f32
    operations a point and iteration (3 sub, 3 mul, 2 add, min, compare)."""
    rows, n = x.shape
    nv = _count(num_valid, rows // 2 if nw_half else rows)
    live = 2 * nv if nw_half else nv
    planes = 3 + len(aux)
    return Work(0, live * (npoint - 1) * n * 10,
                live * n * 4 * planes + rows * npoint * 4 * (1 + planes),
                F32_FLOPS)


def fps_picks(x, y, z, npoint):
    """K2b and K2c: the three planes read, the picks written, 10 f32
    operations a point and iteration."""
    b, n = x.shape
    return Work(0, b * (npoint - 1) * n * 10, 3 * b * n * 4 + b * npoint * 4,
                F32_FLOPS)


def _asm_layout(win1_fea, k2_fea, fps1, q_ext, num_heads, q_prefix, nq):
    nw, n1cap, d = win1_fea.shape
    nk1, nk2 = fps1.shape[1], k2_fea.shape[1]
    nq = int(nq) if q_prefix else q_ext.shape[1]
    ph = d // sum(num_heads)
    mac_proj = sum((ph * h) ** 2 for h in num_heads)  # a token, one matrix
    attn = sum(num_heads) * nq * ((nk1 + nk2) // len(num_heads)) * ph
    return nw, n1cap, d, nk1, nk2, nq, mac_proj, attn


def attention(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
              pos_base, pos_w, proj, key_bias, num_heads, scale, q_prefix,
              nq=0, pad_row=None, num_valid=None, compute_dtype=None):
    """K3 at bf16: the live windows' inputs read, every window's output
    written; its q/k/v and output projections and per-head products."""
    nw, n1cap, d, nk1, nk2, nq, mac_proj, attn = _asm_layout(
        win1_fea, k2_fea, fps1, q_ext, num_heads, q_prefix, nq)
    nkt = nk1 + nk2
    nv = _count(num_valid, nw)
    macs = (nq + 2 * nkt) * mac_proj + nq * mac_proj + 2 * attn
    per_win = (n1cap * d * 2 + nk2 * d * 2 + nk1 * 5 + nq * 4
               + (0 if q_prefix else nq * d * 2)
               + 4 * 3 * (nkt + nq) + d * 2 + nkt * 4
               + (d * 2 if pad_row is not None else 0))
    flops = 2 * macs * nv
    return Work(flops, flops, nv * per_win + nw * nq * d * 2 + 4 * d * d * 2,
                BF16_FLOPS)


def attention_bwd(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel,
                  q_rel, pos_base, pos_w, proj, key_bias, g, num_heads, scale,
                  q_prefix, nq=0, pad_row=None, num_valid=None,
                  compute_dtype=None):
    """K5 at bf16: the live windows' inputs read once, every output written
    once; the forward recompute, the backward's products and the full
    (D, D) weight products of the live windows."""
    nw, n1cap, d, nk1, nk2, nq, mac_proj, attn = _asm_layout(
        win1_fea, k2_fea, fps1, q_ext, num_heads, q_prefix, nq)
    nkt = nk1 + nk2
    nv = _count(num_valid, nw)
    macs = ((nq + 2 * nkt) * mac_proj + 2 * attn       # forward recompute
            + nq * mac_proj + 4 * attn                 # dO, dA, dV, dQ, dK
            + (nq + 2 * nkt) * mac_proj                # dQ3, dK3
            + (2 * nq + 2 * nkt) * d * d)              # dW (full D x D)
    per_win = (n1cap * d * 2 + nk2 * d * 2 + nk1 * 5 + nq * 4
               + (0 if q_prefix else nq * d * 2)
               + 4 * 3 * (nkt + nq) + d * 2 + nkt * 4 + d * 2 + nq * d * 2)
    outs = nw * (n1cap * d * 2 + nk2 * d * 2 + 2 * d * 2
                 + (0 if q_prefix else nq * d * 2))
    flops = 2 * macs * nv
    return Work(flops, flops,
                nv * per_win + 4 * d * d * 2 + outs + (4 * d * d + 7 * d) * 4,
                BF16_FLOPS)


def _qk_layout(query, keys, num_heads):
    nw, nq, d = query.shape
    nkt = keys.shape[1]
    ph = d // sum(num_heads)
    mac_proj = sum((ph * h) ** 2 for h in num_heads)  # a token, one matrix
    attn = sum(num_heads) * nq * (nkt // len(num_heads)) * ph
    es = query.element_size()
    weights = (4 * d * d + 4 * d) * es
    tokens = nw * (nq + nkt) * d * es + nw * nkt * 4
    return nw, nq, d, nkt, mac_proj, attn, es, weights, tokens


def attention_qk(query, keys, proj, key_bias, num_heads, scale,
                 compute_dtype=None):
    """K6: every window's tokens read once, the output written once; the
    block-diagonal products of every window."""
    nw, nq, d, nkt, mac_proj, attn, es, weights, tokens = _qk_layout(
        query, keys, num_heads)
    flops = 2 * ((nq + 2 * nkt) * mac_proj + nq * mac_proj + 2 * attn) * nw
    return Work(flops, flops, tokens + weights + nw * nq * d * es,
                BF16_FLOPS)


def live_windows(g):
    """The windows whose cotangent ``g`` has a nonzero element (a host
    sync on the card)."""
    return int((g.reshape(g.shape[0], -1) != 0).any(dim=1).sum())


def attention_qk_bwd(query, keys, proj, key_bias, g, num_heads, scale,
                     compute_dtype=None):
    """K7: g of every window, the tokens and products of the windows whose
    g has a nonzero element (the others' cotangents are zeros whatever
    their tokens): the forward recompute, the backward and the full (D, D)
    weight products; every output written once."""
    nw, nq, d, nkt, mac_proj, attn, es, weights, tokens = _qk_layout(
        query, keys, num_heads)
    live = live_windows(g)
    macs = ((nq + 2 * nkt) * mac_proj + 2 * attn       # forward recompute
            + nq * mac_proj + 4 * attn                 # dO, dA, dV, dQ, dK
            + (nq + 2 * nkt) * mac_proj                # dq, dk
            + (2 * nq + 2 * nkt) * d * d)              # dW (full D x D)
    nbytes = (tokens * live // nw + weights + nw * nq * d * es     # + g
              + nw * (nq + nkt) * d * es + (4 * d * d + 4 * d) * 4)
    flops = 2 * macs * live
    return Work(flops, flops, nbytes, BF16_FLOPS)


def ffn(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6, compute_dtype=None):
    """K4 at bf16: x read and the output written, both weights read once;
    its two products."""
    v, c = x.shape
    f = w1.shape[1]
    flops = 4 * v * c * f
    return Work(flops, flops, 2 * _nbytes(x) + 2 * c * f * 2, BF16_FLOPS)


class Tally:
    """What one counting context counted: ``kernels`` (FLOPs by kernel
    name), and :meth:`aten_flops`, the aten products outside the kernels."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.mode = FlopCounterMode(display=False)
        self.kernels = collections.Counter()
        self.inside_wrappers = 0  # aten FLOPs counted while a wrapper ran

    def aten_flops(self):
        return self.mode.get_total_flops() - self.inside_wrappers

    def kernel_flops(self):
        return sum(self.kernels.values())

    def total(self):
        return self.kernel_flops() + self.aten_flops()


_TALLY = None  # the open counting context's Tally


@contextlib.contextmanager
def counting():
    """Count the FLOPs of what runs inside (see the module docstring)."""
    global _TALLY
    if _TALLY is not None:
        raise RuntimeError("a counting context is already open")
    tally = Tally()
    _TALLY = tally
    try:
        with tally.mode:
            yield tally
    finally:
        _TALLY = None


def counted(name, formula):
    """Decorates the wrapper of kernel ``name``: inside a counting context
    each of its calls adds ``formula(*args).flops`` under ``name``, in place
    of whatever aten products ran inside it."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            tally = _TALLY
            if tally is None:
                return fn(*args, **kwargs)
            before = tally.mode.get_total_flops()
            out = fn(*args, **kwargs)
            tally.inside_wrappers += tally.mode.get_total_flops() - before
            tally.kernels[name] += formula(*args, **kwargs).flops
            return out
        return call
    return wrap
