"""The H100's peaks and the per-call work of the attention kernels K3
(forward) and K5 (backward): a frozen copy of the port's
``kernels/work.py`` formulas, so that a kernel's roofline share does not
move with the program. FLOPs count as ``FlopCounterMode`` counts an aten
product (2 a multiply-add); a kernel's FLOPs are the block-diagonal
projections and per-head products of the live windows (``num_valid``).
Bounds: each input read once and each output written once over the
memory rate, against the operations over the peak of their type,
whichever is larger (H100 SXM, NVIDIA's data sheet, dense rates)."""

from __future__ import annotations

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


PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
