"""Mixed-scale head-group attention (torch counterpart of
``mssvt_tpu/models/model_utils/attention.py``).

The embedding splits into head groups, one per window scale; group i
attends with its own q/kv projections (``to_q_i``, ``to_kv_i``, ``proj_i``)
over its own contiguous key stripe. Pad keys get an additive -100 (not
-inf), so an all-pad window gives a uniform, then query-masked, result.

Two paths:
- ``assembled`` (the MsSVT blocks, nq >= 8): the raw gather products go to
  the K3 kernel (``kernels/attention.py``), with the per-group parameters
  folded into block-diagonal (D, D) weights at call time;
- per-group einsum (the compress blocks, nq = 1): plain tensor ops.
"""

from __future__ import annotations

import torch
from torch import nn

from ...kernels import attention as attention_kernel
from .layers import Dense

KEY_PAD_NEG = -100.0


class MixedScaleAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = tuple(int(h) for h in num_heads)
        self.compute_dtype = dtype
        per_head = embed_dim // sum(self.num_heads)
        for i, h in enumerate(self.num_heads):
            sd = per_head * h
            self.add_module(f"to_q_{i}", Dense(sd, sd, dtype=dtype))
            self.add_module(f"to_kv_{i}", Dense(sd, 2 * sd, dtype=dtype))
            self.add_module(f"proj_{i}", Dense(sd, sd, dtype=dtype))

    def _group(self, name, i):
        return getattr(self, f"{name}_{i}")

    def folded_projections(self):
        """Block-diagonal (wq, bq, wk, bk, wv, bv, wp, bp) in the flax (in,
        out) layout and the compute dtype; cross-group blocks are zero."""
        d = self.embed_dim
        per_head = d // sum(self.num_heads)
        dev = self.to_q_0.weight.device
        ws = [torch.zeros((d, d), device=dev) for _ in range(4)]
        bs = [torch.zeros((d,), device=dev) for _ in range(4)]
        start = 0
        for i, h in enumerate(self.num_heads):
            sd = per_head * h
            sl = slice(start, start + sd)
            kq = self._group("to_q", i)
            kkv = self._group("to_kv", i)
            kp = self._group("proj", i)
            ws[0][sl, sl] = kq.weight.t()
            bs[0][sl] = kq.bias
            ws[1][sl, sl] = kkv.weight[:sd].t()
            bs[1][sl] = kkv.bias[:sd]
            ws[2][sl, sl] = kkv.weight[sd:].t()
            bs[2][sl] = kkv.bias[sd:]
            ws[3][sl, sl] = kp.weight.t()
            bs[3][sl] = kp.bias
            start += sd
        dt = self.compute_dtype
        return tuple(t.to(dt).contiguous() for pair in zip(ws, bs)
                     for t in pair)

    def forward(self, query=None, keys=None, query_mask=None, key_masks=None,
                assembled=None):
        if self.training:
            raise NotImplementedError("attention training comes with the "
                                      "training slice (ROADMAP.md)")
        dt = self.compute_dtype
        if assembled is not None:
            a = assembled
            pad1 = a.get("pad1")
            pad_row = a.get("pad_row")
            out = attention_kernel.fused_window_attention_assembled(
                a["win1_fea"].contiguous(), a["k2_fea"].contiguous(),
                a["fps1"].to(torch.int32).contiguous(),
                (a["k_mask1"] if pad1 is None else pad1).contiguous(),
                None if a.get("q_ext") is None else
                a["q_ext"].to(dt).contiguous(),
                a["q_keep"].float().contiguous(),
                tuple(r.float().contiguous() for r in a["k_rel"]),
                tuple(r.float().contiguous() for r in a["q_rel"]),
                a["pos_base"].to(dt).contiguous(),
                a["pos_w"].to(dt).contiguous(),
                self.folded_projections(),
                torch.where(key_masks, KEY_PAD_NEG, 0.0).float().contiguous(),
                num_heads=self.num_heads,
                scale=(self.embed_dim // sum(self.num_heads)) ** -0.5,
                q_prefix=a.get("q_ext") is None, nq=int(a["nq"]),
                pad_row=None if pad_row is None else
                pad_row.to(dt).contiguous(),
                num_valid=a.get("num_valid"), compute_dtype=dt)
            if query_mask is not None:
                out = out * (~query_mask)[..., None].to(out.dtype)
            return out

        b, nq, _ = query.shape
        tot_nk = keys.shape[1]
        groups = len(self.num_heads)
        per_head = self.embed_dim // sum(self.num_heads)
        nk = tot_nk // groups
        scale = per_head ** -0.5
        outs = []
        start = 0
        for i, h in enumerate(self.num_heads):
            sd = per_head * h
            q = self._group("to_q", i)(query[..., start:start + sd])
            kv = self._group("to_kv", i)
            keys_i = keys[:, i * nk:(i + 1) * nk, start:start + sd].to(dt)
            w = kv.weight.to(dt)
            bias = kv.bias.to(dt)
            k = keys_i @ w[:sd].t() + bias[:sd]
            v = keys_i @ w[sd:].t() + bias[sd:]
            q = q.reshape(b, nq, h, per_head) * scale
            k = k.reshape(b, nk, h, per_head)
            v = v.reshape(b, nk, h, per_head)
            attn = torch.einsum("bqhc,bkhc->bhqk", q, k)
            if key_masks is not None:
                km = key_masks[:, i * nk:(i + 1) * nk]
                attn = attn + torch.where(km, KEY_PAD_NEG, 0.0)[
                    :, None, None, :].to(attn.dtype)
            attn = torch.softmax(attn.float(), dim=-1).to(attn.dtype)
            x = torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, nq, sd)
            outs.append(self._group("proj", i)(x))
            start += sd
        out = torch.cat(outs, dim=-1)
        if query_mask is not None:
            out = out * (~query_mask)[..., None].to(out.dtype)
        return out
