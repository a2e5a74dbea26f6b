"""Mixed-scale head-group attention (torch counterpart of
``mssvt_tpu/models/model_utils/attention.py``).

The embedding splits into head groups, one per window scale; group i
attends with its own q/kv projections (``to_q_i``, ``to_kv_i``, ``proj_i``)
over its own contiguous key stripe. Pad keys get an additive -100 (not
-inf), so an all-pad window gives a uniform, then query-masked, result.

Three routes, chosen as the JAX module chooses them on the TPU
(``_use_fused_kernel``):
- ``assembled`` with the inputs the trainable assembled kernel needs (at
  inference always; in training when the ref-compat ``pad1``/``pad_row`` and
  ``num_valid`` are present): the raw gather products go to
  ``AssembledAttention`` (``kernels/attention_bwd.py``), the K3 kernel
  forward and the K5 kernel backward;
- assembled tokens, nq >= 8 and no active dropout: ``FusedAttention``
  (``kernels/attention_qk_bwd.py``), the K6 kernel forward and the K7 kernel
  backward. This serves the plain ``query=/keys=`` call and training with
  ``ref_compat_keys: False``, where the block passes no pad inputs and the
  query and keys are assembled here in plain differentiable tensor ops
  (:meth:`MixedScaleAttention.assemble`);
- per-group einsum otherwise (nq < 8: the compress blocks with nq = 1;
  and every training call with dropout > 0, where JAX's
  ``_use_fused_kernel`` leaves the kernels, which carry no dropout), plain
  tensor ops differentiated by autograd.

For the kernels the per-group parameters fold into block-diagonal (D, D)
weights at call time (the folding is differentiable, so the kernels' full
(D, D) weight cotangents reach the per-group parameters through their
diagonal blocks).

With dropout > 0 in training, each group's attention weights and its
projection output go through ``layers.dropout`` (flax's ``attn_drop_i`` and
``proj_drop_i``), their masks drawn from the caller's ``torch.Generator``
in JAX's order. Dropout 0 (the configs' value) draws nothing and keeps the
kernel routes.
"""

from __future__ import annotations

import torch
from torch import nn

from ...kernels.attention_bwd import AssembledAttention
from ...kernels.attention_qk_bwd import FusedAttention
from ...ops.sampling import gather_along_batch
from .layers import Dense, dropout

KEY_PAD_NEG = -100.0
MIN_KERNEL_QUERIES = 8  # below it (the compress blocks) the einsum path runs


class MixedScaleAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = tuple(int(h) for h in num_heads)
        self.dropout = float(dropout)
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
        out) layout, f32 like the parameters; cross-group blocks are zero."""
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
        return tuple(t.contiguous() for pair in zip(ws, bs) for t in pair)

    def assemble(self, a):
        """(query, keys) from the raw gather products of ``assembled``, in
        plain differentiable tensor ops: the formulation the assembled
        kernel fuses (``kernels/attention.py``). keys = [the ``fps1`` picks
        of ``win1_fea``, zero at ``k_mask1`` (or zero at ``pad1`` plus the
        window's ``pad_row`` there) | ``k2_fea``] + pos(k_rel); query =
        ``win1_fea[:, :nq] * q_keep`` (or ``q_ext``) + pos(q_rel), with
        pos(rel) = relu(rx*w0 + ry*w1 + rz*w2 + pos_base)."""
        dt = self.compute_dtype
        win1 = a["win1_fea"]
        pw = a["pos_w"].to(dt)
        base = a["pos_base"].to(dt)[:, None, :]

        def pos(rel):
            rx, ry, rz = (r[..., None].to(dt) for r in rel)
            return torch.relu(rx * pw[0] + ry * pw[1] + rz * pw[2] + base)

        # the take's backward is the sorted, deterministic index_put_ (a
        # window's picks repeat a slot at most key_num_sample times)
        take = gather_along_batch(win1, a["fps1"])
        pad1 = a.get("pad1")
        if pad1 is not None:
            k1 = take * (~pad1)[..., None] + pad1[..., None].to(win1.dtype) \
                * a["pad_row"][:, None, :].to(win1.dtype)
        else:
            k1 = take * (~a["k_mask1"])[..., None]
        keys = torch.cat([k1, a["k2_fea"]], dim=1) + pos(a["k_rel"])
        if a.get("q_ext") is None:
            q_raw = win1[:, :int(a["nq"])] * a["q_keep"][..., None].to(win1.dtype)
        else:
            q_raw = a["q_ext"]
        return q_raw + pos(a["q_rel"]), keys

    def forward(self, query=None, keys=None, query_mask=None, key_masks=None,
                assembled=None, generator=None):
        dt = self.compute_dtype
        drop = self.training and self.dropout != 0.0
        if assembled is not None:
            a = assembled
            pad1 = a.get("pad1")
            pad_row = a.get("pad_row")
            if self.training and (drop or pad1 is None
                                  or a.get("num_valid") is None):
                # JAX's trainable assembled kernel needs the ref-compat
                # inputs and no dropout; else it assembles outside and
                # trains through its fused attention or, with dropout,
                # the einsum, as here
                query, keys = self.assemble(a)
                return self.forward(query=query, keys=keys,
                                    query_mask=query_mask, key_masks=key_masks,
                                    generator=generator)
            q_prefix = a.get("q_ext") is None
            static = (self.num_heads,
                      (self.embed_dim // sum(self.num_heads)) ** -0.5,
                      q_prefix, int(a["nq"]), dt)
            out = AssembledAttention.apply(
                static, a["win1_fea"].contiguous(), a["k2_fea"].contiguous(),
                None if q_prefix else a["q_ext"].to(dt).contiguous(),
                a["pos_base"].to(dt).contiguous(),
                a["pos_w"].to(dt).contiguous(),
                None if pad_row is None else pad_row.to(dt).contiguous(),
                *self.folded_projections(),
                a["fps1"].to(torch.int32).contiguous(),
                (a["k_mask1"] if pad1 is None else pad1).contiguous(),
                a["q_keep"].float().contiguous(),
                *(r.float().contiguous() for r in a["k_rel"]),
                *(r.float().contiguous() for r in a["q_rel"]),
                torch.where(key_masks, KEY_PAD_NEG, 0.0).float().contiguous(),
                a.get("num_valid"))
            if query_mask is not None:
                out = out * (~query_mask)[..., None].to(out.dtype)
            return out

        b, nq, _ = query.shape
        tot_nk = keys.shape[1]
        groups = len(self.num_heads)
        per_head = self.embed_dim // sum(self.num_heads)
        nk = tot_nk // groups
        scale = per_head ** -0.5
        if nq >= MIN_KERNEL_QUERIES and not drop:
            # K6 forward, K7 backward on the unsliced tokens
            if key_masks is not None:
                bias = torch.where(key_masks, KEY_PAD_NEG, 0.0).float()
            else:
                bias = torch.zeros((b, tot_nk), device=query.device)
            out = FusedAttention.apply(
                (self.num_heads, scale, dt), query.to(dt).contiguous(),
                keys.to(dt).contiguous(), *self.folded_projections(),
                bias.contiguous()).to(query.dtype)
            if query_mask is not None:
                out = out * (~query_mask)[..., None].to(out.dtype)
            return out
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
            attn = dropout(attn, self.dropout, self.training, generator)
            x = torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, nq, sd)
            outs.append(dropout(self._group("proj", i)(x), self.dropout,
                                self.training, generator))
            start += sd
        out = torch.cat(outs, dim=-1)
        if query_mask is not None:
            out = out * (~query_mask)[..., None].to(out.dtype)
        return out
