"""Mixed-scale head-group attention, plain route only (frozen copy of the
port's ``MixedScaleAttention``): the block's raw gather products are
assembled into query and keys in plain tensor ops (:meth:`assemble`,
the formulation the assembled kernel fuses) and every call then runs the
per-group einsum attention. Pad keys get an additive -100 (not -inf), so
an all-pad window gives a uniform, then query-masked, result."""

from __future__ import annotations

import torch
from torch import nn

from ...ops.sampling import gather_along_batch
from .layers import Dense, dropout

KEY_PAD_NEG = -100.0


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
        if assembled is not None:
            query, keys = self.assemble(assembled)
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
            attn = dropout(attn, self.dropout, self.training, generator)
            x = torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, nq, sd)
            outs.append(dropout(self._group("proj", i)(x), self.dropout,
                                self.training, generator))
            start += sd
        out = torch.cat(outs, dim=-1)
        if query_mask is not None:
            out = out * (~query_mask)[..., None].to(out.dtype)
        return out
