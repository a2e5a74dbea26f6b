"""CT3D's DETR-style refinement transformer (torch counterpart of
``mssvt_tpu/models/model_utils/ctrans.py``; ref:
pcdet/models/model_utils/ctrans.py:40-348).

- :class:`CTransformer`: post-norm encoder layers over a RoI's sampled
  points (self-attention with q = k = src + pos, v = src), then decoder
  layers for the learned queries: self-attention, CT3D's channel-wise
  cross-attention, a FFN, each followed by add + LayerNorm; ``dec_norm``
  last.
- :class:`_ChannelWiseAttention`: scores per (channel, key), the key
  scaled by its total query affinity, softmaxed over the keys; each output
  channel its own convex combination of that channel's values, then a
  Linear(dim -> 1) over the head's channel axis.

The einsums are the JAX module's, and so is every parameter: the
attentions' ``q_w`` ... ``out_w`` are raw (in, out) matrices, the
channel-wise projections' ``proj_*_w`` raw (out, in) and ``down_w`` raw
(dim, 1), each under its flax name and orientation (``bridge.py`` copies
bare parameters as they are). Batch-first throughout, no dropout (the JAX
module has none).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Dense, LayerNorm


def _xavier(shape, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2 - 1) * limit


class MLP(nn.Module):
    """Linear stack with ReLU between the layers (``layer{i}``)."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers,
                 dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1],
                                               dtype=dtype))

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"layer{i}")(x))
        return getattr(self, f"layer{self.num_layers - 1}")(x)


def _mha(q, k, v, wq, wk, wv, wo, num_heads):
    """torch ``nn.MultiheadAttention``'s core, batch-first, no dropout;
    each ``w*`` a ((in, out) weight, bias) pair."""
    b, nq, d = q.shape
    nk = k.shape[1]
    h = num_heads
    ph = d // h
    qh = (q @ wq[0] + wq[1]).reshape(b, nq, h, ph)
    kh = (k @ wk[0] + wk[1]).reshape(b, nk, h, ph)
    vh = (v @ wv[0] + wv[1]).reshape(b, nk, h, ph)
    attn = torch.einsum("bqhc,bkhc->bhqk", qh * ph ** -0.5, kh)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhqk,bkhc->bqhc", attn, vh).reshape(b, nq, d)
    return out @ wo[0] + wo[1]


class _SelfAttention(nn.Module):
    """Multi-head attention with torch MHA semantics; raw (in, out)
    ``{q,k,v,out}_w`` and ``{q,k,v,out}_b``."""

    NAMES = ("q", "k", "v", "out")

    def __init__(self, d_model, nhead, dtype=torch.float32):
        super().__init__()
        self.d_model, self.nhead, self.compute_dtype = d_model, nhead, dtype
        for n in self.NAMES:
            setattr(self, f"{n}_w", nn.Parameter(torch.zeros(d_model, d_model)))
            setattr(self, f"{n}_b", nn.Parameter(torch.zeros(d_model)))

    def flax_init(self, generator):
        """flax's ``xavier_uniform`` weights and zero biases."""
        d = self.d_model
        with torch.no_grad():
            for n in self.NAMES:
                getattr(self, f"{n}_w").copy_(_xavier((d, d), d, d, generator))
                getattr(self, f"{n}_b").zero_()

    def forward(self, q, k, v):
        dt = self.compute_dtype
        w = {n: (getattr(self, f"{n}_w").to(dt), getattr(self, f"{n}_b").to(dt))
             for n in self.NAMES}
        return _mha(q.to(dt), k.to(dt), v.to(dt), w["q"], w["k"], w["v"],
                    w["out"], self.nhead)


class _ChannelWiseAttention(nn.Module):
    """CT3D's decoder cross-attention (ref: ctrans.py:207-236) on
    channel-first (b, d_model, n) inputs; raw (out, in) ``proj_{q,k,v}_w``,
    raw (dim, 1) ``down_w``. Returns (b, d_model, 1)."""

    PROJ = ("proj_q", "proj_k", "proj_v")

    def __init__(self, d_model, nhead, dtype=torch.float32):
        super().__init__()
        self.d_model, self.nhead, self.compute_dtype = d_model, nhead, dtype
        dim = d_model // nhead
        for n in self.PROJ:
            setattr(self, f"{n}_w", nn.Parameter(torch.zeros(d_model, d_model)))
            setattr(self, f"{n}_b", nn.Parameter(torch.zeros(d_model)))
        self.down_w = nn.Parameter(torch.zeros(dim, 1))
        self.down_b = nn.Parameter(torch.zeros(1))

    def flax_init(self, generator):
        """flax's ``xavier_uniform`` weights and zero biases."""
        d, dim = self.d_model, self.d_model // self.nhead
        with torch.no_grad():
            for n in self.PROJ:
                getattr(self, f"{n}_w").copy_(_xavier((d, d), d, d, generator))
                getattr(self, f"{n}_b").zero_()
            self.down_w.copy_(_xavier((dim, 1), dim, 1, generator))
            self.down_b.zero_()

    def forward(self, q_cf, k_cf, v_cf):
        d, h = self.d_model, self.nhead
        dim = d // h
        dt = self.compute_dtype

        def proj(name, x):  # torch Conv1d(d, d, 1) on (b, d, n)
            w = getattr(self, f"{name}_w").to(dt)
            b_ = getattr(self, f"{name}_b").to(dt)
            y = torch.einsum("oc,bcn->bon", w, x.to(dt)) + b_[None, :, None]
            return y.reshape(y.shape[0], dim, h, y.shape[2])

        q = proj("proj_q", q_cf)
        k = proj("proj_k", k_cf)
        v = proj("proj_v", v_cf)
        scores_1 = torch.einsum("bdhn,bdhm->bhnm", q, k) / dim ** 0.5
        scores_2 = k * scores_1.sum(dim=2)[:, None, :, :]  # (b, dim, h, m)
        prob = torch.softmax(scores_2, dim=-1)
        out = torch.einsum("behm,bdhm->bdhe", prob, v)  # (b, dim, h, dim)
        x = out @ self.down_w.to(dt) + self.down_b.to(dt)  # (b, dim, h, 1)
        return x.reshape(x.shape[0], dim * h, 1)


class _EncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dtype=torch.float32):
        super().__init__()
        self.self_attn = _SelfAttention(d_model, nhead, dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)

    def forward(self, src, pos):
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src))
        src2 = self.linear2(torch.relu(self.linear1(src)))
        return self.norm2(src + src2)


class _DecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dtype=torch.float32):
        super().__init__()
        self.self_attn = _SelfAttention(d_model, nhead, dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.multihead_attn = _ChannelWiseAttention(d_model, nhead, dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype=dtype)

    def forward(self, tgt, memory, pos, query_pos):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        t2_cf = self.multihead_attn((tgt + query_pos).transpose(1, 2),
                                    (memory + pos).transpose(1, 2),
                                    memory.transpose(1, 2))
        tgt = self.norm2(tgt + t2_cf.transpose(1, 2))  # (b, 1, d)
        tgt2 = self.linear2(torch.relu(self.linear1(tgt)))
        return self.norm3(tgt + tgt2)


class CTransformer(nn.Module):
    """Ref ``Transformer`` (ctrans.py:40-80), the post-norm DETR variant:
    ``forward(src, pos=None)`` takes (b, n, d) RoI point tokens and returns
    the decoder output for the learned queries, (b, num_queries, d); the
    cross-attention pools to one token, so CT3D's ``num_queries`` is 1."""

    def __init__(self, d_model=256, nhead=4, num_encoder_layers=3,
                 num_decoder_layers=3, dim_feedforward=512, num_queries=1,
                 dtype=torch.float32):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        for i in range(num_encoder_layers):
            self.add_module(f"enc{i}", _EncoderLayer(
                d_model, nhead, dim_feedforward, dtype))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, d_model))
        for i in range(num_decoder_layers):
            self.add_module(f"dec{i}", _DecoderLayer(
                d_model, nhead, dim_feedforward, dtype))
        self.dec_norm = LayerNorm(d_model, dtype=dtype)

    def flax_init(self, generator):
        """flax's ``normal(1.0)`` query embedding."""
        with torch.no_grad():
            self.query_embed.copy_(torch.randn(self.query_embed.shape,
                                               generator=generator))

    def forward(self, src, pos=None):
        b, _, d = src.shape
        if pos is None:  # ref ct3d_head.py:181 passes zeros_like(src)
            pos = torch.zeros_like(src)
        memory = src
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"enc{i}")(memory, pos)
        qe = self.query_embed[None].to(memory.dtype).expand(b, -1, -1)
        tgt = torch.zeros_like(qe)
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"dec{i}")(tgt, memory, pos, qe)
        return self.dec_norm(tgt)
