"""CT3D's refinement head (torch counterpart of
``mssvt_tpu/models/roi_heads/ct3d_head.py``; ref:
pcdet/models/roi_heads/ct3d_head.py:27-195).

- :func:`sample_roi_points`: per RoI the first ``num_points`` raw points (in
  point order, where the reference draws a seeded random subset) inside a
  BEV cylinder of 1.2 x the RoI's half diagonal; an underfull RoI repeats
  its first point, an empty one stays zero (ref :135-160).
- each point's vectors to the RoI's 8 corners and centre in spherical
  coordinates (distance over the RoI's diagonal, phi, theta) plus its
  intensity (:69-110), through the ``up_dimension`` MLP (28 -> 64 -> 64 ->
  hidden), :class:`CTransformer`, then ``class_embed`` and the
  ``bbox_embed`` MLP.

``_spherical`` keeps the JAX module's gradient guards (the padded RoI
rows are exact zeros, where sqrt and arccos have infinite derivatives):
without them the backward of an empty RoI is NaN. Nothing stops the
gradient into the RoIs (their corners, centre and diagonal).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..model_utils.ctrans import MLP, CTransformer
from ..model_utils.layers import Dense

# the 8 corners in binary counting order, z fastest (ref :84-96)
_DENSE = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
          (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


def _corner_points(rois):
    """(..., 7) RoIs -> (..., 8, 3) corners in the global frame."""
    dense = torch.tensor(_DENSE, dtype=rois.dtype, device=rois.device)
    lwh = rois[..., None, 3:6]
    local = dense * lwh - lwh / 2  # (..., 8, 3)
    ry = rois[..., 6:7]
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x = local[..., 0:1] * c - local[..., 1:2] * s
    y = local[..., 0:1] * s + local[..., 1:2] * c
    rot = torch.cat([x, y, local[..., 2:3]], dim=-1)
    return rot + rois[..., None, 0:3]


def sample_roi_points(points, points_valid, rois, num_sample: int):
    """(B, P, C >= 4) points, (B, P) valid, (B, R, 7) RoIs -> (B, R,
    num_sample, 4): the top ``num_sample`` of the keys ``P - index`` over
    the hits (the first hits in point order), padding slots the first
    pick's row, all zero where a RoI holds no point."""
    xyz = points[..., :3]
    radii = torch.sqrt((rois[..., 3] / 2) ** 2 + (rois[..., 4] / 2) ** 2) * 1.2
    d2 = ((xyz[:, None, :, :2] - rois[:, :, None, :2]) ** 2).sum(-1)  # B,R,P
    hit = (d2 <= radii[..., None] ** 2) & points_valid[:, None, :]
    p = points.shape[1]
    order = p - torch.arange(p, dtype=torch.int32, device=points.device)
    key = torch.where(hit, order, -1)
    topv, topi = torch.topk(key, num_sample, dim=-1)  # descending: idx asc
    ok = topv > 0
    b = points.shape[0]
    rows = points[torch.arange(b, device=points.device)[:, None, None],
                  topi.long(), :4] * ok[..., None]  # (B, R, S, 4)
    return torch.where(ok[..., None], rows, rows[:, :, 0:1])


def _spherical(rel, diag):
    """(N, S, 27) xyz-interleaved vectors -> (N, S, 27) [9 distances /
    diag, 9 phi, 9 theta] (ref :98-110), NaN-free gradients at zero
    vectors."""
    x = rel[..., 0::3]
    y = rel[..., 1::3]
    z = rel[..., 2::3]
    r2 = x * x + y * y + z * z
    nz = r2 > 1e-12
    dis = torch.sqrt(torch.where(nz, r2, 1.0)) * nz
    phi = torch.arctan(y / (x + 1e-5))
    the = torch.arccos(torch.clamp(z / (dis + 1e-5), -1.0 + 1e-6, 1.0 - 1e-6))
    return torch.cat([dis / (diag + 1e-5), phi, the], dim=-1)


class CT3DHead(nn.Module):
    """(points, RoIs) -> per RoI (class logit (B, R), box residuals (B, R,
    code_size)), zero where ``roi_valid`` is not set."""

    def __init__(self, model_cfg: Any, code_size: int = 7,
                 dtype=torch.float32):
        super().__init__()
        tcfg = model_cfg.get("Transformer", {})
        self.num_sample = int(tcfg.get("num_points", 256))
        hidden = int(tcfg.get("hidden_dim", 256))
        self.code_size = code_size
        self.up_dimension = MLP(28, 64, hidden, 3, dtype=dtype)
        self.transformer = CTransformer(
            d_model=hidden, nhead=int(tcfg.get("nheads", 4)),
            num_encoder_layers=int(tcfg.get("enc_layers", 3)),
            num_decoder_layers=int(tcfg.get("dec_layers", 3)),
            dim_feedforward=int(tcfg.get("dim_feedforward", 512)),
            num_queries=int(tcfg.get("num_queries", 1)), dtype=dtype)
        self.class_embed = Dense(hidden, 1, dtype=dtype)
        self.bbox_embed = MLP(hidden, hidden, code_size, 4, dtype=dtype)

    def forward(self, points, points_valid, rois, roi_valid):
        b, r = rois.shape[:2]
        s = self.num_sample
        src = sample_roi_points(points, points_valid, rois, s)
        src = src.reshape(b * r, s, 4)
        rois_flat = rois.reshape(b * r, -1)
        corners = _corner_points(rois_flat)  # (BR, 8, 3)
        keypts = torch.cat([corners.reshape(b * r, 24), rois_flat[:, :3]], -1)
        rel = src[:, :, :3].repeat(1, 1, 9) - keypts[:, None, :]  # (BR, S, 27)
        d2 = (rois_flat[:, 3:6] ** 2).sum(-1)
        big = d2 > 1e-12
        diag = (torch.sqrt(torch.where(big, d2, 1.0)) * big)[:, None, None]
        feats = torch.cat([_spherical(rel, diag), src[:, :, 3:4]], dim=-1)
        hs = self.transformer(self.up_dimension(feats))  # (BR, 1, hidden)
        tok = hs[:, 0]
        cls = self.class_embed(tok)
        reg = self.bbox_embed(tok)
        keep = roi_valid.reshape(b * r, 1).to(cls.dtype)
        return ((cls * keep).reshape(b, r).float(),
                (reg * keep).reshape(b, r, self.code_size).float())
