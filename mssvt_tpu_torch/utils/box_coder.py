"""Box coders (torch counterparts of ``ResidualCoder`` and the two legacy
``PreviousResidual*Decoder``s of ``mssvt_tpu/utils/box_coder.py``; ref:
pcdet/utils/box_coder_utils.py:5-141). ``PointResidualCoder`` is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch


def _split(t, n):
    return [t[..., i:i + 1] for i in range(n)]


class ResidualCoder:
    """Anchor deltas with log dims, the heading as a residual or (with
    ``encode_angle_by_sincos``) as the cos/sin differences; extra box
    columns past 7 as plain differences."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False):
        self.code_size = code_size
        self.encode_angle_by_sincos = encode_angle_by_sincos
        if self.encode_angle_by_sincos:
            self.code_size += 1

    def encode(self, boxes, anchors):
        """boxes/anchors (..., 7+) -> (..., code_size)."""
        xa, ya, za, dxa, dya, dza, ra = _split(anchors[..., :7], 7)
        xg, yg, zg, dxg, dyg, dzg, rg = _split(boxes[..., :7], 7)
        dxa, dya, dza, dxg, dyg, dzg = (torch.clamp(t, min=1e-5) for t in (
            dxa, dya, dza, dxg, dyg, dzg))
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xt = (xg - xa) / diagonal
        yt = (yg - ya) / diagonal
        zt = (zg - za) / dza
        dxt = torch.log(dxg / dxa)
        dyt = torch.log(dyg / dya)
        dzt = torch.log(dzg / dza)
        if self.encode_angle_by_sincos:
            rt = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rt = [rg - ra]
        extras = [boxes[..., 7 + i:8 + i] - anchors[..., 7 + i:8 + i]
                  for i in range(boxes.shape[-1] - 7)]
        return torch.cat([xt, yt, zt, dxt, dyt, dzt, *rt, *extras], dim=-1)

    def decode(self, encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = _split(anchors[..., :7], 7)
        # zero-dim (padded) anchors: clipped as in encode
        dxa, dya, dza = (torch.clamp(t, min=1e-5) for t in (dxa, dya, dza))
        if self.encode_angle_by_sincos:
            xt, yt, zt, dxt, dyt, dzt = _split(encodings[..., :6], 6)
            cost, sint = encodings[..., 6:7], encodings[..., 7:8]
            extras = encodings[..., 8:]
        else:
            xt, yt, zt, dxt, dyt, dzt, rt = _split(encodings[..., :7], 7)
            extras = encodings[..., 7:]
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = torch.exp(torch.clamp(dxt, -8, 8)) * dxa
        dyg = torch.exp(torch.clamp(dyt, -8, 8)) * dya
        dzg = torch.exp(torch.clamp(dzt, -8, 8)) * dza
        if self.encode_angle_by_sincos:
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            rg = rt + ra
        extra_list = [extras[..., i:i + 1] + anchors[..., 7 + i:8 + i]
                      for i in range(extras.shape[-1])]
        return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg, *extra_list], dim=-1)


class PreviousResidualDecoder:
    """Legacy decoder of old checkpoints (ref: box_coder_utils.py:78-107):
    encodings (x, y, z, w, l, h, r) with the w/l swap ``dxg = exp(lt) *
    dxa``, ``dyg = exp(wt) * dya`` and no clip on the exponents."""

    def __init__(self, code_size=7, **kwargs):
        self.code_size = code_size

    @staticmethod
    def decode(box_encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = _split(anchors[..., :7], 7)
        xt, yt, zt, wt, lt, ht, rt = _split(box_encodings[..., :7], 7)
        cas = _split(anchors[..., 7:], anchors.shape[-1] - 7)
        cts = _split(box_encodings[..., 7:], box_encodings.shape[-1] - 7)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = torch.exp(lt) * dxa
        dyg = torch.exp(wt) * dya
        dzg = torch.exp(ht) * dza
        rg = rt + ra
        cgs = [t + a for t, a in zip(cts, cas)]
        return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg, *cgs], dim=-1)


class PreviousResidualRoIDecoder:
    """Legacy RoI decoder: :class:`PreviousResidualDecoder` with the heading
    decoded as ``ra - rt`` (ref: box_coder_utils.py:110-141)."""

    def __init__(self, code_size=7, **kwargs):
        self.code_size = code_size

    @staticmethod
    def decode(box_encodings, anchors):
        out = PreviousResidualDecoder.decode(box_encodings, anchors)
        rg = anchors[..., 6:7] - box_encodings[..., 6:7]
        return torch.cat([out[..., :6], rg, out[..., 7:]], dim=-1)
