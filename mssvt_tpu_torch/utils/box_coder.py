"""Box coders (torch counterparts of ``ResidualCoder``, the two legacy
``PreviousResidual*Decoder``s and ``PointResidualCoder`` of
``mssvt_tpu/utils/box_coder.py``; ref: pcdet/utils/box_coder_utils.py:5-222).
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


def encode_point_residual(gt_boxes, points, anchor=None, min_anchor=None):
    """(..., 7+C) boxes at (..., 3) points -> (..., 8+C) point-anchored codes,
    the heading as cos/sin (ref: box_coder_utils.py:144-222). With
    ``anchor`` ((..., 3) mean sizes at the points): offsets over the mean
    size's diagonal (z over its height) and log dims against it, the anchor
    floored at ``min_anchor`` in the log dims where given; without it,
    plain offsets and log dims. The one encoder of ``PointResidualCoder``
    and ``PointHeadBox``."""
    dims = torch.clamp(gt_boxes[..., 3:6], min=1e-5)
    xg, yg, zg = _split(gt_boxes[..., :3], 3)
    dxg, dyg, dzg = _split(dims, 3)
    rg, cgs = gt_boxes[..., 6:7], gt_boxes[..., 7:]
    xa, ya, za = _split(points[..., :3], 3)
    if anchor is not None:
        dxa, dya, dza = _split(anchor, 3)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xt, yt, zt = (xg - xa) / diagonal, (yg - ya) / diagonal, \
            (zg - za) / dza
        if min_anchor is not None:
            dxa, dya, dza = _split(torch.clamp(anchor, min=min_anchor), 3)
        dxt, dyt, dzt = (torch.log(dxg / dxa), torch.log(dyg / dya),
                         torch.log(dzg / dza))
    else:
        xt, yt, zt = xg - xa, yg - ya, zg - za
        dxt, dyt, dzt = torch.log(dxg), torch.log(dyg), torch.log(dzg)
    return torch.cat([xt, yt, zt, dxt, dyt, dzt, torch.cos(rg),
                      torch.sin(rg), cgs], dim=-1)


def decode_point_residual(box_encodings, points, anchor=None,
                          max_log_dim=None):
    """(..., 8+C) codes at (..., 3) points -> (..., 7+C) boxes: the inverse
    of :func:`encode_point_residual`, the log dims clipped to
    [-``max_log_dim``, ``max_log_dim``] where given."""
    e = box_encodings
    xt, yt, zt, dxt, dyt, dzt, cost, sint = _split(e[..., :8], 8)
    if max_log_dim is not None:
        dxt, dyt, dzt = _split(torch.clamp(e[..., 3:6], -max_log_dim,
                                           max_log_dim), 3)
    xa, ya, za = _split(points[..., :3], 3)
    if anchor is not None:
        dxa, dya, dza = _split(anchor, 3)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg, yg, zg = xt * diagonal + xa, yt * diagonal + ya, zt * dza + za
        dxg, dyg, dzg = (torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
                         torch.exp(dzt) * dza)
    else:
        xg, yg, zg = xt + xa, yt + ya, zt + za
        dxg, dyg, dzg = torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)
    return torch.cat([xg, yg, zg, dxg, dyg, dzg, torch.atan2(sint, cost),
                      e[..., 8:]], dim=-1)


class PointResidualCoder:
    """Point-anchored coder with the heading as cos/sin (ref:
    box_coder_utils.py:144-222): :func:`encode_point_residual` and
    :func:`decode_point_residual` against the class's mean size
    (``use_mean_size``), or plain offsets and log dims."""

    def __init__(self, code_size=8, use_mean_size=True, mean_size=None,
                 **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        if use_mean_size:
            self.mean_size = torch.as_tensor(mean_size, dtype=torch.float32)
            if not float(self.mean_size.min()) > 0:
                raise ValueError("PointResidualCoder: mean sizes must be > 0")

    def _anchor(self, classes, like):
        if not self.use_mean_size:
            return None
        return self.mean_size.to(like.device)[
            torch.clamp(classes.long() - 1, min=0)]

    def encode(self, gt_boxes, points, gt_classes=None):
        """(N, 7+C) boxes x (N, 3) points [+ (N,) classes in [1, K]] ->
        (N, 8+C)."""
        return encode_point_residual(gt_boxes, points,
                                     self._anchor(gt_classes, gt_boxes))

    def decode(self, box_encodings, points, pred_classes=None):
        """(N, 8+C) x (N, 3) [+ (N,) classes] -> (N, 7+C)."""
        return decode_point_residual(box_encodings, points,
                                     self._anchor(pred_classes, box_encodings))
