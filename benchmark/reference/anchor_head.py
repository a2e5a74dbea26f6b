"""SECOND's anchor head and post-processing as pcdet computes them, in
float32: ``AnchorHeadSingle`` (anchor_head_single.py:7-80) over pcdet's
``AnchorGenerator`` (anchor_generator.py:4-79), the ``ResidualCoder``'s
decode (box_coder_utils.py:40-75) with the direction bins
(anchor_head_template.py:221-240), and the class-agnostic NMS of
``Detector3DTemplate.post_processing`` (detector3d_template.py:178-284,
model_nms_utils.class_agnostic_nms): the class-max score, the score
threshold (``>=``), the ``NMS_PRE_MAXSIZE`` best and greedy rotated-IoU NMS.

Departures, each where pcdet leaves a choice open, a layout is the
program's or the seeded weights force it: the log sizes are clipped
before ``exp`` (:func:`decode`); the maps are NHWC and an anchor's row is
location-major ([y][x][class][rotation], which is what pcdet's
``view(-1, 7)`` of its per-class anchors concatenated on the size axis
gives); equal scores keep the lower anchor first (``torch.topk`` leaves
their order unspecified); the rotated IoU and the greedy scan are the
frozen plain copies in ``reference/detector/ops``; the outputs are padded
to ``NMS_POST_MAXSIZE`` a frame with a mask."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from benchmark.reference.detector.models.model_utils.layers import Conv2d
from benchmark.reference.detector.ops.nms import nms_bev


def anchors_of(anchor_cfgs, grid_size, pc_range):
    """(H * W * A, 7) anchors, location-major, and A, the anchors a
    location."""
    per_class = []
    for cfg in anchor_cfgs:
        stride = int(cfg["feature_map_stride"])
        nx, ny = grid_size[0] // stride, grid_size[1] // stride
        if cfg.get("align_center", False):
            xs = (pc_range[3] - pc_range[0]) / nx
            ys = (pc_range[4] - pc_range[1]) / ny
            x_off, y_off = xs / 2, ys / 2
        else:
            xs = (pc_range[3] - pc_range[0]) / (nx - 1)
            ys = (pc_range[4] - pc_range[1]) / (ny - 1)
            x_off = y_off = 0.0
        x = np.arange(nx) * xs + pc_range[0] + x_off
        y = np.arange(ny) * ys + pc_range[1] + y_off
        rows = []
        for h in cfg["anchor_bottom_heights"]:
            for size in cfg["anchor_sizes"]:
                for rot in cfg["anchor_rotations"]:
                    gy, gx = np.meshgrid(y, x, indexing="ij")
                    a = np.zeros((ny, nx, 7))
                    a[..., 0], a[..., 1] = gx, gy
                    a[..., 2] = h + size[2] / 2
                    a[..., 3:6] = size
                    a[..., 6] = rot
                    rows.append(a)
        per_class.append(np.stack(rows, 2))  # (ny, nx, k, 7)
    anchors = np.concatenate(per_class, 2)
    return torch.as_tensor(anchors.reshape(-1, 7), dtype=torch.float32), \
        anchors.shape[2]


def decode(deltas, anchors):
    """pcdet's ``ResidualCoder.decode`` (7 codes), the log sizes clipped
    to [-8, 8] before ``exp``: pcdet clips nothing, and with the seeded
    (untrained) weights the size residuals of a KITTI-size map reach ~40,
    where ``exp`` gives boxes of 1e16 m or inf; the clip is the port's
    (and the JAX package's), kept so that both sides decode one box. A
    trained model's residuals stay far inside it."""
    xa, ya, za, dxa, dya, dza, ra = torch.split(anchors, 1, dim=-1)
    xt, yt, zt, dxt, dyt, dzt, rt = torch.split(deltas, 1, dim=-1)
    diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * dza + za
    dxg = torch.exp(torch.clamp(dxt, -8, 8)) * dxa
    dyg = torch.exp(torch.clamp(dyt, -8, 8)) * dya
    dzg = torch.exp(torch.clamp(dzt, -8, 8)) * dza
    rg = rt + ra
    return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg], dim=-1)


class AnchorHeadSingle(nn.Module):
    """Three 1 x 1 convolutions (``conv_cls``, ``conv_box``, ``conv_dir``)
    over the BEV features, under the program's names."""

    def __init__(self, model_cfg, input_channels, num_class, grid_size,
                 pc_range):
        super().__init__()
        self.cfg = model_cfg
        self.num_class = num_class
        anchors, apl = anchors_of(model_cfg["ANCHOR_GENERATOR_CONFIG"],
                                  grid_size, pc_range)
        self.register_buffer("anchors", anchors, persistent=False)
        self.num_dir_bins = int(model_cfg["NUM_DIR_BINS"])
        self.conv_cls = Conv2d(input_channels, apl * num_class, 1)
        self.conv_box = Conv2d(input_channels, apl * 7, 1)
        self.conv_dir = Conv2d(input_channels, apl * self.num_dir_bins, 1)

    def forward(self, x):
        """(B, H, W, C) -> {cls_preds (B, N, classes), box_preds (B, N, 7),
        dir_cls_preds (B, N, bins)}."""
        x = x.float().permute(0, 3, 1, 2)
        b = x.shape[0]

        def rows(conv, width):
            return conv(x).permute(0, 2, 3, 1).reshape(b, -1, width)

        return {"cls_preds": rows(self.conv_cls, self.num_class),
                "box_preds": rows(self.conv_box, 7),
                "dir_cls_preds": rows(self.conv_dir, self.num_dir_bins)}

    def boxes(self, preds):
        """Decoded (B, N, 7) boxes with the direction bins, and (B, N,
        classes) sigmoid scores."""
        boxes = decode(preds["box_preds"], self.anchors[None])
        period = 2 * np.pi / self.num_dir_bins
        offset = float(self.cfg["DIR_OFFSET"])
        limit = float(self.cfg["DIR_LIMIT_OFFSET"])
        labels = torch.max(preds["dir_cls_preds"], dim=-1)[1]
        val = boxes[..., 6] - offset
        rot = val - torch.floor(val / period + limit) * period
        rot = rot + offset + period * labels.to(boxes.dtype)
        boxes = torch.cat([boxes[..., :6], rot[..., None]], dim=-1)
        return boxes, torch.sigmoid(preds["cls_preds"])


def post_process(head, preds, post_cfg):
    """(boxes (B, P, 7), scores (B, P), 1-based labels (B, P), mask (B, P))
    kept by the class-agnostic NMS, P = ``NMS_POST_MAXSIZE``."""
    nms = post_cfg["NMS_CONFIG"]
    boxes, cls = head.boxes(preds)
    scores, labels = torch.max(cls, dim=-1)
    sel, _ = nms_bev(boxes, scores, scores >= float(post_cfg["SCORE_THRESH"]),
                     float(nms["NMS_THRESH"]), int(nms["NMS_PRE_MAXSIZE"]),
                     int(nms["NMS_POST_MAXSIZE"]))
    ok = sel >= 0
    idx = sel.clamp(min=0).long()
    take = lambda t: torch.gather(t, 1, idx)  # noqa: E731
    kept_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))
    return (kept_boxes * ok[..., None], take(scores) * ok,
            (take(labels) + 1).to(torch.int32) * ok, ok)


def candidates(head, preds):
    """Every anchor's decoded box, its class-max score and 1-based label,
    and a heading weight of 1 (the heading is the anchor's plus a residual
    and a bin, never an ill-conditioned angle)."""
    boxes, cls = head.boxes(preds)
    scores, labels = torch.max(cls, dim=-1)
    return (boxes, scores, (labels + 1).to(torch.int32),
            torch.ones_like(scores))

