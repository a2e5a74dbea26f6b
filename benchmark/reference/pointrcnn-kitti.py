"""Plain reference of ``pointrcnn-kitti``: PointRCNN as OpenPCDet's
``point_rcnn.py`` runs it on KITTI (``PointNet2MSG``, ``PointHeadBox``
with its ``PointResidualCoder`` decode against the class mean sizes, the
proposal layer, ``PointRCNNHead`` and the refinement), in float32 with
TF32 off (``benchmark/run.py`` turns it off for the process), independent
of the port and its kernels: the farthest-point sampling and the rotated
NMS are the frozen plain copies in ``reference/detector``, every ball query
``point_voxel.ball_query``; the 3-NN, the interpolation, the RoI point pool
and the MLPs are written out here, under the program's module and
parameter names, so that both sides take the same weights.

Departures from pcdet, each noted where it is made:

- the port's eval ending, which the JAX package fixes: the refined RoIs
  are the detections, scored by the sigmoid of the RoI head's logit, with
  no further NMS (as ``pvrcnnpp-kitti``'s reference);
- the raw points are each frame's first 16 384 in range in scan order
  (the port's loader; pcdet's ``sample_points`` keeps the far ones and
  draws the near ones at random);
- the program computes in bfloat16 (``MODEL.DTYPE``), this file in
  float32;
- the proposals' scores are the sigmoid of the class-max logit (pcdet
  keeps the logit; the ranking is the same), the point boxes' log sizes
  and the RoI residuals' are clipped at +-8 before ``exp`` (the port's
  decode: with the seeded weights they reach tens);
- an empty ball query pools zeros (pcdet's batch ball query repeats point
  0; no query is empty in the cell, each centre being one of its points);
- a point is inside a RoI on its faces, and its distances, depth and
  canonical coordinates are computed in the program's order of operations
  (pcdet's kernel adds a 1e-5 margin), so that both sides put the same
  floats on either side of a face or a radius;
- the features are laid out point by point, not channel-major; the
  weights are the benchmark's, drawn from the seed.

``judge`` holds the program's captured outputs against it stage by stage,
each reference stage fed the program's output of the one before, in the
harness's five numbers (``harness/compare.py``) and four of its own:

- ``fps_gap``: the share of FPS rows (the backbone's four set
  abstractions and the RoI head's two) whose picks are not the frozen
  plain FPS's on the program's points of that level; ``query_gap``: the
  share of ball queries (every radius of every level) whose members differ
  from ``point_voxel.ball_query``'s on the program's points and centres.
  Both are integer work and must be 0;
- ``backbone_rel``: the worst ``|p - r| / |r|`` of the set abstractions'
  features (each level from the program's points, centres and features of
  the level before); infinite where ``fps_gap`` or ``query_gap`` is not 0;
- ``bev_rel``: PointRCNN has no BEV map; the name stands for the stage
  between the encoder and the heads, here the four feature propagation
  levels (each from the program's coarser level), the worst;
- ``roi_rel``: the RoI head: the pooled points in their canonical frame
  (from the program's points, features, class scores and RoIs), ``xyz_up``
  (from the program's pool), ``merge_down``, each set abstraction inside
  the RoIs, each tower layer (``cls_fc_i``, ``reg_fc_i``; each BatchNorm
  takes the program's product, since a seeded channel's variance can be
  tiny and would multiply the bf16 rounding before it) and the class and
  box outputs, the last over the size of their products' terms
  (``rel_to_terms``: a logit is one sum a RoI, which cancels);
  ``head_rel`` is the worst of the point head's (each tower layer, its
  logits and box codes, as the RoI head's towers) and ``roi_rel``;
- ``det_gap`` and ``count_gap``, the worse of two: the program's
  detections against the refinement of its RoI head's outputs in its RoIs,
  and the program's proposals against this proposal layer (decode,
  class-max, the ``NMS_PRE_MAXSIZE`` best, rotated NMS) of the program's
  point head outputs."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch
from torch import nn

from benchmark.harness import compare, spec
from benchmark.reference import point_voxel
from benchmark.reference.detector.models.model_utils.layers import (
    BatchNorm,
    Dense,
)
from benchmark.reference.detector.ops.nms import nms_bev
from benchmark.reference.detector.ops.sampling import farthest_point_sample

NUMBERS = ("backbone_rel", "fps_gap", "query_gap", "bev_rel", "head_rel",
           "roi_rel", "det_gap", "count_gap")
# the RoI heads' refinement and the last layers' error over their terms, as
# PV-RCNN++'s reference computes them
_TWO_STAGE = spec.load_module(Path(__file__).with_name("pvrcnnpp-kitti.py"))
detections = _TWO_STAGE.detections
rel_to_terms = _TWO_STAGE.rel_to_terms
# (queries x known points) of a 3-NN slab at most
BLOCK = 1 << 24
LOG_CLIP = 8.0


class SharedMLP(nn.Module):
    """Pointwise ``mlp_i`` (no bias) + ``bn_i`` + ReLU; without ``use_bn``
    ``mlp_i`` with a bias + ReLU."""

    def __init__(self, in_channels, channels, use_bn=True):
        super().__init__()
        self.n, self.use_bn = len(channels), use_bn
        for i, c in enumerate(channels):
            self.add_module(f"mlp_{i}", Dense(in_channels, c,
                                              bias=not use_bn))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(c, 1e-3,
                                                     channels_last=True))
            in_channels = c
        self.out_channels = in_channels

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"mlp_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = torch.relu(x)
        return x


class BallQuery(nn.Module):
    """``point_voxel.ball_query`` a row: (B, N, 3) support, (B, M, 3)
    centres -> (idx (B, M, nsample) int32, empty (B, M))."""

    def __init__(self, radius, nsample):
        super().__init__()
        self.radius, self.nsample = float(radius), int(nsample)

    def forward(self, xyz, new_xyz, valid=None):
        if valid is None:
            valid = torch.ones(xyz.shape[:2], dtype=torch.bool,
                               device=xyz.device)
        idx, empty = [], []
        for b in range(xyz.shape[0]):
            i, count = point_voxel.ball_query(self.radius, self.nsample,
                                              xyz[b], valid[b], new_xyz[b])
            idx.append(i)
            empty.append(count == 0)
        return torch.stack(idx).to(torch.int32), torch.stack(empty)


def rows_of(values, idx):
    """(B, N, C) values at (B, ...) indices -> (B, ..., C)."""
    b, c = values.shape[0], values.shape[-1]
    flat = idx.long().reshape(b, -1)
    out = torch.gather(values, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(tuple(idx.shape) + (c,))


class SAModule(nn.Module):
    """pcdet's ``PointnetSAModuleMSG`` (``PointnetSAModule`` for one
    radius): FPS centres, a ball query, the grouped rows (xyz relative to
    the centre, then the features), a shared MLP, max over the neighbours;
    ``npoint`` None or below 0 is ``GroupAll`` (every point, its xyz as it
    is). Submodules ``query_j`` and ``mlp_g{j}``."""

    def __init__(self, npoint, radii, nsamples, mlps, in_channels,
                 use_bn=True):
        super().__init__()
        self.npoint = None if npoint is None or int(npoint) < 0 \
            else int(npoint)
        self.n_groups = len(mlps)
        for j, mlp in enumerate(mlps):
            self.add_module(f"mlp_g{j}", SharedMLP(in_channels + 3, mlp,
                                                   use_bn))
            if self.npoint is not None:
                self.add_module(f"query_{j}", BallQuery(radii[j],
                                                        nsamples[j]))

    def sample(self, xyz):
        """The frozen plain FPS's (B, npoint) int32 picks."""
        return farthest_point_sample(xyz, self.npoint)

    def pool(self, xyz, feats, valid, new_xyz):
        """The centres' pooled features (B, M, C_out) and each radius's
        (idx, empty)."""
        outs, queries = [], []
        for j in range(self.n_groups):
            idx, empty = getattr(self, f"query_{j}")(xyz, new_xyz, valid)
            queries.append((idx, empty))
            g = torch.cat([rows_of(xyz, idx) - new_xyz[:, :, None],
                           rows_of(feats, idx)], -1)
            keep = (~empty)[..., None]
            h = getattr(self, f"mlp_g{j}")(g * keep[..., None])
            outs.append(h.amax(2) * keep)
        return torch.cat(outs, -1), queries

    def forward(self, xyz, feats, valid=None):
        if self.npoint is None:
            h = self.mlp_g0(torch.cat([xyz, feats], -1)[:, None])
            return None, h.amax(2), None
        picks = self.sample(xyz)
        new_xyz = rows_of(xyz, picks)
        return new_xyz, self.pool(xyz, feats, valid, new_xyz)[0], picks


def three_nn(unknown, known):
    """pcdet's ``three_nn`` on one frame: (n, 3), (m, 3) -> squared
    distances (n, 3) ascending (ties to the lower index) and indices (n,
    3), the distances by subtraction, in blocks of queries."""
    ds, idxs = [], []
    step = max(1, BLOCK // max(1, known.shape[0]))
    for q0 in range(0, unknown.shape[0], step):
        u = unknown[q0:q0 + step]
        d = None
        for i in range(3):
            e = u[:, i, None] - known[None, :, i]
            d = e * e if d is None else d + e * e
        picked_d, picked_i = [], []
        for _ in range(min(3, known.shape[0])):
            i = torch.argmin(d, dim=1, keepdim=True)
            picked_d.append(torch.gather(d, 1, i))
            picked_i.append(i)
            d = d.scatter(1, i, float("inf"))
        ds.append(torch.cat(picked_d, 1))
        idxs.append(torch.cat(picked_i, 1))
    return torch.cat(ds), torch.cat(idxs)


class FPModule(nn.Module):
    """pcdet's ``PointnetFPModule``: each unknown point's 3 nearest known
    points weighted by 1 / (distance + 1e-8), normalised; the
    interpolated features, then the point's own, through ``mlp``."""

    def __init__(self, in_channels, mlp):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        out = []
        for b in range(unknown.shape[0]):
            d2, idx = three_nn(unknown[b], known[b])
            w = 1.0 / (torch.sqrt(d2) + 1e-8)
            w = w / w.sum(1, keepdim=True)
            kf = known_feats[b]
            out.append(sum(kf[idx[:, j]] * w[:, j, None]
                           for j in range(idx.shape[1])))
        x = torch.stack(out)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], -1)
        return self.mlp(x)


class PointNet2MSG(nn.Module):
    """The set abstractions ``sa_i`` and the feature propagations
    ``fp_i``."""

    def __init__(self, cfg, input_channels):
        super().__init__()
        sa = cfg["SA_CONFIG"]
        widths = [int(input_channels)]
        self.n_sa = len(sa["NPOINTS"])
        for i, npoint in enumerate(sa["NPOINTS"]):
            self.add_module(f"sa_{i}", SAModule(
                npoint, sa["RADIUS"][i], sa["NSAMPLE"][i], sa["MLPS"][i],
                widths[-1]))
            widths.append(sum(int(m[-1]) for m in sa["MLPS"][i]))
        fp = cfg["FP_MLPS"]
        self.n_fp = len(fp)
        up = widths[self.n_fp]
        for i in range(self.n_fp - 1, -1, -1):
            self.add_module(f"fp_{i}", FPModule(up + widths[i], fp[i]))
            up = int(fp[i][-1])

    def forward(self, xyz, feats, valid):
        xyz_list, feat_list, v = [xyz], [feats], valid
        for i in range(self.n_sa):
            new_xyz, f, _ = getattr(self, f"sa_{i}")(xyz_list[-1],
                                                     feat_list[-1], v)
            xyz_list.append(new_xyz)
            feat_list.append(f)
            v = None
        for i in range(self.n_fp - 1, -1, -1):
            feat_list[i] = getattr(self, f"fp_{i}")(
                xyz_list[i], xyz_list[i + 1], feat_list[i], feat_list[i + 1])
        return feat_list[0]


class Towers(nn.Module):
    """pcdet's ``make_fc_layers`` a tower: ``{t}_fc_i`` (no bias),
    ``{t}_bn_i``, ReLU, then ``{t}_out``."""

    def __init__(self, towers, input_channels):
        super().__init__()
        self.towers = tuple(towers)
        self.depth = {}
        for t, (fcs, out) in towers.items():
            c = input_channels
            for i, fc in enumerate(fcs):
                self.add_module(f"{t}_fc_{i}", Dense(c, fc, bias=False))
                self.add_module(f"{t}_bn_{i}", BatchNorm(fc, 1e-3,
                                                         channels_last=True))
                c = fc
            self.add_module(f"{t}_out", Dense(c, out))
            self.depth[t] = len(fcs)

    def hidden(self, t, i, fc):
        """Layer ``i``'s output of tower ``t`` from its ``{t}_fc_i``'s."""
        return torch.relu(getattr(self, f"{t}_bn_{i}")(fc))

    def tower(self, t, x):
        for i in range(self.depth[t]):
            x = self.hidden(t, i, getattr(self, f"{t}_fc_{i}")(x))
        return getattr(self, f"{t}_out")(x)


class PointHeadBox(Towers):
    """A point's class logits and its 8 box codes."""

    def __init__(self, cfg, input_channels, num_class):
        super().__init__({"cls": (cfg["CLS_FC"], num_class),
                          "reg": (cfg["REG_FC"], 8)}, input_channels)

    def forward(self, x):
        return self.tower("cls", x), self.tower("reg", x)


def decode_points(codes, xyz, labels, mean_sizes):
    """pcdet's ``PointResidualCoder.decode_torch`` with mean sizes: (B, N,
    8) codes at (B, N, 3) points of 1-based ``labels`` -> (B, N, 7)."""
    xt, yt, zt, dxt, dyt, dzt, cost, sint = torch.split(codes, 1, dim=-1)
    xa, ya, za = torch.split(xyz, 1, dim=-1)
    anchor = mean_sizes[(labels.long() - 1).clamp(min=0)]
    dxa, dya, dza = torch.split(anchor, 1, dim=-1)
    diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
    clip = lambda t: torch.clamp(t, -LOG_CLIP, LOG_CLIP)  # noqa: E731
    return torch.cat([xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                      torch.exp(clip(dxt)) * dxa, torch.exp(clip(dyt)) * dya,
                      torch.exp(clip(dzt)) * dza, torch.atan2(sint, cost)],
                     dim=-1)


class Proposals(nn.Module):
    """pcdet's ``proposal_layer`` in eval on the point head's outputs: each
    point's decoded box, the class-max score, the ``NMS_PRE_MAXSIZE``
    best, greedy rotated NMS, ``NMS_POST_MAXSIZE`` RoIs a frame -> (rois
    (B, R, 7), scores, 1-based labels, valid)."""

    def __init__(self, roi_cfg, mean_sizes):
        super().__init__()
        self.nms = roi_cfg["NMS_CONFIG"]["TEST"]
        self.register_buffer("mean_sizes", torch.tensor(
            mean_sizes, dtype=torch.float32), persistent=False)

    def candidates(self, xyz, valid, cls, reg):
        """(boxes (B, N, 7), scores (B, N), 1-based labels (B, N) int32,
        heading weights (B, N): ``min(1, |(cos, sin)|)`` of the codes)."""
        labels = (torch.argmax(cls, -1) + 1).to(torch.int32)
        scores = torch.sigmoid(cls).amax(-1) * valid
        boxes = decode_points(reg, xyz, labels, self.mean_sizes)
        return (boxes, scores, labels,
                torch.linalg.vector_norm(reg[..., 6:8], dim=-1).clamp(max=1))

    def forward(self, xyz, valid, cls, reg):
        boxes, scores, labels, _ = self.candidates(xyz, valid, cls, reg)
        sel, _ = nms_bev(boxes, scores, valid, float(self.nms["NMS_THRESH"]),
                         int(self.nms["NMS_PRE_MAXSIZE"]),
                         int(self.nms["NMS_POST_MAXSIZE"]))
        ok = sel >= 0
        idx = sel.clamp(min=0).long()
        rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))
        return (rois * ok[..., None], torch.gather(scores, 1, idx) * ok,
                torch.gather(labels, 1, idx) * ok, ok)


class RoIPointPool(nn.Module):
    """pcdet's ``roipool3d_gpu``: each point's [xyz, class score, depth /
    ``DEPTH_NORMALIZER`` - 0.5, features] inside each RoI
    (``POOL_EXTRA_WIDTH`` 0: the RoIs as they are), the first
    ``NUM_SAMPLED_POINTS`` in index order wrapped modulo the count, the xyz
    in the RoI's canonical frame, an empty RoI zero -> (pooled (B, R, K, 5
    + C), empty (B, R))."""

    def __init__(self, pool_cfg):
        super().__init__()
        self.k = int(pool_cfg["NUM_SAMPLED_POINTS"])
        self.normalizer = float(pool_cfg["DEPTH_NORMALIZER"])

    def members(self, xyz, valid, rois):
        """(B, R, N) bool: the valid points inside each RoI, faces
        included, in the program's order of operations."""
        size = rois[..., 3:6]
        local = xyz[:, None, :, :] - rois[:, :, None, :3]
        c = torch.cos(-rois[..., 6])[..., None]
        s = torch.sin(-rois[..., 6])[..., None]
        lx = local[..., 0] * c - local[..., 1] * s
        ly = local[..., 0] * s + local[..., 1] * c
        half = size[:, :, None] / 2
        return ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1])
                & (local[..., 2].abs() <= half[..., 2]) & valid[:, None])

    def forward(self, xyz, feats, valid, scores, rois):
        x, y, z = xyz.unbind(-1)
        depth = torch.sqrt(x * x + y * y + z * z) / self.normalizer - 0.5
        n = xyz.shape[1]
        inside = self.members(xyz, valid, rois)
        count = inside.sum(-1).clamp(max=self.k)
        ar = torch.arange(n, device=xyz.device)
        first = torch.where(inside, ar, n).topk(min(self.k, n), dim=-1,
                                                largest=False).values
        slot = torch.arange(self.k, device=xyz.device)
        wrap = slot % count.clamp(min=1)[..., None]
        idx = torch.gather(first, -1, wrap).clamp(max=n - 1)
        rows = torch.cat([xyz, scores[..., None], depth[..., None], feats], -1)
        b, r = rois.shape[:2]
        pooled = rows_of(rows, idx.reshape(b, -1)).reshape(b, r, self.k, -1)
        local = pooled[..., :3] - rois[:, :, None, :3]
        h = rois[..., 6][..., None]
        c, s = torch.cos(-h), torch.sin(-h)
        canon = torch.stack([local[..., 0] * c - local[..., 1] * s,
                             local[..., 0] * s + local[..., 1] * c,
                             local[..., 2]], -1)
        empty = count == 0
        out = torch.cat([canon, pooled[..., 3:]], -1)
        return out * (~empty)[..., None, None], empty


class PointRCNNHead(Towers):
    """``pool``, ``xyz_up``, ``merge_down``, the set abstractions ``sa_k``
    inside every RoI, the towers (one class, 7 residuals)."""

    def __init__(self, cfg, point_channels):
        super().__init__({"cls": (cfg["CLS_FC"], 1),
                          "reg": (cfg["REG_FC"], 7)},
                         int(cfg["SA_CONFIG"]["MLPS"][-1][-1]))
        self.pool = RoIPointPool(cfg["ROI_POINT_POOL"])
        use_bn = bool(cfg["USE_BN"])
        up = [int(c) for c in cfg["XYZ_UP_LAYER"]]
        self.xyz_up = SharedMLP(5, up, use_bn)
        self.merge_down = SharedMLP(up[-1] + point_channels, [up[-1]], use_bn)
        sa = cfg["SA_CONFIG"]
        c = up[-1]
        self.n_sa = len(sa["NPOINTS"])
        for k, npoint in enumerate(sa["NPOINTS"]):
            self.add_module(f"sa_{k}", SAModule(
                npoint, [sa["RADIUS"][k]], [sa["NSAMPLE"][k]],
                [sa["MLPS"][k]], c, use_bn))
            c = int(sa["MLPS"][k][-1])

    def outputs(self, x, roi_valid):
        m = roi_valid.float()
        b, r = roi_valid.shape
        return (self.tower("cls", x).reshape(b, r) * m,
                self.tower("reg", x).reshape(b, r, -1) * m[..., None])

    def forward(self, xyz, feats, valid, scores, rois, roi_valid):
        pooled, _ = self.pool(xyz, feats, valid, scores, rois)
        b, r, k, _ = pooled.shape
        pooled = pooled.reshape(b * r, k, -1)
        x = self.xyz_up(pooled[..., :5])
        x = self.merge_down(torch.cat([x, pooled[..., 5:]], -1))
        l_xyz = pooled[..., :3]
        for i in range(self.n_sa):
            l_xyz, x, _ = getattr(self, f"sa_{i}")(l_xyz, x)
        return self.outputs(x[:, 0], roi_valid)


class PointRCNN(nn.Module):
    def __init__(self, config, batch):
        super().__init__()
        model, data = config["MODEL"], config["data"]
        self.batch_size = batch
        self.max_points = int(model["MAX_POINTS"])
        c_in = int(data["num_point_features"]) - 3
        self.backbone_3d = PointNet2MSG(model["BACKBONE_3D"], c_in)
        c_pt = int(model["BACKBONE_3D"]["FP_MLPS"][0][-1])
        head = model["POINT_HEAD"]
        self.point_head = PointHeadBox(head, c_pt, len(config["class_names"]))
        self.roi_head = PointRCNNHead(model["ROI_HEAD"], c_pt)
        self.proposals = Proposals(model["ROI_HEAD"], head["MEAN_SIZES"])

    def points(self, batch):
        """The raw points by frame: (xyz (B, P, 3), features (B, P, C - 3),
        valid (B, P)), the padding rows zeroed."""
        pts = batch["points"].reshape(self.batch_size, self.max_points,
                                      -1).float()
        valid = batch["points_valid"].reshape(self.batch_size,
                                              self.max_points)
        m = valid[..., None].float()
        return pts[..., :3] * m, pts[..., 3:] * m, valid

    def forward(self, batch, post=True):
        xyz, feats, valid = self.points(batch)
        pf = self.backbone_3d(xyz, feats, valid)
        cls, reg = self.point_head(pf)
        rois, _, labels, roi_valid = self.proposals(xyz, valid, cls, reg)
        scores = torch.sigmoid(cls).amax(-1) * valid
        rcls, rreg = self.roi_head(xyz, pf, valid, scores, rois, roi_valid)
        if not post:
            return cls, reg, rcls, rreg
        fb, fs, fl, fm = detections(rois, labels, roi_valid, rcls, rreg)
        return {"final_boxes": fb, "final_scores": fs, "final_labels": fl,
                "final_mask": fm}


def _sa_paths(prefix, owner):
    out = []
    for i in range(owner.n_sa):
        sa = getattr(owner, f"sa_{i}")
        out.append(f"{prefix}sa_{i}")
        if sa.npoint is not None:
            out += [f"{prefix}sa_{i}.query_{j}" for j in range(sa.n_groups)]
    return out


def _tower_paths(prefix, towers):
    return [f"{prefix}{t}_fc_{i}" for t in towers.towers
            for i in range(towers.depth[t])]


def capture(model):
    """The module paths whose outputs ``judge`` holds: every set
    abstraction and its ball queries, the feature propagations, the point
    head and its tower layers, the proposals, the RoI head's pool,
    ``xyz_up``, ``merge_down``, set abstractions and tower layers, and the
    RoI head."""
    b3d, rh = model.backbone_3d, model.roi_head
    return tuple(
        _sa_paths("backbone_3d.", b3d)
        + [f"backbone_3d.fp_{i}" for i in range(b3d.n_fp)]
        + ["point_head"] + _tower_paths("point_head.", model.point_head)
        + ["proposals", "roi_head.pool", "roi_head.xyz_up",
           "roi_head.merge_down"] + _sa_paths("roi_head.", rh)
        + _tower_paths("roi_head.", rh) + ["roi_head"])


def build(config, batch, device):
    return PointRCNN(config, batch).to(device).eval()


def forward(model, batch, post=True):
    """The detector's eval forward; without ``post`` the two stages'
    outputs before the refinement (the weights' calibration sets every
    BatchNorm of both stages)."""
    with torch.no_grad():
        return model(batch, post=post)


def candidates(model, batch, cls, reg):
    """The proposal layer's candidates of the point head's outputs ``cls``,
    ``reg``: every point's decoded box, its class-max score, 1-based label
    and heading weight."""
    xyz, _, valid = model.points(batch)
    return model.proposals.candidates(xyz, valid, cls, reg)


def _differ(a, b):
    """The share of rows (the last axis) of two index tensors that
    differ."""
    a, b = a.long(), b.to(a.device).long()
    return float((a != b).any(-1).float().mean()) if a.numel() else 0.0


def _set_abstractions(prefix, owner, xyz, feats, valid, got, f32):
    """(rels, fps gap, query gap, the program's last features) of the set
    abstractions under ``owner``, each fed the program's level before."""
    rels, fps_gap, query_gap = [], 0.0, 0.0
    for i in range(owner.n_sa):
        sa = getattr(owner, f"sa_{i}")
        p_xyz, p_feat, p_picks = got[f"{prefix}sa_{i}"]
        p_feat = f32(p_feat)
        if sa.npoint is None:
            r = sa(xyz, feats)[1]
        else:
            fps_gap = max(fps_gap, _differ(p_picks, sa.sample(xyz)))
            p_xyz = f32(p_xyz)
            r, queries = sa.pool(xyz, feats, valid, p_xyz)
            for j, (idx, _) in enumerate(queries):
                query_gap = max(query_gap, _differ(
                    got[f"{prefix}sa_{i}.query_{j}"][0], idx))
        rels.append(compare.rel(p_feat, r))
        xyz, feats, valid = p_xyz, p_feat, None
    return rels, fps_gap, query_gap, feats


def _towers(prefix, towers, x, got, f32, outputs, mask=None):
    """Each tower layer from the program's layer before, then the outputs
    (``outputs``: the program's, one a tower) over their terms."""
    rels = []
    for t, p_out in zip(towers.towers, outputs):
        h = x
        for i in range(towers.depth[t]):
            p_h = f32(got[f"{prefix}{t}_fc_{i}"])
            rels.append(compare.rel(p_h, getattr(towers, f"{t}_fc_{i}")(h)))
            h = towers.hidden(t, i, p_h)
        rels.append(rel_to_terms([p_out], [getattr(towers, f"{t}_out")], h,
                                 mask))
    return rels


def judge(model, batch, got, dets):
    """The numbers of ``NUMBERS`` for one batch: ``got`` holds the
    program's outputs at ``capture(model)``, ``dets`` its detections."""
    dev = batch["points"].device
    f32 = lambda t: t.to(dev, torch.float32)  # noqa: E731
    with torch.no_grad():
        xyz, feats, valid = model.points(batch)
        b3d = model.backbone_3d
        sa_rel, fps_gap, query_gap, _ = _set_abstractions(
            "backbone_3d.", b3d, xyz, feats, valid, got, f32)
        lx, lf = [xyz], [feats]
        for i in range(b3d.n_sa):
            p_xyz, p_feat, _ = got[f"backbone_3d.sa_{i}"]
            lx.append(f32(p_xyz))
            lf.append(f32(p_feat))
        fp_rel, up = [], lf[b3d.n_fp]
        for i in range(b3d.n_fp - 1, -1, -1):
            p_fp = f32(got[f"backbone_3d.fp_{i}"])
            fp_rel.append(compare.rel(p_fp, getattr(b3d, f"fp_{i}")(
                lx[i], lx[i + 1], lf[i], up)))
            up = p_fp
        pf = up
        p_cls, p_reg = (f32(t) for t in got["point_head"])
        ph = model.point_head
        point_rel = _towers("point_head.", ph, pf, got, f32, (p_cls, p_reg),
                            valid.float())

        rois, roi_scores, labels, roi_valid = (t.to(dev)
                                               for t in got["proposals"])
        rois = rois.float()
        rh = model.roi_head
        scores = torch.sigmoid(p_cls).amax(-1) * valid
        p_pooled, _ = got["roi_head.pool"]
        p_pooled = f32(p_pooled)
        roi = [compare.rel(p_pooled, rh.pool(xyz, pf, valid, scores,
                                             rois)[0])]
        b, r, k, _ = p_pooled.shape
        pooled = p_pooled.reshape(b * r, k, -1)
        p_up = f32(got["roi_head.xyz_up"])
        roi.append(compare.rel(p_up, rh.xyz_up(pooled[..., :5])))
        p_md = f32(got["roi_head.merge_down"])
        roi.append(compare.rel(p_md, rh.merge_down(
            torch.cat([p_up, pooled[..., 5:]], -1))))
        head_sa, g_fps, g_query, last = _set_abstractions(
            "roi_head.", rh, pooled[..., :3], p_md, None, got, f32)
        roi += head_sa
        fps_gap, query_gap = max(fps_gap, g_fps), max(query_gap, g_query)
        p_rcls, p_rreg = (f32(t) for t in got["roi_head"])
        roi += _towers("roi_head.", rh, last[:, 0], got, f32,
                       (p_rcls.reshape(b * r, 1), p_rreg.reshape(b * r, -1)),
                       roi_valid.float().reshape(-1))
        out = {"fps_gap": fps_gap, "query_gap": query_gap,
               "bev_rel": max(fp_rel), "roi_rel": max(roi)}
        exact = fps_gap == 0 and query_gap == 0
        out["backbone_rel"] = max(sa_rel) if exact else math.inf
        out["head_rel"] = max(max(point_rel), out["roi_rel"])

        kept = detections(rois, labels, roi_valid, p_rcls, p_rreg)
        cands = (kept[0], kept[1], kept[2], torch.ones_like(kept[1]))
        props = (rois, f32(roi_scores), labels, roi_valid)
        ref_props = model.proposals(xyz, valid, p_cls, p_reg)
        det = [compare.det_gap(dets, kept, cands),
               compare.det_gap(props, ref_props, model.proposals.candidates(
                   xyz, valid, p_cls, p_reg))]
        count = [compare.count_gap(dets[3], kept[3]),
                 compare.count_gap(roi_valid, ref_props[3])]
        out["det_gap"], out["count_gap"] = max(det), max(count)
        inside = rh.pool.members(xyz, valid, rois).sum(-1)[roi_valid]
        held = inside.float() / valid.sum(1, keepdim=True).expand_as(
            roi_valid)[roi_valid].float()
        print(f"# pointrcnn-kitti live RoIs a frame "
              f"{roi_valid.sum(1).tolist()}, valid raw rows "
              f"{valid.sum(1).tolist()}; points in a live RoI: median "
              f"{int(inside.median()) if len(inside) else 0}, RoIs holding "
              f"over half their frame's points "
              f"{int((held > 0.5).sum())}/{len(held)}; fps_gap {fps_gap!r}, "
              f"query_gap {query_gap!r}; set abstractions "
              f"{', '.join(f'{v:.3g}' for v in sa_rel)}; feature "
              f"propagations {', '.join(f'{v:.3g}' for v in fp_rel)}; point "
              f"head {', '.join(f'{v:.3g}' for v in point_rel)}; RoI head "
              f"(pool, xyz_up, merge_down, set abstractions, towers) "
              f"{', '.join(f'{v:.3g}' for v in roi)}; det_gap, count_gap "
              f"(detections, proposals) {det!r}, {count!r}; reference RoIs a "
              f"frame {ref_props[3].sum(1).tolist()}",
              file=sys.stderr, flush=True)
        return out
