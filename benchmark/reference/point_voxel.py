"""PV-RCNN++'s second stage as OpenPCDet computes it, in float32 plain
``torch``: the keypoints (``VoxelSetAbstraction``'s SPC sampling,
voxel_set_abstraction.py:45-121), their features (the BEV map's bilinear
sample, the raw points' ball query and shared MLP, the vector pool of a
sparse stage, vector_pool_gpu.cu; the fusion), ``PointHeadSimple`` and
``PVRCNNHead``'s RoI-grid pooling, shared FCs and refinement
(pvrcnn_head.py, roi_head_template.py), under the program's module and
parameter names, so that both sides take the same weights.

Every ball query is computed here: the first ``nsample`` support points
with squared distance below ``radius ** 2`` in index order (the smallest
indices of the hits, ``topk``), the slots past the hits repeating the
first, in blocks of queries that keep a (queries x support) slab under
:data:`BLOCK` elements. The sample radius test, the sectors and the masked
FPS are the frozen plain copies of ``reference/detector/ops/sampling.py``.

Departures from pcdet, each where pcdet's order is the program's layout,
the JAX package's (which the port follows) or rounding: a sum of squares
and a grid point are computed in the program's order of operations (so
that both sides put the same floats on either side of a radius); the
pooled features are laid out grid point by grid point (the program's
``Dense`` layout; pcdet's is channel-major); the keypoints pool one sparse
source (the final stage, ``x_conv_out``) and the 2-D backbone's map; the
sectors take equal quotas, then one FPS over their union; the sites of a
sparse stage are taken in the order the stage's rows hold them (pcdet's
ball query takes its first hits in its tensor's order, which spconv leaves
open)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.detector.models.model_utils.layers import (
    BatchNorm,
    Dense,
)
from benchmark.reference.detector.ops.sampling import (
    sample_points_with_roi,
    sector_fps,
)

# a (queries x support points) slab, and a grouped (queries x nsample x
# channels) one, at most
BLOCK = 1 << 24


def ball_query(radius, nsample, support, support_valid, queries):
    """One frame: (N, 3) support points, (N,) bool, (M, 3) queries -> idx
    (M, nsample) int64 (0 for a query with no hit), the hits each query
    keeps (M,) (at most ``nsample``)."""
    n = support.shape[0]
    k = min(nsample, n)
    idxs, counts = [], []
    step = max(1, BLOCK // max(n, 1))
    ar = torch.arange(n, device=support.device)
    for q0 in range(0, queries.shape[0], step):
        q = queries[q0:q0 + step]
        d2 = None
        for i in range(3):
            d = q[:, i, None] - support[None, :, i]
            d2 = d * d if d2 is None else d2 + d * d
        hit = (d2 < radius ** 2) & support_valid[None]
        del d2
        first = torch.where(hit, ar, n).topk(k, dim=1, largest=False).values
        count = hit.sum(1).clamp(max=nsample)
        if k < nsample:
            first = torch.cat([first, first[:, :1].expand(-1, nsample - k)], 1)
        slot = torch.arange(nsample, device=q.device)
        idx = torch.where(slot[None] < count[:, None], first, first[:, :1])
        idxs.append(torch.where(count[:, None] == 0, 0, idx))
        counts.append(count)
    return torch.cat(idxs), torch.cat(counts)


class SharedMLP(nn.Module):
    """Pointwise ``mlp_i`` (no bias), ``bn_i``, ReLU."""

    def __init__(self, in_channels, channels):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"mlp_{i}", Dense(in_channels, c, bias=False))
            self.add_module(f"bn_{i}", BatchNorm(c, 1e-3, channels_last=True))
            in_channels = c
        self.out_channels = in_channels

    def forward(self, x):
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"mlp_{i}")(x)))
        return x


def grouped_max(radius, nsample, support, feats, valid, queries, mlp):
    """pcdet's ``QueryAndGroup`` + shared MLP + max over the neighbours,
    (B, N, 3), (B, N, C), (B, N), (B, M, 3) -> (B, M, C_out); zero for a
    query with no neighbour."""
    out = []
    c = 3 + feats.shape[-1]
    for b in range(support.shape[0]):
        idx, count = ball_query(radius, nsample, support[b], valid[b],
                                queries[b])
        empty = count == 0
        rows = []
        step = max(1, BLOCK // (nsample * c))
        for q0 in range(0, len(idx), step):
            i = idx[q0:q0 + step]
            g = torch.cat([support[b][i] - queries[b][q0:q0 + step, None],
                           feats[b][i]], -1)
            g = g * (~empty[q0:q0 + step])[:, None, None]
            rows.append(mlp(g).amax(1) * (~empty[q0:q0 + step])[:, None])
        out.append(torch.cat(rows))
    return torch.stack(out)


def vector_pool(radius, nsample, grid, support, feats, valid, queries):
    """pcdet's vector pool (``VectorPoolAggregationModule`` with a local
    ``grid`` ^ 3 grid over [-radius, radius] ^ 3): each cell's mean
    relative xyz and mean features of the query's ball neighbours,
    concatenated cell by cell (zero where a cell is empty) -> (B, M, grid ^
    3 * (3 + C)), and empty (B, M)."""
    g3 = grid ** 3
    c = feats.shape[-1]
    out, empties = [], []
    for b in range(support.shape[0]):
        idx, count = ball_query(radius, nsample, support[b], valid[b],
                                queries[b])
        m = len(idx)
        empty = count == 0
        # each hit once: the slots past the hits repeat the first
        real = torch.arange(nsample, device=idx.device)[None] < count[:, None]
        rel = support[b][idx] - queries[b][:, None]
        u = torch.clamp(((rel / radius + 1.0) * 0.5 * grid).to(torch.int64),
                        0, grid - 1)
        cell = (u[..., 0] * grid + u[..., 1]) * grid + u[..., 2]
        flat = (torch.arange(m, device=idx.device)[:, None] * g3 + cell)[real]
        sums = rel.new_zeros(m * g3, 3 + c)
        sums.index_add_(0, flat, torch.cat([rel, feats[b][idx]], -1)[real])
        cnt = rel.new_zeros(m * g3).index_add_(
            0, flat, torch.ones_like(flat, dtype=rel.dtype))
        mean = sums / cnt.clamp(min=1.0)[:, None]
        out.append(mean.reshape(m, g3 * (3 + c)))
        empties.append(empty)
    return torch.stack(out), torch.stack(empties)


def bilinear_bev(bev, xy, pc_range, stride_metric):
    """(B, H, W, C) map at (B, K, 2) metric points, bilinear over the cell
    centres, corners off the map reading zero (``grid_sample``)."""
    _, h, w, _ = bev.shape
    gx = 2 * (xy[..., 0] - pc_range[0]) / stride_metric[0] / w - 1
    gy = 2 * (xy[..., 1] - pc_range[1]) / stride_metric[1] / h - 1
    grid = torch.stack([gx, gy], -1)[:, None]  # (B, 1, K, 2)
    out = F.grid_sample(bev.permute(0, 3, 1, 2).float(), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out[:, :, 0].permute(0, 2, 1)


def sites_by_frame(features, coords, valid, batch_size, voxel, pc_range):
    """The live rows of a sparse stage's (N, C) features and (N, 4) (b, z,
    y, x) coords laid out by frame in their row order: (xyz (B, M, 3) of
    the cell centres, features (B, M, C), valid (B, M))."""
    c = coords.long()
    rows = [torch.nonzero(valid & (c[:, 0] == b))[:, 0]
            for b in range(batch_size)]
    m = max(1, max(len(r) for r in rows))
    dev = features.device
    xyz = torch.zeros(batch_size, m, 3, device=dev)
    out = torch.zeros(batch_size, m, features.shape[1], device=dev)
    ok = torch.zeros(batch_size, m, dtype=torch.bool, device=dev)
    for b, r in enumerate(rows):
        cx = c[r][:, [3, 2, 1]].float()
        xyz[b, :len(r)] = torch.stack(
            [(cx[:, i] + 0.5) * voxel[i] + pc_range[i] for i in range(3)], -1)
        out[b, :len(r)] = features[r].float()
        ok[b, :len(r)] = True
    return xyz, out, ok


class VoxelSetAbstraction(nn.Module):
    """The keypoints and their fused features: ``raw_mlp_i`` a radius of
    the raw points, ``x_conv_out_vp_fc_i`` / ``x_conv_out_vp_bn_i`` a radius
    of the vector pool, ``vsa_point_fc`` / ``vsa_bn``."""

    def __init__(self, pfe_cfg, point_channels, source_channels, bev_stride,
                 voxel_size, pc_range):
        super().__init__()
        self.cfg = pfe_cfg
        self.num_keypoints = int(pfe_cfg["NUM_KEYPOINTS"])
        spc = pfe_cfg["SPC_SAMPLING"]
        self.sectors = int(spc["NUM_SECTORS"])
        self.sample_radius = float(spc["SAMPLE_RADIUS_WITH_ROI"])
        self.pc_range = tuple(pc_range)
        self.bev_metric = (voxel_size[0] * bev_stride,
                           voxel_size[1] * bev_stride)
        raw = pfe_cfg["SA_LAYER"]["raw_points"]
        self.raw = list(zip(raw["POOL_RADIUS"], raw["NSAMPLE"]))
        for i, mlp in enumerate(raw["MLPS"]):
            self.add_module(f"raw_mlp_{i}", SharedMLP(3 + point_channels, mlp))
        vp = pfe_cfg["SA_LAYER"]["x_conv_out"]
        self.grid = int(vp["GRID_SIZE"])
        self.vp = list(zip(vp["POOL_RADIUS"], vp["NSAMPLE"]))
        for i, mlp in enumerate(vp["MLPS"]):
            out = int(mlp[-1])
            self.add_module(f"x_conv_out_vp_fc_{i}", Dense(
                self.grid ** 3 * (3 + source_channels), out, bias=False))
            self.add_module(f"x_conv_out_vp_bn_{i}",
                            BatchNorm(out, 1e-3, channels_last=True))

    def build_fuse(self, bev_channels):
        c = bev_channels
        c += sum(getattr(self, f"raw_mlp_{i}").out_channels
                 for i in range(len(self.raw)))
        c += sum(getattr(self, f"x_conv_out_vp_fc_{i}").out_features
                 for i in range(len(self.vp)))
        out = int(self.cfg["NUM_OUTPUT_FEATURES"])
        self.vsa_point_fc = Dense(c, out, bias=False)
        self.vsa_bn = BatchNorm(out, 1e-3, channels_last=True)

    def keypoints(self, xyz, valid, rois, roi_valid):
        """SPC: the points near a proposal, a masked FPS a sector, one over
        the union -> (B, K, 3)."""
        near = sample_points_with_roi(xyz, valid, rois[..., :7], roi_valid,
                                      self.sample_radius)
        picks = sector_fps(xyz, near, self.num_keypoints, self.sectors)
        return torch.gather(xyz, 1, picks.long()[..., None].expand(-1, -1, 3))

    def sources(self, kp, xyz, feat, valid, sites, bev):
        """The concatenated sources (B, K, C) of keypoints ``kp``: the BEV
        map, the raw points ``(xyz, feat, valid)``, the sparse stage
        ``sites`` (xyz, features, valid by frame)."""
        parts = [bilinear_bev(bev, kp[..., :2], self.pc_range,
                              self.bev_metric)]
        parts += [grouped_max(float(r), int(ns), xyz, feat, valid, kp,
                              getattr(self, f"raw_mlp_{i}"))
                  for i, (r, ns) in enumerate(self.raw)]
        sx, sf, sv = sites
        for i, (r, ns) in enumerate(self.vp):
            pooled, empty = vector_pool(float(r), int(ns), self.grid, sx, sf,
                                        sv, kp)
            h = getattr(self, f"x_conv_out_vp_bn_{i}")(
                getattr(self, f"x_conv_out_vp_fc_{i}")(pooled))
            parts.append(torch.relu(h) * (~empty)[..., None])
        return torch.cat(parts, -1)

    def fuse(self, fc):
        """The fused features of ``vsa_point_fc``'s output."""
        return torch.relu(self.vsa_bn(fc))

    def forward(self, points, sites, bev, rois, roi_valid):
        xyz, feat, valid = points
        kp = self.keypoints(xyz, valid, rois, roi_valid)
        cat = self.sources(kp, xyz, feat, valid, sites, bev)
        return kp, self.fuse(self.vsa_point_fc(cat)), cat


class PointHeadSimple(nn.Module):
    """``cls_fc_i`` (no bias), ``cls_bn_i``, ReLU, then ``cls_out``: a
    keypoint's foreground logit."""

    def __init__(self, head_cfg, input_channels):
        super().__init__()
        self.n = len(head_cfg["CLS_FC"])
        for i, c in enumerate(head_cfg["CLS_FC"]):
            self.add_module(f"cls_fc_{i}", Dense(input_channels, c, bias=False))
            self.add_module(f"cls_bn_{i}", BatchNorm(c, 1e-3,
                                                     channels_last=True))
            input_channels = c
        self.cls_out = Dense(input_channels, 1)

    def hidden(self, i, fc):
        """Layer ``i``'s output from its ``cls_fc_i``'s."""
        return torch.relu(getattr(self, f"cls_bn_{i}")(fc))

    def forward(self, x):
        for i in range(self.n):
            x = self.hidden(i, getattr(self, f"cls_fc_{i}")(x))
        return self.cls_out(x)


def roi_grid_points(rois, g):
    """(B, R, 7) -> (B, R, g ^ 3, 3): the centres of a g ^ 3 grid of cells
    in each RoI (x-major, then y, then z), rotated by its heading."""
    u = (torch.arange(g, dtype=torch.float32, device=rois.device) + 0.5) / g \
        - 0.5
    gx, gy, gz = torch.meshgrid(u, u, u, indexing="ij")
    local = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    p = local * rois[..., None, 3:6]
    c = torch.cos(rois[..., 6])[..., None]
    s = torch.sin(rois[..., 6])[..., None]
    return torch.stack([p[..., 0] * c - p[..., 1] * s + rois[..., 0:1],
                        p[..., 0] * s + p[..., 1] * c + rois[..., 1:2],
                        p[..., 2] + rois[..., 2:3]], -1)


class PVRCNNHead(nn.Module):
    """RoI-grid pooling (``pool_mlp_i`` a radius over the keypoints), the
    shared FCs (``shared_fc_i``, ``shared_bn_i``, ReLU; no dropout in eval),
    ``cls_out`` and ``reg_out``."""

    def __init__(self, roi_cfg, input_channels):
        super().__init__()
        self.grid = int(roi_cfg["GRID_SIZE"])
        pool = roi_cfg["ROI_GRID_POOL"]
        self.pool = list(zip(pool["POOL_RADIUS"], pool["NSAMPLE"]))
        c = 0
        for i, mlp in enumerate(pool["MLPS"]):
            mod = SharedMLP(3 + input_channels, mlp)
            self.add_module(f"pool_mlp_{i}", mod)
            c += mod.out_channels
        c *= self.grid ** 3
        self.n_fc = len(roi_cfg["SHARED_FC"])
        for i, fc in enumerate(roi_cfg["SHARED_FC"]):
            self.add_module(f"shared_fc_{i}", Dense(c, fc, bias=False))
            self.add_module(f"shared_bn_{i}", BatchNorm(fc, 1e-3,
                                                        channels_last=True))
            c = fc
        self.cls_out = Dense(c, 1)
        self.reg_out = Dense(c, 7)

    def grid_pool(self, keypoints, kp_features, rois):
        """The RoIs' grid points pooled over the keypoints, (B, R, g ^ 3 x
        the pools' channels), grid point by grid point."""
        b, r = rois.shape[:2]
        pts = roi_grid_points(rois, self.grid).reshape(b, -1, 3)
        everyone = torch.ones(keypoints.shape[:2], dtype=torch.bool,
                              device=keypoints.device)
        x = torch.cat([grouped_max(float(rad), int(ns), keypoints, kp_features,
                                   everyone, pts,
                                   getattr(self, f"pool_mlp_{i}"))
                       for i, (rad, ns) in enumerate(self.pool)], -1)
        return x.reshape(b, r, -1)

    def hidden(self, i, fc):
        """Shared layer ``i``'s output from its ``shared_fc_i``'s."""
        return torch.relu(getattr(self, f"shared_bn_{i}")(fc))

    def outputs(self, x, roi_valid):
        """(cls (B, R), reg (B, R, 7)) of the last shared layer's output,
        zero where a RoI is not valid."""
        m = roi_valid.float()
        return self.cls_out(x)[..., 0] * m, self.reg_out(x) * m[..., None]

    def forward(self, keypoints, kp_features, rois, roi_valid):
        x = self.grid_pool(keypoints, kp_features, rois)
        for i in range(self.n_fc):
            x = self.hidden(i, getattr(self, f"shared_fc_{i}")(x))
        return self.outputs(x, roi_valid)
