"""Plain reference of ``pvrcnnpp-kitti``: PV-RCNN++ as OpenPCDet's
``pv_rcnn_plusplus.py`` runs it on KITTI (MeanVFE, ``VoxelBackBone8x`` on
pcdet's grid, the BEV map of its 2 x 128-channel output,
``BaseBEVBackbone`` [5, 5] at [128, 256], ``AnchorHeadSingle``, the
proposal NMS, the SPC keypoints and their features, ``PointHeadSimple``,
``PVRCNNHead`` and the refinement), in float32, independent of the port's
sparse-conv engine and kernels: the backbone is ``dense_spconv.py``'s dense
convolutions, the head and the proposals' decode ``anchor_head.py``'s, the
second stage ``point_voxel.py``'s plain ball queries, pools and MLPs;
MeanVFE, the 2-D backbone, the rotated NMS and the sector FPS are the
frozen plain copies in ``reference/detector``.

Departures from pcdet, each noted where it is made: the BEV channels are
z-major (the port's order), the maps NHWC; the proposals keep pcdet's
class-max score and NMS; the refined RoIs are the detections, scored by
the sigmoid of the RoI head's logit, with no further NMS (the JAX
package's eval ending, which the port follows); the weights are the
benchmark's, drawn from the seed.

``judge`` holds the program's captured outputs against it stage by stage,
each reference stage fed the program's output of the one before, in the
harness's five numbers (``harness/compare.py``) and four of its own:

- ``site_gap`` and the sparse stages' ratio as ``second-kitti``'s judge;
  ``kp_gap``, the share of the program's keypoints that are not the
  reference's SPC picks from the program's raw points and RoIs (the
  ``proposals``; a pick differs where its point does); ``pfe_rel``, the
  worst ratio of the keypoints' concatenated sources (from the program's
  keypoints, raw points, ``conv_out`` sites and 2-D map), of
  ``vsa_point_fc``'s output (from the program's sources), of the fused
  features (from the program's ``vsa_point_fc`` output), of each of the
  point head's ``cls_fc_i`` (the first from the program's fused features,
  the next from the program's ``cls_fc_i - 1``) and of its logits (from
  the program's last ``cls_fc``), the logits' error over the size of the
  products' terms (:func:`rel_to_terms`: a logit is one sum a keypoint,
  which cancels, so its rounding error scales with its terms, not with
  itself). Each stage's BatchNorm takes the program's product, as the RoI
  head's below.
  ``backbone_rel`` is
  the worst of the sparse stages' and ``pfe_rel`` (pcdet's keypoint
  branch is a module of its 3-D backbones, ``backbones_3d/pfe``), infinite
  where ``site_gap`` or ``kp_gap`` is not 0 (integer work, which must
  agree exactly);
- ``bev_rel`` as ``second-kitti``'s judge;
- ``roi_rel``, the worst ratio of the RoI head's stages: each
  ``shared_fc_i``'s output (the first from the reference's grid pooling of
  the program's keypoints, RoIs and fused features weighted by its point
  head's logits, the next from the program's ``shared_fc_i - 1``), then
  the outputs, each RoI's class logit and box residuals (from the
  program's last ``shared_fc``), their error over the size of the
  products' terms as the point head's logits.
  Each stage's BatchNorm takes the program's product: with the seeded
  statistics a channel's variance can be tiny, and a BatchNorm would
  multiply the bf16 rounding of a product before it by its inverse
  deviation. ``head_rel`` is the worst of the dense head's maps and
  ``roi_rel`` (both heads' outputs before decoding);
- ``det_gap`` and ``count_gap``, the worse of two: the program's
  detections against the refinement of the program's RoI head outputs in
  its RoIs, and the program's proposals (RoIs, scores, labels, valid)
  against the reference's proposal layer (decode, class-max, the
  ``NMS_PRE_MAXSIZE`` best, rotated NMS) of the program's dense-head
  maps, as ``second-kitti``'s judge holds its detections."""

from __future__ import annotations

import math
import sys

import torch
from torch import nn

from benchmark.harness import compare
from benchmark.reference import anchor_head, dense_spconv, point_voxel
from benchmark.reference.detector.models.backbones_2d.base_bev_backbone \
    import BaseBEVBackbone
from benchmark.reference.detector.models.backbones_3d.vfe import MeanVFE
from benchmark.reference.detector.ops.nms import nms_bev

NUMBERS = ("backbone_rel", "site_gap", "kp_gap", "pfe_rel", "bev_rel",
           "head_rel", "roi_rel", "det_gap", "count_gap")
BEV_STRIDE = 8  # the 2-D map's cells in voxels


class Proposals(nn.Module):
    """pcdet's ``proposal_layer`` in eval: the class-max score of every
    anchor's decoded box, the ``NMS_PRE_MAXSIZE`` best, greedy rotated NMS,
    ``NMS_POST_MAXSIZE`` RoIs a frame -> (rois (B, R, 7), scores, 1-based
    labels, valid)."""

    def __init__(self, roi_cfg):
        super().__init__()
        self.nms = roi_cfg["NMS_CONFIG"]["TEST"]

    def forward(self, head, preds):
        boxes, cls = head.boxes(preds)
        scores, labels = torch.max(cls, dim=-1)
        sel, _ = nms_bev(boxes, scores, torch.ones_like(scores, dtype=bool),
                         float(self.nms["NMS_THRESH"]),
                         int(self.nms["NMS_PRE_MAXSIZE"]),
                         int(self.nms["NMS_POST_MAXSIZE"]))
        ok = sel >= 0
        idx = sel.clamp(min=0).long()
        rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))
        return (rois * ok[..., None], torch.gather(scores, 1, idx) * ok,
                (torch.gather(labels, 1, idx) + 1).to(torch.int32) * ok, ok)


def refine(rois, reg):
    """pcdet's ``generate_predicted_boxes`` of a RoI head: the residuals
    decoded against each RoI's size at the origin (its heading added by the
    decode), rotated by the heading and moved to the RoI's centre."""
    local = anchor_head.decode(reg, torch.cat(
        [torch.zeros_like(rois[..., :3]), rois[..., 3:6].clamp(min=1e-5),
         torch.zeros_like(rois[..., 6:7])], -1))
    h = rois[..., 6]
    c, s = torch.cos(h), torch.sin(h)
    return torch.stack([local[..., 0] * c - local[..., 1] * s + rois[..., 0],
                        local[..., 0] * s + local[..., 1] * c + rois[..., 1],
                        local[..., 2] + rois[..., 2], local[..., 3],
                        local[..., 4], local[..., 5], local[..., 6] + h], -1)


def detections(rois, roi_labels, roi_valid, cls, reg):
    """(boxes, scores, labels, mask) of the refined RoIs."""
    m = roi_valid
    return (refine(rois, reg) * m[..., None], torch.sigmoid(cls) * m,
            roi_labels, m)


class PVRCNNPlusPlus(nn.Module):
    def __init__(self, config, batch):
        super().__init__()
        model, data = config["MODEL"], config["data"]
        self.batch_size = batch
        self.max_points = int(model["MAX_POINTS"])
        self.voxel_size = tuple(data["voxel_size"])
        self.pc_range = tuple(data["point_cloud_range"])
        self.vfe = MeanVFE()
        b3d = model["BACKBONE_3D"]
        self.backbone_3d = dense_spconv.VoxelBackBone8x(
            int(data["num_point_features"]), data["grid_size"],
            b3d["NUM_FILTERS"], int(b3d["OUT_CHANNELS"]))
        depth = self.backbone_3d.out_spatial_shape[2]
        bev = model["BACKBONE_2D"]
        self.backbone_2d = BaseBEVBackbone(
            depth * int(b3d["OUT_CHANNELS"]), bev["LAYER_NUMS"],
            bev["LAYER_STRIDES"], bev["NUM_FILTERS"],
            bev["UPSAMPLE_STRIDES"], bev["NUM_UPSAMPLE_FILTERS"])
        self.dense_head = anchor_head.AnchorHeadSingle(
            model["DENSE_HEAD"], self.backbone_2d.num_bev_features,
            len(config["class_names"]), data["grid_size"],
            data["point_cloud_range"])
        self.proposals = Proposals(model["ROI_HEAD"])
        # the cell size of conv_out's sites: the strided layers' strides
        stride = [1, 1, 1]
        for name in ("conv2_down", "conv3_down", "conv4_down", "conv_out"):
            st = getattr(self.backbone_3d, name).stride
            stride = [stride[i] * st[i] for i in range(3)]
        self.site_voxel = tuple(self.voxel_size[i] * stride[i]
                                for i in range(3))
        self.pfe = point_voxel.VoxelSetAbstraction(
            model["PFE"], int(data["num_point_features"]) - 3,
            int(b3d["OUT_CHANNELS"]), BEV_STRIDE, self.voxel_size,
            self.pc_range)
        self.pfe.build_fuse(self.backbone_2d.num_bev_features)
        c_kp = int(model["PFE"]["NUM_OUTPUT_FEATURES"])
        self.point_head = point_voxel.PointHeadSimple(model["POINT_HEAD"],
                                                      c_kp)
        self.roi_head = point_voxel.PVRCNNHead(model["ROI_HEAD"], c_kp)

    def sites(self, batch):
        """The input voxels' mean points on their sites."""
        f = self.vfe(batch["voxels"], batch["voxel_num_points"])
        return dense_spconv.sites_of(f, batch["voxel_coords"],
                                     batch["voxel_valid"], self.batch_size,
                                     self.backbone_3d.sparse_shape)

    def points(self, batch):
        """The raw points by frame: (xyz (B, P, 3), features (B, P, C - 3),
        valid (B, P)), the padding rows zeroed."""
        pts = batch["points"].reshape(self.batch_size, self.max_points,
                                      -1).float()
        valid = batch["points_valid"].reshape(self.batch_size,
                                              self.max_points)
        m = valid[..., None].float()
        return pts[..., :3] * m, pts[..., 3:] * m, valid

    def sites_of_stage(self, out):
        """A ``conv_out`` output (the program's padded rows or the
        reference's sites) laid out by frame, in its row order."""
        return point_voxel.sites_by_frame(out.features, out.coords, out.valid,
                                          self.batch_size, self.site_voxel,
                                          self.pc_range)

    def forward(self, batch, post=True):
        x = self.backbone_3d(self.sites(batch))
        bev = self.backbone_2d(x.bev())
        preds = self.dense_head(bev)
        rois, _, labels, roi_valid = self.proposals(self.dense_head, preds)
        kp, fused, _ = self.pfe(self.points(batch), self.sites_of_stage(x),
                                bev, rois, roi_valid)
        weighted = fused * torch.sigmoid(self.point_head(fused))
        cls, reg = self.roi_head(kp, weighted, rois, roi_valid)
        if not post:
            return preds
        fb, fs, fl, fm = detections(rois, labels, roi_valid, cls, reg)
        return {"pred_dicts": preds, "final_boxes": fb, "final_scores": fs,
                "final_labels": fl, "final_mask": fm}


def capture(model):
    """The module paths whose outputs ``judge`` holds: the sparse
    backbone's five stages, the BEV backbone, the dense head, the
    proposals, the PFE, the point head and the RoI head."""
    return tuple(f"backbone_3d.{name}" for name, _ in
                 model.backbone_3d.stages) + (
        "backbone_2d", "dense_head", "proposals", "pfe", "pfe.vsa_point_fc",
        "point_head") + tuple(f"point_head.cls_fc_{i}" for i in
                              range(model.point_head.n)) + tuple(
        f"roi_head.shared_fc_{i}" for i in range(model.roi_head.n_fc)) + (
        "roi_head",)


def build(config, batch, device):
    return PVRCNNPlusPlus(config, batch).to(device).eval()


def forward(model, batch, post=True):
    """The detector's eval forward; without ``post`` the first stage's maps
    after the whole second stage has run (the weights' calibration sets
    every BatchNorm of both stages), no refinement."""
    with torch.no_grad():
        return model(batch, post=post)


def rel_to_terms(prog, layers, x, mask=None):
    """The error of a last ``Dense`` layer's outputs against the size of
    their products' terms: ``|p - r| / |s|`` (Frobenius) over the outputs
    of every ``layers`` entry on ``x``, ``r`` its output and ``s`` the same
    product of the magnitudes (``|x| |W|^T + |b|``), times ``mask`` (B, R)
    where given. A sum that cancels keeps the rounding error of its terms,
    so ``|p - r| / |r|`` would swing with the cancellation."""
    num = den = 0.0
    for p, layer in zip(prog, layers):
        r = layer(x)
        s = torch.nn.functional.linear(x.abs(), layer.weight.abs(),
                                       None if layer.bias is None
                                       else layer.bias.abs())
        if mask is not None:
            r, s = r * mask[..., None], s * mask[..., None]
        num += float(torch.sum((p.double() - r.double()) ** 2))
        den += float(torch.sum(s.double() ** 2))
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return math.sqrt(num / den)


def candidates(model, preds):
    """The dense head's candidates (``anchor_head.candidates``): every
    anchor's decoded box, its class-max score and label."""
    return anchor_head.candidates(model.dense_head, preds)


def held(prog, ref):
    """(site_gap, the features' ratio on the sites both hold) of a stage:
    ``prog`` the program's padded output, ``ref`` the reference's sites."""
    if tuple(prog.spatial_shape) != tuple(ref.spatial_shape):
        return math.inf, math.inf
    p = dense_spconv.sites_of(prog.features, prog.coords, prog.valid,
                              ref.batch_size, ref.spatial_shape)
    pk, rk = p.keys(), ref.keys()
    at = torch.searchsorted(rk, pk).clamp(max=max(len(rk) - 1, 0))
    both = (rk[at] == pk) if len(rk) else torch.zeros_like(pk, dtype=bool)
    n = int(both.sum())
    gap = (len(pk) - n + len(rk) - n) / max(len(rk), 1)
    return gap, compare.rel(p.features[both], ref.features[at[both]])


def first_stage(model, batch, got):
    """``backbone_rel``, ``site_gap``, ``bev_rel``, ``head_rel`` as
    ``second-kitti``'s judge takes them."""
    dev = batch["voxels"].device
    b3d = model.backbone_3d
    sp = model.sites(batch)
    backbone, site_gap, live = 0.0, 0.0, []
    for name, _ in b3d.stages:
        out = b3d.stage(name, sp)
        prog = got[f"backbone_3d.{name}"]
        gap, r = held(prog, out)
        backbone, site_gap = max(backbone, r), max(site_gap, gap)
        live.append(f"{name} {int(prog.valid.sum())}/{len(out.coords)}"
                    f"/{prog.valid.shape[0]}")
        if math.isinf(gap):  # another grid
            break
        sp = dense_spconv.sites_of(prog.features, prog.coords, prog.valid,
                                   sp.batch_size, out.spatial_shape)
    print(f"# pvrcnnpp-kitti sites a stage (program / reference / the "
          f"program's rows): {', '.join(live)}; site_gap {site_gap!r}",
          file=sys.stderr, flush=True)
    prog_bev = got["backbone_2d"].to(dev, torch.float32)
    bev = (model.backbone_2d(sp.bev()) if math.isfinite(site_gap)
           else torch.zeros_like(prog_bev))
    prog_maps = compare.as_f32(got["dense_head"], dev)
    return {"backbone_rel": backbone, "site_gap": site_gap,
            "bev_rel": compare.rel(prog_bev, bev),
            "head_rel": compare.head_rel(prog_maps,
                                         model.dense_head(prog_bev))}


def judge(model, batch, got, dets):
    """The numbers of ``NUMBERS`` for one batch: ``got`` holds the
    program's outputs at ``capture(model)``, ``dets`` its detections."""
    dev = batch["voxels"].device
    f32 = lambda t: t.to(dev, torch.float32)  # noqa: E731
    with torch.no_grad():
        out = first_stage(model, batch, got)
        rois, _, labels, roi_valid = (t.to(dev) for t in got["proposals"])
        rois = rois.float()
        points = model.points(batch)
        prog_kp, prog_fused, prog_cat = (f32(t) for t in got["pfe"])
        kp = model.pfe.keypoints(points[0], points[2], rois, roi_valid)
        out["kp_gap"] = float((prog_kp != kp).any(-1).float().mean())
        cat = model.pfe.sources(
            prog_kp, *points, model.sites_of_stage(got["backbone_3d.conv_out"]),
            f32(got["backbone_2d"]))
        prog_fc = f32(got["pfe.vsa_point_fc"])
        prog_logit = f32(got["point_head"])
        pfe = [compare.rel(prog_cat, cat),
               compare.rel(prog_fc, model.pfe.vsa_point_fc(prog_cat)),
               compare.rel(prog_fused, model.pfe.fuse(prog_fc))]
        ph, x = model.point_head, prog_fused
        for i in range(ph.n):
            prog_h = f32(got[f"point_head.cls_fc_{i}"])
            pfe.append(compare.rel(prog_h, getattr(ph, f"cls_fc_{i}")(x)))
            x = ph.hidden(i, prog_h)
        pfe.append(rel_to_terms([prog_logit], [ph.cls_out], x))
        out["pfe_rel"] = max(pfe)
        head = model.roi_head
        x = head.grid_pool(prog_kp, prog_fused * torch.sigmoid(prog_logit),
                           rois)
        roi = []
        for i in range(head.n_fc):
            prog_h = f32(got[f"roi_head.shared_fc_{i}"])
            roi.append(compare.rel(prog_h, getattr(head, f"shared_fc_{i}")(x)))
            x = head.hidden(i, prog_h)
        prog_cls, prog_reg = f32(got["roi_head"][0]), f32(got["roi_head"][1])
        roi.append(rel_to_terms([prog_cls[..., None], prog_reg],
                                [head.cls_out, head.reg_out], x,
                                roi_valid.float()))
        out["roi_rel"] = max(roi)
        exact = out["site_gap"] == 0 and out["kp_gap"] == 0
        out["backbone_rel"] = (max(out["backbone_rel"], out["pfe_rel"])
                               if exact else math.inf)
        out["head_rel"] = max(out["head_rel"], out["roi_rel"])
        kept = detections(rois, labels, roi_valid, prog_cls, prog_reg)
        cands = (kept[0], kept[1], kept[2], torch.ones_like(kept[1]))
        # the proposals: the program's RoIs against the reference's
        # proposal layer on the program's dense-head maps
        prog_maps = compare.as_f32(got["dense_head"], dev)
        props = (rois, f32(got["proposals"][1]), labels, roi_valid)
        ref_props = model.proposals(model.dense_head, prog_maps)
        det = [compare.det_gap(dets, kept, cands),
               compare.det_gap(props, ref_props,
                               candidates(model, prog_maps))]
        count = [compare.count_gap(dets[3], kept[3]),
                 compare.count_gap(roi_valid, ref_props[3])]
        out["det_gap"], out["count_gap"] = max(det), max(count)
        print(f"# pvrcnnpp-kitti live RoIs a frame "
              f"{roi_valid.sum(1).tolist()}, valid raw rows "
              f"{points[2].sum(1).tolist()}; second stage: kp_gap "
              f"{out['kp_gap']!r}, pfe_rel {out['pfe_rel']!r} (sources, "
              f"fc, fused, point head fcs, logits "
              f"{', '.join(f'{v:.3g}' for v in pfe)}),"
              f" roi_rel {out['roi_rel']!r} (shared fcs, outputs "
              f"{', '.join(f'{v:.3g}' for v in roi)}); det_gap, count_gap "
              f"(detections, proposals) {det!r}, {count!r}; reference "
              f"RoIs a frame {ref_props[3].sum(1).tolist()}",
              file=sys.stderr, flush=True)
        return out
