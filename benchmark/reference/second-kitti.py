"""Plain reference of ``second-kitti``: SECOND as OpenPCDet's
``second.yaml`` runs it (MeanVFE, ``VoxelBackBone8x`` on pcdet's grid,
the BEV map of its 2 x 128-channel output, ``BaseBEVBackbone`` [5, 5] at
[128, 256], ``AnchorHeadSingle`` and the class-agnostic rotated NMS), in
float32, independent of the port's sparse-conv engine: the backbone is
``dense_spconv.py``'s dense convolutions, the head and post-processing
``anchor_head.py``'s; MeanVFE and the 2-D backbone are the frozen plain
copies in ``reference/detector``.

Departures from pcdet, each noted where it is made: the BEV channels are
z-major (the port's order; both sides take the same named weights), the
maps NHWC, equal scores keep the lower anchor first; the weights are the
benchmark's, drawn from the seed.

``judge`` holds the program's captured outputs against it stage by stage,
each reference stage fed the program's output of the one before: the five
stages of the sparse backbone (``conv1`` from the inputs, then
``conv2_subm``, ``conv3_subm``, ``conv4_subm`` and ``conv_out``), the BEV
features (the 2-D backbone's output from the program's ``conv_out``), the
head's three maps from the program's BEV features, and the boxes the
program keeps against those this post-processing keeps from the program's
maps. ``site_gap`` is the sites of the strided stages on one side only
over the reference's sites (the program keeps at most a capacity of
them); ``backbone_rel`` is infinite where it is not 0, as the harness
reads sites that differ, and the live sites a stage are printed against
the program's capacity."""

from __future__ import annotations

import math
import sys

import torch
from torch import nn

from benchmark.harness import compare
from benchmark.reference import anchor_head, dense_spconv
from benchmark.reference.detector.models.backbones_2d.base_bev_backbone \
    import BaseBEVBackbone
from benchmark.reference.detector.models.backbones_3d.vfe import MeanVFE

NUMBERS = ("backbone_rel", "site_gap", "bev_rel", "head_rel", "det_gap",
           "count_gap")


class SECOND(nn.Module):
    def __init__(self, config, batch):
        super().__init__()
        model, data = config["MODEL"], config["data"]
        self.post_cfg = model["POST_PROCESSING"]
        self.batch_size = batch
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

    def sites(self, batch):
        """The input voxels' mean points on their sites."""
        f = self.vfe(batch["voxels"], batch["voxel_num_points"])
        return dense_spconv.sites_of(f, batch["voxel_coords"],
                                     batch["voxel_valid"], self.batch_size,
                                     self.backbone_3d.sparse_shape)

    def forward(self, batch, post=True):
        preds = self.dense_head(self.backbone_2d(
            self.backbone_3d(self.sites(batch)).bev()))
        if not post:
            return preds
        fb, fs, fl, fm = anchor_head.post_process(self.dense_head, preds,
                                                  self.post_cfg)
        return {"pred_dicts": preds, "final_boxes": fb, "final_scores": fs,
                "final_labels": fl, "final_mask": fm}


def capture(model):
    """The module paths whose outputs ``judge`` holds: the sparse
    backbone's five stages, the BEV backbone, the dense head."""
    return tuple(f"backbone_3d.{name}" for name, _ in
                 model.backbone_3d.stages) + ("backbone_2d", "dense_head")


def build(config, batch, device):
    return SECOND(config, batch).to(device).eval()


def forward(model, batch, post=True):
    """The detector's eval forward; without ``post`` only up to the head's
    maps (the weights' calibration needs no decode or NMS)."""
    with torch.no_grad():
        return model(batch, post=post)


def detect(model, preds):
    with torch.no_grad():
        return anchor_head.post_process(model.dense_head, preds,
                                        model.post_cfg)


def candidates(model, preds):
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


def judge(model, batch, got, dets):
    """The numbers of ``compare`` for one batch: ``got`` holds the program's
    outputs at ``capture(model)``, ``dets`` its detections."""
    dev = batch["voxels"].device
    with torch.no_grad():
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
        print(f"# second-kitti sites a stage (program / reference / the "
              f"program's rows): {', '.join(live)}; site_gap {site_gap!r}",
              file=sys.stderr, flush=True)
        prog_bev = got["backbone_2d"].to(dev, torch.float32)
        if site_gap:
            backbone = math.inf
        # the 2-D backbone on the program's own BEV map (its conv_out sites)
        bev = (model.backbone_2d(sp.bev()) if math.isfinite(site_gap)
               else torch.zeros_like(prog_bev))
        prog_maps = compare.as_f32(got["dense_head"], dev)
        maps = model.dense_head(prog_bev)
        kept = detect(model, prog_maps)
        return {
            "backbone_rel": backbone,
            "site_gap": site_gap,
            "bev_rel": compare.rel(prog_bev, bev),
            "head_rel": compare.head_rel(prog_maps, maps),
            "det_gap": compare.det_gap(dets, kept,
                                       candidates(model, prog_maps)),
            "count_gap": compare.count_gap(dets[3], kept[3])}
