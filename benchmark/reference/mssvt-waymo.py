"""Plain reference of ``mssvt-waymo``: the CenterPoint detector of
``mssvt.yaml`` (MeanVFE, the five MsSVT blocks, HeightCompression,
BaseBEVBackbone, CenterHead's decode and rotated NMS) in float32 from
the frozen plain copy in ``reference/detector`` (no kernel: K1-K4's plain
versions, the assembled attention as plain tensor ops and an einsum).

``judge`` holds the program's captured outputs against it stage by stage:
the first MsSVT block from the inputs, each later block from the
program's output of the block before it, the BEV stages (HeightCompression
and BaseBEVBackbone) from the program's backbone output, the head's maps
from the program's BEV features, and the post-processing from the
program's maps: the boxes the program keeps against those the
reference keeps. From the inputs alone the comparison cannot tell bf16
from fp8: with seeded weights the BEV tail amplifies any rounding (the
reference computed in bf16 reads as far from the float32 one as the
program does), so each stage is held to its own rounding."""

from __future__ import annotations

import torch

from benchmark.harness import compare
from benchmark.reference.detector.core.sparse import SparseVoxels
from benchmark.reference.detector.models.detectors.centerpoint import (
    CenterPoint,
)
from benchmark.reference.detector.models.detectors.generic_post import (
    apply_vfe,
)


NUMBERS = ("backbone_rel", "bev_rel", "head_rel", "det_gap", "count_gap")


def capture(model):
    """The module paths whose outputs ``judge`` holds: each MsSVT block,
    the BEV backbone, the dense head."""
    return tuple(f"backbone_3d.blocks_{i}"
                 for i in range(model.backbone_3d.num_blocks)) + (
        "backbone_2d", "dense_head")


def build(config, batch, device):
    data = config["data"]
    model = CenterPoint(
        model_cfg=config["MODEL"], num_class=len(config["class_names"]),
        class_names=config["class_names"],
        grid_size=tuple(data["grid_size"]),
        voxel_size=tuple(data["voxel_size"]),
        point_cloud_range=tuple(data["point_cloud_range"]), batch_size=batch,
        max_voxels=int(data["max_voxels_per_frame"]),
        max_points_per_voxel=int(data["max_points_per_voxel"]),
        num_point_features=int(data["num_point_features"]),
        dtype=torch.float32)
    return model.to(device).eval()


def forward(model, batch, post=True):
    """The detector's eval forward; without ``post`` only up to the head's
    maps (the weights' calibration needs no decode or NMS)."""
    with torch.no_grad():
        if post:
            return model(batch)
        sp = SparseVoxels.create(
            apply_vfe(model.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], model.batch_size, model.grid_size,
            model.voxel_size, model.point_cloud_range, with_index=False)
        sp = model.backbone_3d(sp)
        return model.dense_head(model.backbone_2d(model.map_to_bev(sp)))


def detect(model, preds):
    """The post-processing (decode, score threshold, rotated NMS) of head
    maps ``preds``: (boxes, scores, labels, mask)."""
    with torch.no_grad():
        return model.dense_head.generate_predicted_boxes(preds)


def candidates(model, preds):
    """Every location's decoded box under every class of its head: (boxes
    (B, M, 7), scores (B, M), 1-based labels (B, M), heading weights (B,
    M): ``min(1, |(cos, sin)|)`` of the regressed heading)."""
    head = model.dense_head
    stride = head.feature_map_stride
    vs, pcr = head.voxel_size, head.point_cloud_range
    boxes, scores, labels, weights = [], [], [], []
    for head_idx, pred in enumerate(preds):
        b, h, w, c = pred["hm"].shape
        ys, xs = torch.meshgrid(torch.arange(h, device=pred["hm"].device),
                                torch.arange(w, device=pred["hm"].device),
                                indexing="ij")
        ctr = pred["center"].reshape(b, h * w, 2)
        x = (xs.reshape(1, -1) + ctr[..., 0]) * stride * vs[0] + pcr[0]
        y = (ys.reshape(1, -1) + ctr[..., 1]) * stride * vs[1] + pcr[1]
        z = pred["center_z"].reshape(b, h * w)
        dim = torch.exp(torch.clamp(pred["dim"], -8, 8)).reshape(b, h * w, 3)
        rot = pred["rot"].reshape(b, h * w, 2)
        ang = torch.atan2(rot[..., 1], rot[..., 0])
        hw = torch.linalg.vector_norm(rot, dim=-1).clamp(max=1.0)
        box = torch.cat([x[..., None], y[..., None], z[..., None], dim,
                         ang[..., None]], -1)
        sc = torch.sigmoid(pred["hm"]).reshape(b, h * w, c)
        ids = head.class_id_mapping_each_head[head_idx]
        for ci in range(c):
            boxes.append(box)
            scores.append(sc[..., ci])
            weights.append(hw)
            labels.append(torch.full((b, h * w), int(ids[ci]) + 1,
                                     dtype=torch.int32, device=box.device))
    return (torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(labels, 1),
            torch.cat(weights, 1))


def _voxels(sp):
    return sp.features, sp.coords, sp.valid


def judge(model, batch, got, dets):
    """The numbers of ``compare`` for one batch: ``got`` holds the program's
    outputs at ``capture(model)``, ``dets`` its detections."""
    dev = batch["voxels"].device
    with torch.no_grad():
        b3d = model.backbone_3d
        sp = SparseVoxels.create(
            apply_vfe(model.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], model.batch_size, model.grid_size,
            model.voxel_size, model.point_cloud_range, with_index=False)
        sp = sp.with_features(b3d.input_proj(sp.features)
                              * sp.valid[:, None].float())
        backbone = 0.0
        for i, block in enumerate(b3d.blocks()):
            out = block(sp)
            prog = got[f"backbone_3d.blocks_{i}"]
            backbone = max(backbone, compare.backbone_rel(_voxels(prog),
                                                          _voxels(out)))
            sp = out.with_features(prog.features.to(dev, torch.float32))
        bev = model.backbone_2d(model.map_to_bev(sp))
        prog_bev = got["backbone_2d"].to(dev, torch.float32)
        maps = model.dense_head(prog_bev)
        prog_maps = compare.as_f32(got["dense_head"], dev)
        kept = detect(model, prog_maps)
        return {
            "backbone_rel": backbone,
            "bev_rel": compare.rel(prog_bev, bev),
            "head_rel": compare.head_rel(prog_maps, maps),
            "det_gap": compare.det_gap(dets, kept,
                                       candidates(model, prog_maps)),
            "count_gap": compare.count_gap(dets[3], kept[3])}
