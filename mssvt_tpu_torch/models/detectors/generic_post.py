"""Family dispatch around the detector stages (the VFE's inputs, the dense
head's ending) and the anchor heads' post-processing (torch counterpart of
``mssvt_tpu/models/detectors/generic_post.py``; ref:
detector3d_template.py:178-284)."""

from __future__ import annotations

import torch

from ...ops.nms import nms_bev
from ...runtime import tracing
from ..backbones_3d.image_vfe import ImageVFE
from ..backbones_3d.vfe import DynamicVFE, HardVFE, MeanVFE, PillarVFE
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..dense_heads.anchor_head_multi import AnchorHeadMulti
from ..dense_heads.center_head import CenterHead


def apply_vfe(vfe, batch):
    """The batch onto the VFE family's inputs (the reference's VFEs read
    different batch keys: mean_vfe.py:14, pillar_vfe.py:52,
    dynamic_vfe.py:13, image_vfe.py), in the span ``mssvt.vfe``."""
    with tracing.span("vfe"):
        if isinstance(vfe, MeanVFE):
            return vfe(batch["voxels"], batch["voxel_num_points"])
        if isinstance(vfe, (PillarVFE, HardVFE)):
            return vfe(batch["voxels"], batch["voxel_num_points"],
                       batch["voxel_coords"])
        if isinstance(vfe, DynamicVFE):
            return vfe(batch["points"], batch["point_voxel_rows"],
                       batch["voxel_coords"])
        if isinstance(vfe, ImageVFE):
            return vfe(batch["images"], batch["trans_lidar_to_cam"],
                       batch["trans_cam_to_img"])
        raise NotImplementedError(f"VFE {type(vfe).__name__} (see ROADMAP.md)")


def per_sample_points(batch, batch_size: int, max_points: int):
    """The flat ``points`` (B * P, C) rows as (xyz (B, P, 3), features (B,
    P, C - 3) or None, valid (B, P)), padding rows zeroed (at the origin)."""
    pts = batch["points"].reshape(batch_size, max_points, -1).float()
    valid = batch["points_valid"].reshape(batch_size, max_points)
    m = valid[..., None].to(pts.dtype)
    feat = pts[..., 3:] * m
    return pts[..., :3] * m, (feat if feat.shape[-1] else None), valid


def run_dense_head(head, spatial_2d, batch=None, train: bool = False,
                   post_cfg=None):
    """Head maps plus, in training, the targets' loss (``loss``,
    ``tb_dict``; no decode or NMS), else the decoded, NMSed, fixed-size
    ``final_*`` outputs: CenterHead decodes and NMSes itself, an anchor
    head's boxes go through :func:`post_process_anchor` with
    ``post_cfg`` (the model's POST_PROCESSING). The head's maps are the
    span ``mssvt.head``, the decode and NMS ``mssvt.post``."""
    if not isinstance(head, (CenterHead, AnchorHeadSingle, AnchorHeadMulti)):
        raise NotImplementedError(f"dense head {type(head).__name__} "
                                  "(see ROADMAP.md)")
    with tracing.span("head"):
        preds = head(spatial_2d)
    if train:
        if isinstance(head, CenterHead):
            targets = head.assign_targets(
                batch["gt_boxes"], feature_map_size=spatial_2d.shape[1:3])
        else:
            targets = head.assign_targets(batch["gt_boxes"])
        loss, tb = head.get_loss(preds, targets)
        return {"pred_dicts": preds, "loss": loss, "tb_dict": tb}
    with tracing.span("post"):
        if isinstance(head, CenterHead):
            fb, fs, fl, fm = head.generate_predicted_boxes(preds)
        else:
            fb, fs, fl, fm = post_process_anchor(
                *head.generate_predicted_boxes(preds), post_cfg)
    return {"pred_dicts": preds, "final_boxes": fb, "final_scores": fs,
            "final_labels": fl, "final_mask": fm}


def post_process_anchor(boxes, cls_scores, post_cfg):
    """(B, N, 7) boxes and (B, N, C) sigmoid scores -> padded final
    detections (boxes, scores, 1-based labels, mask), each (B,
    NMS_POST_MAXSIZE, ...): the class-agnostic path of the reference
    (ref: detector3d_template.py:220-272), the max over the classes as the
    score, the score threshold, then rotated NMS a sample."""
    nms_cfg = post_cfg["NMS_CONFIG"]
    score_thresh = float(post_cfg.get("SCORE_THRESH", 0.1))
    scores, labels = cls_scores.max(dim=-1)
    labels = labels.to(torch.int32) + 1
    sel, _ = nms_bev(boxes, scores, scores > score_thresh,
                     float(nms_cfg["NMS_THRESH"]),
                     int(nms_cfg["NMS_PRE_MAXSIZE"]),
                     int(nms_cfg["NMS_POST_MAXSIZE"]))
    ok = sel >= 0
    safe = sel.clamp(min=0).long()
    pick = lambda t: t.gather(1, safe if t.ndim == 2 else safe[..., None]
                              .expand(-1, -1, t.shape[-1]))
    return (pick(boxes) * ok[..., None], pick(scores) * ok,
            pick(labels) * ok, ok)

