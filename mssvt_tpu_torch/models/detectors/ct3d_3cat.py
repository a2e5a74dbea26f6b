"""CT3D, three categories (torch counterpart of
``mssvt_tpu/models/detectors/ct3d_3cat.py``; ref:
pcdet/models/detectors/ct3d_3cat.py): SECOND's first stage (VFE -> sparse
3D backbone -> BEV map -> BaseBEVBackbone -> anchor head), the proposal
NMS, and ``CT3DHead`` refining each RoI from the raw points
(``MAX_POINTS`` rows a frame: ``points``, ``points_valid``).

Train: the anchor loss plus the RoI losses on the sampled RoIs (the
gradient flows through the RoIs into the first stage). Eval: the refined
RoIs scored sigmoid(RoI logit), zeroed under their class's ``CAT_THRE``
(ref ct3d_3cat.py:121-127), with no further NMS.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ..builders import (
    build_backbone_2d,
    build_backbone_3d,
    build_ctx,
    build_dense_head,
    build_vfe,
)
from ..roi_heads.ct3d_head import CT3DHead
from ..roi_heads.roi_head_template import (
    assign_proposal_targets,
    head_valid,
    propose,
    refine_boxes,
    target_kwargs,
    two_stage_loss,
)
from .generic_post import apply_vfe

CAT_KEYS = ("Car", "Ped", "Cyc")  # CAT_THRE's keys, labels 1, 2, 3


class CT3D3CAT(nn.Module):
    def __init__(self, model_cfg: Any, num_class: int,
                 class_names: Sequence[str], grid_size, voxel_size,
                 point_cloud_range, batch_size: int, max_voxels: int,
                 max_points_per_voxel: int, num_point_features: int = 4,
                 max_points: int = 16384, dtype=torch.float32):
        super().__init__()
        self.model_cfg = model_cfg
        ctx = build_ctx(num_class, class_names, grid_size, voxel_size,
                        point_cloud_range, batch_size, max_voxels,
                        max_points_per_voxel, num_point_features, dtype)
        self.grid_size, self.voxel_size = ctx.grid_size, ctx.voxel_size
        self.point_cloud_range = ctx.point_cloud_range
        self.batch_size, self.max_points = ctx.batch_size, int(max_points)
        self.vfe = build_vfe(model_cfg["VFE"], ctx)
        self.backbone_3d = build_backbone_3d(model_cfg["BACKBONE_3D"], ctx)
        self.backbone_2d = build_backbone_2d(
            model_cfg["BACKBONE_2D"], ctx, self.backbone_3d.num_bev_features)
        self.dense_head = build_dense_head(
            model_cfg["DENSE_HEAD"], ctx, self.backbone_2d.num_bev_features)
        self.roi_cfg = model_cfg["ROI_HEAD"]
        self.roi_head = CT3DHead(self.roi_cfg, dtype=dtype)

    def cat_thresholds(self, roi_labels):
        """(B, R) per-RoI score thresholds of POST_PROCESSING.CAT_THRE by
        label (1 Car, 2 Ped, 3 Cyc, 0 past those), or None without one."""
        cat = self.model_cfg.get("POST_PROCESSING", {}).get("CAT_THRE")
        if not cat:
            return None
        thr = torch.tensor([float(cat.get(k, 0.0)) for k in CAT_KEYS] + [0.0],
                           device=roi_labels.device)
        return thr[torch.clamp(roi_labels.long() - 1, 0, 3)]

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` (the refined, gated RoIs); train: ``loss`` and
        ``tb_dict``. With ``return_intermediates`` also the RoIs (and, in
        training, the sampled targets)."""
        sp = SparseVoxels.create(
            apply_vfe(self.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], self.batch_size, self.grid_size,
            self.voxel_size, self.point_cloud_range)
        spatial_2d = self.backbone_2d(self.backbone_3d(sp).bev())
        preds = self.dense_head(spatial_2d)
        rois, _, roi_labels, roi_valid = propose(
            self.dense_head, preds, self.roi_cfg, self.training)
        pts = batch["points"].reshape(self.batch_size, self.max_points, -1)
        pvalid = batch["points_valid"].reshape(self.batch_size,
                                               self.max_points)
        out = {"pred_dicts": preds}
        if return_intermediates:
            out.update(rois=rois, roi_valid=roi_valid)
        if self.training:
            targets = assign_proposal_targets(
                rois, roi_valid, batch["gt_boxes"],
                **target_kwargs(self.roi_cfg))
            cls, reg = self.roi_head(pts, pvalid, targets["rois"],
                                     head_valid(targets))
            out["loss"], out["tb_dict"] = two_stage_loss(
                self.dense_head, preds, batch["gt_boxes"], cls, reg, targets,
                self.roi_cfg)
            if return_intermediates:
                out["targets"] = targets
            return out
        cls, reg = self.roi_head(pts, pvalid, rois, roi_valid)
        scores = torch.sigmoid(cls) * roi_valid
        thr = self.cat_thresholds(roi_labels)
        if thr is not None:
            scores = torch.where(scores < thr, 0.0, scores)
        keep = roi_valid & (scores > 0)
        out.update(final_boxes=refine_boxes(rois, reg) * keep[..., None],
                   final_scores=scores * keep, final_labels=roi_labels,
                   final_mask=keep)
        return out
