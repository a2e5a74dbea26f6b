"""The detectors' shell (ref: pcdet/models/detectors/detector3d_template.py):
the constructor every detector shares, the voxel first stage with its
stage spans, and the two-stage ending.

A voxel detector registers ``vfe``, ``backbone_3d``, ``map_to_bev`` (where
its family has the module), ``backbone_2d`` and ``dense_head`` in that
order (``init_weights`` draws in ``named_modules()`` order), then its own
second stage. Its eval request opens the six stage spans of
``runtime/tracing.py`` in order: ``mssvt.vfe`` (``generic_post.apply_vfe``),
``mssvt.backbone_3d``, ``mssvt.map_to_bev`` and ``mssvt.backbone_2d``
(:meth:`Detector3DTemplate.first_stage`), ``mssvt.head`` and ``mssvt.post``
(``generic_post.run_dense_head``, or :meth:`Detector3DTemplate.two_stage`).
Inside ``mssvt.post`` the two-stage ending opens ``mssvt.roi_head`` around
its RoI head (and, in eval, the refinement); PV-RCNN and PV-RCNN++ open
``mssvt.keypoints`` and ``mssvt.pfe`` before it.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ...core.sparse import SparseVoxels
from ...runtime import tracing
from ..builders import (
    build_backbone_2d,
    build_backbone_3d,
    build_ctx,
    build_dense_head,
    build_vfe,
)
from ..roi_heads.roi_head_template import (
    Proposals,
    assign_proposal_targets,
    head_valid,
    refine_boxes,
    target_kwargs,
    two_stage_loss,
)
from .generic_post import apply_vfe, run_dense_head


class Detector3DTemplate(nn.Module):
    """The constructor's arguments as the builders' context (``ctx``) and
    the attributes the detectors and their callers read; then
    :meth:`build_networks`."""

    def __init__(self, model_cfg: Any, num_class: int,
                 class_names: Sequence[str], grid_size, voxel_size,
                 point_cloud_range, batch_size: int, max_voxels: int,
                 max_points_per_voxel: int, num_point_features: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.model_cfg = model_cfg
        self.ctx = ctx = build_ctx(
            num_class, class_names, grid_size, voxel_size, point_cloud_range,
            batch_size, max_voxels, max_points_per_voxel, num_point_features,
            dtype)
        self.num_class, self.batch_size = ctx.num_class, ctx.batch_size
        self.grid_size, self.voxel_size = ctx.grid_size, ctx.voxel_size
        self.point_cloud_range = ctx.point_cloud_range
        self.build_networks()

    # -- the voxel first stage ---------------------------------------------
    def build_networks(self, backbone_3d_cfg=None):
        """The voxel first stage from the config (``backbone_3d_cfg`` in
        place of ``BACKBONE_3D``); a two-stage family adds its second stage
        after it, a family without one overrides it whole."""
        cfg, ctx = self.model_cfg, self.ctx
        self.vfe = build_vfe(cfg["VFE"], ctx)
        self.backbone_3d = build_backbone_3d(
            backbone_3d_cfg or cfg["BACKBONE_3D"], ctx)
        self.backbone_2d = build_backbone_2d(cfg["BACKBONE_2D"], ctx,
                                             self.build_map_to_bev())
        self.dense_head = build_dense_head(
            cfg["DENSE_HEAD"], ctx, self.backbone_2d.num_bev_features)

    def build_map_to_bev(self) -> int:
        """The BEV map's width; a family with a ``map_to_bev`` module builds
        it here. By default the map is the backbone output's ``.bev()``."""
        return self.backbone_3d.num_bev_features

    def to_bev(self, x, batch):
        """The BEV map (B, H, W, C) of the 3-D stage's output: by default
        the ``.bev()`` (z-major D x C channels) of the backbone's sparse
        output, the first of a pair."""
        return (x[0] if isinstance(x, tuple) else x).bev()

    def bev_stages(self, x, batch):
        """(BEV map, 2-D backbone's map), in the spans ``mssvt.map_to_bev``
        and ``mssvt.backbone_2d``."""
        with tracing.span("map_to_bev"):
            spatial = self.to_bev(x, batch)
        with tracing.span("backbone_2d"):
            return spatial, self.backbone_2d(spatial)

    def first_stage(self, batch, generator=None):
        """The VFE (``mssvt.vfe``), the voxels (no sorted-key index: the
        sparse-conv backbones build it on their own grid), the 3-D backbone
        (``mssvt.backbone_3d``; DropPath and dropout draw from
        ``generator``), the BEV map and the 2-D backbone: (the backbone's
        own output, BEV map, 2-D map)."""
        sp = SparseVoxels.create(
            apply_vfe(self.vfe, batch), batch["voxel_coords"],
            batch["voxel_valid"], self.batch_size, self.grid_size,
            self.voxel_size, self.point_cloud_range, with_index=False)
        with tracing.span("backbone_3d"):
            out = self.backbone_3d(sp, generator)
        return (out,) + self.bev_stages(out, batch)

    def one_stage(self, batch, first, return_intermediates=False):
        """The dense head's ending (``run_dense_head``) of the first stage's
        maps; the intermediates are the backbone's voxels and both maps."""
        sp, spatial, spatial_2d = first
        out = run_dense_head(self.dense_head, spatial_2d, batch,
                             train=self.training,
                             post_cfg=self.model_cfg.get("POST_PROCESSING"))
        if return_intermediates:
            out.update(backbone_voxels=sp, spatial_features=spatial,
                       spatial_features_2d=spatial_2d)
        return out

    # -- the two-stage ending ----------------------------------------------
    def build_proposals(self, roi_cfg):
        """A two-stage family's ``roi_cfg`` (its ``ROI_HEAD``) and its
        proposal step, the module ``proposals``."""
        self.roi_cfg = roi_cfg
        self.proposals = Proposals(roi_cfg)

    def two_stage(self, batch, first, return_intermediates=False,
                  generator=None):
        """The anchor head's maps (``mssvt.head``), then in ``mssvt.post``
        the proposal NMS (``proposals``), the family's RoI inputs and its
        RoI head (``mssvt.roi_head``): in training on the sampled RoIs with
        :meth:`roi_loss` (``loss``, ``tb_dict``), in eval
        :meth:`roi_detections`. The intermediates: the family's, the RoIs
        and, in training, the sampled targets."""
        with tracing.span("head"):
            preds = self.dense_head(first[2])
        with tracing.span("post"):
            rois, roi_scores, roi_labels, roi_valid = self.proposals(
                self.dense_head, preds)
            rin, extra = self.roi_inputs(batch, first, rois, roi_valid)
            out = {"pred_dicts": preds}
            if return_intermediates:
                out.update(extra, rois=rois, roi_valid=roi_valid)
            if not self.training:
                out.update(self.roi_detections(rin, rois, roi_scores,
                                               roi_labels, roi_valid))
                return out
            targets = assign_proposal_targets(
                rois, roi_valid, batch["gt_boxes"],
                **target_kwargs(self.roi_cfg))
            with tracing.span("roi_head"):
                cls, reg = self.run_roi_head(rin, targets["rois"],
                                             head_valid(targets), generator)
            out["loss"], out["tb_dict"] = self.roi_loss(batch, preds, rin,
                                                        cls, reg, targets)
            if return_intermediates:
                out["targets"] = targets
        return out

    def roi_inputs(self, batch, first, rois, roi_valid):
        """(what the family's RoI head and losses read, the family's own
        intermediates), both dicts."""
        raise NotImplementedError

    def run_roi_head(self, rin, rois, roi_valid, generator=None):
        """The family's RoI head on ``rin``: (cls (B, R), reg (B, R, 7))."""
        raise NotImplementedError

    def roi_loss(self, batch, preds, rin, cls, reg, targets):
        """The anchor loss plus the RoI losses: (loss, tb_dict)."""
        return two_stage_loss(self.dense_head, preds, batch["gt_boxes"], cls,
                              reg, targets, self.roi_cfg)

    def final_scores(self, cls, roi_scores, roi_labels, roi_valid):
        """(scores, mask) of the refined RoIs: sigmoid(RoI logit)."""
        return torch.sigmoid(cls) * roi_valid, roi_valid

    def roi_detections(self, rin, rois, roi_scores, roi_labels, roi_valid):
        """The RoI head on the proposals, its residuals decoded in each RoI
        (``refine_boxes``): the ``final_*`` outputs under
        :meth:`final_scores`' mask, with no further NMS; all of it in the
        span ``mssvt.roi_head``."""
        with tracing.span("roi_head"):
            cls, reg = self.run_roi_head(rin, rois, roi_valid)
            scores, mask = self.final_scores(cls, roi_scores, roi_labels,
                                             roi_valid)
            return {"final_boxes": refine_boxes(rois, reg) * mask[..., None],
                    "final_scores": scores, "final_labels": roi_labels,
                    "final_mask": mask}
