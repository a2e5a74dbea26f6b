"""CaDDN, the monocular detector (torch counterpart of
``mssvt_tpu/models/detectors/caddn.py``; ref:
pcdet/models/detectors/caddn.py): ImageVFE (the depth-distribution FFN and
the frustum-to-voxel sampler) -> Conv2DCollapse -> BaseBEVBackbone ->
AnchorHeadSingle, with the depth-distribution loss when the batch holds
``depth_maps``.

As in the JAX module the stages are built by class, not by the
registries' names: the camera grid is ``grid_size`` and its collapse takes
Z x the FFN's channels. Batch inputs: ``images`` (B, H, W, 3),
``trans_lidar_to_cam`` (B, 4, 4), ``trans_cam_to_img`` (B, 3, 4), and for
training ``gt_boxes`` and optionally ``depth_maps`` (B, H, W) and
``gt_boxes2d`` (B, N, 4).
"""

from __future__ import annotations

from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev import Conv2DCollapse
from ..backbones_3d.image_vfe import ImageVFE, ddn_loss
from ..dense_heads.anchor_head import AnchorHeadSingle
from .detector3d_template import Detector3DTemplate
from .generic_post import apply_vfe, run_dense_head


class CaDDN(Detector3DTemplate):
    def build_networks(self):
        cfg, ctx = self.model_cfg, self.ctx
        vfe_cfg = cfg["VFE"]
        self.vfe = ImageVFE(vfe_cfg, ctx.grid_size, ctx.voxel_size,
                            ctx.point_cloud_range, dtype=ctx.dtype)
        c_img = int(vfe_cfg.get("FFN", {}).get("DDN_CFG", {}).get(
            "NUM_CHANNELS", 32))
        self.map_to_bev = Conv2DCollapse(
            ctx.grid_size[2] * c_img,
            int(cfg["MAP_TO_BEV"]["NUM_BEV_FEATURES"]), dtype=ctx.dtype)
        b2d = cfg["BACKBONE_2D"]
        self.backbone_2d = BaseBEVBackbone(
            self.map_to_bev.num_bev_features, tuple(b2d["LAYER_NUMS"]),
            tuple(b2d["LAYER_STRIDES"]), tuple(b2d["NUM_FILTERS"]),
            tuple(b2d.get("UPSAMPLE_STRIDES", [])),
            tuple(b2d.get("NUM_UPSAMPLE_FILTERS", [])), dtype=ctx.dtype)
        self.dense_head = AnchorHeadSingle(
            cfg["DENSE_HEAD"], self.backbone_2d.num_bev_features,
            ctx.num_class, ctx.class_names, ctx.grid_size,
            ctx.point_cloud_range, dtype=ctx.dtype)

    def to_bev(self, x, batch):
        return self.map_to_bev(x)

    def depth_loss(self, depth_logits, depth_maps, gt_boxes2d=None):
        """:func:`ddn_loss` with the VFE config's bins and loss arguments."""
        vfe_cfg = self.model_cfg["VFE"]
        disc = vfe_cfg.get("DISCRETIZE", {})
        args = vfe_cfg.get("FFN", {}).get("LOSS", {}).get("ARGS", {})
        loss, _ = ddn_loss(
            depth_logits, depth_maps,
            d_min=float(disc.get("DEPTH_MIN", 2.0)),
            d_max=float(disc.get("DEPTH_MAX", 46.8)),
            n_bins=int(disc.get("NUM_BINS", 80)),
            gt_boxes2d=gt_boxes2d,
            alpha=float(args.get("alpha", 0.25)),
            gamma=float(args.get("gamma", 2.0)),
            fg_weight=float(args.get("fg_weight", 13.0)),
            bg_weight=float(args.get("bg_weight", 1.0)))
        return loss

    def forward(self, batch, return_intermediates: bool = False,
                generator=None):
        """Eval: ``final_*`` detections (``post_process_anchor``); train:
        the anchor loss plus ``LOSS_WEIGHT`` x the depth loss (when the batch
        holds ``depth_maps``). With ``return_intermediates`` also the voxel
        grid, the depth logits and the two BEV maps."""
        vox, depth_logits = apply_vfe(self.vfe, batch)
        bev, spatial_2d = self.bev_stages(vox, batch)
        out = run_dense_head(self.dense_head, spatial_2d, batch,
                             train=self.training,
                             post_cfg=self.model_cfg.get("POST_PROCESSING"))
        if self.training and "depth_maps" in batch:
            dl = self.depth_loss(depth_logits, batch["depth_maps"],
                                 batch.get("gt_boxes2d"))
            out["loss"] = out["loss"] + dl * float(
                self.model_cfg["VFE"].get("LOSS_WEIGHT", 3.0))
            out["tb_dict"]["depth_loss"] = dl
        if return_intermediates:
            out.update(voxel_features=vox, depth_logits=depth_logits,
                       spatial_features=bev, spatial_features_2d=spatial_2d)
        return out
