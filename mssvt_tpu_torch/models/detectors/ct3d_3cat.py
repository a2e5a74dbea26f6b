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

from ..roi_heads.ct3d_head import CT3DHead
from .detector3d_template import Detector3DTemplate

CAT_KEYS = ("Car", "Ped", "Cyc")  # CAT_THRE's keys, labels 1, 2, 3


class CT3D3CAT(Detector3DTemplate):
    def __init__(self, model_cfg: Any, num_class: int,
                 class_names: Sequence[str], grid_size, voxel_size,
                 point_cloud_range, batch_size: int, max_voxels: int,
                 max_points_per_voxel: int, num_point_features: int = 4,
                 max_points: int = 16384, dtype=torch.float32):
        super().__init__(model_cfg, num_class, class_names, grid_size,
                         voxel_size, point_cloud_range, batch_size,
                         max_voxels, max_points_per_voxel, num_point_features,
                         dtype)
        self.max_points = int(max_points)

    def build_networks(self):
        super().build_networks()
        self.build_proposals(self.model_cfg["ROI_HEAD"])
        self.roi_head = CT3DHead(self.roi_cfg, dtype=self.ctx.dtype)

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
        return self.two_stage(batch, self.first_stage(batch, generator),
                              return_intermediates, generator)

    def roi_inputs(self, batch, first, rois, roi_valid):
        b, p = self.batch_size, self.max_points
        return {"points": batch["points"].reshape(b, p, -1),
                "points_valid": batch["points_valid"].reshape(b, p)}, {}

    def run_roi_head(self, rin, rois, roi_valid, generator=None):
        return self.roi_head(rin["points"], rin["points_valid"], rois,
                             roi_valid)

    def final_scores(self, cls, roi_scores, roi_labels, roi_valid):
        """sigmoid(RoI logit), zeroed under the class's ``CAT_THRE``; the
        mask keeps the RoIs scoring above 0."""
        scores = torch.sigmoid(cls) * roi_valid
        thr = self.cat_thresholds(roi_labels)
        if thr is not None:
            scores = torch.where(scores < thr, 0.0, scores)
        keep = roi_valid & (scores > 0)
        return scores * keep, keep
