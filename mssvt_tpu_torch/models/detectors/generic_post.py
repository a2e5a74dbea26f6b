"""Family dispatch around the detector stages (torch counterpart of
``mssvt_tpu/models/detectors/generic_post.py``), inference only."""

from __future__ import annotations

from ..backbones_3d.vfe import MeanVFE
from ..dense_heads.center_head import CenterHead


def apply_vfe(vfe, batch):
    if isinstance(vfe, MeanVFE):
        return vfe(batch["voxels"], batch["voxel_num_points"])
    raise NotImplementedError(f"VFE {type(vfe).__name__} (see ROADMAP.md)")


def run_dense_head(head, spatial_2d):
    """Head maps plus decoded, NMSed, fixed-size outputs."""
    if not isinstance(head, CenterHead):
        raise NotImplementedError(f"dense head {type(head).__name__} "
                                  "(see ROADMAP.md)")
    preds = head(spatial_2d)
    fb, fs, fl, fm = head.generate_predicted_boxes(preds)
    return {"pred_dicts": preds, "final_boxes": fb, "final_scores": fs,
            "final_labels": fl, "final_mask": fm}
