"""Stage dispatch around the detector's dense head (frozen copy of the
port's ``generic_post.py``, cut to MeanVFE and CenterHead)."""

from __future__ import annotations

from ..backbones_3d.vfe import MeanVFE
from ..dense_heads.center_head import CenterHead


def apply_vfe(vfe, batch):
    """The batch onto the MeanVFE's inputs."""
    if isinstance(vfe, MeanVFE):
        return vfe(batch["voxels"], batch["voxel_num_points"])
    raise NotImplementedError(f"VFE {type(vfe).__name__}")


def run_dense_head(head, spatial_2d, batch=None, train: bool = False):
    """Head maps plus, in training, the targets' loss (``loss``,
    ``tb_dict``; no decode or NMS), else the decoded, NMSed, fixed-size
    ``final_*`` outputs (CenterHead decodes and NMSes itself)."""
    if not isinstance(head, CenterHead):
        raise NotImplementedError(f"dense head {type(head).__name__}")
    preds = head(spatial_2d)
    if train:
        targets = head.assign_targets(
            batch["gt_boxes"], feature_map_size=spatial_2d.shape[1:3])
        loss, tb = head.get_loss(preds, targets)
        return {"pred_dicts": preds, "loss": loss, "tb_dict": tb}
    fb, fs, fl, fm = head.generate_predicted_boxes(preds)
    return {"pred_dicts": preds, "final_boxes": fb, "final_scores": fs,
            "final_labels": fl, "final_mask": fm}
