from .roi_head_template import (
    assign_proposal_targets,
    corner_weight_from_cfg,
    proposal_layer,
    roi_box_loss,
    roi_cls_loss,
)

__all__ = [
    "proposal_layer",
    "assign_proposal_targets",
    "corner_weight_from_cfg",
    "roi_box_loss",
    "roi_cls_loss",
]
