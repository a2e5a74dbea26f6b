"""Two-stage RoI machinery (torch counterpart of
``mssvt_tpu/models/roi_heads/roi_head_template.py``; ref:
pcdet/models/roi_heads/roi_head_template.py and
target_assigner/proposal_target_layer.py).

- :func:`proposal_layer`: per-sample rotated NMS of the first stage's boxes
  into a fixed number of RoIs; :func:`propose` and its module
  :class:`Proposals` run it on an anchor head's boxes.
- :func:`assign_proposal_targets`: deterministic IoU-ranked fg/bg RoI
  sampling (as the JAX module: fg by descending IoU, bg preferring the
  hard interval) with regression targets in each RoI's canonical frame.
- :func:`roi_cls_loss`, :func:`roi_box_loss` (with the corner loss),
  :func:`corner_weight_from_cfg` and :func:`refine_boxes` (the RoI-frame
  refinement back in the global frame, as the JAX detectors decode it).

As in the JAX package, nothing here stops the gradient: it flows from the
RoI losses into the RoIs (their sizes, the canonical targets, the IoU that
sets the soft class labels) and on into the first stage's box
predictions. The rankings use a stable descending sort, so equal scores
keep their index order as ``lax.top_k``'s do; picks are advanced indexing
(a sorted, deterministic backward on the card, see ``ops/sampling.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.box_ops import pairwise_iou_3d
from ...ops.nms import nms_bev
from ...utils.box_coder import ResidualCoder
from ..losses import get_corner_loss_lidar, weighted_smooth_l1


def _pick(t, idx):
    """(B, N, ...) rows at (B, M) indices."""
    rows = torch.arange(t.shape[0], device=t.device)[:, None]
    return t[rows, idx.long()]


def proposal_layer(boxes, scores, valid, nms_pre: int, nms_post: int,
                   nms_thresh: float, labels=None):
    """(B, N, 7) boxes, (B, N) scores -> (rois (B, nms_post, 7), scores,
    labels, valid), zeros past each frame's kept boxes."""
    if labels is None:
        labels = torch.ones(scores.shape, dtype=torch.int32,
                            device=scores.device)
    sel, _ = nms_bev(boxes.detach(), scores.detach(), valid, nms_thresh,
                     nms_pre, nms_post)
    ok = sel >= 0
    safe = sel.clamp(min=0)
    return (_pick(boxes, safe) * ok[..., None], _pick(scores, safe) * ok,
            _pick(labels, safe) * ok, ok)


def _canonical_transform(gt_of_roi, rois):
    """GT boxes in their RoIs' canonical frame (centre at the RoI's, x
    along its heading)."""
    diff = gt_of_roi[..., :3] - rois[..., :3]
    heading = rois[..., 6]
    c, s = torch.cos(-heading), torch.sin(-heading)
    lx = diff[..., 0] * c - diff[..., 1] * s
    ly = diff[..., 0] * s + diff[..., 1] * c
    local = torch.stack([lx, ly, diff[..., 2]], dim=-1)
    rot = gt_of_roi[..., 6] - heading
    return torch.cat([local, gt_of_roi[..., 3:6], rot[..., None]], dim=-1)


def _top(score, k):
    """The ``k`` largest of each row, equal scores in index order."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def assign_proposal_targets(rois, roi_valid, gt_boxes, roi_per_image: int,
                            fg_thresh: float = 0.55,
                            bg_thresh_hi: float = 0.55,
                            bg_thresh_lo: float = 0.1,
                            fg_ratio: float = 0.5):
    """A fixed set of ``roi_per_image`` training RoIs a frame and their
    targets: rois (B, R, 7), gt_of_rois (B, R, 8) in the canonical frame
    (zero but for fg), roi_ious (B, R), reg_valid (B, R) (fg), cls_labels
    (B, R) in [0, 1] from the IoU, -1 where ignored."""
    gt_valid = gt_boxes[..., -1] > 0
    iou = pairwise_iou_3d(rois[..., :7], gt_boxes[..., :7])  # (B, N, M)
    iou = torch.where(gt_valid[:, None, :] & roi_valid[:, :, None], iou,
                      torch.full((), -1.0, dtype=iou.dtype, device=iou.device))
    best_gt = torch.argmax(iou, dim=2)
    best_iou = iou.amax(dim=2)  # ties share the gradient, as jnp.max

    n_fg = int(roi_per_image * fg_ratio)
    n_bg = roi_per_image - n_fg
    neg = torch.full((), -1.0, dtype=iou.dtype, device=iou.device)
    fg_score = torch.where(best_iou >= fg_thresh, best_iou, neg)
    fg_top, fg_idx = _top(fg_score.detach(), n_fg)
    fg_ok = fg_top > 0
    is_bg = (best_iou < bg_thresh_hi) & roi_valid
    bg_score = torch.where(is_bg, torch.where(best_iou >= bg_thresh_lo,
                                              2.0 - best_iou, best_iou), neg)
    bg_top, bg_idx = _top(bg_score.detach(), n_bg)
    bg_ok = bg_top > -1.0

    sel = torch.cat([fg_idx, bg_idx], dim=1)
    sel_ok = torch.cat([fg_ok, bg_ok], dim=1)
    sel_fg = torch.cat([fg_ok, torch.zeros_like(bg_ok)], dim=1)
    s_rois = _pick(rois, sel) * sel_ok[..., None]
    s_iou = _pick(best_iou, sel) * sel_ok
    s_gt = _pick(gt_boxes, _pick(best_gt, sel))
    gt_canonical = torch.cat([_canonical_transform(s_gt[..., :7], s_rois),
                              s_gt[..., 7:8]], dim=-1)
    cls = torch.where(s_iou > fg_thresh, 1.0,
                      torch.where(s_iou < bg_thresh_lo, 0.0,
                                  (s_iou - bg_thresh_lo)
                                  / (fg_thresh - bg_thresh_lo)))
    return {"rois": s_rois, "gt_of_rois": gt_canonical * sel_fg[..., None],
            "roi_ious": s_iou, "reg_valid": sel_fg,
            "cls_labels": torch.where(sel_ok, cls, neg)}


def roi_cls_loss(cls_logits, cls_labels):
    """BCE against the IoU-guided soft labels over the cared RoIs (ref:
    roi_head_template.py:136-160)."""
    cared = cls_labels >= 0
    p = torch.clamp(torch.sigmoid(cls_logits), 1e-6, 1 - 1e-6)
    bce = -(cls_labels * torch.log(p) + (1 - cls_labels) * torch.log(1 - p))
    return (bce * cared).sum() / torch.clamp(cared.sum(), min=1.0)


def _size_anchor(rois):
    """The RoI as the coder's anchor of its canonical frame: its sizes at
    the origin, heading 0."""
    z3 = torch.zeros_like(rois[..., :3])
    return torch.cat([z3, rois[..., 3:6], torch.zeros_like(rois[..., 6:7])],
                     dim=-1)


def roi_box_loss(reg_preds, gt_of_rois, rois, reg_valid, code_weights=None,
                 corner_loss_weight: float = 0.0):
    """Smooth-L1 on the canonical-frame residuals over the fg RoIs, plus
    ``corner_loss_weight`` x the corner loss (ref:
    roi_head_template.py:162-238; both boxes stay in the RoI's frame, a
    rigid map of the global one, so corner distances are the same)."""
    anchor = _size_anchor(rois)
    coder = ResidualCoder()
    targets = coder.encode(gt_of_rois[..., :7], anchor)
    loss = weighted_smooth_l1(reg_preds, targets, code_weights=code_weights)
    n_fg = torch.clamp(reg_valid.sum(), min=1.0)
    total = (loss * reg_valid[..., None]).sum() / n_fg
    if corner_loss_weight > 0.0:
        pred = coder.decode(reg_preds, anchor)
        per_roi = get_corner_loss_lidar(
            pred[..., :7].reshape(-1, 7),
            gt_of_rois[..., :7].reshape(-1, 7)).reshape(reg_valid.shape)
        total = total + corner_loss_weight * (per_roi * reg_valid).sum() / n_fg
    return total


def corner_weight_from_cfg(roi_cfg) -> float:
    """``LOSS_CONFIG.LOSS_WEIGHTS.rcnn_corner_weight`` of a ROI_HEAD config
    (default 1) when ``CORNER_LOSS_REGULARIZATION`` is set, else 0."""
    lc = (roi_cfg or {}).get("LOSS_CONFIG", {})
    if not lc.get("CORNER_LOSS_REGULARIZATION", False):
        return 0.0
    return float(lc.get("LOSS_WEIGHTS", {}).get("rcnn_corner_weight", 1.0))


def refine_boxes(rois, reg):
    """The head's (B, R, 7) residuals decoded in each RoI's canonical frame
    and mapped back to the global frame."""
    local = ResidualCoder().decode(reg, _size_anchor(rois))
    h = rois[..., 6]
    c, s = torch.cos(h), torch.sin(h)
    gx = local[..., 0] * c - local[..., 1] * s + rois[..., 0]
    gy = local[..., 0] * s + local[..., 1] * c + rois[..., 1]
    return torch.stack([gx, gy, local[..., 2] + rois[..., 2], local[..., 3],
                        local[..., 4], local[..., 5], local[..., 6] + h],
                       dim=-1)


def target_kwargs(roi_cfg):
    """``assign_proposal_targets``' keyword arguments from TARGET_CONFIG."""
    t = roi_cfg["TARGET_CONFIG"]
    return dict(roi_per_image=int(t.get("ROI_PER_IMAGE", 128)),
                fg_thresh=float(t.get("REG_FG_THRESH", 0.55)),
                bg_thresh_hi=float(t.get("CLS_BG_THRESH", 0.55)),
                bg_thresh_lo=float(t.get("CLS_BG_THRESH_LO", 0.1)),
                fg_ratio=float(t.get("FG_RATIO", 0.5)))


def nms_kwargs(roi_cfg, train: bool):
    """``proposal_layer``'s NMS arguments from NMS_CONFIG.TRAIN / TEST."""
    c = roi_cfg["NMS_CONFIG"]["TRAIN" if train else "TEST"]
    return dict(nms_pre=int(c["NMS_PRE_MAXSIZE"]),
                nms_post=int(c["NMS_POST_MAXSIZE"]),
                nms_thresh=float(c["NMS_THRESH"]))


def propose(dense_head, preds, roi_cfg, train: bool):
    """The anchor head's decoded boxes through :func:`proposal_layer` with
    the config's TRAIN or TEST NMS: (rois, scores, 1-based labels,
    valid), the score the best class's and the label its index."""
    boxes, scores_mc = dense_head.generate_predicted_boxes(preds)
    scores = scores_mc.amax(dim=-1)
    labels = scores_mc.argmax(dim=-1).to(torch.int32) + 1
    return proposal_layer(boxes[..., :7], scores, torch.ones_like(
        scores, dtype=torch.bool), labels=labels,
        **nms_kwargs(roi_cfg, train))


class Proposals(nn.Module):
    """A proposal function (a detector's own, else :func:`propose`, looked
    up at each call) as a module without parameters, called with the
    config's TRAIN or TEST NMS by the module's mode: a forward hook on it
    sees the RoIs (rois, scores, labels, valid) that the RoI head is
    given."""

    def __init__(self, roi_cfg, propose_fn=None):
        super().__init__()
        self.roi_cfg = roi_cfg
        self.propose_fn = propose_fn

    def forward(self, *inputs):
        return (self.propose_fn or propose)(*inputs, self.roi_cfg,
                                            self.training)


def two_stage_loss(dense_head, preds, gt_boxes, cls_logits, reg, targets,
                   roi_cfg, code_weights=None):
    """The first stage's anchor loss plus the RoI losses: (loss, tb_dict
    with ``rcnn_loss_cls`` and ``rcnn_loss_reg`` beside the head's)."""
    rcnn_cls = roi_cls_loss(cls_logits, targets["cls_labels"])
    rcnn_reg = roi_box_loss(reg, targets["gt_of_rois"], targets["rois"],
                            targets["reg_valid"], code_weights=code_weights,
                            corner_loss_weight=corner_weight_from_cfg(roi_cfg))
    rpn_loss, tb = dense_head.get_loss(preds,
                                       dense_head.assign_targets(gt_boxes))
    tb.update({"rcnn_loss_cls": rcnn_cls, "rcnn_loss_reg": rcnn_reg})
    return rpn_loss + rcnn_cls + rcnn_reg, tb


def head_valid(targets):
    """The RoIs a training head computes: fg or cared."""
    return targets["reg_valid"] | (targets["cls_labels"] >= 0)
