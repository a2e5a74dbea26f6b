"""Detection losses (torch counterpart of ``mssvt_tpu/models/losses.py``;
ref: pcdet/utils/loss_utils.py): CenterPoint's CenterNet losses, the
anchor heads' focal, smooth-L1, L1 and cross-entropy losses and the RoI
heads' corner loss, pure functions over padded, masked tensors."""

from __future__ import annotations

import torch


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def sigmoid_focal_cls_loss(pred_logits, target, weights, gamma=2.0,
                           alpha=0.25):
    """Sigmoid focal loss per anchor and class (ref: loss_utils.py:9-73),
    times ``weights[..., None]`` when given."""
    pred_sigmoid = torch.clamp(_sigmoid(pred_logits), 1e-7, 1 - 1e-7)
    alpha_weight = target * alpha + (1 - target) * (1 - alpha)
    pt = target * (1.0 - pred_sigmoid) + (1.0 - target) * pred_sigmoid
    focal_weight = alpha_weight * torch.pow(pt, gamma)
    # BCE with logits, the numerically stable form
    bce = (torch.clamp(pred_logits, min=0) - pred_logits * target
           + torch.log1p(torch.exp(-torch.abs(pred_logits))))
    loss = focal_weight * bce
    return loss * weights[..., None] if weights is not None else loss


def weighted_smooth_l1(pred, target, weights=None, beta=1.0 / 9.0,
                       code_weights=None):
    """Smooth-L1 per code (ref: loss_utils.py:75-137)."""
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
    n = torch.abs(diff)
    loss = torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)
    return loss * weights[..., None] if weights is not None else loss


def weighted_l1(pred, target, weights=None, code_weights=None):
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
    loss = torch.abs(diff)
    return loss * weights[..., None] if weights is not None else loss


def weighted_cross_entropy(pred_logits, target_onehot, weights):
    """Cross-entropy per anchor on one-hot targets (ref:
    loss_utils.py:181-207)."""
    m = pred_logits.max(dim=-1, keepdim=True).values
    lse = m + torch.log(torch.exp(pred_logits - m).sum(dim=-1, keepdim=True))
    loss = -(target_onehot * (pred_logits - lse)).sum(-1)
    return loss * weights


def focal_loss_centernet(pred, gt):
    """CornerNet focal loss on an already-sigmoided (B, C, H, W) heatmap:
    positives at gt == 1, negatives weighted (1 - gt)^4, normalised by the
    number of positives."""
    pos_inds = (gt == 1.0).to(pred.dtype)
    neg_inds = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - gt, 4)
    pos_loss = (torch.log(pred) * torch.pow(1 - pred, 2) * pos_inds).sum()
    neg_loss = (torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights
                * neg_inds).sum()
    num_pos = pos_inds.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def reg_loss_centernet(pred_bhwc, mask, ind, target):
    """Masked L1 at the object centres, per code dimension (c,), each
    normalised by (number of positives + 1e-4). The predictions are picked
    by advanced indexing: several boxes may share a centre (padding boxes
    all use index 0), and its backward sums them deterministically (see
    ``ops/sampling.py``)."""
    b, h, w, c = pred_bhwc.shape
    flat = pred_bhwc.reshape(b, h * w, c)
    rows = torch.arange(b, device=flat.device)[:, None]
    pred = flat[rows, ind.long()]  # (B, M, c)
    m = mask[..., None].to(pred.dtype)
    num = mask.to(pred.dtype).sum()
    loss = torch.abs(pred * m - target * m)
    return loss.sum(dim=(0, 1)) / (num + 1e-4)


_CORNERS = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
            (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))


def _boxes_to_corners_3d(boxes):
    """(N, 7) -> (N, 8, 3) corners in the reference's order (x-major, the
    bottom face first; ref: box_utils.py boxes_to_corners_3d)."""
    template = torch.tensor(_CORNERS, dtype=boxes.dtype,
                            device=boxes.device) / 2
    corners = boxes[:, None, 3:6] * template[None]
    cosa = torch.cos(boxes[:, 6])[:, None]
    sina = torch.sin(boxes[:, 6])[:, None]
    x = corners[..., 0] * cosa - corners[..., 1] * sina
    y = corners[..., 0] * sina + corners[..., 1] * cosa
    return torch.stack([x, y, corners[..., 2]], dim=-1) + boxes[:, None, 0:3]


def _safe_norm(v):
    """L2 norm over the last axis with a zero gradient where it is 0 (padded
    RoIs give coincident corners, where sqrt's derivative is infinite)."""
    s = (v * v).sum(dim=2)
    nz = s > 1e-12
    return torch.sqrt(torch.where(nz, s, 1.0)) * nz


def get_corner_loss_lidar(pred_bbox3d, gt_bbox3d):
    """Corner-distance smooth-L1 (beta 1) against the GT box and its
    pi-flipped twin, the smaller of the two a corner, averaged over the 8
    corners (ref: loss_utils.py:209-233): (N, 7) x (N, 7) -> (N,)."""
    pred_c = _boxes_to_corners_3d(pred_bbox3d)
    gt_c = _boxes_to_corners_3d(gt_bbox3d)
    flip = torch.cat([gt_bbox3d[:, :6], gt_bbox3d[:, 6:7] + torch.pi,
                      gt_bbox3d[:, 7:]], dim=1)
    gt_c_flip = _boxes_to_corners_3d(flip)
    d = torch.minimum(_safe_norm(pred_c - gt_c), _safe_norm(pred_c - gt_c_flip))
    loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    return loss.mean(dim=1)
