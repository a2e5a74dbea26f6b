"""Detection losses (torch counterpart of ``mssvt_tpu/models/losses.py``;
ref: pcdet/utils/loss_utils.py): CenterPoint's CenterNet losses and the
anchor heads' focal, smooth-L1, L1 and cross-entropy losses, pure
functions over padded, masked tensors."""

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
