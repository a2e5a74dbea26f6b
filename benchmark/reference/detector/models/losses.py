"""CenterPoint's CenterNet losses (torch counterpart of
``mssvt_tpu/models/losses.py``, cut to them; ref:
pcdet/utils/loss_utils.py), pure functions over padded, masked tensors."""

from __future__ import annotations

import torch


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
