"""CenterNet heatmap decoding with static shapes (torch counterpart of the
decode half of ``mssvt_tpu/models/model_utils/centernet.py``).

``topk_heatmap`` is exact: a stable descending sort keeps equal scores in
index order, which is what CPU JAX's ``top_k`` gives (the TPU path's
``approx_max_k`` is an approximation of the same).
"""

from __future__ import annotations

import torch

from ...utils.device import device_constant


def _topk(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_heatmap(scores, k: int):
    """Two-stage top-K over (B, C, H, W): per class, then across classes.
    Returns (scores, flat inds, classes, ys, xs), each (B, K)."""
    b, _, h, w = scores.shape
    flat = scores.reshape(b, scores.shape[1], h * w)
    topk_scores, topk_inds = _topk(flat, k)  # (B, C, K)
    topk_ys = (topk_inds // w).float()
    topk_xs = (topk_inds % w).float()
    topk_score, topk_ind = _topk(topk_scores.reshape(b, -1), k)
    topk_classes = (topk_ind // k).to(torch.int32)

    def g(x):
        return torch.gather(x.reshape(b, -1), 1, topk_ind)

    return topk_score, g(topk_inds), topk_classes, g(topk_ys), g(topk_xs)


def decode_bbox_from_heatmap(heatmap, rot_cos, rot_sin, center, center_z,
                             dim, point_cloud_range, voxel_size,
                             feature_map_stride, vel=None, k=100,
                             score_thresh=None, post_center_limit_range=None):
    """NHWC heads -> (boxes (B, K, 7/9), scores, labels (0-based), mask);
    masked entries are kept, not removed."""
    b, h, w, _ = heatmap.shape
    scores, inds, class_ids, ys, xs = topk_heatmap(
        heatmap.permute(0, 3, 1, 2), k)

    def gather(feat):
        c = feat.shape[-1]
        return torch.gather(feat.reshape(b, h * w, c), 1,
                            inds[..., None].expand(-1, -1, c))

    center = gather(center)
    angle = torch.atan2(gather(rot_sin), gather(rot_cos))
    xs = (xs[..., None] + center[..., 0:1]) * feature_map_stride \
        * voxel_size[0] + point_cloud_range[0]
    ys = (ys[..., None] + center[..., 1:2]) * feature_map_stride \
        * voxel_size[1] + point_cloud_range[1]
    parts = [xs, ys, gather(center_z), gather(dim), angle]
    if vel is not None:
        parts.append(gather(vel))
    boxes = torch.cat(parts, dim=-1)
    mask = torch.ones_like(scores, dtype=torch.bool)
    if post_center_limit_range is not None:
        r = device_constant(post_center_limit_range, boxes.device,
                            torch.float32)
        mask &= (boxes[..., :3] >= r[:3]).all(dim=-1)
        mask &= (boxes[..., :3] <= r[3:]).all(dim=-1)
    if score_thresh is not None:
        mask &= scores > score_thresh
    return boxes, scores, class_ids, mask
