"""CenterNet target drawing and heatmap decoding with static shapes (torch
counterpart of ``mssvt_tpu/models/model_utils/centernet.py``).

``topk_heatmap`` is exact: a stable descending sort keeps equal scores in
index order, which is what CPU JAX's ``top_k`` gives (the TPU path's
``approx_max_k`` is an approximation of the same).
"""

from __future__ import annotations

import torch

from ...utils.device import device_constant


def gaussian_radius(height, width, min_overlap=0.5):
    """CornerNet radius heuristic: the smallest of three quadratic roots."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt(torch.clamp(b1 ** 2 - 4 * a1 * c1, min=0))
    r1 = (b1 + sq1) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0))
    r2 = (b2 + sq2) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0))
    r3 = (b3 + sq3) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def _sigma(radii):
    return (2 * radii.float() + 1) / 6.0


def draw_gaussians(heatmap_shape, centers, radii, class_ids, valid,
                   max_radius: int):
    """Scatter-max of every box's (2r+1)^2 gaussian patch into a
    (B, num_classes, H, W) f32 heatmap: sigma = (2r+1)/6, cells outside the
    radius box or the map dropped, overlaps resolved by max (an order-free
    reduction). ``centers`` (B, M, 2) are (x, y) map coordinates, truncated
    to int; ``radii`` (B, M) int, clipped to ``max_radius``."""
    b, num_classes, h, w = heatmap_shape
    m = centers.shape[1]
    p = 2 * max_radius + 1
    dev = centers.device
    radii = torch.clamp(radii, max=max_radius)
    cx = centers[..., 0].to(torch.int32)
    cy = centers[..., 1].to(torch.int32)
    d = torch.arange(-max_radius, max_radius + 1, device=dev)
    dyy, dxx = torch.meshgrid(d, d, indexing="ij")
    sigma = _sigma(radii)
    d2 = (dxx ** 2 + dyy ** 2).float()
    g = torch.exp(-d2[None, None] / (2.0 * sigma[..., None, None] ** 2))
    r = radii[..., None, None]
    in_radius = (dxx.abs()[None, None] <= r) & (dyy.abs()[None, None] <= r)
    px = cx[..., None, None] + dxx[None, None]
    py = cy[..., None, None] + dyy[None, None]
    in_map = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    ok = in_radius & in_map & valid[..., None, None]
    bid = torch.arange(b, device=dev)[:, None, None, None].expand(b, m, p, p)
    cls = class_ids[..., None, None].expand(b, m, p, p).long()
    flat = ((bid * num_classes + cls) * h + py) * w + px
    flat = torch.where(ok, flat, b * num_classes * h * w)
    heat = torch.zeros(b * num_classes * h * w + 1, device=dev)
    heat.scatter_reduce_(0, flat.reshape(-1), g.reshape(-1), "amax")
    return heat[:-1].reshape(b, num_classes, h, w)


def draw_gaussians_dense(heatmap_shape, centers, radii, class_ids, valid,
                         max_radius: int):
    """:func:`draw_gaussians` evaluated densely: every gaussian at every map
    cell, max over boxes per class. Same output; used while the
    (B, M, H, W) sweep is small."""
    b, num_classes, h, w = heatmap_shape
    dev = centers.device
    radii = torch.clamp(radii, max=max_radius)
    cx = centers[..., 0].to(torch.int32)[..., None, None]
    cy = centers[..., 1].to(torch.int32)[..., None, None]
    ys = torch.arange(h, device=dev)[None, None, :, None]
    xs = torch.arange(w, device=dev)[None, None, None, :]
    dx = (xs - cx).float()
    dy = (ys - cy).float()
    sigma = _sigma(radii)
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma[..., None, None] ** 2))
    r = radii.float()[..., None, None]
    ok = (dx.abs() <= r) & (dy.abs() <= r) & valid[..., None, None]
    g = torch.where(ok, g, 0.0)
    heat = [torch.where((class_ids == c)[..., None, None], g, 0.0).amax(dim=1)
            for c in range(num_classes)]
    return torch.stack(heat, dim=1).float()


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
