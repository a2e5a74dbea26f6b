"""Camera-based voxel feature encoding, CaDDN's ImageVFE (torch counterpart
of ``mssvt_tpu/models/backbones_3d/image_vfe.py``; ref:
pcdet/models/backbones_3d/vfe/image_vfe.py + image_vfe_modules/).

- :class:`DepthFFN`: the JAX package's DeepLabV3-style network (a
  BasicBlock encoder at stride 2^num_blocks, ASPP, then a 3x3 feature head
  and a 1x1 head of D+1 depth-bin logits), not torchvision's DeepLabV3.
  Every conv pads as flax's ``SAME`` (``Conv2d(padding="SAME")``).
- :func:`ddn_loss`: the focal cross-entropy over the D+1 LID bins against
  the lidar depth map resized to the logits' grid, balanced by the 2D GT
  boxes.
- :class:`ImageVFE`: every voxel centre projected through the calibration
  into (u, v, depth) on the feature map; its feature is the bilinear sample
  of the image features weighted by the bilinear sample of the depth
  probability, lerped between its two LID bins.

Two behaviours of the JAX module are kept as they are: the feature stride
is ``H // h`` (at KITTI's 375 rows the map has 47, so the stride is 7, not
8), and the depth map is resized with half-pixel nearest sampling
(``nearest-exact``, as ``jax.image.resize``).

The sampler differs from the JAX module in how, not what: it gathers only
the two depth bins a voxel needs at each corner (JAX bilerps all D bins and
takes two), loops over the frames (JAX vmaps), gathers through
``ops.sampling.gather_rows`` (every out-of-view voxel is clipped onto an
edge pixel, whose row then collects hundreds of thousands of picks: the
backward is a parallel ``segment_sum``), and clamps u and v in float before
the integer cast (in-view voxels are unchanged).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.sampling import gather_rows
from ..model_utils.layers import BatchNorm, Conv2d


def bin_depths_lid(depth, depth_min, depth_max, num_bins):
    """The continuous LID bin of ``depth`` (ref:
    utils/transform_utils.py:bin_depths): ``-0.5 + 0.5 * sqrt(1 + 8 (d -
    dmin) / w)`` with ``w = 2 (dmax - dmin) / (D (1 + D))``, the depth
    clamped to [dmin, dmax] before the sqrt, the index to [0, D - 1]."""
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    d = torch.clamp(depth, depth_min, depth_max)
    idx = -0.5 + 0.5 * torch.sqrt(1 + 8 * (d - depth_min) / bin_size)
    return torch.clamp(idx, 0, num_bins - 1)


def _bn(c, dtype):
    return BatchNorm(c, 1e-3, momentum=0.99, dtype=dtype)


class _BasicBlock(nn.Module):
    """ResNet BasicBlock (conv-bn-relu-conv-bn + skip, a 1x1 strided
    projection when the width or the stride changes), NCHW."""

    def __init__(self, in_channels, channels, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride=stride,
                            padding="SAME", bias=False, dtype=dtype)
        self.bn1 = _bn(channels, dtype)
        self.conv2 = Conv2d(channels, channels, 3, padding="SAME", bias=False,
                            dtype=dtype)
        self.bn2 = _bn(channels, dtype)
        if in_channels != channels or stride != 1:
            self.down = Conv2d(in_channels, channels, 1, stride=stride,
                               padding="SAME", bias=False, dtype=dtype)
            self.down_bn = _bn(channels, dtype)

    def forward(self, x):
        r = x
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.bn2(self.conv2(x))
        if hasattr(self, "down"):
            r = self.down_bn(self.down(r))
        return torch.relu(x + r)


class _ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, dilated 3x3 branches
    at ``rates``, the image-level mean through a 1x1 conv, concatenated and
    fused by a 1x1 conv, BN and ReLU."""

    def __init__(self, in_channels, channels, rates: Sequence[int] = (1, 6, 12),
                 dtype=torch.float32):
        super().__init__()
        self.rates = tuple(rates)
        self.aspp_1x1 = Conv2d(in_channels, channels, 1, padding="SAME",
                               bias=False, dtype=dtype)
        for r in self.rates:
            self.add_module(f"aspp_r{r}", Conv2d(
                in_channels, channels, 3, dilation=r, padding="SAME",
                bias=False, dtype=dtype))
        self.aspp_pool = Conv2d(in_channels, channels, 1, padding="SAME",
                                bias=False, dtype=dtype)
        self.aspp_proj = Conv2d(channels * (len(self.rates) + 2), channels, 1,
                                padding="SAME", bias=False, dtype=dtype)
        self.aspp_bn = _bn(channels, dtype)

    def forward(self, x):
        outs = [torch.relu(self.aspp_1x1(x))]
        for r in self.rates:
            outs.append(torch.relu(getattr(self, f"aspp_r{r}")(x)))
        g = torch.relu(self.aspp_pool(x.mean(dim=(2, 3), keepdim=True)))
        outs.append(g.expand_as(outs[0]))
        return torch.relu(self.aspp_bn(self.aspp_proj(torch.cat(outs, 1))))


class DepthFFN(nn.Module):
    """(B, H, W, 3) images -> (image features (B, h, w, C), depth logits
    (B, h, w, D + 1)), both f32 channels-last, h = H / 2^num_blocks rounded
    up at each stride-2 conv. Stage i of the encoder has ``C * 2^min(i,
    2)`` channels."""

    def __init__(self, num_depth_bins: int, num_channels: int = 32,
                 num_blocks: int = 3, blocks_per_stage: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.num_blocks, self.blocks_per_stage = num_blocks, blocks_per_stage
        self.compute_dtype = dtype
        c = num_channels
        self.stem = Conv2d(3, c, 3, stride=2, padding="SAME", bias=False,
                           dtype=dtype)
        self.stem_bn = _bn(c, dtype)
        c_in = c
        for i in range(1, num_blocks):
            cs = c * (2 ** min(i, 2))
            for j in range(blocks_per_stage):
                self.add_module(f"stage{i}_block{j}", _BasicBlock(
                    c_in, cs, stride=2 if j == 0 else 1, dtype=dtype))
                c_in = cs
        ca = c * (2 ** min(num_blocks - 1, 2))
        self.aspp = _ASPP(c_in, ca, dtype=dtype)
        self.feat_head = Conv2d(ca, c, 3, padding="SAME", dtype=dtype)
        self.depth_head = Conv2d(ca, num_depth_bins + 1, 1, padding="SAME",
                                 dtype=dtype)

    def forward(self, images):
        # contiguous NCHW: PyTorch's CPU backward of the strided 1x1
        # projection on a channels-last input (what the permute gives)
        # corrupts memory when run on more than two threads
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()
        x = torch.relu(self.stem_bn(self.stem(x)))
        for i in range(1, self.num_blocks):
            for j in range(self.blocks_per_stage):
                x = getattr(self, f"stage{i}_block{j}")(x)
        x = self.aspp(x)
        nhwc = lambda t: t.float().permute(0, 2, 3, 1)  # noqa: E731
        return nhwc(self.feat_head(x)), nhwc(self.depth_head(x))


def ddn_loss(depth_logits, depth_maps, d_min, d_max, n_bins,
             gt_boxes2d=None, alpha=0.25, gamma=2.0,
             fg_weight=13.0, bg_weight=1.0):
    """The depth-distribution loss (ref: ffn/ddn_loss/ddn_loss.py +
    balancer.py): focal cross-entropy over the D+1 LID bins of
    ``depth_logits`` (B, h, w, D+1) against ``depth_maps`` (B, H, W) in
    metres (0: no depth) resized to (h, w), pixels inside any of the
    optional (B, N, 4) [u1, v1, u2, v2] full-image ``gt_boxes2d`` weighted
    ``fg_weight``, summed over the pixels with depth and divided by their
    count. Returns (loss, tb_dict)."""
    b, h, w, _ = depth_logits.shape
    gt = F.interpolate(depth_maps[:, None].float(), size=(h, w),
                       mode="nearest-exact")[:, 0]
    valid = gt > 0
    bins = torch.where((gt > d_min) & (gt < d_max),
                       bin_depths_lid(gt, d_min, d_max, n_bins).to(torch.int64),
                       n_bins)
    logp = torch.log_softmax(depth_logits, dim=-1)
    pt = torch.gather(logp, -1, bins[..., None])[..., 0]
    focal = -alpha * (1.0 - torch.exp(pt)) ** gamma * pt

    if gt_boxes2d is not None:
        stride = depth_maps.shape[1] // h
        dev = depth_logits.device
        u = (torch.arange(w, device=dev) * stride)[None, None, :, None]
        v = (torch.arange(h, device=dev) * stride)[None, :, None, None]
        bx = gt_boxes2d[:, None, None, :, :]  # (B, 1, 1, N, 4)
        inside = ((u >= bx[..., 0]) & (u <= bx[..., 2]) & (v >= bx[..., 1])
                  & (v <= bx[..., 3]) & (bx[..., 2] > bx[..., 0]))
        fg = inside.any(dim=-1)  # (B, h, w)
    else:
        fg = torch.zeros((b, h, w), dtype=torch.bool,
                         device=depth_logits.device)
    weights = torch.where(fg, fg_weight, bg_weight) * valid
    n_pix = torch.clamp(valid.sum(), min=1)
    loss = (focal * weights).sum() / n_pix
    return loss, {
        "ddn_loss_fg": (focal * torch.where(fg, fg_weight, 0.0) * valid).sum()
        / n_pix,
        "ddn_loss_bg": (focal * torch.where(fg, 0.0, bg_weight) * valid).sum()
        / n_pix}


class ImageVFE(nn.Module):
    """DepthFFN -> frustum features -> the dense (B, X, Y, Z, C) voxel grid
    (channels-last, as the JAX module's), with the depth logits for the
    depth loss. Ref: vfe/image_vfe.py:7-60."""

    def __init__(self, model_cfg: Any, grid_size: Tuple[int, int, int],
                 voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float], dtype=torch.float32):
        super().__init__()
        ddn_cfg = model_cfg.get("FFN", {}).get("DDN_CFG", {})
        disc = model_cfg.get("DISCRETIZE", {})
        self.d_min = float(disc.get("DEPTH_MIN", 2.0))
        self.d_max = float(disc.get("DEPTH_MAX", 46.8))
        self.n_bins = int(disc.get("NUM_BINS", 80))
        self.grid_size = tuple(int(g) for g in grid_size)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.ffn = DepthFFN(
            num_depth_bins=self.n_bins,
            num_channels=int(ddn_cfg.get("NUM_CHANNELS", 32)),
            num_blocks=int(ddn_cfg.get("NUM_BLOCKS", 3)),
            blocks_per_stage=int(ddn_cfg.get("BLOCKS_PER_STAGE", 1)),
            dtype=dtype)

    def voxel_centers(self, device):
        """(X * Y * Z, 3) metric voxel centres, x slowest, z fastest."""
        gx, gy, gz = self.grid_size
        idx = torch.stack(torch.meshgrid(
            torch.arange(gx, device=device), torch.arange(gy, device=device),
            torch.arange(gz, device=device), indexing="ij"), -1).reshape(-1, 3)
        vs = torch.tensor(self.voxel_size, device=device)
        mins = torch.tensor(self.point_cloud_range[:3], device=device)
        return (idx.float() + 0.5) * vs + mins

    def forward(self, images, lidar_to_cam, cam_to_img):
        """images (B, H, W, 3), lidar_to_cam (B, 4, 4), cam_to_img (B, 3, 4)
        -> (voxel features (B, X, Y, Z, C), depth logits (B, h, w, D+1))."""
        feat, depth_logits = self.ffn(images)
        depth_prob = torch.softmax(depth_logits, dim=-1)[..., :self.n_bins]
        b, fh, fw, c = feat.shape
        stride = images.shape[1] // fh
        centers = self.voxel_centers(feat.device)
        vox = [self.sample_frame(centers, lidar_to_cam[i].float(),
                                 cam_to_img[i].float(), feat[i], depth_prob[i],
                                 stride)
               for i in range(b)]
        return torch.stack(vox).reshape(b, *self.grid_size, c), depth_logits

    def sample_frame(self, centers, l2c, c2i, fmap, dprob, stride):
        """One frame's (N, C) voxel features: the bilinear sample of
        ``fmap`` (h, w, C) at each centre's projection times the bilinear
        sample of ``dprob`` (h, w, D) lerped between the centre's two LID
        bins, zero outside the view or the depth range."""
        fh, fw, c = fmap.shape
        d = self.n_bins
        ones = torch.ones_like(centers[:, :1])
        cam = (torch.cat([centers, ones], -1) @ l2c.T)[:, :3]
        img = torch.cat([cam, ones], -1) @ c2i.T  # (N, 3)
        depth = img[:, 2]
        u = img[:, 0] / torch.clamp(depth, min=1e-3) / stride
        v = img[:, 1] / torch.clamp(depth, min=1e-3) / stride
        inb = ((u >= 0) & (u < fw - 1) & (v >= 0) & (v < fh - 1)
               & (depth > self.d_min) & (depth < self.d_max))
        # int(clamp(u)) == int(u) wherever int(u) is defined, then clipped
        u0 = torch.clamp(torch.clamp(u, -1.0, float(fw)).to(torch.int64),
                         0, fw - 2)
        v0 = torch.clamp(torch.clamp(v, -1.0, float(fh)).to(torch.int64),
                         0, fh - 2)
        du = torch.clamp(u - u0, 0, 1)[:, None]
        dv = torch.clamp(v - v0, 0, 1)[:, None]
        pix = v0 * fw + u0
        corners = torch.stack([pix, pix + 1, pix + fw, pix + fw + 1])

        def bilerp(g):  # (4, N, k) corner values -> (N, k)
            return ((1 - dv) * ((1 - du) * g[0] + du * g[1])
                    + dv * ((1 - du) * g[2] + du * g[3]))

        f = bilerp(gather_rows(fmap.reshape(fh * fw, c), corners))
        dbin = bin_depths_lid(depth, self.d_min, self.d_max, d)
        b0 = torch.clamp(dbin.to(torch.int64), 0, d - 1)
        frac = (dbin - b0)[:, None]
        b1 = torch.clamp(b0 + 1, 0, d - 1)
        p = gather_rows(dprob.reshape(fh * fw * d, 1),
                        torch.stack([corners * d + b0, corners * d + b1]))
        w = (1 - frac) * bilerp(p[0]) + frac * bilerp(p[1])
        return (f * w) * inb[:, None]
