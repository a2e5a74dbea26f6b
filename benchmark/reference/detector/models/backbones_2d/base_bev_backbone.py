"""Multi-scale dense BEV backbone (torch counterpart of
``mssvt_tpu/models/backbones_2d/base_bev_backbone.py``): strided down blocks
and transposed-conv up blocks, concatenated. NHWC at the public boundary."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..model_utils.layers import BatchNorm, Conv2d, ConvTranspose2d


class BaseBEVBackbone(nn.Module):
    def __init__(self, in_channels: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[int] = (),
                 num_upsample_filters: Sequence[int] = (),
                 dtype=torch.float32):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.upsample_strides = tuple(upsample_strides)
        self.compute_dtype = dtype
        bn = lambda c: BatchNorm(c, 1e-3, momentum=0.99, dtype=dtype)
        c_in = in_channels
        for i, nf in enumerate(num_filters):
            self.add_module(f"block{i}_conv0", Conv2d(
                c_in, nf, 3, stride=layer_strides[i], padding=1, bias=False,
                dtype=dtype))
            self.add_module(f"block{i}_bn0", bn(nf))
            for k in range(layer_nums[i]):
                self.add_module(f"block{i}_conv{k + 1}", Conv2d(
                    nf, nf, 3, padding=1, bias=False, dtype=dtype))
                self.add_module(f"block{i}_bn{k + 1}", bn(nf))
            if upsample_strides:
                s = upsample_strides[i]
                nu = num_upsample_filters[i]
                if s >= 1:
                    up = ConvTranspose2d(nf, nu, int(s), stride=int(s),
                                         bias=False, dtype=dtype)
                else:
                    s_inv = int(np.round(1 / s))
                    up = Conv2d(nf, nu, s_inv, stride=s_inv, bias=False,
                                dtype=dtype)
                self.add_module(f"deblock{i}_conv", up)
                self.add_module(f"deblock{i}_bn", bn(nu))
            c_in = nf
        self.num_bev_features = (sum(num_upsample_filters)
                                 if num_upsample_filters else num_filters[-1])
        if len(self.upsample_strides) > len(self.layer_nums):
            s = int(self.upsample_strides[-1])
            c = self.num_bev_features
            self.deblock_extra_conv = ConvTranspose2d(c, c, s, stride=s,
                                                      bias=False, dtype=dtype)
            self.deblock_extra_bn = bn(c)

    def forward(self, x):
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        ups = []
        for i, n in enumerate(self.layer_nums):
            for k in range(n + 1):
                x = getattr(self, f"block{i}_conv{k}")(x)
                x = torch.relu(getattr(self, f"block{i}_bn{k}")(x))
            if self.upsample_strides:
                u = getattr(self, f"deblock{i}_conv")(x)
                ups.append(torch.relu(getattr(self, f"deblock{i}_bn")(u)))
            else:
                ups.append(x)
        if len(ups) > 1:
            # odd maps make the transposed conv overshoot by a pixel: crop
            h = min(u.shape[2] for u in ups)
            w = min(u.shape[3] for u in ups)
            out = torch.cat([u[:, :, :h, :w] for u in ups], dim=1)
        else:
            out = ups[0]
        if len(self.upsample_strides) > len(self.layer_nums):
            out = torch.relu(self.deblock_extra_bn(self.deblock_extra_conv(out)))
        return out.permute(0, 2, 3, 1).float()
