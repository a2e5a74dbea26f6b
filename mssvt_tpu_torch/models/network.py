"""``build_network``: the port's model entry point.

The model is built on the card by default (``device="cuda"``) and that
raises when CUDA is absent; it never falls back to the CPU. Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels. Weights
are drawn from a ``torch.Generator`` seeded with ``seed`` (flax-like:
LeCun-normal kernels, zero biases, identity normalisation, the heatmap
output bias at -2.19, an anchor head's class prior and box kernel as
``AnchorHeadSingle.flax_init`` draws them); ``bridge.load_flax_variables``
replaces them with a JAX model's variables.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .backbones_3d.spconv_backbone import SparseConvKernel
from .detectors import build_detector
from .model_utils.layers import (
    BatchNorm,
    Conv2d,
    Conv3d,
    ConvTranspose2d,
    Dense,
)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (Dense, Conv2d, Conv3d, ConvTranspose2d)):
                w = m.weight
                if isinstance(m, ConvTranspose2d):  # (in, out, kh, kw)
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                else:
                    fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.fill_(-2.19 if name.endswith("hm_out") else 0.0)
            elif isinstance(m, BatchNorm):
                m.scale.fill_(1.0)
                m.bias.fill_(0.0)
                m.mean.fill_(0.0)
                m.var.fill_(1.0)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
            elif isinstance(m, SparseConvKernel):  # (K, Cin, Cout)
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(w.shape[0] * w.shape[1]))
        for m in model.modules():  # a head's own flax initialisers
            if hasattr(m, "flax_init"):
                m.flax_init(gen)
    return model


def build_network(model_cfg, num_class, class_names, grid_size, voxel_size,
                  point_cloud_range, batch_size, max_voxels,
                  max_points_per_voxel, num_point_features: int = 5,
                  device="cuda", seed: int = 0):
    """Build the detector of ``model_cfg`` in eval mode on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_network: CUDA is not available; pass "
                           "device='cpu' to run the plain PyTorch versions")
    model = build_detector(
        model_cfg, num_class=num_class, class_names=tuple(class_names),
        grid_size=grid_size, voxel_size=voxel_size,
        point_cloud_range=point_cloud_range, batch_size=batch_size,
        max_voxels=max_voxels, max_points_per_voxel=max_points_per_voxel,
        num_point_features=num_point_features)
    init_weights(model, seed)
    return model.to(device).eval()
