"""Weights made by the benchmark from the seed, on the device, and handed
to both sides: the program's model and the plain reference.

The leaves of the reference model are drawn in one ``torch.randn`` call
on the device (a ``torch.Generator`` there, seeded with the run's seed) and
scaled leaf by leaf, flax's initialisers as the port's ``init_weights``
states them: LeCun normal kernels (standard deviation 1 / sqrt(fan_in)),
zero biases (the heatmap output's at -2.19), identity normalisation. The
BatchNorm statistics are then those of one forward of the reference over
a batch of the traffic (momentum 0 for it): with LeCun kernels on sparse
inputs the features otherwise fade by orders of magnitude a layer and
every score ties."""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.reference.detector.models.model_utils.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    Dense,
)

HM_BIAS = -2.19


def _plan(model):
    """[(leaf, std or None for a constant, constant)] in module order."""
    plan = []
    for name, m in model.named_modules():
        if isinstance(m, (Dense, Conv2d, ConvTranspose2d)):
            w = m.weight
            if isinstance(m, ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            plan.append((w, 1.0 / math.sqrt(fan_in), 0.0))
            if m.bias is not None:
                plan.append((m.bias, None,
                             HM_BIAS if name.endswith("hm_out") else 0.0))
        elif isinstance(m, BatchNorm):
            plan += [(m.scale, None, 1.0), (m.bias, None, 0.0),
                     (m.mean, None, 0.0), (m.var, None, 1.0)]
        elif isinstance(m, nn.LayerNorm):
            plan += [(m.weight, None, 1.0), (m.bias, None, 0.0)]
    return plan


def initialise(model, seed, device):
    """Draw every leaf of ``model`` (already on ``device``) from ``seed``;
    returns the names of the leaves it set."""
    plan = _plan(model)
    total = sum(t.numel() for t, std, _ in plan if std is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device)
    at = 0
    with torch.no_grad():
        for t, std, const in plan:
            if std is None:
                t.fill_(const)
            else:
                n = t.numel()
                t.copy_(draw[at:at + n].view(t.shape) * std)
                at += n
    ids = {id(t) for t, _, _ in plan}
    return [k for k, v in list(model.named_parameters())
            + list(model.named_buffers()) if id(v) in ids]


def calibrate(model, batch, forward):
    """BatchNorm statistics from one ``forward(model, batch, post=False)``
    with the BatchNorm layers in training mode at momentum 0."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.momentum for m in bns]
    try:
        for m in bns:
            m.momentum = 0.0
            m.train()
        with torch.no_grad():
            forward(model, batch, post=False)
    finally:
        for m, mom in zip(bns, saved):
            m.momentum = mom
            m.eval()


def make(ref_model, seed, device, calib_batch, forward):
    """The benchmark's weights: ``ref_model`` initialised in place from
    ``seed`` and its BatchNorm statistics calibrated on ``calib_batch``;
    returns its state restricted to the leaves set here."""
    names = initialise(ref_model, seed, device)
    calibrate(ref_model, calib_batch, forward)
    state = ref_model.state_dict()
    return {k: state[k] for k in names}
