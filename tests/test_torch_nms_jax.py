"""The port's packed NMS mask (``mssvt_tpu_torch/kernels/nms_iou.py``) and
its early-out against the JAX package's rotated-BEV IoU
(``mssvt_tpu/ops/box_ops.py``), on the CPU. ``tests/test_torch_nms.py``
holds the same cases against the port's own IoU and imports nothing of
JAX, so the card tests can import them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.ops.box_ops import pairwise_iou_bev
from mssvt_tpu_torch.kernels import nms_iou
from test_torch_nms import EDGE_CASES, _near_boundary_boxes, _rows


def _mask_boxes(name):
    if name in EDGE_CASES:
        return _rows(EDGE_CASES[name])
    rng = np.random.default_rng(5)
    return torch.from_numpy(np.stack([
        np.array([rng.uniform(0, 15), rng.uniform(0, 15), 0.0,
                  rng.uniform(0.5, 4), rng.uniform(0.5, 4), 1.0,
                  rng.uniform(-np.pi, np.pi)], np.float32)
        for _ in range(70)])[None])


@pytest.mark.parametrize("thresh", [0.0, 0.01, 0.5])
@pytest.mark.parametrize("name", sorted(EDGE_CASES) + ["seeded"])
def test_port_packed_mask_matches_this_iou(name, thresh):
    """The port's packed NMS words (its CPU route, the mask kernel's plain
    version) hold the JAX package's ``pairwise_iou_bev > thresh`` over the
    strict upper triangle, but where the IoU lies within 1e-5 of the
    threshold (the two round apart): identical, abutting, collinear, 45
    degree and zero-size boxes, and 70 seeded ones (K past a word)."""
    boxes = _mask_boxes(name)
    k = boxes.shape[1]
    got = nms_iou.unpack(nms_iou.nms_iou_mask(boxes, thresh), k)[0].numpy()
    b = jnp.asarray(boxes[0].numpy())
    iou = np.asarray(pairwise_iou_bev(b, b))
    tri = np.triu(np.ones((k, k), bool), 1)
    band = np.abs(iou - thresh) <= 1e-5
    assert not got[~tri].any()
    assert not ((got != ((iou > thresh) & tri)) & ~band).any()


@pytest.mark.parametrize("seed", range(3))
def test_port_early_out_skips_only_pairs_of_iou_zero(seed):
    """Every pair the port's mask kernel skips (``far_apart``) has an IoU of
    exactly 0 in the JAX package too, on boxes placed just past the
    reach."""
    boxes = _near_boundary_boxes(seed)
    far = nms_iou.far_apart(boxes, boxes)[0].numpy()
    b = jnp.asarray(boxes[0].numpy())
    iou = np.asarray(pairwise_iou_bev(b, b))
    assert far.sum() > 1000 and (iou[far] == 0).all()
