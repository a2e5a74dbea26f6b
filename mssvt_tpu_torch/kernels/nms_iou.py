"""The rotated-IoU suppression mask of the greedy NMS, packed as the scan
reads it.

Replaces no TPU kernel (the JAX package computes the candidates' IoU
inside jit, ``mssvt_tpu/ops/box_ops.py``). Given candidates (B, K, C >= 7)
f32 (x, y, z, dx, dy, dz, heading, ...) and a threshold >= 0, it returns
(B, K, ceil(K / 64)) int64 words: bit j % 64 of row i's word j // 64 is
``pairwise_iou_bev(boxes[:, i], boxes[:, j]) > thresh`` for j > i, and 0
for j <= i and past K. Words left of a row's diagonal word (w < i // 64)
are never read: the kernel leaves them as it found them, the plain version
writes 0. ``kernels/nms.nms_greedy_packed`` scans the result.

CUDA tensors go to ``csrc/nms_iou.cu`` (64 x 64 candidates a CTA, upper
triangle only; pairs that :func:`far_apart` names are skipped, their IoU
being exactly 0); CPU tensors to :func:`iou_mask_plain`, the plain IoU in
row blocks (:func:`overlaps`, the route ``ops.nms.nms_bev`` takes on the
CPU) packed by :func:`pack_upper`.
"""

from __future__ import annotations

import torch

from ..ops.box_ops import pairwise_iou_bev
from . import _lib, work

launches = 0
WORD = 64
MIN_SIDE = 1e-2  # narrower boxes never take the early-out (csrc/nms_iou.cu)
SLACK = 1e-4     # the early-out's slack over the coordinates' scale


# candidate pairs a block of the plain IoU: its largest temporaries are
# (B, rows, K, 4, 2) f32, 256 MiB at this many pairs (a whole 4 x 4096^2
# matrix at once would take ~2 GiB each)
IOU_BLOCK_PAIRS = 1 << 23


def overlaps(c7, thresh: float):
    """(B, K, K) ``pairwise_iou_bev(c7, c7) > thresh``, computed in row
    blocks of at most ``IOU_BLOCK_PAIRS`` pairs (each element's IoU is
    the same whatever the block)."""
    b, k = c7.shape[:2]
    rows = max(1, IOU_BLOCK_PAIRS // max(1, b * k))
    if rows >= k:
        return pairwise_iou_bev(c7, c7) > thresh
    return torch.cat([pairwise_iou_bev(c7[:, i:i + rows], c7) > thresh
                      for i in range(0, k, rows)], dim=1)


def words_of(k: int) -> int:
    return (k + WORD - 1) // WORD


def upper_words(k: int, device=None):
    """(K, ceil(K / 64)) bool: the words a row's scan reads (w >= i // 64)."""
    w = torch.arange(words_of(k), device=device)
    return w[None, :] >= (torch.arange(k, device=device) // WORD)[:, None]


def pack_upper(over):
    """(B, K, K) bool -> (B, K, ceil(K / 64)) int64: bit j % 64 of word
    j // 64 of row i is over[:, i, j] for j > i; every other bit 0."""
    b, k = over.shape[:2]
    n = words_of(k) * WORD
    up = over & torch.ones((k, k), dtype=torch.bool,
                           device=over.device).triu(1)
    bits = torch.zeros((b, k, n), dtype=torch.int64, device=over.device)
    bits[..., :k] = up.to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=over.device)
    # distinct bits: the sum is their OR (bit 63 wraps to the sign bit)
    return (bits.view(b, k, -1, WORD) << shifts).sum(dim=-1)


def unpack(words, k: int):
    """(B, K, ceil(K / 64)) int64 -> (B, K, K) bool, every bit as stored."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :k].bool()


def reach(boxes):
    """(..., K, 7+) -> (..., K): each box's circumradius plus its share of
    the early-out's slack; inf where a side is under MIN_SIDE or NaN."""
    x, y, dx, dy = (boxes[..., i] for i in (0, 1, 3, 4))
    r = 0.5 * torch.sqrt(dx * dx + dy * dy)
    q = r + SLACK * (0.5 + x.abs() + y.abs() + r)
    return torch.where((dx >= MIN_SIDE) & (dy >= MIN_SIDE), q, float("inf"))


def far_apart(boxes_a, boxes_b):
    """(..., N, 7+) x (..., M, 7+) -> (..., N, M) bool: the pairs the
    kernel skips, whose centres lie further apart than their reaches' sum
    (the kernel's test, rounding for rounding). Their plain IoU is exactly
    0."""
    g = boxes_a[..., :, None, :2] - boxes_b[..., None, :, :2]
    q = reach(boxes_a)[..., :, None] + reach(boxes_b)[..., None, :]
    return g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] > q * q


def near_pairs(boxes, block_pairs: int = 1 << 22) -> int:
    """Upper-triangle pairs (j > i) of (B, K, 7+) boxes that the early-out
    does not skip, counted in row blocks of ``block_pairs`` pairs."""
    b, k = boxes.shape[:2]
    rows = max(1, block_pairs // max(1, b * k))
    j = torch.arange(k, device=boxes.device)
    n = 0
    for i in range(0, k, rows):
        near = ~far_apart(boxes[:, i:i + rows], boxes)
        n += int((near & (j[None, :] > j[i:i + rows, None])).sum())
    return n


def iou_mask_plain(boxes, thresh: float):
    """Plain PyTorch version (same contract as :func:`nms_iou_mask`)."""
    return pack_upper(overlaps(boxes[..., :7], float(thresh)))


def kernel_inputs(boxes, thresh):
    """The checks in front of the kernel: (B, K, C), or a raise on what the
    kernel does not take."""
    if not isinstance(boxes, torch.Tensor) or boxes.dim() != 3 \
            or boxes.shape[-1] < 7:
        raise ValueError("nms_iou_mask: boxes must be (B, K, C >= 7)")
    _lib.require(boxes, "boxes", torch.float32)
    if not float(thresh) >= 0:
        raise ValueError(f"nms_iou_mask: thresh {thresh} must be >= 0")
    return tuple(boxes.shape)


def _work(boxes, thresh):
    """``work.nms_iou_mask`` at the boxes' near pairs (a host sync)."""
    return work.nms_iou_mask(boxes, near_pairs(boxes))


@work.counted("nms_iou_mask", _work)
def nms_iou_mask(boxes, thresh: float):
    """The packed suppression words (see the module docstring) of boxes
    (B, K, C >= 7) f32, contiguous, at IoU threshold ``thresh`` >= 0."""
    global launches
    b, k, c = kernel_inputs(boxes, thresh)
    if boxes.device.type == "cpu":
        return iou_mask_plain(boxes, thresh)
    out = torch.empty((b, k, words_of(k)), dtype=torch.int64,
                      device=boxes.device)
    err = _lib.lib().mssvt_nms_iou_mask(boxes.data_ptr(), b, k, c,
                                        float(thresh), out.data_ptr(),
                                        _lib.stream_ptr(boxes))
    _lib.check(err, "mssvt_nms_iou_mask")
    launches += 1
    return out
