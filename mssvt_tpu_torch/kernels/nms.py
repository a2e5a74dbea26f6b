"""The greedy NMS scan: which candidates, in score order, survive.

Replaces no TPU kernel (the JAX package scans inside jit,
``mssvt_tpu/ops/nms.py``); it takes the post-processing's loop of K host
iterations off the host. Given the (B, K, K) suppression matrix ``over``
(``over[b, i, j]``: candidate i suppresses j; only j > i is read), the
candidates' validity (B, K) and their input indices ``order`` (B, K), a
candidate is kept when it is valid and no kept candidate before it
suppresses it. Returns (selected (B, post_max) int32 input indices of the
kept candidates in order, -1 padded, num_selected (B,) int32, at most
``post_max``).

CUDA tensors go to ``csrc/nms.cu`` (one CTA a sample, the rows packed into
64-bit words, one ordered scan on the card); CPU tensors to
:func:`greedy_plain`, the loop. Both give the same indices bit for bit.
:func:`nms_greedy_packed` takes the rows already packed
(``kernels/nms_iou.py``'s words) in place of the bool matrix, on the card
only: on the CPU, ``ops.nms.nms_bev`` scans the bool matrix, so there is
one plain route.
"""

from __future__ import annotations

import torch

from . import _lib, work

launches = 0
SMEM_MAX = 227 * 1024  # the packed rows' shared memory (csrc/nms.cu)


def greedy_plain(over, cand_valid, order, post_max: int):
    """Plain PyTorch version (same contract as :func:`nms_greedy`)."""
    b, k = cand_valid.shape
    dev = over.device
    over = over & torch.ones((k, k), dtype=torch.bool, device=dev).triu(1)
    keep = torch.zeros((b, k), dtype=torch.bool, device=dev)
    sup = torch.zeros((b, k), dtype=torch.bool, device=dev)
    for i in range(k):
        k_i = cand_valid[:, i] & ~sup[:, i]
        keep[:, i] = k_i
        sup |= over[:, i] & k_i[:, None]
    slot = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    dest = torch.where(keep & (slot < post_max), slot, post_max).long()
    sel = torch.full((b, post_max + 1), -1, dtype=torch.int32, device=dev)
    sel.scatter_(1, dest, order.to(torch.int32))
    num = torch.clamp(keep.sum(dim=1), max=post_max).to(torch.int32)
    return sel[:, :post_max], num


def packed_in_shared(k: int) -> bool:
    """Whether the kernel keeps the packed rows in shared memory (else in
    a scratch buffer the wrapper allocates)."""
    return ((k + 4) * ((k + 63) // 64) + 1) * 8 <= SMEM_MAX


def kernel_inputs(over, cand_valid, order, post_max):
    """The checks in front of the kernel: (B, K, post_max), or a raise on
    what the kernel does not take."""
    b, k = cand_valid.shape
    dev = over.device
    _lib.require(over, "over", torch.bool, (b, k, k), dev)
    _lib.require(cand_valid, "cand_valid", torch.bool, (b, k), dev)
    _lib.require(order, "order", torch.int64, (b, k), dev)
    post_max = int(post_max)
    if post_max < 0:
        raise ValueError(f"nms_greedy: post_max {post_max} < 0")
    return b, k, post_max


@work.counted("nms_greedy", work.nms_greedy)
def nms_greedy(over, cand_valid, order, post_max: int):
    """The greedy scan (see the module docstring): over (B, K, K) bool,
    cand_valid (B, K) bool, order (B, K) int64, all contiguous."""
    global launches
    if over.device.type == "cpu":
        return greedy_plain(over, cand_valid, order, post_max)
    b, k, post_max = kernel_inputs(over, cand_valid, order, post_max)
    dev = over.device
    sel = torch.empty((b, post_max), dtype=torch.int32, device=dev)
    num = torch.empty((b,), dtype=torch.int32, device=dev)
    scratch = None if packed_in_shared(k) else torch.empty(
        (b, k, (k + 63) // 64), dtype=torch.int64, device=dev)
    err = _lib.lib().mssvt_nms_greedy(
        over.data_ptr(), cand_valid.data_ptr(), order.data_ptr(), b, k,
        post_max, _lib.ptr(scratch), sel.data_ptr(), num.data_ptr(),
        _lib.stream_ptr(over))
    _lib.check(err, "mssvt_nms_greedy")
    launches += 1
    return sel, num


@work.counted("nms_greedy_packed", work.nms_greedy_packed)
def nms_greedy_packed(words, cand_valid, order, post_max: int):
    """The greedy scan of rows packed as ``kernels/nms_iou.nms_iou_mask``
    writes them: words (B, K, ceil(K / 64)) int64 (only the words at and
    right of each row's diagonal word are read), cand_valid (B, K) bool,
    order (B, K) int64, all contiguous. Same result as :func:`nms_greedy`
    on the unpacked matrix. CUDA tensors only (see the module docstring)."""
    global launches
    b, k = cand_valid.shape
    dev = words.device
    _lib.require(words, "words", torch.int64, (b, k, (k + 63) // 64), dev)
    _lib.require(cand_valid, "cand_valid", torch.bool, (b, k), dev)
    _lib.require(order, "order", torch.int64, (b, k), dev)
    post_max = int(post_max)
    if post_max < 0:
        raise ValueError(f"nms_greedy_packed: post_max {post_max} < 0")
    if dev.type != "cuda":
        raise RuntimeError("nms_greedy_packed: CUDA tensors only; on the "
                           "CPU, scan the bool matrix (nms_greedy)")
    sel = torch.empty((b, post_max), dtype=torch.int32, device=dev)
    num = torch.empty((b,), dtype=torch.int32, device=dev)
    err = _lib.lib().mssvt_nms_greedy_packed(
        words.data_ptr(), cand_valid.data_ptr(), order.data_ptr(), b, k,
        post_max, sel.data_ptr(), num.data_ptr(), _lib.stream_ptr(words))
    _lib.check(err, "mssvt_nms_greedy_packed")
    launches += 1
    return sel, num
