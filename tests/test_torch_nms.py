"""The greedy NMS scan (``kernels/nms.py``) on the CPU: hand-computed kept
indices of the plain version, the wrapper's route (the plain version for
CPU tensors, no launch), the checks in front of the kernel, the byte
formula and the shared-memory plan. ``tests/test_torch_cuda.py`` holds the
kernel to the same cases on the card.

The file imports nothing of JAX, so the card tests can import its cases.
"""

import pytest
import torch

from mssvt_tpu_torch.kernels import _lib, nms, work
from mssvt_tpu_torch.ops import nms as ops_nms


def _case(k, edges, valid, order, post_max, sel, b=1):
    """One sample (repeated ``b`` times) of K candidates: ``edges`` the (i,
    j) with over[i, j] set, ``sel`` the kept input indices."""
    over = torch.zeros((b, k, k), dtype=torch.bool)
    for i, j in edges:
        over[:, i, j] = True
    v = torch.tensor(valid, dtype=torch.bool).expand(b, k).contiguous()
    o = torch.tensor(order, dtype=torch.int64).expand(b, k).contiguous()
    want = torch.tensor(sel + [-1] * (post_max - len(sel)), dtype=torch.int32)
    return (over, v, o, post_max), (want.expand(b, post_max),
                                    torch.full((b,), len(sel), dtype=torch.int32))


# name -> (K, over's set (i, j), valid, order, post_max, kept input indices)
HAND_CASES = {
    # K = 1: the diagonal is never read
    "k1": (1, [(0, 0)], [True], [7], 3, [7]),
    "k1_invalid": (1, [], [False], [7], 3, []),
    # 0 suppresses 1, so 1 does not suppress 2; j < i is never read
    "chain": (4, [(0, 1), (1, 2), (3, 0), (2, 0)], [True] * 4, [9, 8, 7, 6],
              4, [9, 7, 6]),
    # an invalid candidate suppresses nothing and is never kept
    "invalid_suppresses_nothing": (3, [(0, 1), (0, 2)], [False, True, True],
                                   [0, 1, 2], 3, [1, 2]),
    # every candidate invalid (a call where nothing is valid)
    "all_invalid": (5, [(0, 1)], [False] * 5, [0, 1, 2, 3, 4], 3, []),
    # post_max below the kept count: the first post_max kept, num post_max
    "post_max_cut": (5, [], [True] * 5, [4, 3, 2, 1, 0], 3, [4, 3, 2]),
    "post_max_zero": (3, [], [True] * 3, [0, 1, 2], 0, []),
    # a row crossing a 64-bit word: 0 suppresses 64, 1 suppresses 2..63
    "k65": (65, [(0, 64)] + [(1, j) for j in range(2, 64)], [True] * 65,
            list(range(65)), 4, [0, 1]),
}


def hand_case(name, b=1):
    k, edges, valid, order, post_max, sel = HAND_CASES[name]
    return _case(k, edges, valid, order, post_max, sel, b)


@pytest.fixture
def no_card_library(monkeypatch):
    def no_lib():
        raise AssertionError("the CUDA library was requested for CPU tensors")

    monkeypatch.setattr(_lib, "lib", no_lib)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_greedy_keeps_hand_computed_indices(name, b, no_card_library):
    """The plain version keeps the hand-computed candidates, and the
    wrapper takes it for CPU tensors without a launch."""
    args, (want_sel, want_num) = hand_case(name, b)
    before = nms.launches
    for fn in (nms.greedy_plain, nms.nms_greedy):
        sel, num = fn(*args)
        assert torch.equal(sel, want_sel) and torch.equal(num, want_num)
    assert nms.launches == before == 0


def _boxes(rows):
    """(1, N, 7) boxes from (x, y, dx, dy) rows (z 0, height 1, heading 0)."""
    t = torch.zeros((1, len(rows), 7))
    for n, (x, y, dx, dy) in enumerate(rows):
        t[0, n] = torch.tensor([x, y, 0.0, dx, dy, 1.0, 0.0])
    return t


@pytest.mark.parametrize("fn,arg", [(ops_nms.nms_bev, 0.5),
                                    (ops_nms.circle_nms, 1.0)])
def test_nms_keeps_the_first_of_tied_scores(fn, arg, no_card_library):
    """Equal scores keep their input order (the stable sort): of three
    copies of one box the first is kept; far boxes survive; an invalid box
    and the boxes past pre_max are never candidates."""
    boxes = _boxes([(0, 0, 2, 2), (0, 0, 2, 2), (0, 0, 2, 2), (0, 0, 2, 2),
                    (10, 0, 2, 2), (20, 0, 2, 2), (40, 0, 2, 2)])
    scores = torch.tensor([[0.9, 0.5, 0.5, 0.5, 0.9, 0.5, 0.1]])
    valid = torch.tensor([[False, True, True, True, True, True, True]])
    sel, num = fn(boxes, scores, valid, arg, 5, 5)
    # candidates: 4 (0.9), then 1, 2, 3, 5 (0.5, input order); 6 (0.1) is
    # past pre_max 5, 0 invalid
    assert sel.tolist() == [[4, 1, 5, -1, -1]] and num.tolist() == [3]
    assert nms.launches == 0


def _bad_inputs():
    args, _ = hand_case("chain", 2)
    over, valid, order, post_max = args
    return {
        "over_dtype": (over.to(torch.uint8), valid, order, post_max),
        "valid_dtype": (over, valid.to(torch.uint8), order, post_max),
        "order_int32": (over, valid, order.to(torch.int32), post_max),
        "over_shape": (over[:, :, :3].contiguous(), valid, order, post_max),
        "order_shape": (over, valid, order[:1].contiguous(), post_max),
        "over_strided": (over.transpose(1, 2), valid, order, post_max),
        "order_strided": (over, valid, torch.zeros((2, 8), dtype=torch.int64)
                          [:, ::2], post_max),
        "post_max_negative": (over, valid, order, -1),
    }


@pytest.mark.parametrize("name", sorted(_bad_inputs()))
def test_kernel_inputs_refuse_what_the_kernel_does_not_take(name):
    """The checks in front of the kernel (pure Python, so they run here)
    raise on a wrong dtype, shape or layout and a negative post_max."""
    with pytest.raises((TypeError, ValueError)):
        nms.kernel_inputs(*_bad_inputs()[name])


def test_kernel_inputs_pass_what_the_callers_give():
    """What ``nms_bev`` and ``circle_nms`` hand the wrapper passes the
    checks, also where pre_max cuts the sorted indices (made contiguous)."""
    g = torch.Generator().manual_seed(0)
    boxes = torch.rand((2, 40, 7), generator=g) * 10
    scores = torch.rand((2, 40), generator=g)
    cand, cand_valid, order = ops_nms._candidates(boxes, scores,
                                                  scores > 0.3, 24)
    over = ops_nms._overlaps(cand[..., :7], 0.1)
    assert nms.kernel_inputs(over, cand_valid, order, 12) == (2, 24, 12)
    c = cand[..., :2]
    d2 = ((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    assert nms.kernel_inputs(d2 < 1.0, cand_valid, order, 12) == (2, 24, 12)


def test_work_formula_and_counting():
    """``work.nms_greedy``: the matrix, the validity and the order read,
    the outputs written, K steps a sample; a counting context charges the
    wrapper's call that formula in place of the loop's aten ops."""
    args, _ = hand_case("k65", 2)
    w = work.nms_greedy(*args)
    assert w.flops == 0 and w.ops == 2 * 65
    assert w.nbytes == 2 * 65 * 65 + 2 * 65 + 2 * 65 * 8 + 2 * 5 * 4
    assert w.bound()[1] == "bytes"
    with work.counting(device="cpu") as tally:
        nms.nms_greedy(*args)
    assert tally.kernel_bytes == {"nms_greedy": w.nbytes}
    assert tally.aten_bytes() == 0 and tally.total() == 0


@pytest.mark.parametrize("k,shared", [(1, True), (500, True), (512, True),
                                      (1024, True), (1344, True),
                                      (1345, False), (4096, False),
                                      (9000, False)])
def test_packed_rows_in_shared_memory_up_to_1344(k, shared):
    """((K + 4) x ceil(K / 64) + 1) x 8 bytes against 227 KiB: K = 1 344
    takes 226 472 bytes, K = 1 345 237 432."""
    assert nms.packed_in_shared(k) is shared
