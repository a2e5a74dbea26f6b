"""The greedy NMS scan (``kernels/nms.py``) and its rotated-IoU mask
(``kernels/nms_iou.py``) on the CPU: hand-computed kept indices of the
plain version, the wrapper's route (the plain version for CPU tensors, no
launch), the checks in front of the kernels, the work formulas, the
shared-memory plan; the mask's words against the plain IoU packed by hand,
the early-out's exactness, the packed scan's plain model, the ``mssvt.nms``
span and its reader. ``tests/test_torch_cuda.py`` holds the kernels to the same cases
on the card.

The file imports nothing of JAX, so the card tests can import its cases.
"""

import numpy as np
import pytest
import torch

from mssvt_tpu_torch.kernels import _lib, nms, nms_iou, work
from mssvt_tpu_torch.ops import box_ops
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
    over = nms_iou.overlaps(cand[..., :7], 0.1)
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


# ------------------------------------------- the rotated-IoU mask, packed
def hand_packed(over):
    """(B, K, K) bool -> (B, K, ceil(K / 64)) int64, packed bit by bit over
    the strict upper triangle (j > i), every other bit 0."""
    over = np.asarray(over)
    b, k = over.shape[:2]
    out = np.zeros((b, k, (k + 63) // 64), np.uint64)
    for s, i, j in zip(*np.nonzero(over)):
        if j > i:
            out[s, i, j // 64] |= np.uint64(1) << np.uint64(j % 64)
    return torch.from_numpy(out.view(np.int64))


def _rows(rows):
    """(1, N, 7) boxes from (x, y, dx, dy, heading) rows (z 0, height 1)."""
    return torch.tensor([[[x, y, 0.0, dx, dy, 1.0, h]
                          for x, y, dx, dy, h in rows]], dtype=torch.float32)


Q = float(np.pi / 4)
# name -> (x, y, dx, dy, heading) rows
EDGE_CASES = {
    "identical": [(1, -2, 3, 1.5, 0.7)] * 3 + [(9, 0, 2, 2, 0)],
    "identical_far_from_origin": [(-57.3, 212.9, 3, 1.5, 0.7)] * 2
    + [(100, 100, 3, 1.5, 0.7)] * 2,
    # abutting along a whole edge, half an edge, at a corner
    "shared_edge": [(0, 0, 1, 1, 0), (1, 0, 1, 1, 0), (1, 0.5, 1, 1, 0),
                    (1, 1, 1, 1, 0), (100, 100, 1, 1, 0), (101, 100, 1, 1, 0)],
    # collinear edges: contained sharing an edge, co- and anti-parallel
    "collinear": [(0, 0, 4, 4, 0), (1.5, 0, 1, 2, 0), (2.5, 0, 1, 2, 0),
                  (0, 2.5, 4, 1, 0), (0, 0, 4, 4, np.pi)],
    "rot45": [(0, 0, 1, 1, 0), (0, 0, 1, 1, Q), (0.5, 0.5, 1, 1, Q),
              (1.2, 0, 1, 1, -Q), (0, 0, 2, 0.5, 3 * Q)],
    # zero-size boxes: a box's IoU against one is far above 1, however far
    "zero_size": [(0, 0, 0, 0, 0), (5, 5, 2, 2, 0), (0, 0, 2, 2, 0),
                  (30, 30, 0, 1, 0.3), (0, 0, 0, 0, 0), (60, -40, 4, 1.6, 1)],
}


def _seeded_boxes(b, k, seed, span=20.0):
    g = torch.Generator().manual_seed(seed)
    return torch.cat([torch.rand((b, k, 2), generator=g) * span,
                      torch.rand((b, k, 1), generator=g),
                      0.5 + torch.rand((b, k, 3), generator=g) * 4,
                      torch.rand((b, k, 1), generator=g) * 6.3], dim=-1)


def _mask_cases():
    cases = {f"{name}-{th}": (_rows(rows), th) for name, rows in
             EDGE_CASES.items() for th in (0.0, 0.01, 0.5)}
    for b, k in ((1, 1), (2, 5), (1, 63), (2, 64), (2, 65), (1, 130)):
        for th in (0.0, 0.1):
            cases[f"seeded-{b}x{k}-{th}"] = (_seeded_boxes(b, k, k), th)
    return cases


@pytest.mark.parametrize("name", sorted(_mask_cases()))
def test_packed_words_equal_the_plain_iou_packed_by_hand(name,
                                                         no_card_library):
    """The CPU route of ``nms_iou_mask`` (the kernel's plain version):
    bit j % 64 of row i's word j // 64 is ``pairwise_iou_bev > thresh``
    for j > i, every other bit 0, no launch; the loop over the unpacked
    words (what the card's packed scan is held to) keeps what the loop
    over the bool matrix keeps."""
    boxes, th = _mask_cases()[name]
    b, k = boxes.shape[:2]
    before = nms_iou.launches
    got = nms_iou.nms_iou_mask(boxes, th)
    want = hand_packed(box_ops.pairwise_iou_bev(boxes, boxes) > th)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert nms_iou.launches == before == 0
    valid = torch.arange(k)[None].expand(b, k) % 3 != 1  # a third invalid
    order = torch.arange(k)[None].expand(b, k).contiguous()
    over = box_ops.pairwise_iou_bev(boxes, boxes) > th
    for post_max in (k + 1, max(k // 2, 1)):
        sel, num = nms.greedy_plain(nms_iou.unpack(got, k), valid, order,
                                    post_max)
        want_sel, want_num = nms.greedy_plain(over, valid, order, post_max)
        assert torch.equal(sel, want_sel) and torch.equal(num, want_num)


def _reach64(x, y, dx, dy):
    r = 0.5 * np.hypot(dx, dy)
    return r + nms_iou.SLACK * (0.5 + abs(x) + abs(y) + r)


def _near_boundary_boxes(seed, n=400):
    """Boxes of every size (zero, thin, negative among them) at every
    heading and scale of coordinate, half of them placed against an earlier
    box at the sum of the two reaches (or circumradii) times 1 + 1e-6 to
    1 + 1e-2, where rounding would show."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dx, dy = rng.choice([0.0, 0.005, 0.5, 2.0, 4.5, -1.0, 30.0], 2,
                            p=[0.05, 0.05, 0.3, 0.3, 0.2, 0.05, 0.05])
        h = rng.uniform(-7, 7)
        if i % 2 and out:
            x0, y0, _, dx0, dy0 = out[rng.integers(len(out))][:5]
            d = _reach64(x0, y0, dx0, dy0) + _reach64(x0, y0, dx, dy)
            if rng.uniform() < 0.25:
                d = 0.5 * (np.hypot(dx0, dy0) + np.hypot(dx, dy))
            d *= 1 + rng.choice([1e-6, 1e-5, 1e-4, 1e-3, 1e-2])
            a = rng.uniform(0, 2 * np.pi)
            x, y = x0 + d * np.cos(a), y0 + d * np.sin(a)
        else:
            scale = rng.choice([1.0, 80.0, 1000.0])
            x, y = rng.uniform(-scale, scale, 2)
        out.append((x, y, 0.0, dx, dy, 1.0, h))
    return torch.tensor([out], dtype=torch.float32)


@pytest.mark.parametrize("seed", range(6))
def test_early_out_skips_only_pairs_of_iou_exactly_zero(seed):
    """Every pair that ``far_apart`` (the kernel's early-out, rounding for
    rounding) skips has a plain IoU of exactly 0, both ways round, on
    boxes placed just past the reach; zero-size, thin and negative boxes
    never take it (against a zero-size box a box's IoU is its area over a
    rounding residue or 1e-6, far above 1, however far apart)."""
    boxes = _near_boundary_boxes(seed)
    far = nms_iou.far_apart(boxes, boxes)
    iou = box_ops.pairwise_iou_bev(boxes, boxes)
    assert torch.equal(far, far.transpose(1, 2))
    assert int(far.sum()) > 0.3 * far.numel()
    assert (iou[far] == 0).all()
    # skipped pairs within 1% of their reach
    b64 = boxes[0].double()
    g = (b64[:, None, :2] - b64[None, :, :2]).norm(dim=-1)
    q = nms_iou.reach(b64)
    assert int((far[0] & (g < 1.01 * (q[:, None] + q[None]))).sum()) > 50
    small = (boxes[0, :, 3] < nms_iou.MIN_SIDE) | (boxes[0, :, 4]
                                                   < nms_iou.MIN_SIDE)
    assert not far[0][small].any() and not far[0][:, small].any()
    zero = (boxes[0, :, 3] == 0) & (boxes[0, :, 4] == 0)
    big = boxes[0, :, 3] * boxes[0, :, 4] > 1
    assert (iou[0][big][:, zero] > 1).all()


def test_near_pairs_counts_the_upper_triangle_in_row_blocks():
    boxes = _seeded_boxes(2, 150, 3, span=60.0)
    k = boxes.shape[1]
    tri = torch.ones((k, k), dtype=torch.bool).triu(1)
    want = int((~nms_iou.far_apart(boxes, boxes) & tri).sum())
    assert 0 < want < 2 * k * (k - 1) // 2
    for block in (1, 150, 1 << 22):
        assert nms_iou.near_pairs(boxes, block) == want


@pytest.mark.parametrize("k", [1, 63, 64, 65, 500, 1344, 1345])
def test_packed_scan_equals_the_scan_of_the_matrix(k, no_card_library):
    """The packed scan's plain model, the loop over ``unpack``'s matrix
    (what the card tests hold ``nms_greedy_packed`` to): the same
    selections as the bool matrix's scan for K under a word, at a word,
    past it and on both sides of the kernel's shared-memory limit, with
    the words left of each row's diagonal word garbage. The wrapper itself
    takes no CPU tensors (``ops.nms.nms_bev`` scans the bool matrix
    there)."""
    g = torch.Generator().manual_seed(k)
    over = torch.rand((2, k, k), generator=g) < 0.02
    valid = torch.rand((2, k), generator=g) < 0.9
    order = torch.argsort(torch.rand((2, k), generator=g), dim=1)
    words = nms_iou.pack_upper(over)
    left = ~nms_iou.upper_words(k)
    words[:, left] = -1  # the kernel leaves these as it found them
    for post_max in (k + 1, 7):
        got = nms.greedy_plain(nms_iou.unpack(words, k), valid, order,
                               post_max)
        want = nms.greedy_plain(over, valid, order, post_max)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        nms.nms_greedy_packed(words, valid, order, k)
    assert nms.launches == 0


def _bad_mask_inputs():
    boxes = _seeded_boxes(2, 10, 0)
    return {
        "thresh_negative": (boxes, -0.1),
        "thresh_nan": (boxes, float("nan")),
        "boxes_f64": (boxes.double(), 0.1),
        "boxes_bf16": (boxes.bfloat16(), 0.1),
        "boxes_2d": (boxes[0], 0.1),
        "boxes_c6": (boxes[..., :6].contiguous(), 0.1),
        "boxes_strided": (boxes.transpose(0, 1), 0.1),
    }


@pytest.mark.parametrize("name", sorted(_bad_mask_inputs()))
def test_mask_wrapper_refuses_what_the_kernel_does_not_take(name):
    """A negative (or NaN) threshold, a dtype other than f32, a shape other
    than (B, K, C >= 7) and a strided tensor raise, on the CPU route too."""
    with pytest.raises((TypeError, ValueError)):
        nms_iou.nms_iou_mask(*_bad_mask_inputs()[name])


def _bad_packed_inputs():
    args, _ = hand_case("k65", 2)
    over, valid, order, post_max = args
    words = nms_iou.pack_upper(over)
    return {
        "words_int32": (words.to(torch.int32), valid, order, post_max),
        "words_shape": (words[:, :, :1].contiguous(), valid, order, post_max),
        "words_strided": (words.transpose(0, 1).contiguous().transpose(0, 1),
                          valid, order, post_max),
        "valid_uint8": (words, valid.to(torch.uint8), order, post_max),
        "order_int32": (words, valid, order.to(torch.int32), post_max),
        "post_max_negative": (words, valid, order, -1),
    }


@pytest.mark.parametrize("name", sorted(_bad_packed_inputs()))
def test_packed_scan_refuses_what_the_kernel_does_not_take(name):
    with pytest.raises((TypeError, ValueError)):
        nms.nms_greedy_packed(*_bad_packed_inputs()[name])


def test_mask_and_packed_scan_work_formulas():
    """``work.nms_iou_mask``: the boxes read, the rows' words at and right
    of the diagonal written; every upper-triangle pair's early-out test and
    the near pairs' full IoU. ``work.nms_greedy_packed``: those words, the
    validity and the order read. A counting context charges the mask's
    wrapper its formula at the boxes' near pairs in place of the plain
    version's aten ops."""
    boxes = _seeded_boxes(2, 65, 1)
    near = nms_iou.near_pairs(boxes)
    w = work.nms_iou_mask(boxes, near)
    # rows 0-63 write 2 words, row 64 one, in each of 2 samples
    assert w.nbytes == 2 * 65 * 7 * 4 + 2 * (64 * 2 + 1) * 8
    assert w.ops == (2 * 65 * 64 // 2 * work.NMS_IOU_TEST_OPS
                     + near * work.NMS_IOU_PAIR_OPS)
    assert w.flops == 0 and w.bound()[1] == "operations"
    words = nms_iou.nms_iou_mask(boxes, 0.1)
    args, _ = hand_case("k65", 2)
    valid, order = args[1], args[2]
    p = work.nms_greedy_packed(words, valid, order, 5)
    assert p.nbytes == 2 * (64 * 2 + 1) * 8 + 2 * 65 + 2 * 65 * 8 + 2 * 6 * 4
    assert p.ops == 2 * 65 and p.bound()[1] == "bytes"
    with work.counting(device="cpu") as tally:
        nms_iou.nms_iou_mask(boxes, 0.1)
    assert tally.kernel_bytes == {"nms_iou_mask": w.nbytes}
    assert tally.aten_bytes() == 0


@pytest.mark.parametrize("fn,arg", [(ops_nms.nms_bev, 0.5),
                                    (ops_nms.circle_nms, 1.0)])
def test_nms_opens_its_span_under_a_profiler(fn, arg):
    """``nms_bev`` and ``circle_nms`` record ``mssvt.nms`` while a profiler
    records, around the candidates, the mask and the scan."""
    boxes = _seeded_boxes(1, 20, 2)
    scores = torch.rand((1, 20), generator=torch.Generator().manual_seed(2))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(boxes, scores, scores > 0.2, arg, 16, 8)
    names = [e.name for e in prof.events()]
    assert names.count("mssvt.nms") == 1
    assert any(n == "aten::sort" for n in names)


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_nms_device_ms_reader():
    """``nms_device_ms.infer``: device time of the kernels launched inside
    ``mssvt.nms``, ms a frame; None without the span (the parent)."""
    from types import SimpleNamespace

    from benchmark.harness import spec

    reader = spec.load_module(spec.BENCH / "metrics"
                              / "nms_device_ms.infer.py")
    events = [
        _ev("mssvt.post", "user_annotation", 100, 400),
        _ev("mssvt.nms", "user_annotation", 150, 100),
        _ev("mssvt.nms", "user_annotation", 600, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 120, 5, 1),  # outside
        _ev("cudaLaunchKernel", "cuda_runtime", 160, 5, 2),
        _ev("cudaLaunchKernel", "cuda_runtime", 200, 5, 3),
        _ev("cudaLaunchKernel", "cuda_runtime", 610, 5, 4),
        _ev("elementwise_kernel", "kernel", 130, 50, 1),
        _ev("nms_iou_mask_kernel", "kernel", 170, 300, 2),
        _ev("nms_greedy_kernel", "kernel", 480, 200, 3),
        _ev("sort_kernel", "kernel", 620, 100, 4),
    ]
    rec = SimpleNamespace(events=events, requests=2, batch=2)
    assert reader.read(rec) == pytest.approx(0.6 / 4)
    rec.events = [e for e in events if e["name"] != "mssvt.nms"]
    assert reader.read(rec) is None
