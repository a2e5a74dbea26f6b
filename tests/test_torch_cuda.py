"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Fill, FPS, the NMS scan and its IoU mask must match exactly; attention (forward and backward) and FFN
in f32 to 1e-4 (the same f32 math summed in another order) and in bf16 to
2^-5 of the largest output magnitude (an intermediate may round one bf16 ulp
apart).
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mssvt_tpu_torch import kernels
from mssvt_tpu_torch.kernels import (
    attention,
    attention_bwd,
    attention_qk,
    attention_qk_bwd,
    ffn,
    fill,
    fps,
    nms,
    nms_iou,
)
from mssvt_tpu_torch.ops import box_ops
from mssvt_tpu_torch.ops import nms as ops_nms
from mssvt_tpu_torch.runtime.train_utils import set_deterministic
from test_torch_nms import (
    EDGE_CASES,
    HAND_CASES,
    _near_boundary_boxes,
    _rows,
    hand_case,
)


@pytest.fixture
def dev():
    """The card, with TF32 off and cuDNN deterministic
    (``train_utils.set_deterministic``, as the entry points set it), so the
    tests that repeat a call can ask for bit-identical results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    set_deterministic()
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert (got - want).abs().max() <= 2.0 ** -5 * want.abs().max()


# (NW, K, cap, order, own-slab width cv (0: no slab), eligibility columns,
# num_valid, box offset in entries from a 16-byte boundary)
FILL_KERNEL_CASES = [
    (40, 648, 96, True, 72, 3, 23, 0), (40, 648, 96, False, 0, 0, None, 0),
    (40, 648, 96, True, 0, 0, 5, 0),
    (1001, 648, 96, True, 72, 3, 777, 0),   # NW no multiple of a CTA's rows
    (40, 648, 700, True, 72, 3, 40, 0),     # cap above every row's hits
    (37, 163, 96, True, 53, 3, 30, 0),      # K % 4 != 0, cv % 4 != 0
    (37, 163, 101, True, 53, 2, 37, 1),     # cap % 4 != 0, unaligned box
    (33, 648, 96, True, 72, 3, 0, 0),       # num_valid 0
    (33, 648, 96, True, 72, 0, 33, 3),      # num_valid NW, slab, no elig
    (4000, 648, 96, True, 72, 3, 2250, 0),  # block-0 geometry
]


@pytest.mark.cuda
@pytest.mark.parametrize("nw,k,cap,with_order,cv,ne,nv,shift",
                         FILL_KERNEL_CASES)
def test_fill_kernel_matches_plain(dev, nw, k, cap, with_order, cv, ne, nv,
                                   shift):
    """K1 equals fill_plain on every output, for live and dead rows, rows
    staged from any 4-byte phase and output rows of any width; a second
    call (the cached table) repeats it."""
    rng = np.random.default_rng(0)
    box = np.where(rng.random((nw, k)) < 0.3,
                   rng.integers(0, 10**7, (nw, k)), -1).astype(np.int32)
    offs = rng.integers(0, 2**15, k).astype(np.int32)
    order = rng.permutation(k) if with_order else None
    own_slab = (k // 3, cv) if cv else None
    elig = rng.integers(0, 2, (k, ne)).astype(np.float32) if ne else None
    nv_t = None if nv is None else torch.tensor(nv, device=dev)
    flat = torch.empty(nw * k + shift, dtype=torch.int32, device=dev)
    b = flat[shift:].view(nw, k)
    b.copy_(torch.as_tensor(box))
    got = fill.fill_capacity_buffer(b, offs, cap, order, own_slab, elig, nv_t)
    again = fill.fill_capacity_buffer(b, offs, cap, order, own_slab, elig, nv_t)
    want = fill.fill_plain(b, offs, cap, order, own_slab, elig, nv_t)
    assert len(got) == len(want) == (4 if cv else 2)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("return_inverse", [True, False])
def test_non_bijective_gather_launches_fill(dev, return_inverse):
    """A non-bijective query table (win2 / win1 = 5/3) on the own-cell path
    launches K1 at ``order=None`` once, and every buffer and the inverse
    map equal the same gather on the CPU (``fill_plain``)."""
    from mssvt_tpu_torch.ops import window

    grid, b, v = (24, 24, 8), 2, 512
    rng = np.random.default_rng(5)
    coords = np.unique(np.stack([
        rng.integers(0, b, 420), rng.integers(0, grid[2], 420),
        rng.integers(0, grid[1], 420), rng.integers(0, grid[0], 420)], 1),
        axis=0).astype(np.int32)
    pad = np.full((v, 4), -1, np.int32)
    pad[:len(coords)] = coords
    tables = window.build_query_tables((3, 3, 4), (5, 5, 4))
    assert tables.inv_src is None
    outs = []
    for d in ("cpu", dev):
        c = torch.as_tensor(pad, device=d)
        ok = torch.as_tensor(np.arange(v) < len(coords), device=d)
        wc, wv, _, nv = window.window_partition(c, ok, grid, (3, 3, 4), 96, b)
        before = fill.launches
        outs.append(window.gather_window_voxels(
            wc, wv, c, ok, grid, (3, 3, 4), tables, max_num_win1=20,
            max_num_win2=40, batch_size=b, return_inverse=return_inverse,
            num_valid=nv))
        assert fill.launches - before == (d == dev)
    want, got = outs
    assert set(got) == set(want) and ("inv_win1" in got) == return_inverse
    for name in want:
        for key in want[name]:
            assert torch.equal(got[name][key].cpu(), want[name][key]), (
                name, key)


def _fps_planes(rng, kind, rows, n, count):
    """``count`` (rows, n) f32 planes: "int" small integers (exact ties),
    "dup" each row's points drawn from 3 distinct ones (every distance 0
    after the first picks), "normal" floats."""
    def mk():
        if kind == "int":
            return rng.integers(-6, 7, (rows, n)).astype(np.float32)
        if kind == "dup":
            return rng.integers(0, 3, (rows, n)).astype(np.float32)
        return rng.normal(size=(rows, n)).astype(np.float32)
    return [mk() for _ in range(count)]


# (N, nw_half (0: 21 rows, no halves), planes, num_valid, npoint, kind)
FPS_CASES = [
    (96, 48, 4, 45, 32, "int"), (96, 48, 4, 45, 32, "normal"),
    (33, 0, 4, 17, 32, "normal"), (256, 8, 4, 5, 32, "int"),
    (1, 0, 3, None, 32, "normal"),   # npoint > N: the picks repeat 0
    (7, 4, 8, 0, 16, "int"),         # every row dead
    (7, 0, 3, 21, 12, "dup"),        # npoint > N, all rows live
    (33, 0, 8, None, 13, "int"),     # npoint % 4 != 0: scalar row writes
    (96, 64, 4, 30, 32, "dup"),      # all-zero distances after 3 picks
    (97, 40, 8, 40, 32, "int"),      # N % 4 != 0, all rows live
    (128, 24, 3, 11, 32, "normal"), (200, 16, 8, 9, 32, "int"),
    (256, 10, 3, 10, 40, "dup"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,nw_half,nplanes,nv,npoint,kind", FPS_CASES)
def test_fps_kernel_matches_plain(dev, n, nw_half, nplanes, nv, npoint, kind):
    """K2: picks and every selected plane exactly the plain version's
    (ties to the lowest index), dead rows zero."""
    rng = np.random.default_rng(1)
    rows = 2 * nw_half if nw_half else 21
    planes = [torch.as_tensor(p, device=dev)
              for p in _fps_planes(rng, kind, rows, n, nplanes)]
    nv_t = None if nv is None else torch.tensor(nv, device=dev)
    got = fps.fps_select(*planes[:3], tuple(planes[3:]), npoint, nv_t, nw_half)
    want = fps.fps_plain(*planes[:3], tuple(planes[3:]), npoint, nv_t, nw_half)
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == nplanes
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    if nv is not None:
        dead = fps._dead_rows(rows, nv, nw_half, dev)
        assert (got[0][dead] == 0).all()


def _attn_args(dev, dtype, q_prefix, pad_keys, num_heads=(2, 2), nq=32):
    g = torch.Generator().manual_seed(2)
    nw, n1cap, nk1, nk2, d = 37, 48, 32, 32, 128
    r = lambda *s: torch.randn(*s, generator=g)
    sd = [d // sum(num_heads) * h for h in num_heads]
    proj = []
    for _ in range(4):
        w = torch.zeros(d, d)
        s = 0
        for n in sd:
            w[s:s + n, s:s + n] = r(n, n) * 0.15
            s += n
        proj += [w.to(dev, dtype), (r(d) * 0.1).to(dev, dtype)]
    keep = (torch.rand(nw, nq, generator=g) > 0.2).float()
    args = dict(
        win1_fea=r(nw, n1cap, d).to(dev, dtype),
        k2_fea=r(nw, nk2, d).to(dev, dtype),
        fps1=torch.randint(0, n1cap, (nw, nk1), generator=g,
                           dtype=torch.int32).to(dev),
        k_mask1=(torch.rand(nw, nk1, generator=g) < 0.3).to(dev),
        q_ext=None if q_prefix else (r(nw, nq, d) * keep[..., None]).to(dev, dtype),
        q_keep=keep.to(dev),
        k_rel=tuple(r(nw, nk1 + nk2).to(dev) for _ in range(3)),
        q_rel=tuple(r(nw, nq).to(dev) for _ in range(3)),
        pos_base=r(nw, d).to(dev, dtype), pos_w=r(3, d).to(dev, dtype),
        proj=tuple(proj),
        key_bias=torch.where(torch.rand(nw, nk1 + nk2, generator=g) < 0.2,
                             -100.0, 0.0).to(dev),
        num_heads=num_heads, scale=(d // sum(num_heads)) ** -0.5,
        q_prefix=q_prefix, nq=nq,
        pad_row=r(nw, d).to(dev, dtype) if pad_keys else None,
        num_valid=torch.tensor(29, device=dev), compute_dtype=dtype)
    return args, keep.to(dev)[..., None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_prefix,pad_keys,num_heads,nq", [
    (True, True, (2, 2), 32), (False, False, (2, 2), 32), (True, False, (4,), 32),
    (False, True, (2, 2), 8), (True, True, (2, 2), 20)])
def test_attention_kernel_matches_plain(dev, dtype, q_prefix, pad_keys,
                                        num_heads, nq):
    """The bf16 cases run the tensor-core path, f32 the FMA path; nq = 8
    (the even-cell and block-4 queries) and 20 pad the query tiles."""
    args, keep = _attn_args(dev, dtype, q_prefix, pad_keys, num_heads, nq)
    got = attention.fused_window_attention_assembled(**args)
    want = attention.attention_plain(**args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype
    _close(got * keep, want * keep, dtype)
    assert (got[29:] == 0).all()


BWD_NAMES = ("dwin1", "dk2", "dq_ext", "dpad_row", "dpos_base", "dpos_w",
             "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwp", "dbp")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,q_prefix,num_heads,nq", [
    (dt, *case) for dt in (torch.float32, torch.bfloat16)
    for case in ((True, (2, 2), 32), (False, (2, 2), 8), (True, (2, 2), 20))
] + [(torch.bfloat16, False, (4,), 32)])
def test_attention_bwd_kernel_matches_plain(dev, dtype, q_prefix, num_heads,
                                            nq):
    """K5 against attention_bwd_plain: every cotangent within 1e-4 in f32
    (plus 1e-5 of the largest element for the sums over windows: dW, db,
    dpos_w, dpad_row) and 2^-5 of its largest magnitude in bf16 (tensor-core
    tiles; nq = 8 and 20 pad the query tiles); windows past num_valid get zeros; a second
    call gives bit-identical cotangents (no float atomics). ``dbk`` is
    analytically zero (a softmax does not change when all its keys' scores
    shift, so each row of dS sums to zero): both sides compute rounding
    noise, held to the tolerance times max |dbv|, a sum over the same
    tokens that does not cancel. (In f32, one head group of 4 heads at
    D = 128 and 32 queries needs more shared memory than a CTA has; no
    configuration runs it.)"""
    args, _ = _attn_args(dev, dtype, q_prefix, True, num_heads, nq)
    nw, d = args["win1_fea"].shape[0], args["win1_fea"].shape[2]
    g = torch.Generator().manual_seed(9)
    args["g"] = torch.randn(nw, nq, d, generator=g).to(dev, dtype)
    got = attention_bwd.fused_window_attention_assembled_bwd(**args)
    again = attention_bwd.fused_window_attention_assembled_bwd(**args)
    want = attention.attention_bwd_plain(**args)
    torch.cuda.synchronize()
    flat = lambda r: dict(zip(BWD_NAMES, (*r[:6], *r[6])))
    got, again, want = flat(got), flat(again), flat(want)
    assert (got["dq_ext"] is None) == q_prefix
    for name, wt in want.items():
        gt = got[name]
        if wt is None:
            continue
        assert gt.dtype == wt.dtype and gt.shape == wt.shape, name
        assert torch.equal(gt, again[name]), name
        if name == "dbk":
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
            scale = want["dbv"].float().abs().max()
            assert (gt.float() - wt.float()).abs().max() <= tol * scale
        elif dtype == torch.float32 and name[:2] in ("dw", "db", "dp"):
            # f32 sums over all windows and tokens, in another order: the
            # error scales with the terms, the largest elements
            torch.testing.assert_close(
                gt, wt, rtol=1e-4, atol=1e-4 + 1e-5 * wt.abs().max().item())
        else:
            _close(gt, wt, dtype)
    for name in ("dwin1", "dk2", "dpad_row", "dpos_base"):
        assert (got[name][29:] == 0).all()


# (kernel, N, planes (see _fps_planes), rows, npoint)
FPS_PICKS_CASES = [
    (kn, n, "int" if integer else "normal", 37, 32) for kn, n, integer in (
        ("warp", 96, True), ("warp", 33, False), ("warp", 256, False),
        ("warp", 1, False), ("warp", 7, True), ("warp", 128, True),
        ("warp", 200, False), ("warp", 256, True),
        ("block", 257, False), ("block", 2048, True), ("block", 700, False),
        ("block", 96, True))
] + [
    ("block", 14336, "normal", 5, 64), ("block", 16384, "int", 3, 64),
    ("block", 16384, "normal", 2, 9000),  # pick list past shared memory
    ("block", 4099, "int", 37, 32),       # N % 4 != 0: scalar loads
    ("block", 8192, "normal", 4, 100),    # registers: 512 threads
    ("block", 8193, "int", 4, 100),       # planes in shared memory
    ("block", 2048, "dup", 37, 32),       # all-zero distances
    ("block", 300, "normal", 37, 400),    # npoint > N
    ("block", 2048, "normal", 1, 512),    # one row
    ("block", 777, "int", 37, 1),         # npoint = 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n,kind,rows,npoint", FPS_PICKS_CASES)
def test_fps_picks_kernels_match_plain(dev, kernel, n, kind, rows, npoint):
    """K2b (a group of lanes a row, N <= 256) and K2c (one CTA a row, N up
    to 16 384): the picks equal the plain version's exactly, on integer
    planes (many exact ties), duplicated points (all-zero distances after
    the first picks) and normal ones."""
    rng = np.random.default_rng(4)
    planes = [torch.as_tensor(p, device=dev)
              for p in _fps_planes(rng, kind, rows, n, 3)]
    fn = fps.fps_picks_warp if kernel == "warp" else fps.fps_picks_block
    before = fps.launches_warp + fps.launches_block
    got = fn(*planes, npoint)
    want = fps.fps_plain(*planes, (), npoint)[0]
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert fps.launches_warp + fps.launches_block == before + 1
    # the entry point chooses by N
    assert torch.equal(fps.fps_picks(*planes, npoint), want)


def _qk_args(dev, dtype, num_heads, nq, nw=37):
    a, _ = _attn_args(dev, dtype, False, False, num_heads, nq)
    g = torch.Generator().manual_seed(5)
    nk_tot, d = a["key_bias"].shape[1], a["win1_fea"].shape[2]
    return dict(
        query=torch.randn(nw, nq, d, generator=g).to(dev, dtype),
        keys=torch.randn(nw, nk_tot, d, generator=g).to(dev, dtype),
        proj=a["proj"], key_bias=a["key_bias"], num_heads=num_heads,
        scale=a["scale"], compute_dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_heads,nq", [((2, 2), 32), ((4,), 32),
                                          ((2, 2), 8), ((2, 2), 20)])
def test_attention_qk_kernel_matches_plain(dev, dtype, num_heads, nq):
    """K6 against attention_qk_plain on every window (it has no live
    prefix): bf16 on the tensor-core path, f32 on the FMA path."""
    args = _qk_args(dev, dtype, num_heads, nq)
    got = attention_qk.fused_window_attention(**args)
    want = attention_qk.attention_qk_plain(**args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    _close(got, want, dtype)


QK_BWD_NAMES = ("dq", "dk", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwp",
                "dbp")


def _hold_qk_bwd(got, want, dtype):
    """K7's cotangents against the plain version's, tolerances as above."""
    for name, wt in want.items():
        gt = got[name]
        assert gt.dtype == wt.dtype and gt.shape == wt.shape, name
        if name == "dbk":
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
            scale = want["dbv"].float().abs().max()
            assert (gt.float() - wt.float()).abs().max() <= tol * scale, name
        elif dtype == torch.float32 and name[:2] in ("dw", "db"):
            torch.testing.assert_close(
                gt, wt, rtol=1e-4, atol=1e-4 + 1e-5 * wt.abs().max().item())
        else:
            _close(gt, wt, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,num_heads,nq", [
    (dt, *case) for dt in (torch.float32, torch.bfloat16)
    for case in (((2, 2), 32), ((2, 2), 8), ((2, 2), 20))
] + [(torch.bfloat16, (4,), 32)])
def test_attention_qk_bwd_kernel_matches_plain(dev, dtype, num_heads, nq):
    """K7 against attention_qk_bwd_plain with a random cotangent on every
    window: tolerances as for K5 (1e-4 in f32, plus 1e-5 of the largest
    element for the sums over windows; 2^-5 of each cotangent's largest
    magnitude in bf16; dbk, analytically zero, against max |dbv|); the
    projection cotangents come back in the projections' dtype; a second
    call gives bit-identical cotangents (no float atomics)."""
    args = _qk_args(dev, dtype, num_heads, nq)
    args["proj"] = tuple(p.float() for p in args["proj"])  # f32 parameters
    g = torch.Generator().manual_seed(9)
    args["g"] = torch.randn(args["query"].shape, generator=g).to(dev, dtype)
    got = attention_qk_bwd.fused_window_attention_bwd(**args)
    again = attention_qk_bwd.fused_window_attention_bwd(**args)
    want = attention_qk_bwd.attention_qk_bwd_plain(**args)
    torch.cuda.synchronize()
    flat = lambda r: dict(zip(QK_BWD_NAMES, (*r[:2], *r[2])))
    got, again, want = flat(got), flat(again), flat(want)
    for name, gt in got.items():
        assert gt.dtype == (dtype if name in ("dq", "dk") else torch.float32)
        assert torch.equal(gt, again[name]), name
    _hold_qk_bwd(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("zero,nw,nq,nk,num_heads,d,dtype", [
    ("none", 37, 32, 32, (2, 2), 128, torch.bfloat16),
    ("prefix", 37, 32, 32, (2, 2), 128, torch.bfloat16),
    ("scattered", 37, 32, 32, (2, 2), 128, torch.bfloat16),
    ("all", 37, 32, 32, (2, 2), 128, torch.bfloat16),
    ("none", 1, 32, 32, (2, 2), 128, torch.bfloat16),
    ("scattered", 7, 18, 32, (2, 2), 128, torch.bfloat16),
    ("scattered", 1025, 18, 16, (2, 2), 128, torch.bfloat16),
    ("prefix", 1025, 32, 32, (4,), 128, torch.bfloat16),
    ("scattered", 37, 32, 16, (4,), 64, torch.bfloat16),
    ("scattered", 37, 18, 16, (2, 2), 64, torch.bfloat16),
    ("scattered", 37, 32, 32, (2, 2), 128, torch.float32),
    ("prefix", 7, 18, 16, (4,), 64, torch.float32),
])
def test_attention_qk_bwd_live_window_list(dev, zero, nw, nq, nk, num_heads, d,
                                           dtype):
    """K7 walks only the windows whose g has a nonzero element: against the
    plain version (which computes every window) with g zeroed on no window,
    on the trailing ~44%, on a scattered half and on all of them; window
    counts that no grid or split divides; 18 queries (padded to 32 on the
    tensor-core path) and 32; 32 and 16 keys a head group; one and two head
    groups; D = 128 (the weight product on wgmma in bf16) and 64 (FMA). The
    skipped windows get exactly zero dq and dk; a second call repeats bit for
    bit."""
    rng = torch.Generator().manual_seed(11)
    r = lambda *s: torch.randn(*s, generator=rng)
    nk_tot = nk * len(num_heads)
    sd = [d // sum(num_heads) * h for h in num_heads]
    proj = []
    for _ in range(4):
        w = torch.zeros(d, d)
        s0 = 0
        for n in sd:
            w[s0:s0 + n, s0:s0 + n] = r(n, n) * 0.15
            s0 += n
        proj += [w.to(dev), (r(d) * 0.1).to(dev)]
    g = r(nw, nq, d)
    dead = {"none": torch.zeros(nw, dtype=torch.bool),
            "prefix": torch.arange(nw) >= int(0.56 * nw),
            "scattered": torch.rand(nw, generator=rng) < 0.5,
            "all": torch.ones(nw, dtype=torch.bool)}[zero]
    g[dead] = 0.0
    args = dict(
        query=r(nw, nq, d).to(dev, dtype), keys=r(nw, nk_tot, d).to(dev, dtype),
        proj=tuple(proj),
        key_bias=torch.where(torch.rand(nw, nk_tot, generator=rng) < 0.2,
                             -100.0, 0.0).to(dev),
        g=g.to(dev, dtype), num_heads=num_heads,
        scale=(d // sum(num_heads)) ** -0.5, compute_dtype=dtype)
    got = attention_qk_bwd.fused_window_attention_bwd(**args)
    walked = int(attention_qk_bwd.last_list[-1])
    again = attention_qk_bwd.fused_window_attention_bwd(**args)
    want = attention_qk_bwd.attention_qk_bwd_plain(**args)
    torch.cuda.synchronize()
    assert walked == nw - int(dead.sum())
    flat = lambda res: dict(zip(QK_BWD_NAMES, (*res[:2], *res[2])))
    got, again, want = flat(got), flat(again), flat(want)
    for name in QK_BWD_NAMES:
        assert torch.equal(got[name], again[name]), name
    assert not got["dq"][dead.to(dev)].any() and not got["dk"][dead.to(dev)].any()
    _hold_qk_bwd(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_prefix", [True, False])
def test_attention_bwd_kernel_without_pad_row_or_num_valid(dev, dtype,
                                                           q_prefix):
    """K5 with ``pad_row=None`` and ``num_valid=None`` (the wrapper gives
    the kernel a zero pad row and every window live) against the plain
    version with the same Nones, at the tolerances of
    test_attention_bwd_kernel_matches_plain; no pad-row cotangent comes
    back, and a second call is bit-identical."""
    nq = 32 if q_prefix else 8
    args, _ = _attn_args(dev, dtype, q_prefix, False, (2, 2), nq)
    args["num_valid"] = None
    nw, d = args["win1_fea"].shape[0], args["win1_fea"].shape[2]
    g = torch.Generator().manual_seed(9)
    args["g"] = torch.randn(nw, nq, d, generator=g).to(dev, dtype)
    got = attention_bwd.fused_window_attention_assembled_bwd(**args)
    again = attention_bwd.fused_window_attention_assembled_bwd(**args)
    want = attention.attention_bwd_plain(**args)
    torch.cuda.synchronize()
    flat = lambda res: dict(zip(BWD_NAMES, (*res[:6], *res[6])))
    got, again, want = flat(got), flat(again), flat(want)
    assert got["dpad_row"] is None and want["dpad_row"] is None
    for name, wt in want.items():
        if wt is None:
            continue
        gt = got[name]
        assert torch.equal(gt, again[name]), name
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
        if name == "dbk":
            scale = want["dbv"].float().abs().max()
            assert (gt.float() - wt.float()).abs().max() <= tol * scale
        elif dtype == torch.float32 and name[:2] in ("dw", "db", "dp"):
            torch.testing.assert_close(
                gt.float(), wt.float(), rtol=1e-4,
                atol=1e-4 + 1e-5 * wt.float().abs().max().item())
        else:
            _close(gt, wt, dtype)
    assert got["dwin1"][-1].abs().sum() > 0  # the last window is live


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [0, 17, 37])
@pytest.mark.parametrize("nq", [32, 18])
def test_attention_bwd_kernel_num_valid(dev, nv, nq):
    """K5 with no live window, some and all of the 37: against the plain
    version in bf16, windows at or past num_valid zero, and a second call
    bit-identical."""
    dtype = torch.bfloat16
    args, _ = _attn_args(dev, dtype, True, True, (2, 2), nq)
    args["num_valid"] = torch.tensor(nv, device=dev)
    nw, d = args["win1_fea"].shape[0], args["win1_fea"].shape[2]
    g = torch.Generator().manual_seed(9)
    args["g"] = torch.randn(nw, nq, d, generator=g).to(dev, dtype)
    got = attention_bwd.fused_window_attention_assembled_bwd(**args)
    again = attention_bwd.fused_window_attention_assembled_bwd(**args)
    want = attention.attention_bwd_plain(**args)
    torch.cuda.synchronize()
    flat = lambda res: dict(zip(BWD_NAMES, (*res[:6], *res[6])))
    got, again, want = flat(got), flat(again), flat(want)
    for name, wt in want.items():
        if wt is None:
            continue
        gt = got[name]
        assert torch.equal(gt, again[name]), name
        if name == "dbk":
            scale = want["dbv"].float().abs().max()
            assert (gt.float() - wt.float()).abs().max() <= 2.0 ** -5 * scale
        else:
            _close(gt, wt, dtype)
    for name in ("dwin1", "dk2", "dpad_row", "dpos_base"):
        assert (got[name][nv:] == 0).all()


def _layout_args(dev, dtype, nw, nq, nk, num_heads, d, seed=13):
    """Assembled-attention inputs (pad keys, q_prefix) at a free layout:
    ``nk`` keys a head group (half of them FPS picks), capacity 48."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    groups = len(num_heads)
    nk_tot = nk * groups
    nk1 = nk_tot // 2
    n1cap = max(48, nq)
    sd = [d // sum(num_heads) * h for h in num_heads]
    proj = []
    for _ in range(4):
        w = torch.zeros(d, d)
        s0 = 0
        for n in sd:
            w[s0:s0 + n, s0:s0 + n] = r(n, n) * 0.15
            s0 += n
        proj += [w.to(dev, dtype), (r(d) * 0.1).to(dev, dtype)]
    keep = (torch.rand(nw, nq, generator=g) > 0.2).float()
    args = dict(
        win1_fea=r(nw, n1cap, d).to(dev, dtype),
        k2_fea=r(nw, nk_tot - nk1, d).to(dev, dtype),
        fps1=torch.randint(0, n1cap, (nw, nk1), generator=g,
                           dtype=torch.int32).to(dev),
        k_mask1=(torch.rand(nw, nk1, generator=g) < 0.3).to(dev),
        q_ext=None, q_keep=keep.to(dev),
        k_rel=tuple(r(nw, nk_tot).to(dev) for _ in range(3)),
        q_rel=tuple(r(nw, nq).to(dev) for _ in range(3)),
        pos_base=r(nw, d).to(dev, dtype), pos_w=r(3, d).to(dev, dtype),
        proj=tuple(proj),
        key_bias=torch.where(torch.rand(nw, nk_tot, generator=g) < 0.2,
                             -100.0, 0.0).to(dev),
        num_heads=num_heads, scale=(d // sum(num_heads)) ** -0.5,
        q_prefix=True, nq=nq, pad_row=r(nw, d).to(dev, dtype),
        num_valid=torch.tensor(nw - 3, device=dev), compute_dtype=dtype)
    return args, keep.to(dev)[..., None]


# (nq, keys a head group, heads, D): D = 64; more queries than keys in all
# (the two layouts whose buffers are the tightest); then two bf16 layouts the
# tensor-core tiles do not fit, which take the FMA path: head width 8, and a
# key stripe of 48
FWD_LAYOUTS = [(32, 16, (4,), 64), (18, 16, (2, 2), 64), (48, 16, (2, 2), 128),
               (32, 16, (8, 8), 128), (32, 48, (2, 2), 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [0, 17, 37, None])
@pytest.mark.parametrize("nq", [32, 18])
def test_attention_kernel_num_valid(dev, nv, nq):
    """K3 with no live window, some, all of the 37 and without num_valid:
    against the plain version in bf16 after the query mask, zeros at and
    past num_valid, and a second call bit-identical."""
    dtype = torch.bfloat16
    args, keep = _attn_args(dev, dtype, True, True, (2, 2), nq)
    args["num_valid"] = None if nv is None else torch.tensor(nv, device=dev)
    got = attention.fused_window_attention_assembled(**args)
    again = attention.fused_window_attention_assembled(**args)
    want = attention.attention_plain(**args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if nv != 0:
        _close(got * keep, want * keep, dtype)
    if nv is not None:
        assert (got[nv:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,num_heads,d", FWD_LAYOUTS)
def test_attention_kernel_layouts(dev, nq, nk, num_heads, d):
    """K3 in bf16 at the layouts of FWD_LAYOUTS: against the plain version,
    and a repeated call bit-identical."""
    dtype = torch.bfloat16
    args, keep = _layout_args(dev, dtype, 301, nq, nk, num_heads, d)
    want = attention.attention_plain(**args)
    outs = [attention.fused_window_attention_assembled(**args)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    _close(outs[0] * keep, want * keep, dtype)
    assert (outs[0][298:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,num_heads,d", FWD_LAYOUTS)
def test_attention_qk_kernel_layouts(dev, nq, nk, num_heads, d):
    """K6 in bf16 at the same layouts: against the plain version on every
    window; a repeated call bit-identical."""
    dtype = torch.bfloat16
    a, _ = _layout_args(dev, dtype, 301, nq, nk, num_heads, d)
    g = torch.Generator().manual_seed(5)
    nw, nk_tot = a["key_bias"].shape
    args = dict(query=torch.randn(nw, nq, d, generator=g).to(dev, dtype),
                keys=torch.randn(nw, nk_tot, d, generator=g).to(dev, dtype),
                proj=a["proj"], key_bias=a["key_bias"], num_heads=num_heads,
                scale=a["scale"], compute_dtype=dtype)
    want = attention_qk.attention_qk_plain(**args)
    outs = [attention_qk.fused_window_attention(**args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [32, 18])
def test_attention_forward_equals_backward_recompute(dev, nq):
    """K3 and K5 run the same code from the planes to O (assembly,
    projections, scores, softmax with the plain version's division, value
    product). With an identity output projection and no output bias K3
    returns O itself, so it must equal, bit for bit, the rounded O that K5
    recomputes and writes as the operand of its out-projection weight
    product, on every live window."""
    dtype = torch.bfloat16
    args, _ = _attn_args(dev, dtype, True, True, (2, 2), nq)
    d = args["win1_fea"].shape[2]
    proj = list(args["proj"])
    proj[6] = torch.eye(d, device=dev, dtype=dtype)
    proj[7] = torch.zeros(d, device=dev, dtype=dtype)
    args["proj"] = tuple(proj)
    out = attention.fused_window_attention_assembled(**args)
    g = torch.Generator().manual_seed(9)
    _, os_ = attention_bwd._launch(
        **args, g=torch.randn(out.shape, generator=g).to(dev, dtype))
    torch.cuda.synchronize()
    nv = int(args["num_valid"])
    assert out[:nv].abs().max() > 0
    assert torch.equal(out[:nv], os_[:nv])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_function_gradients(dev, dtype):
    """The autograd Function pairing K6 and K7 hands K7's cotangents to
    query, keys and the eight projection tensors."""
    args = _qk_args(dev, dtype, (2, 2), 8)
    leaves = [args["query"], args["keys"], *(p.float() for p in args["proj"])]
    for t in leaves:
        t.requires_grad_(True)
    static = (args["num_heads"], args["scale"], dtype)
    out = attention_qk_bwd.FusedAttention.apply(static, *leaves,
                                                args["key_bias"])
    g = torch.randn(out.shape, device=dev).to(dtype)
    out.backward(g)
    want = attention_qk_bwd.fused_window_attention_bwd(
        args["query"].detach(), args["keys"].detach(),
        tuple(p.detach() for p in leaves[2:]), args["key_bias"], g,
        args["num_heads"], args["scale"], dtype)
    for leaf, w in zip(leaves, (*want[:2], *want[2])):
        assert torch.equal(leaf.grad, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,f", [(128, 256), (64, 128)])
@pytest.mark.parametrize("v", [1, 63, 65, 1000, 20_000])
def test_ffn_kernel_matches_plain(dev, dtype, c, f, v):
    """Ragged last tiles (V = 1, 63, 65, 1000) and, at V = 20 000 (313
    tiles of 64 rows), more tiles than the bf16 kernel's persistent grid has
    CTAs; a repeated call is bit-identical."""
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g)
    args = [r(v, c).to(dev, dtype), (1 + 0.1 * r(c)).to(dev),
            (0.1 * r(c)).to(dev), (r(c, f) * 0.1).to(dev, dtype),
            (0.1 * r(f)).to(dev), (r(f, c) * 0.1).to(dev, dtype),
            (0.1 * r(c)).to(dev)]
    got = ffn.fused_residual_ffn(*args, compute_dtype=dtype)
    again = ffn.fused_residual_ffn(*args, compute_dtype=dtype)
    want = ffn.ffn_plain(*args, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (v, c)
    assert torch.equal(got, again)
    _close(got, want, dtype)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(TypeError):
        fill.fill_capacity_buffer(torch.zeros(4, 8, device=dev),
                                  np.zeros(8, np.int32), 4)
    x = torch.zeros(4, 10, device=dev)
    with pytest.raises(ValueError):
        fps.fps_select(x, x, x.t().contiguous().t(), (), 3)
    with pytest.raises(TypeError):
        ffn.fused_residual_ffn(torch.zeros(4, 32, device=dev, dtype=torch.half),
                               *([torch.zeros(32, device=dev)] * 6))
    bf = torch.bfloat16
    for c, f, offset in ((96, 192, 0), (128, 512, 0), (128, 256, 1)):
        xb = torch.zeros(5 * c + offset, device=dev, dtype=bf)[offset:]
        with pytest.raises(ValueError):  # widths not built, or misaligned x
            ffn.fused_residual_ffn(
                xb.view(5, c), torch.ones(c, device=dev),
                torch.zeros(c, device=dev), torch.zeros(c, f, device=dev, dtype=bf),
                torch.zeros(f, device=dev), torch.zeros(f, c, device=dev, dtype=bf),
                torch.zeros(c, device=dev), compute_dtype=bf)
    wide = torch.zeros(2, 300, device=dev)
    with pytest.raises(ValueError):
        fps.fps_picks_warp(wide, wide, wide, 4)
    huge = torch.zeros(1, fps.MAX_N_BLOCK + 1, device=dev)  # 16 385
    with pytest.raises(ValueError):
        fps.fps_picks_block(huge, huge, huge, 4)
    q = torch.zeros(3, 8, 64, device=dev)
    proj = tuple(t for _ in range(4) for t in (torch.eye(64, device=dev),
                                               torch.zeros(64, device=dev)))
    with pytest.raises(TypeError):  # mixed dtypes
        attention_qk.fused_window_attention(
            q, q.bfloat16(), proj, torch.zeros(3, 8, device=dev), (1, 1), 0.2)


# ------------------------------------------------------ the NMS scan
def _greedy_inputs(dev, b, k, density, seed):
    """Random suppression matrices (the diagonal and lower triangle set
    too: the scan must not read them), validity with invalid rows here and
    there and, for B > 1, one sample with no valid candidate; ``order`` a
    permutation of each row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    over = torch.rand((b, k, k), generator=g, device=dev) < density
    valid = torch.rand((b, k), generator=g, device=dev) < 0.9
    if b > 1:
        valid[1] = False
    order = torch.argsort(torch.rand((b, k), generator=g, device=dev), dim=1)
    return over, valid, order


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.002, 0.05, 0.5])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 500, 1024, 1344, 1345, 4096,
                               9000])
def test_nms_kernel_matches_plain(dev, k, b, density):
    """The kernel's selections and counts equal the loop's, bit for bit,
    with the packed rows in shared memory (K <= 1 344; above 48 KiB from
    K = 1 024) and in the scratch buffer (1 345, 4 096, 9 000), byte
    loads (K % 4 != 0) and 4-byte loads, with post_max above and below
    the kept count, and one launch a call."""
    a = _greedy_inputs(dev, b, k, density, seed=k * 10 + b)
    want = nms.greedy_plain(*a, k + 1)
    kept = int(want[1].max())
    for post_max in sorted({k + 1, max(kept // 2, 1), 0}):
        before = nms.launches
        got = nms.nms_greedy(*a, post_max)
        assert nms.launches == before + 1
        want = nms.greedy_plain(*a, post_max)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_nms_kernel_keeps_hand_computed_indices(dev, name, b):
    """The CPU tests' hand-computed cases (ties of the chain, invalid and
    all-invalid rows, K = 1, a post_max cut, a row crossing a word)."""
    args, want = hand_case(name, b)
    args = tuple(t.to(dev) if isinstance(t, torch.Tensor) else t for t in args)
    sel, num = nms.nms_greedy(*args)
    torch.cuda.synchronize()
    assert torch.equal(sel.cpu(), want[0]) and torch.equal(num.cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fn,arg", [(ops_nms.nms_bev, 0.1),
                                    (ops_nms.circle_nms, 1.5)])
@pytest.mark.parametrize("b,n,pre_max,post_max", [(2, 500, 512, 500),
                                                  (2, 700, 512, 83),
                                                  (1, 4096, 4096, 500)])
def test_nms_on_card_matches_the_loop_without_host_sync(dev, monkeypatch, fn,
                                                        arg, b, n, pre_max,
                                                        post_max):
    """``nms_bev`` and ``circle_nms`` on the card: one scan (and for
    ``nms_bev`` one mask) launch and no host sync a call
    (``set_sync_debug_mode("error")``), and the same indices as the plain
    route's (the IoU in row blocks, the loop). Scores take 8 values, so most
    candidates tie; boxes crowd a 40 m square, so many overlap."""
    g = torch.Generator(device=dev).manual_seed(n + b)
    boxes = torch.cat([torch.rand((b, n, 2), generator=g, device=dev) * 40,
                       torch.rand((b, n, 1), generator=g, device=dev),
                       0.5 + torch.rand((b, n, 3), generator=g, device=dev) * 4,
                       torch.rand((b, n, 1), generator=g, device=dev) * 6.3],
                      dim=-1)
    scores = torch.randint(0, 8, (b, n), generator=g, device=dev) / 8.0
    valid = scores > 0.1
    before, before_mask = nms.launches, nms_iou.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(boxes, scores, valid, arg, pre_max, post_max)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert nms.launches == before + 1
    assert nms_iou.launches == before_mask + (fn is ops_nms.nms_bev)
    # the plain route on the card: the IoU in row blocks, the loop
    monkeypatch.setattr(nms, "nms_greedy", nms.greedy_plain)
    monkeypatch.setattr(nms_iou, "nms_iou_mask", nms_iou.iou_mask_plain)
    monkeypatch.setattr(nms, "nms_greedy_packed", lambda w, v, o, p:
                        nms.greedy_plain(nms_iou.unpack(w, v.shape[1]), v,
                                         o, p))
    want = fn(boxes, scores, valid, arg, pre_max, post_max)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].min()) > 1


def _mask_case_boxes(dev, name):
    if name in EDGE_CASES:
        return _rows(EDGE_CASES[name]).to(dev)
    b, k = (int(v) for v in name.split("x"))
    g = torch.Generator(device=dev).manual_seed(k * 7 + b)
    return torch.cat([torch.rand((b, k, 2), generator=g, device=dev) * 40,
                      torch.rand((b, k, 1), generator=g, device=dev),
                      0.5 + torch.rand((b, k, 3), generator=g, device=dev) * 4,
                      torch.rand((b, k, 1), generator=g, device=dev) * 6.3,
                      torch.rand((b, k, 2), generator=g, device=dev)], dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", [0.0, 0.01, 0.1, 0.7])
@pytest.mark.parametrize("name", sorted(EDGE_CASES) + [
    "1x1", "1x63", "2x64", "2x65", "2x500", "1x1344", "3x1345", "4x4096"])
def test_nms_iou_mask_matches_plain(dev, name, thresh):
    """The mask kernel's words at and right of each row's diagonal word
    equal the plain version's on the card (the IoU in row blocks, packed)
    bit for bit, on (B, K, 9) boxes (velocities after the 7), with one
    launch a call; the words left of the diagonal are not written."""
    boxes = _mask_case_boxes(dev, name)
    b, k = boxes.shape[:2]
    up = nms_iou.upper_words(k, dev)
    out = torch.full((b, k, nms_iou.words_of(k)), 12345, dtype=torch.int64,
                     device=dev)
    before = nms_iou.launches
    got = nms_iou.nms_iou_mask(boxes, thresh)
    assert nms_iou.launches == before + 1
    want = nms_iou.iou_mask_plain(boxes, thresh)
    torch.cuda.synchronize()
    assert torch.equal(got[:, up], want[:, up])
    # the C entry writes into a given buffer: left of the diagonal untouched
    err = nms_iou._lib.lib().mssvt_nms_iou_mask(
        boxes.data_ptr(), b, k, boxes.shape[-1], float(thresh),
        out.data_ptr(), nms_iou._lib.stream_ptr(boxes))
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(out[:, up], want[:, up])
    assert (out[:, ~up] == 12345).all()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_nms_iou_mask_early_out_on_the_card(dev, seed):
    """Boxes placed just past the early-out's reach (and degenerate ones):
    the kernel's bits equal the plain IoU's at threshold 0, where a pair
    skipped wrongly would show as a missing bit."""
    boxes = _near_boundary_boxes(seed).to(dev)
    k = boxes.shape[1]
    up = nms_iou.upper_words(k, dev)
    got = nms_iou.nms_iou_mask(boxes, 0.0)
    want = nms_iou.pack_upper(box_ops.pairwise_iou_bev(boxes, boxes) > 0)
    torch.cuda.synchronize()
    assert torch.equal(got[:, up], want[:, up])


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.002, 0.05])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 500, 1344, 1345, 4096, 9000])
def test_nms_packed_scan_matches_plain(dev, k, b, density):
    """The scan of packed rows keeps what the loop keeps, bit for bit, with
    the rows copied to shared memory (K <= 1 344) and read in place (1 345
    up), whatever the words left of the diagonal hold; one launch a
    call."""
    over, valid, order = _greedy_inputs(dev, b, k, density, seed=k * 3 + b)
    words = nms_iou.pack_upper(over)
    words[:, ~nms_iou.upper_words(k, dev)] = -1
    for post_max in (k + 1, 7, 0):
        before = nms.launches
        got = nms.nms_greedy_packed(words, valid, order, post_max)
        assert nms.launches == before + 1
        want = nms.greedy_plain(over, valid, order, post_max)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_nms_mask_and_packed_scan_refuse_what_the_kernels_do_not_take(dev):
    boxes = _mask_case_boxes(dev, "2x65")[..., :7].contiguous()
    for bad in ((boxes.bfloat16(), 0.1), (boxes.double(), 0.1),
                (boxes, -0.5), (boxes[..., :6].contiguous(), 0.1),
                (boxes.transpose(0, 1), 0.1)):
        with pytest.raises((TypeError, ValueError)):
            nms_iou.nms_iou_mask(*bad)
    words = nms_iou.nms_iou_mask(boxes, 0.1)
    valid = torch.ones((2, 65), dtype=torch.bool, device=dev)
    order = torch.arange(65, device=dev).expand(2, 65).contiguous()
    for bad in ((words.to(torch.int32), valid, order),
                (words[:, :, :1].contiguous(), valid, order),
                (words, valid.cpu(), order)):
        with pytest.raises((TypeError, ValueError)):
            nms.nms_greedy_packed(*bad, 4)


@pytest.mark.cuda
def test_nms_wrapper_refuses_what_the_kernel_does_not_take(dev):
    over, valid, order = _greedy_inputs(dev, 2, 10, 0.1, seed=0)
    for bad in ((over.to(torch.uint8), valid, order),
                (over, valid, order.to(torch.int32)),
                (over.transpose(1, 2), valid, order),
                (over[:, :, :9], valid, order)):
        with pytest.raises((TypeError, ValueError)):
            nms.nms_greedy(*bad, 4)
    with pytest.raises(ValueError):
        nms.nms_greedy(over, valid.cpu(), order, 4)  # devices differ


# ------------------------------------ the sparse-conv and anchor families
# They reach none of the kernels above: these hold the plain PyTorch path
# on the card (gathers, products, scatters, NMS) against the CPU's.
@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
def test_sparse_conv_backbone_on_card_matches_cpu(dev, residual):
    """The SECOND backbone (subm stages, strided layers, masked BN) in
    training on the card: output sites equal, features and every gradient
    within 1e-4 of the CPU's largest magnitude (f32, TF32 off)."""
    from mssvt_tpu_torch.core.sparse import SparseVoxels
    from mssvt_tpu_torch.models.backbones_3d.spconv_backbone import (
        VoxelBackBone8x,
    )
    from mssvt_tpu_torch.models.network import init_weights

    rng = np.random.default_rng(2)
    n, cap, grid = 600, 512, (32, 32, 32)
    cells = np.unique(np.stack([rng.integers(0, 2, n), rng.integers(0, 8, n),
                                rng.integers(0, 32, n), rng.integers(0, 32, n)],
                               1), axis=0)[:cap]
    coords = np.full((cap, 4), -1, np.int32)
    coords[:len(cells)] = cells
    valid = np.arange(cap) < len(cells)
    feats = (rng.normal(size=(cap, 4)) * valid[:, None]).astype(np.float32)
    res = {}
    for d in ("cpu", dev):
        bb = init_weights(VoxelBackBone8x(
            4, cap, grid, (8, 16, 16, 16), 32, residual=residual), 3).to(d)
        bb.train()
        f = torch.as_tensor(feats, device=d).requires_grad_(True)
        sp = bb(SparseVoxels.create(f, torch.as_tensor(coords, device=d),
                                    torch.as_tensor(valid, device=d), 2, grid,
                                    (0.4, 0.4, 0.125), (0,) * 6))
        g = torch.as_tensor(np.random.default_rng(3).normal(
            size=tuple(sp.features.shape)).astype(np.float32), device=d)
        sp.features.backward(g)
        res[d] = (sp, f.grad, {k: p.grad for k, p in bb.named_parameters()})
    (sc, fc, gc), (sg, fg, gg) = res["cpu"], res[dev]
    assert torch.equal(sc.coords, sg.coords.cpu())
    for name, a, b in [("features", sc.features, sg.features),
                       ("input cotangent", fc, fg)] + [
            (k, gc[k], gg[k]) for k in gc]:
        assert (a - b.cpu()).abs().max() <= 1e-4 * a.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["second", "pointpillar"])
def test_tiny_kitti_detectors_on_card_match_cpu(dev, name, monkeypatch):
    """chip_smoke 10a as a test: tiny ``kitti_models/<name>.yaml`` on the
    card against the CPU on the same weights (``kitti_tiny_models``: BN
    statistics of the scene, classification bias zeroed): the kept boxes
    of each frame, as sets, within 1e-3, the training loss within 1e-4
    relative, the gradient norm and every gradient within 1e-3 of the
    global norm (f32: TF32 off for cuDNN's convolutions too); no kernel
    launched."""
    import chip_smoke
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.runtime.train_utils import forward_backward

    (_, args), scene = chip_smoke.kitti_tiny(name, 29)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    kernels.reset_launch_counts()
    res = {}
    models = chip_smoke.kitti_tiny_models(torch, args, scene, 7)
    for d, model in zip(("cpu", dev), models):
        batch = {k: torch.as_tensor(v, device=d) for k, v in scene.items()}
        with torch.no_grad():
            out = model(batch)
        loss, _ = forward_backward(model, batch)
        grads = torch.cat([p.grad.reshape(-1).cpu()
                           for p in model.parameters()])
        res[d] = (out, float(loss), grads)
    (oc, lc, gc), (og, lg, gg) = res["cpu"], res[dev]
    n_kept, err = chip_smoke.kept_box_sets_error(oc, og)  # sets a frame
    assert n_kept > 0 and err <= 1e-3, (n_kept, err)
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert abs(gg.norm() - gc.norm()) <= 1e-3 * gc.norm()
    assert (gg - gc).abs().max() <= 1e-3 * gc.norm()
    assert not any(kernels.launch_counts().values())


# ------------------------------------------ the two-stage voxel family
# No kernel of K1-K7 either: the RoI machinery's gathers and pools on the
# card, whose backward sums must repeat bit for bit.
@pytest.mark.cuda
def test_voxel_query_on_card_matches_cpu(dev):
    """``voxel_query`` at VoxelRCNN's (4, 4, 4) neighbourhood on a stage
    grid of 2 x 176 x 200 x 5 cells: rows and emptiness equal to the CPU's,
    and again on a repeat."""
    from mssvt_tpu_torch.ops.voxel_query import voxel_query

    rng = np.random.default_rng(4)
    grid, vs, pcr = (176, 200, 5), (0.4, 0.4, 0.8), (0, -40, -3, 70.4, 40, 1)
    n = 6000
    cells = np.unique(np.stack([rng.integers(0, 2, n), rng.integers(0, 5, n),
                                rng.integers(0, 200, n),
                                rng.integers(0, 176, n)], 1), axis=0)
    coords = np.full((8192, 4), -1, np.int32)
    coords[:len(cells)] = cells
    valid = np.arange(8192) < len(cells)
    q = np.stack([rng.uniform(0, 70.4, (2, 4000)), rng.uniform(-40, 40, (2, 4000)),
                  rng.uniform(-3, 1, (2, 4000))], -1).astype(np.float32)
    args = (grid, vs, pcr, (4, 4, 4), 1.6, 16, 2)
    want = voxel_query(torch.as_tensor(q), torch.as_tensor(coords),
                       torch.as_tensor(valid), *args)
    got = [voxel_query(torch.as_tensor(q, device=dev),
                       torch.as_tensor(coords, device=dev),
                       torch.as_tensor(valid, device=dev), *args)
           for _ in range(2)]
    for g in got:
        assert torch.equal(g[0].cpu(), want[0]) and torch.equal(g[1].cpu(),
                                                                want[1])
    assert 0 < int(want[1].sum()) < want[1].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["max", "avg"])
def test_roiaware_pool_on_card_matches_cpu(dev, pool):
    """``roiaware_pool3d`` at PartA2's 12^3 grid, 64 RoIs over 8 000
    points a frame: values and the features' cotangent within 1e-6 of the
    CPU's largest magnitude (the average's sums in another order), and bit
    for bit on a repeat."""
    from mssvt_tpu_torch.ops.roiaware_pool import roiaware_pool3d

    rng = np.random.default_rng(5)
    b, n, r, c = 2, 8000, 64, 16
    pts = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 2, (b, n))
    feats = np.round(rng.normal(size=(b, n, c)), 1).astype(np.float32)
    rois = np.concatenate([rng.uniform(-15, 15, (b, r, 2)),
                           rng.uniform(-1, 1, (b, r, 1)),
                           rng.uniform(2, 6, (b, r, 3)),
                           rng.uniform(-3, 3, (b, r, 1))], -1).astype(np.float32)
    valid = rng.random((b, n)) < 0.9
    rvalid = rng.random((b, r)) < 0.9
    cot = rng.normal(size=(b, r, 12, 12, 12, c)).astype(np.float32)
    res = []
    for d in ("cpu", dev, dev):
        f = torch.as_tensor(feats, device=d).requires_grad_(True)
        out, empty = roiaware_pool3d(*(torch.as_tensor(x, device=d) for x in (
            pts,)), f, torch.as_tensor(valid, device=d),
            torch.as_tensor(rois, device=d), torch.as_tensor(rvalid, device=d),
            12, pool)
        out.backward(torch.as_tensor(cot, device=d))
        res.append((out.detach().cpu(), empty.cpu(), f.grad.cpu()))
    (oc, ec, gc), (o1, e1, g1), (o2, e2, g2) = res
    assert torch.equal(ec, e1) and 0 < int((~ec).sum()) < ec.numel()
    assert (o1 - oc).abs().max() <= 1e-6 * oc.abs().max()
    assert (g1 - gc).abs().max() <= 1e-6 * gc.abs().max()
    assert torch.equal(o1, o2) and torch.equal(g1, g2)


@pytest.mark.cuda
def test_gather_rows_backward_on_card(dev):
    """``gather_rows`` with one row picked 200 000 times and the rest a few
    times each: the backward within 1e-5 of the CPU's float64 ``index_add_``
    (relative to each row's magnitude sum), bit for bit on a repeat."""
    from mssvt_tpu_torch.ops.sampling import gather_rows

    gen = torch.Generator().manual_seed(6)
    v, n, c = 5000, 400_000, 32
    idx = torch.randint(0, v, (n,), generator=gen)
    idx[:200_000] = 7
    idx = idx[torch.randperm(n, generator=gen)].view(-1, 16)
    g = torch.randn(n // 16, 16, c, generator=gen)
    want = torch.zeros(v, c, dtype=torch.float64).index_add_(
        0, idx.reshape(-1), g.reshape(-1, c).double())
    scale = torch.zeros(v, c, dtype=torch.float64).index_add_(
        0, idx.reshape(-1), g.reshape(-1, c).double().abs())
    grads = []
    for _ in range(2):
        x = torch.zeros(v, c, device=dev, requires_grad=True)
        gather_rows(x, idx.to(dev)).backward(g.to(dev))
        grads.append(x.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    assert ((grads[0].double() - want).abs() <= 1e-5 * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["voxel_rcnn_car", "PartA2", "second_iou"])
def test_tiny_two_stage_detectors_on_card_match_cpu(dev, name, monkeypatch):
    """chip_smoke 12a as a test: the tiny two-stage model on the card
    against the CPU on the same weights: RoIs and refined boxes as sets
    within 1e-3 of max(1, |value|), the training loss within 1e-4
    relative, the gradient norm
    within 1e-3, the card's gradients bit-identical on a repeat; no kernel
    launched."""
    import chip_smoke
    from mssvt_tpu_torch import kernels

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    kernels.reset_launch_counts()
    chip_smoke.two_stage_tiny_check(torch, name, seed=31)
    assert not any(kernels.launch_counts().values())


# -------------------------------------- the point-based two-stage family
# K2c and K2b on the FPS of PV-RCNN's keypoints and PointRCNN's set
# abstractions; the rest plain PyTorch, whose gathers' backward sums must
# repeat bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,npoint,kernel", [
    (2, 16384, 2048, "fps_picks_block"),  # PV-RCNN keypoints, SA level 0
    (2, 1024, 256, "fps_picks_block"),    # SA level 2
    (2, 256, 64, "fps_picks_warp")])      # SA level 3
def test_farthest_point_sample_launches_k2c_k2b(dev, b, n, npoint, kernel):
    """``ops.sampling.farthest_point_sample`` on a card tensor launches K2c
    (N > 256) or K2b (N <= 256) once and nothing else, and its picks equal
    ``fps_plain``'s on the same card planes; above K2c's 16 384 it
    raises."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.ops.sampling import farthest_point_sample

    rng = np.random.default_rng(n)
    xyz = np.stack([rng.uniform(0, 70.4, (b, n)), rng.uniform(-40, 40, (b, n)),
                    rng.uniform(-3, 1, (b, n))], -1).astype(np.float32)
    xyz[:, n - 37:] = 0.0  # padding rows at the origin
    t = torch.as_tensor(xyz, device=dev)
    kernels.reset_launch_counts()
    got = farthest_point_sample(t, npoint)
    counts = kernels.launch_counts()
    assert counts[kernel] == 1 and sum(counts.values()) == 1, counts
    want = fps.fps_plain(t[..., 0].contiguous(), t[..., 1].contiguous(),
                         t[..., 2].contiguous(), (), npoint)[0]
    assert torch.equal(got, want)
    if n == 16384:
        with pytest.raises(ValueError, match="16384"):
            farthest_point_sample(torch.zeros((1, 16385, 3), device=dev), 8)


def _masked_rows(rng, kind, rows, frames, n):
    """(planes (3, frames, n) f32, valid (rows, n) bool) of a masked FPS
    case: "sectors" KITTI-like points, each row one azimuth sector of its
    frame (row r: frame r % frames, sector r // frames) among points near
    a few boxes; "union" 80% valid; "empty" row 0 without a valid point;
    "few" 5 valid points a row (fewer than the picks); "all" every point
    valid; "ties" small integer coordinates (exact ties), 30% valid."""
    if kind == "ties":
        planes = rng.integers(-4, 5, (3, frames, n)).astype(np.float32)
    else:
        planes = np.stack([rng.uniform(0, 70.4, (frames, n)),
                           rng.uniform(-40, 40, (frames, n)),
                           rng.uniform(-3, 1, (frames, n))]).astype(np.float32)
    if kind == "sectors":
        az = np.arctan2(planes[1], planes[0])
        sector = np.clip(((az + np.pi) / (2 * np.pi) * (rows // frames))
                         .astype(int), 0, rows // frames - 1)
        near = rng.random((frames, n)) < 0.7
        valid = np.stack([near[r % frames] & (sector[r % frames] == r // frames)
                          for r in range(rows)])
    elif kind == "union":
        valid = rng.random((rows, n)) < 0.8
    elif kind == "few":
        valid = np.zeros((rows, n), bool)
        for r in range(rows):
            valid[r, rng.choice(n, 5, replace=False)] = True
    elif kind == "all":
        valid = np.ones((rows, n), bool)
    else:
        valid = rng.random((rows, n)) < 0.3
    if kind == "empty":
        valid[0] = False
    return planes, valid


# (rows, frames, N, npoint, case): PV-RCNN++'s two passes at the cell's
# shapes (2 frames x 6 sectors of 16 384 points -> 342; 2 rows of 2 052 ->
# 2 048), then the kernel's other forms
FPS_MASKED_CASES = [
    (12, 2, 16384, 342, k) for k in ("sectors", "empty", "few", "all", "ties")
] + [
    (2, 2, 2052, 2048, k) for k in ("union", "empty", "few", "all", "ties")
] + [
    (37, 37, 700, 32, "ties"),       # 128 threads, 6 CTAs an SM
    (5, 5, 4099, 64, "union"),       # N % 4 != 0: scalar loads
    (4, 2, 8192, 100, "all"),        # registers: 512 threads
    (3, 3, 16384, 9000, "union"),    # the pick list past shared memory
    (6, 3, 300, 400, "few"),         # npoint > N
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,frames,n,npoint,kind", FPS_MASKED_CASES)
def test_fps_masked_kernel_matches_plain(dev, rows, frames, n, npoint, kind):
    """The masked FPS kernel's picks equal the plain loop's
    (``fps_masked_plain``) exactly on the same card planes: rows that share
    a frame's planes, an empty sector, fewer valid points than picks,
    every point valid, exact ties; one launch a call."""
    rng = np.random.default_rng(n + rows)
    planes, valid = _masked_rows(rng, kind, rows, frames, n)
    planes = [torch.as_tensor(p, device=dev) for p in planes]
    valid = torch.as_tensor(valid, device=dev)
    before = fps.launches_masked
    got = fps.fps_picks_masked(*planes, valid, npoint)
    want = fps.fps_masked_plain(*planes, valid, npoint)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert fps.launches_masked == before + 1
    if kind == "empty":
        assert not bool(got[0].any())


@pytest.mark.cuda
def test_sector_fps_on_card_launches_the_masked_kernel_twice(dev,
                                                            monkeypatch):
    """``ops.sampling.sector_fps`` at the cell's size (2 frames of 16 384
    points, 2 048 keypoints, 6 sectors) launches the masked FPS twice and
    no other kernel of the port, and picks what it picks with the plain
    loop in the kernel's place; past 16 384 points it raises."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.ops import sampling

    rng = np.random.default_rng(11)
    planes, _ = _masked_rows(rng, "union", 2, 2, 16384)
    xyz = torch.as_tensor(np.moveaxis(planes, 0, -1), device=dev)
    valid = torch.as_tensor(rng.random((2, 16384)) < 0.5, device=dev)
    valid[1, 9000:] = False  # padding rows
    kernels.reset_launch_counts()
    got = sampling.sector_fps(xyz, valid, 2048, 6)
    counts = kernels.launch_counts()
    assert counts["fps_picks_masked"] == 2 and sum(counts.values()) == 2
    monkeypatch.setattr(fps, "fps_picks_masked", fps.fps_masked_plain)
    assert torch.equal(got, sampling.sector_fps(xyz, valid, 2048, 6))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="16384"):
        sampling.farthest_point_sample_masked(
            torch.zeros((1, 16385, 3), device=dev),
            torch.ones((1, 16385), dtype=torch.bool, device=dev), 8)


@pytest.mark.cuda
def test_ball_query_on_card_matches_cpu(dev):
    """``ball_query`` at PV-RCNN head scale (a frame's 8 000 grid points
    against 2 048 keypoints, 2 frames, 16 slots; masked raw points of
    PointRCNN's level 0 at 4 096 x 16 384): indices and emptiness equal to
    the CPU's, and on a repeat."""
    from mssvt_tpu_torch.ops.pointnet2 import ball_query

    rng = np.random.default_rng(7)
    for m, n, radius, valid_rows in ((8000, 2048, 1.6, None),
                                     (4096, 16384, 0.5, 15000)):
        pts = np.stack([rng.uniform(0, 70.4, (2, n)),
                        rng.uniform(-40, 40, (2, n)),
                        rng.uniform(-3, 1, (2, n))], -1).astype(np.float32)
        pts[:, :n // 2] = pts[:, :n // 2] * 0.1 + [20, 0, -1]
        q = pts[:, rng.integers(0, n, m)] + rng.normal(
            size=(2, m, 3)).astype(np.float32) * radius
        valid = None if valid_rows is None else np.arange(n)[None].repeat(
            2, 0) < valid_rows
        args = lambda d: (torch.as_tensor(pts, device=d),  # noqa: E731
                          torch.as_tensor(q, device=d),
                          None if valid is None else torch.as_tensor(
                              valid, device=d))
        want = ball_query(radius, 16, *args("cpu"))
        for _ in range(2):
            got = ball_query(radius, 16, *args(dev))
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
        assert 0 < int(want[1].sum()) < want[1].numel()


@pytest.mark.cuda
def test_point_gathers_backward_on_card(dev):
    """The training gathers of the point detectors on the card against the
    CPU and again on a repeat: ``query_and_group`` (PV-RCNN head scale,
    empty grid points picking keypoint 0 sixteen times; the cotangents of
    the features and the query centres), ``three_interpolate`` (FP level 0:
    16 384 x 3 picks onto 4 096 rows) and ``roipoint_pool3d`` (128 RoIs of
    512 slots a frame over 16 384 points, wrapped slots): values and
    cotangents within 1e-5 of the CPU's largest magnitude, and bit for bit
    on a repeat."""
    from mssvt_tpu_torch.ops.pointnet2 import query_and_group, roipoint_pool3d
    from mssvt_tpu_torch.ops.sampling import three_interpolate, three_nn

    rng = np.random.default_rng(8)

    def kitti(n):
        return np.stack([rng.uniform(0, 70.4, (2, n)),
                         rng.uniform(-40, 40, (2, n)),
                         rng.uniform(-3, 1, (2, n))], -1).astype(np.float32)

    kp, grid = kitti(2048), kitti(8000)
    grid[:, :4000] = kp[:, :4000 // 2].repeat(2, 1) + 0.3
    kf = rng.normal(size=(2, 2048, 32)).astype(np.float32)
    unknown, known = kitti(16384), kitti(4096)
    known_f = rng.normal(size=(2, 4096, 64)).astype(np.float32)
    pts, pf = kitti(16384), rng.normal(size=(2, 16384, 16)).astype(np.float32)
    rois = np.concatenate([pts[:, :128] + 0.2, rng.uniform(2, 6, (2, 128, 3)),
                           rng.uniform(-3, 3, (2, 128, 1))], -1).astype(
        np.float32)

    def run(d):
        t = lambda a, g=False: torch.as_tensor(a, device=d).requires_grad_(g)  # noqa: E731
        tkf, tgrid, tkn, tpf = t(kf, True), t(grid, True), t(known_f, True), \
            t(pf, True)
        out1, e1 = query_and_group(1.6, 16, t(kp), tgrid, tkf)
        d2, idx = three_nn(t(unknown), t(known))
        w = 1.0 / (torch.sqrt(d2) + 1e-8)
        out2 = three_interpolate(tkn, idx, w / w.sum(-1, keepdim=True))
        out3, e3 = roipoint_pool3d(t(pts), tpf, t(rois), 512)
        loss = sum((o * torch.sin(torch.arange(o.numel(), device=d,
                                               dtype=o.dtype).view(o.shape)
                                  )).sum() for o in (out1, out2, out3))
        loss.backward()
        return [x.detach().cpu() for x in (out1, out2, out3, e1, e3, idx,
                                           tkf.grad, tgrid.grad, tkn.grad,
                                           tpf.grad)]

    want = run("cpu")
    got1, got2 = run(dev), run(dev)
    for a, b in zip(got1, got2):
        assert torch.equal(a, b)
    for g, w in zip(got1, want):
        if w.dtype == torch.bool or not w.is_floating_point():
            assert torch.equal(g, w)
        else:
            assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    assert bool(want[3].any()) and not bool(want[3].all())


def _kitti_kw(name):
    from mssvt_tpu_torch.config import cfg_from_yaml_file
    from mssvt_tpu_torch.utils.edict import EasyDict

    root = __import__("pathlib").Path(__file__).resolve().parent.parent
    cfg = cfg_from_yaml_file(str(root / f"tools/cfgs/kitti_models/{name}.yaml"),
                             EasyDict())
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vox = dc.DATA_PROCESSOR[-1]
    vs = tuple(vox.VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    return dict(model_cfg=cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                class_names=cfg.CLASS_NAMES, grid_size=grid, voxel_size=vs,
                point_cloud_range=pcr, batch_size=2,
                max_voxels=vox.MAX_NUMBER_OF_VOXELS["train"],
                max_points_per_voxel=vox.MAX_POINTS_PER_VOXEL,
                num_point_features=len(
                    dc.POINT_FEATURE_ENCODING.used_feature_list))


@pytest.mark.cuda
@pytest.mark.parametrize("name,cls", [("pv_rcnn", "PVRCNN"),
                                      ("pv_rcnn_plusplus", "PVRCNN"),
                                      ("pointrcnn", "PointRCNN")])
def test_point_kitti_configs_build_on_cuda_by_default(dev, name, cls):
    """The three yamls at their published widths build on the card when no
    device is named, with the yaml's raw-point rows."""
    from mssvt_tpu_torch.models import build_network

    model = build_network(**_kitti_kw(name))
    assert type(model).__name__ == cls and model.max_points == 16384
    assert all(p.device.type == "cuda" for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pvrcnn", "pvrcnn_plusplus", "pointrcnn"])
def test_tiny_point_detectors_on_card_match_cpu(dev, name, monkeypatch):
    """chip_smoke 13a as a test: the tiny model on the card against the CPU
    on the same weights (refined boxes as sets within 1e-3, loss within
    1e-4 relative, gradient norm within 1e-3, a repeated backward
    bit-identical), launching K2c (PV-RCNN, PointRCNN) and K2b (PointRCNN)
    on its FPS, the masked FPS (PV-RCNN++'s sector FPS), and no other
    kernel."""
    import chip_smoke
    from mssvt_tpu_torch import kernels

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    kernels.reset_launch_counts()
    r = chip_smoke.point_tiny_check(torch, name, seed=31)
    launched = {k for k, v in kernels.launch_counts().items() if v}
    assert launched == {"pvrcnn": {"fps_picks_block"},
                        "pvrcnn_plusplus": {"fps_picks_masked"},
                        "pointrcnn": {"fps_picks_block",
                                      "fps_picks_warp"}}[name]
    assert r["kept"][0] > 0


@pytest.mark.cuda
def test_pvrcnn_plusplus_keypoints_span_on_card(dev, tmp_path):
    """One profiled eval request of the benchmark's rehearsal PV-RCNN++ (at
    pcdet's depth) on the card: ``mssvt.keypoints`` holds the masked FPS
    kernel twice and a few dozen launches in all (the plain loop launched
    ~90 000), then ``mssvt.pfe`` and ``mssvt.roi_head`` follow inside
    ``mssvt.post``."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import spec, trace
    from benchmark.traffic import kitti_points_scene
    from mssvt_tpu_torch.models import build_network
    from mssvt_tpu_torch.runtime.eval_utils import eval_step
    from mssvt_tpu_torch.utils.edict import EasyDict

    reh = json.loads(json.dumps(spec.load_json(
        spec.BENCH / "rehearsal" / "pvrcnnpp-kitti.json")))
    data = reh["data"]
    model = build_network(
        EasyDict(reh["MODEL"]), 3, reh["class_names"],
        tuple(data["grid_size"]), tuple(data["voxel_size"]),
        tuple(data["point_cloud_range"]), 2, data["max_voxels_per_frame"], 5,
        num_point_features=4, device=dev, seed=0).eval()
    host, _ = kitti_points_scene.make(
        dict(reh["traffic"]["params"], distinct_batches=1), reh, 2, 5)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in host[0].items()}
    eval_step(model, batch)  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eval_step(model, batch)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = trace.load(path)
    spans = {s: trace.ranges(events, "mssvt." + s)
             for s in ("post", "keypoints", "pfe", "roi_head")}
    assert all(len(r) == 1 for r in spans.values()), spans
    (post,) = spans["post"]
    order = [spans[s][0] for s in ("keypoints", "pfe", "roi_head")]
    assert post[0] <= order[0][0] and order[-1][1] <= post[1]
    for (_, end), (start, _) in zip(order, order[1:]):
        assert end <= start
    ks = trace.launched_within(events, spans["keypoints"])
    masked = [e for e in ks if "fps_masked_kernel" in e["name"]]
    print(f"mssvt.keypoints: {len(ks)} kernels, {len(masked)} masked FPS")
    assert len(masked) == 2 and len(ks) < 64, [e["name"] for e in ks]


# ------------------------------ CaDDN, CT3D_3CAT, AnchorHeadMulti/ATSS
# no kernel of K1-K7 on their path; the camera sampler's gathers go through
# gather_rows, whose backward must repeat bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["caddn", "ct3d", "second_multi"])
def test_tiny_late_families_on_card_match_cpu(dev, name, monkeypatch):
    """chip_smoke 14a as a test: the tiny CaDDN, CT3D_3CAT and SECOND with
    AnchorHeadMulti/ATSS on the card against the CPU on the same weights
    (detections as sets within 1e-3, loss within 1e-4 relative, gradient
    norm within 1e-3, a repeated backward bit-identical), no kernel
    launched."""
    import chip_smoke
    from mssvt_tpu_torch import kernels

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    kernels.reset_launch_counts()
    r = chip_smoke.late_tiny_check(torch, name, seed=31)
    assert not any(kernels.launch_counts().values())
    assert r["kept"][0] > 0


@pytest.mark.cuda
def test_image_vfe_sampler_on_card_matches_cpu(dev, monkeypatch):
    """ImageVFE on chip_smoke 14c's seeded KITTI batch (one frame, the
    tree's calibration, 375 x 1242) over a coarse grid, BatchNorm on its
    running statistics (in training, flax's E[x^2] - E[x]^2 over 116 000
    pixels a channel cancels, and card and CPU gradients part by more than
    1e-4 of the largest on some machines; chip_smoke 14a holds the
    training step at small size): the
    voxel features within 1e-4 of the CPU's largest magnitude, every
    parameter's gradient within 1e-4 of the CPU's largest gradient
    magnitude (of any parameter: some leaves hold only rounding noise),
    the card's gradients bit-identical on a repeat (the out-of-view voxels
    all pick the edge pixels)."""
    import copy

    import chip_smoke
    from mssvt_tpu_torch.models.backbones_3d.image_vfe import ImageVFE

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = {"FFN": {"DDN_CFG": {"NUM_CHANNELS": 8, "NUM_BLOCKS": 3}},
           "DISCRETIZE": {"DEPTH_MIN": 2.0, "DEPTH_MAX": 46.8,
                          "NUM_BINS": 80}}
    b = chip_smoke.caddn_batches(np, 1, seed=3, bsz=1)[0]
    grid = (40, 48, 10)
    cpu = ImageVFE(cfg, grid, (1.0, 1.0, 0.4), (2.0, -24.0, -3.0, 42.0, 24.0,
                                                1.0)).eval()
    card = copy.deepcopy(cpu).to(dev)
    res = []
    for m, d in ((cpu, "cpu"), (card, dev), (card, dev)):
        m.zero_grad()
        ins = [torch.as_tensor(b[k], device=d) for k in (
            "images", "trans_lidar_to_cam", "trans_cam_to_img")]
        vox, logits = m(*ins)
        g = torch.Generator(device="cpu").manual_seed(0)
        w = torch.randn(vox.shape, generator=g).to(d)
        (vox * w).sum().backward()
        res.append((vox.detach().cpu(), {n: p.grad.cpu() for n, p in
                                         m.named_parameters()}))
    (vc, gc), (vg, gg), (_, gg2) = res
    assert (vc.abs().sum(-1) > 0).float().mean() > 0.01
    assert (vg - vc).abs().max() <= 1e-4 * vc.abs().max()
    top = max(float(w.abs().max()) for w in gc.values())
    for n, w in gc.items():
        assert (gg[n] - w).abs().max() <= 1e-4 * top, n
    assert all(torch.equal(gg[n], gg2[n]) for n in gg)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cls", [("ct3d_3cat", "CT3D3CAT"),
                                      ("CaDDN", "CaDDN")])
def test_late_kitti_configs_build_on_cuda_by_default(dev, name, cls):
    """The two yamls at their published widths build on the card when no
    device is named."""
    from mssvt_tpu_torch.models import build_network

    model = build_network(**_kitti_kw(name))
    assert type(model).__name__ == cls
    assert all(p.device.type == "cuda" for p in model.parameters())


# ----------------------------------------------------------------------
# The MsSVT backbone's inference forward as a CUDA graph, at mssvt.yaml's
# shapes (bf16, seeded LeCun weights), batch 2 of Waymo-scale scenes

MSSVT_YAML = (Path(__file__).resolve().parent.parent / "tools" / "cfgs"
              / "waymo_models" / "mssvt.yaml")
WAYMO_GRID = (480, 480, 32)


def _waymo_voxels(seed, batch=2):
    from mssvt_tpu_torch.core.sparse import SparseVoxels
    from mssvt_tpu_torch.datasets.synthetic_scene import (
        make_waymo_scale_scene,
    )

    scene, _ = make_waymo_scale_scene(90_000 * batch, WAYMO_GRID, seed=seed,
                                      batch=batch)
    pts = torch.as_tensor(scene["voxel_num_points"]).clamp(min=1)
    feats = torch.as_tensor(scene["voxels"]).sum(1) / pts[:, None]
    return SparseVoxels.create(
        feats.cuda(), torch.as_tensor(scene["voxel_coords"]).cuda(),
        torch.as_tensor(scene["voxel_valid"]).cuda(), batch, WAYMO_GRID,
        (0.32, 0.32, 0.1875), (-76.8, -76.8, -2.0, 76.8, 76.8, 4.0),
        with_index=False)


@pytest.fixture(scope="module")
def mssvt_graph():
    """(backbone, two scenes, each scene's eager ``stages``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    from mssvt_tpu_torch.models.backbones_3d.mssvt import (
        MixedScaleSparseTransformer,
    )
    from mssvt_tpu_torch.models.network import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    set_deterministic()
    with open(MSSVT_YAML) as f:
        params = yaml.safe_load(f)["MODEL"]["BACKBONE_3D"]["PARAMS"]
    model = init_weights(MixedScaleSparseTransformer(
        params, 5, dtype=torch.bfloat16)).cuda().eval()
    scenes = [_waymo_voxels(seed) for seed in (0, 1)]
    with torch.no_grad():
        eager = [model.stages(sp) for sp in scenes]
    return model, scenes, eager


def _same(a, b):
    return (torch.equal(a.features, b.features)
            and torch.equal(a.coords, b.coords)
            and torch.equal(a.valid, b.valid))


@pytest.mark.cuda
def test_mssvt_backbone_graph_equals_eager(mssvt_graph):
    """One graph serves two scenes in turn, bit for bit the eager forward's
    (the replay reads the static inputs anew). The device trace of three
    replays holds the K1-K4 launches of three eager forwards, as the
    launch counters read them, and the replays open
    ``mssvt.backbone_graph``."""
    import chip_smoke

    model, scenes, eager = mssvt_graph
    model.graph.clear()
    with torch.no_grad():
        before = kernels.launch_counts()
        eager_traced = chip_smoke.traced_launches(
            torch, lambda: model.stages(scenes[0]))
        mid = kernels.launch_counts()
        first = model(scenes[0])
        assert model.graph.captured is not None
        outs = []
        before_replays = kernels.launch_counts()
        replays_traced = chip_smoke.traced_launches(
            torch, lambda: outs.extend(model(scenes[i]) for i in (1, 0, 1)))
        after = kernels.launch_counts()
    assert _same(first, eager[0][-1])
    for i, out in zip((1, 0, 1), outs):
        assert _same(out, eager[i][-1])
    assert not torch.equal(eager[0][-1].features, eager[1][-1].features)
    one = chip_smoke.launches(fill=5, fps=3, attention=3, ffn=3)
    assert eager_traced == {n: mid[n] - before[n] for n in mid} == one
    assert replays_traced == {n: after[n] - before_replays[n] for n in after}
    assert replays_traced == {n: 3 * v for n, v in one.items()}


@pytest.mark.cuda
def test_mssvt_backbone_replays_open_their_span(mssvt_graph):
    model, scenes, _ = mssvt_graph
    with torch.no_grad():
        model(scenes[0])  # the set-up, if this key has none yet
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i in (1, 0, 1):
                model(scenes[i])
    spans = [e.name for e in prof.events() if e.name.startswith("mssvt.")]
    assert spans == ["mssvt.backbone_graph"] * 3


@pytest.mark.cuda
def test_mssvt_backbone_replay_makes_no_host_sync(mssvt_graph):
    model, scenes, eager = mssvt_graph
    with torch.no_grad():
        model(scenes[0])  # the set-up, if this key has none yet
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model(scenes[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert model.graph.captured is not None
    assert _same(out, eager[1][-1])


@pytest.mark.cuda
def test_mssvt_backbone_capture_failure_falls_back_to_eager(mssvt_graph,
                                                            monkeypatch):
    """A capture that raises (here a device sync inside it) leaves the key
    eager, with one warning; both calls give the eager output, the second
    inside ``mssvt.backbone_graph_eager``."""
    model, scenes, eager = mssvt_graph
    model.graph.clear()
    model.graph.warned = False
    fused = ffn.fused_residual_ffn

    def syncing(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return fused(*a, **k)

    monkeypatch.setattr(ffn, "fused_residual_ffn", syncing)
    try:
        with torch.no_grad():
            with pytest.warns(RuntimeWarning, match="capture failed"):
                first = model(scenes[0])
            assert model.graph.key is not None
            assert model.graph.captured is None
            with warnings.catch_warnings(), torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                warnings.simplefilter("error")
                second = model(scenes[0])
    finally:
        model.graph.clear()
    assert _same(first, eager[0][-1]) and _same(second, eager[0][-1])
    spans = [e.name for e in prof.events() if e.name.startswith("mssvt.")]
    assert spans == ["mssvt.backbone_graph_eager"]


@pytest.mark.cuda
def test_mssvt_backbone_outputs_survive_the_next_replay(mssvt_graph):
    model, scenes, eager = mssvt_graph
    with torch.no_grad():
        model(scenes[0])
        a = model(scenes[0])
        b = model(scenes[1])
    assert _same(a, eager[0][-1]) and _same(b, eager[1][-1])


@pytest.mark.cuda
def test_mssvt_backbone_replay_runs_the_blocks_forward_hooks(mssvt_graph):
    """Forward hooks on the blocks (the benchmark keeps each block's
    output through them) see each block's input and output after a
    replay, and keep them through the next replay."""
    model, scenes, eager = mssvt_graph
    seen = []
    handles = [b.register_forward_hook(
        lambda m, a, o, i=i: seen.append((i, a[0], o)))
        for i, b in enumerate(model.blocks())]
    try:
        with torch.no_grad():
            model(scenes[1])
            seen.clear()
            model(scenes[0])
            model(scenes[1])
    finally:
        for h in handles:
            h.remove()
    assert [i for i, _, _ in seen] == list(range(5)) * 2
    for i, inp, out in seen[:5]:
        assert _same(inp, eager[0][i]) and _same(out, eager[0][i + 1])
    for i, inp, out in seen[5:]:
        assert _same(out, eager[1][i + 1])


# ----------------------------------------------------------------------
# The sparse-conv backbone's inference forward as two CUDA graphs (the
# rules', then the layers'), at SECOND's and PV-RCNN++'s KITTI shapes:
# pcdet's grid, 40 000 voxels a frame, batch 4 and 2, bf16

KITTI_GRID = (1408, 1600, 40)
KITTI_VOXEL = (0.05, 0.05, 0.1)
KITTI_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
KITTI_CAP = 40_000


def _kitti_sites(seed, batch, live):
    """``live`` sites a frame in blobs of a few metres (so the tables hold
    neighbours), padded to 40 000 rows a frame; features from the seed."""
    from mssvt_tpu_torch.core.sparse import SparseVoxels

    rng = np.random.default_rng(seed)
    coords = np.full((batch * KITTI_CAP, 4), -1, np.int32)
    for b in range(batch):
        centres = rng.uniform((0, 0, 5), (KITTI_GRID[0], KITTI_GRID[1], 30),
                              (80, 3))
        xyz = centres[rng.integers(0, 80, 4 * live)] + rng.normal(
            0, (12, 12, 3), (4 * live, 3))
        xyz = np.clip(np.rint(xyz), 0, np.array(KITTI_GRID) - 1).astype(int)
        cells = np.unique(np.stack([xyz[:, 2], xyz[:, 1], xyz[:, 0]], 1),
                          axis=0)
        cells = cells[rng.permutation(len(cells))[:live]]
        assert len(cells) == live
        coords[b * KITTI_CAP:b * KITTI_CAP + live, 0] = b
        coords[b * KITTI_CAP:b * KITTI_CAP + live, 1:] = cells
    valid = coords[:, 0] >= 0
    feats = rng.normal(size=(batch * KITTI_CAP, 4)).astype(np.float32)
    return SparseVoxels.create(
        torch.as_tensor(feats * valid[:, None]).cuda(),
        torch.as_tensor(coords).cuda(), torch.as_tensor(valid).cuda(), batch,
        KITTI_GRID, KITTI_VOXEL, KITTI_RANGE, with_index=False)


@pytest.fixture(scope="module", params=[4, 2], ids=["second_b4",
                                                     "pvrcnnpp_b2"])
def spconv_graph(request):
    """(backbone, two scenes of different live counts, each scene's eager
    ``layers`` by name): ``VoxelBackBone8x`` as SECOND and PV-RCNN++ build
    it (widths 16/32/64/64 -> 128, pcdet's grid), bf16, seeded weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    from mssvt_tpu_torch.models.backbones_3d import spconv_backbone
    from mssvt_tpu_torch.models.network import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    set_deterministic()
    batch = request.param
    model = init_weights(spconv_backbone.VoxelBackBone8x(
        in_channels=4, input_capacity=KITTI_CAP * batch,
        grid_size=KITTI_GRID, pcdet_sparse_shape=True,
        dtype=torch.bfloat16), 3).cuda().eval()
    scenes = [_kitti_sites(seed, batch, live)
              for seed, live in ((5, 17_000), (6, 15_500))]
    with torch.no_grad():
        eager = [dict(zip(spconv_backbone.ENCODER,
                          model.layers(sp, model.rules(sp))))
                 for sp in scenes]
    return model, scenes, eager


def _same_sites(a, b):
    return (_same(a, b) and tuple(a.spatial_shape) == tuple(b.spatial_shape)
            and a.batch_size == b.batch_size)


def _stages_of(out):
    """(x_conv1, .., x_conv4, output) of a ``return_stages`` forward."""
    sp, stages = out
    return [stages[f"x_conv{i}"] for i in (1, 2, 3, 4)] + [sp]


STAGE_ENDS = ("conv1", "conv2_subm", "conv3_subm", "conv4_subm", "conv_out")


@pytest.mark.cuda
def test_spconv_backbone_graph_equals_eager(spconv_graph):
    """One pair of graphs serves two scenes of different live counts in
    turn, each replay bit for bit the eager forward (the replays read the
    static inputs anew): the output's features, coords and valid."""
    model, scenes, eager = spconv_graph
    model.graph.clear()
    with torch.no_grad():
        first = model(scenes[0])
        assert model.graph.captured is not None
        assert len(model.graph.captured.graphs) == 2
        outs = [model(scenes[i]) for i in (1, 0, 1)]
    assert _same_sites(first, eager[0]["conv_out"])
    for i, out in zip((1, 0, 1), outs):
        assert _same_sites(out, eager[i]["conv_out"])
    assert not torch.equal(eager[0]["conv_out"].valid,
                           eager[1]["conv_out"].valid)
    assert float(outs[0].features.float().abs().sum()) > 0


@pytest.mark.cuda
def test_spconv_backbone_return_stages_through_the_graph(spconv_graph):
    """VoxelRCNN's ``return_stages``: the four stages and the output of a
    replay, bit for bit the eager ones, kept through the next replay."""
    model, scenes, eager = spconv_graph
    model.return_stages = True
    try:
        with torch.no_grad():
            model(scenes[0])  # the set-up, if this key has none yet
            a = _stages_of(model(scenes[0]))
            b = _stages_of(model(scenes[1]))
    finally:
        model.return_stages = False
    for got, want in ((a, eager[0]), (b, eager[1])):
        for g, name in zip(got, STAGE_ENDS):
            assert _same_sites(g, want[name]), name


@pytest.mark.cuda
def test_spconv_backbone_makes_no_host_sync(spconv_graph):
    """Once its constants are on the card, neither the eager forward nor a
    replay waits for the card: no pageable copy, no sync."""
    model, scenes, eager = spconv_graph
    with torch.no_grad():
        model(scenes[0])  # the set-up, if this key has none yet
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            layers = model.layers(scenes[1], model.rules(scenes[1]))
            out = model(scenes[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert model.graph.captured is not None
    assert _same_sites(layers[-1], eager[1]["conv_out"])
    assert _same_sites(out, eager[1]["conv_out"])


@pytest.mark.cuda
def test_spconv_backbone_replays_open_their_spans(spconv_graph):
    """Each replay opens ``mssvt.spconv_graph`` with one
    ``mssvt.spconv_rules`` (the rules' replay) inside it, and nothing
    else."""
    model, scenes, _ = spconv_graph
    with torch.no_grad():
        model(scenes[0])  # the set-up, if this key has none yet
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i in (1, 0, 1):
                model(scenes[i])
    ev = [e for e in prof.events() if e.name.startswith("mssvt.")]
    assert sorted(e.name for e in ev) == \
        ["mssvt.spconv_graph"] * 3 + ["mssvt.spconv_rules"] * 3

    def ranges(name):
        return sorted((e.time_range.start, e.time_range.end) for e in ev
                      if e.name == name)

    for (g0, g1), (r0, r1) in zip(ranges("mssvt.spconv_graph"),
                                  ranges("mssvt.spconv_rules")):
        assert g0 <= r0 and r1 <= g1


@pytest.mark.cuda
def test_spconv_backbone_capture_failure_falls_back_to_eager(spconv_graph,
                                                             monkeypatch):
    """A capture that raises (here a device sync inside the rules') leaves
    the key eager, with one warning; both calls give the eager output, the
    second inside ``mssvt.spconv_graph_eager`` (its rules in
    ``mssvt.spconv_rules``)."""
    from mssvt_tpu_torch.models.backbones_3d import spconv_backbone

    model, scenes, eager = spconv_graph
    model.graph.clear()
    model.graph.warned = False
    table = spconv_backbone.build_subm_neighbor_table

    def syncing(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return table(*a, **k)

    monkeypatch.setattr(spconv_backbone, "build_subm_neighbor_table",
                        syncing)
    try:
        with torch.no_grad():
            with pytest.warns(RuntimeWarning, match="capture failed"):
                first = model(scenes[0])
            assert model.graph.key is not None
            assert model.graph.captured is None
            with warnings.catch_warnings(), torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                warnings.simplefilter("error")
                second = model(scenes[0])
    finally:
        model.graph.clear()
    assert _same_sites(first, eager[0]["conv_out"])
    assert _same_sites(second, eager[0]["conv_out"])
    spans = [e.name for e in prof.events() if e.name.startswith("mssvt.")]
    assert spans == ["mssvt.spconv_graph_eager", "mssvt.spconv_rules"]


@pytest.mark.cuda
def test_spconv_backbone_outputs_survive_the_next_replay(spconv_graph):
    model, scenes, eager = spconv_graph
    with torch.no_grad():
        model(scenes[0])
        a = model(scenes[0])
        b = model(scenes[1])
    assert _same_sites(a, eager[0]["conv_out"])
    assert _same_sites(b, eager[1]["conv_out"])


@pytest.mark.cuda
def test_spconv_backbone_replay_runs_the_stage_ends_forward_hooks(
        spconv_graph):
    """Forward hooks on the five stage-ending layers (the benchmark's judge
    keeps their outputs through them) see each one's input and output
    after a replay, in the eager order, and keep them through the next
    replay; a hook on any other layer sends the call to the eager
    forward."""
    from mssvt_tpu_torch.models.backbones_3d.spconv_backbone import ENCODER

    model, scenes, eager = spconv_graph
    seen = []
    handles = [getattr(model, n).register_forward_hook(
        lambda m, a, o, n=n: seen.append((n, a[0], o))) for n in STAGE_ENDS]
    try:
        with torch.no_grad():
            model(scenes[1])
            seen.clear()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                model(scenes[0])
                model(scenes[1])
            other = model.conv2_down.register_forward_hook(
                lambda m, a, o: None)
            try:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU]) as eager_prof:
                    model(scenes[0])
            finally:
                other.remove()
    finally:
        for h in handles:
            h.remove()
    assert [n for n, _, _ in seen[:10]] == list(STAGE_ENDS) * 2
    assert [e.name for e in prof.events()
            if e.name == "mssvt.spconv_graph"] == ["mssvt.spconv_graph"] * 2
    for k, (n, inp, out) in enumerate(seen[:10]):
        want = eager[0] if k < 5 else eager[1]
        before = ENCODER[ENCODER.index(n) - 1]
        assert _same_sites(inp, want[before]), n
        assert _same_sites(out, want[n]), n
    assert not any(e.name.startswith("mssvt.spconv_graph")
                   for e in eager_prof.events())
    assert _same_sites(seen[-1][2], eager[0]["conv_out"])
