"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Fill and FPS must match exactly; attention (forward and backward) and FFN
in f32 to 1e-4 (the same f32 math summed in another order) and in bf16 to
2^-5 of the largest output magnitude (an intermediate may round one bf16 ulp
apart).
"""

import numpy as np
import pytest
import torch

from mssvt_tpu_torch.kernels import attention, attention_bwd, ffn, fill, fps


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert (got - want).abs().max() <= 2.0 ** -5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("with_order,with_slab,nv", [
    (True, True, 23), (False, False, None), (True, False, 5)])
def test_fill_kernel_matches_plain(dev, with_order, with_slab, nv):
    rng = np.random.default_rng(0)
    nw, k, cap = 40, 648, 96
    box = np.where(rng.random((nw, k)) < 0.3,
                   rng.integers(0, 10**7, (nw, k)), -1).astype(np.int32)
    offs = rng.integers(0, 2**15, k).astype(np.int32)
    order = rng.permutation(k) if with_order else None
    own_slab = (216, 72) if with_slab else None
    elig = rng.integers(0, 2, (k, 3)).astype(np.float32) if with_slab else None
    nv_t = None if nv is None else torch.tensor(nv, device=dev)
    b = torch.as_tensor(box, device=dev)
    got = fill.fill_capacity_buffer(b, offs, cap, order, own_slab, elig, nv_t)
    want = fill.fill_plain(b, offs, cap, order, own_slab, elig, nv_t)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nw_half,integer", [(96, 48, True), (96, 48, False),
                                               (33, 0, False), (256, 8, True)])
def test_fps_kernel_matches_plain(dev, n, nw_half, integer):
    rng = np.random.default_rng(1)
    rows = 2 * nw_half if nw_half else 21
    mk = ((lambda: rng.integers(-6, 7, (rows, n)).astype(np.float32))
          if integer else (lambda: rng.normal(size=(rows, n)).astype(np.float32)))
    planes = [torch.as_tensor(mk(), device=dev) for _ in range(4)]
    nv = torch.tensor(max(nw_half - 3, 1) if nw_half else 17, device=dev)
    got = fps.fps_select(*planes[:3], (planes[3],), 32, nv, nw_half)
    want = fps.fps_plain(*planes[:3], (planes[3],), 32, nv, nw_half)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_kernel_matches_plain(dev, dtype):
    g = torch.Generator().manual_seed(3)
    v, c, f = 1000, 128, 256
    r = lambda *s: torch.randn(*s, generator=g)
    args = [r(v, c).to(dev, dtype), (1 + 0.1 * r(c)).to(dev),
            (0.1 * r(c)).to(dev), (r(c, f) * 0.1).to(dev, dtype),
            (0.1 * r(f)).to(dev), (r(f, c) * 0.1).to(dev, dtype),
            (0.1 * r(c)).to(dev)]
    got = ffn.fused_residual_ffn(*args, compute_dtype=dtype)
    want = ffn.ffn_plain(*args, compute_dtype=dtype)
    torch.cuda.synchronize()
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
