"""Port kernels (mssvt_tpu_torch/kernels) against the JAX package.

Each kernel's plain PyTorch version (what a wrapper runs for CPU tensors) is
held against the JAX function on the same numpy inputs: the Pallas kernel in
interpret mode and, where the JAX package has one, its XLA form. The CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mssvt_tpu.ops.pallas_attention import fused_window_attention_assembled
from mssvt_tpu.ops.pallas_ffn import fused_residual_ffn
from mssvt_tpu.ops.pallas_fill import (
    fill_capacity_buffer,
    fill_capacity_buffer_xla,
)
from mssvt_tpu.ops.pallas_fps import farthest_point_sample_planes_pallas_t_sel
from mssvt_tpu_torch.kernels import _lib, attention, attention_qk, ffn, fill, fps

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a))


# ----------------------------------------------------------------- K1 fill
FILL_CASES = [
    # (nw, k, cap, order, own_slab, num_valid)
    (40, 648, 96, True, True, None),    # block-0 table geometry
    (40, 648, 96, True, True, 23),      # tail rows past num_valid
    (130, 300, 48, False, False, None),
    (16, 162, 96, True, True, 9),       # block-4 table geometry
    (5, 129, 64, True, False, None),    # dense occupancy
    (24, 648, 96, True, True, 0),       # no live row
    (19, 163, 96, True, True, 11),      # K % 4 != 0: rows start unaligned
]


def _fill_inputs(case):
    nw, k, cap, with_order, with_slab, nv = case
    rng = np.random.default_rng(nw * 1000 + k)
    occp = rng.uniform(0.05, 0.9)
    box = np.where(rng.random((nw, k)) < occp,
                   rng.integers(0, 16_000_000, (nw, k)), -1).astype(np.int32)
    if nv is not None:
        box[nv:] = -1  # windows past the live prefix have empty tables
    offs = rng.integers(0, 2**15, (k,)).astype(np.int32)
    order = rng.permutation(k).astype(np.int64) if with_order else None
    own_slab = elig = None
    if with_slab:
        own_slab = (k // 3, min(72, k - k // 3))
        elig = rng.integers(0, 2, (k, 3)).astype(np.float32)
    return box, offs, cap, order, own_slab, elig, nv


@pytest.mark.parametrize("case", FILL_CASES,
                         ids=[f"nw{c[0]}k{c[1]}nv{c[5]}" for c in FILL_CASES])
def test_fill_plain_matches_jax(case):
    """Exact: every int output against the XLA fill and the Pallas kernel
    (interpret mode, with num_valid where given)."""
    box, offs, cap, order, own_slab, elig, nv = _fill_inputs(case)
    got = fill.fill_plain(_t(box), offs, cap, order=order, own_slab=own_slab,
                          elig=elig,
                          num_valid=None if nv is None else torch.tensor(nv))
    want_xla = fill_capacity_buffer_xla(jnp.asarray(box), offs, cap,
                                        order=order, own_slab=own_slab,
                                        elig=elig)
    want_pl = fill_capacity_buffer(
        jnp.asarray(box), offs, cap, interpret=True, order=order,
        own_slab=own_slab, elig=elig,
        num_valid=None if nv is None else jnp.asarray(nv, jnp.int32))
    assert len(got) == len(want_xla) == len(want_pl)
    for i, (g, wx, wp) in enumerate(zip(got, want_xla, want_pl)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wx),
                                      err_msg=f"output {i} vs xla")
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp),
                                      err_msg=f"output {i} vs pallas")


# ------------------------------------------------------------------ K2 FPS
@pytest.mark.parametrize("integer_planes,n,npoint", [
    (True, 96, 32), (False, 96, 32), ("dup", 96, 32), (True, 20, 40)],
    ids=["True", "False", "duplicated_points", "npoint_above_n"])
def test_fps_plain_matches_pallas_select(integer_planes, n, npoint):
    """Exact picks and selections, with two stacked halves and a live
    prefix; integer planes (the model's offsets) produce many distance
    ties, which must resolve to the lowest index. "dup" draws each row's
    points from 27 distinct ones, so every distance is 0 after the first
    picks; with npoint > N every point is taken and the picks repeat."""
    rng = np.random.default_rng(5)
    nw_half, nv = 160, 40
    b = 2 * nw_half
    if integer_planes == "dup":
        x, y, z = (rng.integers(0, 3, (b, n)).astype(np.float32)
                   for _ in range(3))
    elif integer_planes:
        x, y, z = (rng.integers(-4, 5, (b, n)).astype(np.float32)
                   for _ in range(3))
    else:
        x, y, z = (rng.normal(size=(b, n)).astype(np.float32) * 3
                   for _ in range(3))
    aux = rng.integers(-1, 90_000, (b, n)).astype(np.float32)
    dead = np.zeros(b, bool)
    dead[nv:nw_half] = True
    dead[nw_half + nv:] = True
    for p in (x, y, z, aux):
        p[dead] = 0.0  # dead windows have empty (zero) buffers
    got_idx, got_sel = fps.fps_plain(_t(x), _t(y), _t(z), (_t(aux),), npoint,
                                     num_valid=torch.tensor(nv),
                                     nw_half=nw_half)
    want_idx, want_sel = farthest_point_sample_planes_pallas_t_sel(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), (jnp.asarray(aux),),
        npoint, col_block=128, interpret=True,
        num_valid=jnp.asarray(nv, jnp.int32), nw_half=nw_half)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    for g, w in zip(got_sel, want_sel):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got_idx.numpy()[dead] == 0).all()


# ------------------------------------------------------ K3 assembled attention
def _blockdiag(blocks, d):
    out = np.zeros((d, d), np.float32)
    s = 0
    for blk in blocks:
        out[s:s + blk.shape[0], s:s + blk.shape[0]] = blk
        s += blk.shape[0]
    return out


def _attn_inputs(q_prefix, pad_keys, rng, nq=12, d=64):
    nw, n1cap, nk1, nk2 = 20, 24, 8, 8
    num_heads = (2, 2)
    sd = d // 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    proj = []
    for _ in range(4):
        proj.append(_blockdiag([f(sd, sd) * 0.3, f(sd, sd) * 0.3], d))
        proj.append(f(d) * 0.1)
    qm = rng.random((nw, nq)) < 0.2
    km = rng.random((nw, nk1 + nk2)) < 0.2
    return dict(
        win1_fea=f(nw, n1cap, d), k2_fea=f(nw, nk2, d),
        fps1=rng.integers(0, n1cap, (nw, nk1)).astype(np.int32),
        k_mask1=rng.random((nw, nk1)) < 0.3,
        q_ext=None if q_prefix else f(nw, nq, d) * (~qm)[..., None],
        q_keep=(~qm).astype(np.float32),
        k_rel=tuple(f(nw, nk1 + nk2) for _ in range(3)),
        q_rel=tuple(f(nw, nq) for _ in range(3)),
        pos_base=f(nw, d), pos_w=f(3, d), proj=tuple(proj),
        key_bias=np.where(km, -100.0, 0.0).astype(np.float32),
        num_heads=num_heads, scale=(d // 4) ** -0.5, q_prefix=q_prefix,
        nq=nq, pad_row=f(nw, d) if pad_keys else None, qm=qm)


def _map_arrays(args, fn):
    """Apply ``fn`` to every numpy array of ``args`` (and inside tuples)."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return fn(v)
        if isinstance(v, tuple) and v and isinstance(v[0], np.ndarray):
            return tuple(fn(x) for x in v)
        return v
    return {k: conv(v) for k, v in args.items()}


@pytest.mark.parametrize("q_prefix,pad_keys", [(True, False), (False, False),
                                               (True, True), (False, True)])
def test_attention_plain_matches_pallas(q_prefix, pad_keys):
    """f32, compared after the query mask and on the live windows (the
    Pallas kernel zeroes only whole supertiles past num_valid). Tolerance
    1e-4: the same f32 math, summed in another order."""
    a = _attn_inputs(q_prefix, pad_keys, np.random.default_rng(7))
    qm = a.pop("qm")
    nv = 13
    t_args = _map_arrays(a, _t)
    got = attention.attention_plain(
        **t_args, num_valid=torch.tensor(nv),
        compute_dtype=torch.float32).numpy()
    j_args = _map_arrays(a, jnp.asarray)
    if j_args["q_ext"] is None:
        j_args["q_ext"] = jnp.zeros((qm.shape[0], 1, 64), jnp.float32)
    want = np.asarray(fused_window_attention_assembled(
        **j_args, num_valid=jnp.asarray(nv, jnp.int32), window_block=8,
        interpret=True, compute_dtype=jnp.float32))
    keep = (~qm)[..., None]
    np.testing.assert_allclose((got * keep)[:nv], (want * keep)[:nv],
                               atol=1e-4, rtol=1e-4)
    assert (got[nv:] == 0).all()


@pytest.mark.parametrize("nq,d", [(18, 64), (18, 128)])
def test_attention_plain_matches_pallas_at_card_test_shapes(nq, d):
    """The plain version at the query count and widths the card tests add
    for the CUDA forward (18 queries, which pad the 16-row tiles there; D =
    64 and 128): f32 against the Pallas kernel in interpret mode, as above."""
    a = _attn_inputs(True, True, np.random.default_rng(11), nq=nq, d=d)
    qm = a.pop("qm")
    nv = 13
    got = attention.attention_plain(
        **_map_arrays(a, _t), num_valid=torch.tensor(nv),
        compute_dtype=torch.float32).numpy()
    j_args = _map_arrays(a, jnp.asarray)
    j_args["q_ext"] = jnp.zeros((qm.shape[0], 1, d), jnp.float32)
    want = np.asarray(fused_window_attention_assembled(
        **j_args, num_valid=jnp.asarray(nv, jnp.int32), window_block=8,
        interpret=True, compute_dtype=jnp.float32))
    keep = (~qm)[..., None]
    np.testing.assert_allclose((got * keep)[:nv], (want * keep)[:nv],
                               atol=1e-4, rtol=1e-4)
    assert (got[nv:] == 0).all()


# ------------------------------------- host-side preparation of K3 and K6
def test_transposed_weights_are_contiguous_transposes():
    """The forwards' and backwards' tensor-core paths read the projection
    weights as [output][input] channel: the copies the wrappers pass."""
    a = _attn_inputs(True, True, np.random.default_rng(3))
    ws = [_t(w) for w in a["proj"][0::2]]
    wts = _lib.transposed(ws)
    assert len(wts) == 4
    for w, wt in zip(ws, wts):
        assert wt.is_contiguous() and torch.equal(wt, w.mT.contiguous())
        assert not torch.equal(wt, w)  # the blocks are not symmetric


def test_forward_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU tensor goes to the plain version and launches nothing."""
    a = _attn_inputs(True, True, np.random.default_rng(3))
    a.pop("qm")
    t_args = _map_arrays(a, _t)
    before = (attention.launches, attention_qk.launches)
    got = attention.fused_window_attention_assembled(
        **t_args, num_valid=torch.tensor(13), compute_dtype=torch.float32)
    want = attention.attention_plain(
        **t_args, num_valid=torch.tensor(13), compute_dtype=torch.float32)
    assert torch.equal(got, want)
    q, k = t_args["win1_fea"][:, :12], t_args["win1_fea"][:, 8:]
    qk = dict(proj=t_args["proj"], key_bias=t_args["key_bias"],
              num_heads=(2, 2), scale=0.25)
    assert torch.equal(attention_qk.fused_window_attention(q, k, **qk),
                       attention_qk.attention_qk_plain(q, k, **qk))
    assert (attention.launches, attention_qk.launches) == before


def test_kernel_inputs_refuse_what_the_kernels_do_not_take():
    """The checks in front of the CUDA forwards (pure Python, so they run
    here): the tensors come back in the order the C entries read them, with
    the four weights where the wrappers take them for transposing; a width
    that is no multiple of 32, mixed dtypes or a wrong shape raise."""
    a = _attn_inputs(True, True, np.random.default_rng(3))
    a.pop("qm")
    t_args = _map_arrays(a, _t)
    scale = t_args.pop("scale")
    extra = dict(num_valid=torch.tensor(13), compute_dtype=torch.float32,
                 name="attention")
    t, nq, tensors, dims = attention.kernel_inputs(**t_args, **extra)
    assert (t, nq, len(tensors)) == (torch.float32, 12, 25)
    assert dims == [20, 24, 8, 8, 12, 64, 2, 1, 2, 2, 0, 0]
    for w, got in zip(t_args["proj"][0::2], tensors[14:18]):
        assert torch.equal(w, got)
    narrow = dict(t_args, win1_fea=t_args["win1_fea"][..., :48].contiguous())
    with pytest.raises(ValueError):
        attention.kernel_inputs(**narrow, **extra)
    with pytest.raises(TypeError):
        attention.kernel_inputs(**dict(t_args, k2_fea=t_args["k2_fea"].bfloat16()),
                                **extra)
    q, k = t_args["win1_fea"][:, :12].contiguous(), t_args["win1_fea"]
    t, tensors, dims = attention_qk.kernel_inputs(
        q, k, t_args["proj"], torch.zeros(20, 24), (2, 2), None, "attention_qk")
    assert dims == [20, 12, 24, 64, 2, 2, 2, 0, 0]
    for w, got in zip(t_args["proj"][0::2], tensors[2:6]):
        assert torch.equal(w, got)
    with pytest.raises(TypeError):
        attention_qk.kernel_inputs(q, k.bfloat16(), t_args["proj"],
                                   torch.zeros(20, 24), (2, 2), None, "k6")
    with pytest.raises(ValueError):  # keys do not split over 3 head groups
        attention_qk.kernel_inputs(q, k[:, :23].contiguous(), t_args["proj"],
                                   torch.zeros(20, 23), (2, 1, 1), None, "k6")


# ------------------------------------------------------------------- K4 FFN
def _ffn_inputs(rng, v=300, c=64, f=128):
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    s1, s2 = 0.2 * (64 / c) ** 0.5, 0.2 * (128 / f) ** 0.5  # fan-in scaled
    return (r(v, c), 1 + 0.1 * r(c), 0.1 * r(c), r(c, f) * s1, 0.1 * r(f),
            r(f, c) * s2, 0.1 * r(c))


@pytest.mark.parametrize("v,c,f", [(300, 64, 128), (1025, 128, 256)])
def test_ffn_plain_bf16_matches_pallas(v, c, f):
    """bf16 mode is the TPU kernel's arithmetic (LN output and hidden
    activation rounded to bf16, f32 accumulation), at the widths of
    mssvt_tiny.yaml and mssvt.yaml, with V ragged to the Pallas row block
    (1 024). Tolerance 2e-2 abs / 1e-2 rel: the f32 sums run in another
    order, which can move a hidden activation across a bf16 rounding
    boundary (one bf16 ulp is 2^-8 rel)."""
    args = _ffn_inputs(np.random.default_rng(2), v, c, f)
    got = ffn.ffn_plain(*(_t(a) for a in args),
                        compute_dtype=torch.bfloat16).numpy()
    want = np.asarray(fused_residual_ffn(*(jnp.asarray(a) for a in args),
                                         interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)


def test_ffn_plain_f32_matches_flax_chain():
    """f32 mode against the JAX CPU path's flax LayerNorm + Dense chain;
    tolerance 1e-5 (f32, different summation order)."""
    from flax import linen as nn

    x, s, b, w1, b1, w2, b2 = _ffn_inputs(np.random.default_rng(3))
    ln = nn.LayerNorm().apply({"params": {"scale": s, "bias": b}},
                              jnp.asarray(x))
    h = nn.relu(nn.Dense(w1.shape[1]).apply(
        {"params": {"kernel": w1, "bias": b1}}, ln))
    want = np.asarray(jnp.asarray(x) + nn.Dense(w2.shape[1]).apply(
        {"params": {"kernel": w2, "bias": b2}}, h))
    got = ffn.ffn_plain(*(_t(a) for a in (x, s, b, w1, b1, w2, b2)),
                        compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
