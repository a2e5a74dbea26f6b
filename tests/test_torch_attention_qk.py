"""The ``ref_compat_keys: False`` slice of the port against the JAX package,
on the CPU: the plain versions of K6/K7 (window attention on pre-assembled
tokens, forward and backward) against the Pallas kernels in interpret mode,
``MixedScaleAttention``'s flag-off routes, the selection-free FPS (K2b/K2c)
against both Pallas layouts, and the tiny model with the flag off.

Inputs come from numpy seeds and go through both sides. Each test states its
tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.models.model_utils.attention import MixedScaleAttention as JAttn
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.kernels import attention_qk, attention_qk_bwd, fps
from mssvt_tpu_torch.models.model_utils.attention import (
    MixedScaleAttention as TAttn)
from test_pallas_attention import _rand_proj
from test_torch_detector import _check, _run_pair
from test_torch_train import (
    _tiny_cfgs,
    _tiny_geometry,
    _tiny_scene,
    check_loss_grads_and_stats,
    make_tiny_pair,
)

torch.set_num_threads(2)

CASES = [((2, 2), 8), ((2, 2), 32), ((4,), 8), ((4,), 32)]
PROJ_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp")


def _qk_inputs(num_heads, nq):
    rng = np.random.default_rng(5)
    nw, nk_tot, d = 5, 32, 64
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        query=f(nw, nq, d), keys=f(nw, nk_tot, d),
        proj=tuple(_rand_proj(rng, num_heads, d)),
        bias=np.where(rng.random((nw, nk_tot)) < 0.25, -100.0,
                      0.0).astype(np.float32),
        g=f(nw, nq, d), scale=(d // sum(num_heads)) ** -0.5)


def _dtypes(dtype):
    return ((jnp.float32, torch.float32) if dtype == "float32"
            else (jnp.bfloat16, torch.bfloat16))


def _T(x, tdt=None):
    t = torch.as_tensor(np.asarray(x, np.float32))
    return t if tdt is None else t.to(tdt)


def _hold(got, want, dtype, name, scale=None):
    """f32: rtol/atol 1e-5 (the same f32 math summed in another order).
    bf16: 2^-5 of the largest magnitude (the same bf16 rounding points; an
    intermediate may land one bf16 ulp apart after a sum in another order).
    ``scale`` replaces the tensor's own largest magnitude where the tensor
    is analytically zero."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    top = np.abs(want).max() if scale is None else scale
    if dtype == "float32":
        atol = 1e-5 if scale is None else 1e-5 * scale
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=name)
    else:
        err = np.abs(got - want).max()
        assert err <= 2.0 ** -5 * top, (name, err, top)


# ------------------------------------------------------------ K6, K7 plain
@pytest.mark.parametrize("num_heads,nq", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_jax_forward(num_heads, nq, dtype):
    """``attention_qk_plain`` against ``fused_window_attention(...,
    interpret=True)``, the Pallas forward itself, on every window; the
    output comes in the query's dtype on both sides."""
    from mssvt_tpu.ops.pallas_attention import fused_window_attention

    a = _qk_inputs(num_heads, nq)
    jdt, tdt = _dtypes(dtype)
    with jax.default_matmul_precision("float32"):
        want = fused_window_attention(
            jnp.asarray(a["query"], jdt), jnp.asarray(a["keys"], jdt),
            tuple(map(jnp.asarray, a["proj"])), jnp.asarray(a["bias"]),
            num_heads=num_heads, scale=a["scale"], interpret=True,
            compute_dtype=jdt)
    got = attention_qk.fused_window_attention(
        _T(a["query"], tdt), _T(a["keys"], tdt), tuple(map(_T, a["proj"])),
        _T(a["bias"]), num_heads, a["scale"], compute_dtype=tdt)
    assert got.dtype == tdt and want.dtype == jdt
    _hold(got, want, dtype, "out")
    assert attention_qk.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("num_heads,nq", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_matches_jax_vjp(num_heads, nq, dtype):
    """``attention_qk_bwd_plain`` against ``jax.vjp`` through
    ``fused_window_attention(..., interpret=True)`` (the Pallas backward
    with its supertile padding): dq and dk in the tokens' dtype, the eight
    projection cotangents in f32. f32: rtol 1e-5 with atol 1e-5 of each
    cotangent's largest magnitude (the weight cotangents sum ~10^2 terms of
    order one in another order). ``dbk`` is analytically zero (softmax rows
    are shift-invariant): rounding noise on both sides, held against the
    size of ``dbv``, a sum over the same tokens."""
    _check_k7_plain_vs_jax_vjp(_qk_inputs(num_heads, nq), num_heads, dtype)


def _check_k7_plain_vs_jax_vjp(a, num_heads, dtype):
    from mssvt_tpu.ops.pallas_attention import fused_window_attention

    jdt, tdt = _dtypes(dtype)

    def fwd(q, k, proj):
        return fused_window_attention(
            q, k, proj, jnp.asarray(a["bias"]), num_heads=num_heads,
            scale=a["scale"], interpret=True, compute_dtype=jdt)

    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(fwd, jnp.asarray(a["query"], jdt),
                         jnp.asarray(a["keys"], jdt),
                         tuple(map(jnp.asarray, a["proj"])))
        wq, wk, wproj = vjp(jnp.asarray(a["g"], jdt))
    dq, dk, dproj = attention_qk_bwd.fused_window_attention_bwd(
        _T(a["query"], tdt), _T(a["keys"], tdt), tuple(map(_T, a["proj"])),
        _T(a["bias"]), _T(a["g"], tdt), num_heads, a["scale"],
        compute_dtype=tdt)
    assert dq.dtype == dk.dtype == tdt
    assert all(p.dtype == torch.float32 for p in dproj)
    pairs = [("dq", dq, wq), ("dk", dk, wk)]
    pairs += [("d" + n, g_, w_) for n, g_, w_ in zip(PROJ_NAMES, dproj, wproj)]
    dbv = np.abs(np.asarray(wproj[5], np.float32)).max()
    for name, g_, w_ in pairs:
        w_ = np.asarray(w_, np.float32)
        top = dbv if name == "dbk" else np.abs(w_).max()
        _hold(g_, w_, dtype, name, scale=top)
    assert attention_qk_bwd.launches == 0


ZERO_G = [1, 3]  # scattered windows of the 5, not a prefix


@pytest.mark.parametrize("num_heads", [(2, 2), (4,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_matches_jax_vjp_with_zero_g_windows(num_heads, dtype):
    """As above with ``g`` zeroed on a scattered subset of the windows (what
    masked queries and rows the loss never reaches give in training): the
    Pallas backward in interpret mode and the plain version agree at the
    same tolerances. The CUDA kernel skips such windows."""
    a = _qk_inputs(num_heads, 8)
    a["g"][ZERO_G] = 0.0
    _check_k7_plain_vs_jax_vjp(a, num_heads, dtype)


@pytest.mark.parametrize("num_heads", [(2, 2), (4,)])
@pytest.mark.parametrize("nq", [8, 32])
def test_k7_plain_zero_g_windows_contribute_exact_zeros(num_heads, nq):
    """What the CUDA kernel's live-window list relies on: a window whose
    ``g`` is all zero gets exactly zero ``dq`` and ``dk``, and the weight
    and bias cotangents equal those of the other windows alone (f32, to
    1e-6 of each cotangent's largest magnitude: the sums run over fewer
    terms in another order)."""
    a = _qk_inputs(num_heads, nq)
    a["g"][ZERO_G] = 0.0
    live = [w for w in range(a["g"].shape[0]) if w not in ZERO_G]
    proj = tuple(map(_T, a["proj"]))

    def bwd(sel):
        return attention_qk_bwd.attention_qk_bwd_plain(
            _T(a["query"][sel]), _T(a["keys"][sel]), proj, _T(a["bias"][sel]),
            _T(a["g"][sel]), num_heads, a["scale"])

    dq, dk, dproj = bwd(slice(None))
    assert not dq[ZERO_G].any() and not dk[ZERO_G].any()
    assert dq[live].any() and dk[live].any()
    dq_l, dk_l, dproj_l = bwd(live)
    assert torch.equal(dq[live], dq_l) and torch.equal(dk[live], dk_l)
    for name, got, want in zip(PROJ_NAMES, dproj, dproj_l):
        top = max(want.abs().max().item(), dproj_l[5].abs().max().item()
                  if name == "bk" else 0.0)
        assert (got - want).abs().max().item() <= 1e-6 * top, name


# ------------------------------------------------- MixedScaleAttention routes
def _module_inputs(path):
    rng = np.random.default_rng(11)
    nw, n1cap, nk1, nk2, d = 7, 24, 8, 8, 64
    nq = 4 if path == "assembled_einsum" else 12
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    qm = rng.random((nw, nq)) < 0.2
    km = rng.random((nw, nk1 + nk2)) < 0.2
    if path == "query_keys":
        return dict(query=f(nw, nq, d), keys=f(nw, nk1 + nk2, d),
                    query_mask=qm, key_masks=km), ("query", "keys")
    asm = dict(win1_fea=f(nw, n1cap, d), k2_fea=f(nw, nk2, d),
               fps1=rng.integers(0, n1cap, (nw, nk1)).astype(np.int32),
               k_mask1=km[:, :nk1],
               q_ext=f(nw, nq, d) if path == "assembled_q_ext" else None,
               q_keep=(~qm).astype(np.float32),
               q_rel=tuple(f(nw, nq) for _ in range(3)),
               k_rel=tuple(f(nw, nk1 + nk2) for _ in range(3)),
               pos_base=f(nw, d), pos_w=f(3, d), nq=nq,
               num_valid=np.asarray(nw, np.int32))
    diff = ("win1_fea", "k2_fea", "pos_base", "pos_w") + (
        ("q_ext",) if path == "assembled_q_ext" else ())
    return dict(query_mask=qm, key_masks=km, assembled=asm), diff


@pytest.mark.parametrize("path", ["assembled", "assembled_q_ext",
                                  "assembled_einsum", "query_keys"])
def test_mixed_scale_attention_flag_off_training_matches_jax(path,
                                                             monkeypatch):
    """The training routes this slice opens, forward and every gradient
    (the per-group parameters by flax path, and the differentiable inputs):
    ``assembled`` without pad inputs (``ref_compat_keys: False``), as the
    win1 prefix and with ``q_ext``, and the plain ``query=/keys=`` call,
    all with nq = 12 >= 8. JAX runs its fallback assembly and the Pallas
    K6/K7 kernels in interpret mode (``MSSVT_PALLAS=interpret``); the port
    assembles in plain tensor ops and runs the plain versions of its K6/K7
    through ``FusedAttention``. ``assembled_einsum`` has nq = 4: both sides
    take the per-group einsum (JAX with ``MSSVT_PALLAS=off``). f32, rtol
    1e-5 with atol 1e-5 of each tensor's largest magnitude (sums in another
    order; the key-bias gradient is analytically zero and is held against
    the value-bias gradient's size)."""
    monkeypatch.setenv("MSSVT_PALLAS",
                       "off" if path == "assembled_einsum" else "interpret")
    kwargs, diff = _module_inputs(path)
    rng = np.random.default_rng(12)
    d, num_heads = 64, (2, 2)
    nq = kwargs["query_mask"].shape[1]
    gout = rng.normal(size=(kwargs["query_mask"].shape[0], nq, d)).astype(
        np.float32)

    def conv(fn, kw):
        def one(v):
            if isinstance(v, np.ndarray):
                return fn(v)
            if isinstance(v, tuple):
                return tuple(map(fn, v))
            if isinstance(v, dict):
                return {a: one(b) for a, b in v.items()}
            return v
        return {k: one(v) for k, v in kw.items()}

    def split(kw):
        """The differentiable inputs out of kwargs, and a way back in."""
        holder = kw["assembled"] if "assembled" in kw else kw
        vals = {n: holder[n] for n in diff}

        def put(new):
            h2 = {**holder, **new}
            return {**kw, "assembled": h2} if "assembled" in kw else h2
        return vals, put

    jm = JAttn(embed_dim=d, num_heads=num_heads)
    jkw = conv(jnp.asarray, kwargs)
    params = jm.init(jax.random.PRNGKey(0), **jkw)
    jvals, jput = split(jkw)

    def jloss(p, vals):
        out = jm.apply(p, **jput(vals), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out * gout), out

    with jax.default_matmul_precision("float32"):
        (_, want), (gp, gv) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                 has_aux=True)(params, jvals)

    tm = TAttn(d, num_heads).train()
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, params))
    tkw = conv(lambda v: torch.as_tensor(np.array(v)), kwargs)
    tvals, tput = split(tkw)
    for v in tvals.values():
        v.requires_grad_(True)
    before = (attention_qk.launches, attention_qk_bwd.launches)
    got = tm(**tput(tvals))
    (got * torch.as_tensor(gout)).sum().backward()
    assert (attention_qk.launches, attention_qk_bwd.launches) == before
    _hold(got, want, "float32", "out")
    for n in diff:
        _hold(tvals[n].grad, gv[n], "float32", n,
              scale=np.abs(np.asarray(gv[n])).max())
    got_g = to_flax_tree(tm, "params", grads=True)
    for mod, leaves in gp["params"].items():
        for leaf, w in leaves.items():
            w = np.asarray(w)
            top = np.abs(w).max()
            if mod.startswith("to_kv") and leaf == "bias":
                top = np.abs(w[w.shape[0] // 2:]).max()  # the value half
            _hold(torch.as_tensor(got_g[mod][leaf]), w, "float32",
                  f"{mod}/{leaf}", scale=top)


def test_query_keys_call_runs_k6_at_inference_and_matches_einsum():
    """At inference the ``query=/keys=`` call with nq >= 8 runs K6 (its
    plain version here) and agrees with JAX's einsum path to 1e-5 in f32."""
    kwargs, _ = _module_inputs("query_keys")
    jm = JAttn(embed_dim=64, num_heads=(2, 2))
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    params = jm.init(jax.random.PRNGKey(0), **jkw)
    want = np.asarray(jm.apply(params, **jkw))
    tm = TAttn(64, (2, 2)).eval()
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, params))
    calls = []
    orig = attention_qk.fused_window_attention
    attention_qk.fused_window_attention = \
        lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with torch.no_grad():
            got = tm(**{k: torch.as_tensor(v) for k, v in kwargs.items()})
    finally:
        attention_qk.fused_window_attention = orig
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- K2b, K2c FPS
@pytest.mark.parametrize("n,npoint", [(96, 32), (300, 40), (2048, 64),
                                     (1001, 40)])
def test_selection_free_fps_matches_both_pallas_layouts(n, npoint):
    """``ops.sampling.farthest_point_sample_planes`` (the entry point that
    launches K2b for N <= 256 and K2c above it on the card; here the plain
    version) and the two wrappers against
    ``farthest_point_sample_planes_pallas_t`` (K2b's TPU kernel) and
    ``farthest_point_sample_planes_pallas`` (K2c's) in interpret mode, on
    integer planes, where distances are exact and ties are common: the
    picks agree exactly. N = 2 048 is chip_smoke's K2c width, 1 001 no
    multiple of 4 or 32 (scalar loads, a part-padded warp on the card)."""
    from mssvt_tpu.ops.pallas_fps import (
        farthest_point_sample_planes_pallas,
        farthest_point_sample_planes_pallas_t,
    )
    from mssvt_tpu_torch.ops.sampling import farthest_point_sample_planes

    rng = np.random.default_rng(6)
    planes = [rng.integers(-6, 7, (11, n)).astype(np.float32)
              for _ in range(3)]
    jp = tuple(map(jnp.asarray, planes))
    want_t = np.asarray(farthest_point_sample_planes_pallas_t(
        *jp, npoint, col_block=128, interpret=True))
    want_r = np.asarray(farthest_point_sample_planes_pallas(
        *jp, npoint, row_block=8, interpret=True))
    np.testing.assert_array_equal(want_t, want_r)
    tp = tuple(map(torch.as_tensor, planes))
    for fn in (farthest_point_sample_planes, fps.fps_picks_block) + (
            (fps.fps_picks_warp,) if n <= fps.MAX_N else ()):
        got = fn(*tp, npoint)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want_t)
    assert fps.launches_warp == fps.launches_block == 0
    assert len(np.unique(want_t[:, :8], axis=1)[0]) > 1


# ------------------------------------------------- tiny model, flag off
@pytest.fixture(scope="module")
def tiny_pair_flag_off():
    yield from make_tiny_pair(ref_compat_keys=False)


def test_tiny_model_flag_off_inference_matches_jax(monkeypatch):
    """Inference of ``mssvt_tiny.yaml`` with ``ref_compat_keys: False``
    (the assembled forward with ``k_mask1`` as the zero mask, empty-slot
    picks masked instead of carrying the frame's first voxel) against JAX
    with the same flag: backbone features, BEV maps and head maps to 1e-4,
    the detections as sets of boxes (``test_torch_detector``'s checks)."""
    monkeypatch.setenv("MSSVT_PALLAS", "xla_fill")
    cfg_j, cfg_t = _tiny_cfgs(ref_compat_keys=False)
    pcr, vs, grid, n_feat = _tiny_geometry(cfg_t)
    scene = _tiny_scene(np.random.default_rng(3), grid, n_feat)
    batch = {k: jnp.asarray(v) for k, v in scene.items() if k != "gt_boxes"}
    build_kw = dict(num_class=3, class_names=list(cfg_t.CLASS_NAMES),
                    grid_size=grid, voxel_size=vs, point_cloud_range=pcr,
                    batch_size=2, max_voxels=1024, max_points_per_voxel=5)
    want, got = _run_pair(cfg_j.MODEL, cfg_t.MODEL, batch, build_kw, n_feat)
    _check(want, got)
    # the flag changes the result: the same weights with ref-compat keys
    cfg_j2, cfg_t2 = _tiny_cfgs()
    want2, _ = _run_pair(cfg_j2.MODEL, cfg_t2.MODEL, batch, build_kw, n_feat)
    assert np.abs(np.asarray(want2["features"])
                  - np.asarray(want["features"])).max() > 1e-3


def test_tiny_model_flag_off_loss_grads_and_stats_match_jax(
        tiny_pair_flag_off):
    """The training step with ``ref_compat_keys: False``: block 0 (nq = 18)
    trains through the outside assembly and the plain K6/K7, the last block
    (nq = 2) through the einsum path; held as
    ``test_tiny_model_loss_grads_and_stats_match_jax`` holds the default."""
    from mssvt_tpu_torch.kernels import attention_qk_bwd as k7

    calls = []
    orig = k7.fused_window_attention_bwd
    k7.fused_window_attention_bwd = \
        lambda *a, **k: calls.append(a[0].shape[1]) or orig(*a, **k)
    try:
        check_loss_grads_and_stats(tiny_pair_flag_off)
    finally:
        k7.fused_window_attention_bwd = orig
    assert calls and all(nq >= 8 for nq in calls)
