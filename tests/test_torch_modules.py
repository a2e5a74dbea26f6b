"""Port modules (mssvt_tpu_torch) against the JAX package, module by module.

Same numpy inputs (seeded) and the same weights (flax init carried across
with ``bridge.load_flax_variables``) go through both; the JAX side gathers
windows with the XLA fill (``MSSVT_PALLAS=xla_fill``). Integer outputs are
compared exactly; f32 features to 1e-5 (the same f32 math in another
summation order; the deepest chains get 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.core import index as j_index
from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.models.backbones_2d.base_bev_backbone import (
    BaseBEVBackbone as JBEV)
from mssvt_tpu.models.backbones_2d.map_to_bev import (
    HeightCompression as JHeight)
from mssvt_tpu.models.backbones_3d import mssvt as j_mssvt
from mssvt_tpu.models.dense_heads.center_head import CenterHead as JHead
from mssvt_tpu.models.model_utils import centernet as j_centernet
from mssvt_tpu.models.model_utils.attention import (
    MixedScaleAttention as JAttn)
from mssvt_tpu.ops import nms as j_nms
from mssvt_tpu.ops import sampling as j_sampling
from mssvt_tpu.ops import window as j_window
from mssvt_tpu_torch.bridge import load_flax_variables
from mssvt_tpu_torch.core import index as t_index
from mssvt_tpu_torch.core.sparse import SparseVoxels as TSV
from mssvt_tpu_torch.models.backbones_2d.base_bev_backbone import (
    BaseBEVBackbone as TBEV)
from mssvt_tpu_torch.models.backbones_2d.map_to_bev import (
    HeightCompression as THeight)
from mssvt_tpu_torch.models.backbones_3d import mssvt as t_mssvt
from mssvt_tpu_torch.models.dense_heads.center_head import CenterHead as THead
from mssvt_tpu_torch.models.model_utils import centernet as t_centernet
from mssvt_tpu_torch.models.model_utils.attention import (
    MixedScaleAttention as TAttn)
from mssvt_tpu_torch.models.network import init_weights
from mssvt_tpu_torch.ops import nms as t_nms
from mssvt_tpu_torch.ops import sampling as t_sampling
from mssvt_tpu_torch.ops import window as t_window
from test_model_forward import tiny_model_cfg

torch.set_num_threads(2)

GRID = (24, 24, 8)
VOXEL = (0.4, 0.4, 0.5)
PCR = (0.0, -4.8, -2.0, 9.6, 4.8, 2.0)
B, V, C = 2, 512, 32


@pytest.fixture(autouse=True)
def _xla_fill(monkeypatch):
    monkeypatch.setenv("MSSVT_PALLAS", "xla_fill")


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _voxels(seed=0, n=420):
    rng = np.random.default_rng(seed)
    coords = np.unique(np.stack([
        rng.integers(0, B, n), rng.integers(0, GRID[2], n),
        rng.integers(0, GRID[1], n), rng.integers(0, GRID[0], n)], 1),
        axis=0).astype(np.int32)
    pad = np.full((V, 4), -1, np.int32)
    pad[:len(coords)] = coords
    valid = np.arange(V) < len(coords)
    feats = rng.normal(size=(V, C)).astype(np.float32) * valid[:, None]
    return feats, pad, valid


def _perturb_stats(variables, seed):
    """Random BatchNorm statistics, so inference BN is not the identity."""
    rng = np.random.default_rng(seed)
    if "batch_stats" not in variables:
        return variables
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def _to_np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


# ------------------------------------------------------------- core/index
def test_index_helpers_match():
    feats, coords, valid = _voxels(1)
    del feats
    keys_j = j_index.linearize_coords(jnp.asarray(coords), GRID,
                                      jnp.asarray(valid))
    keys_t = t_index.linearize_coords(_t(coords), GRID, _t(valid))
    np.testing.assert_array_equal(_np(keys_t), np.asarray(keys_j))
    np.testing.assert_array_equal(
        _np(t_index.delinearize_key(keys_t, GRID)),
        np.asarray(j_index.delinearize_key(keys_j, GRID)))
    n_cells = B * GRID[0] * GRID[1] * GRID[2]
    for cap in (64, 600):
        got = t_index.unique_compact_dense(keys_t, cap, n_cells, True)
        want = j_index.unique_compact_dense(keys_j, cap, n_cells, True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(
        _np(t_index.build_dense_row_table(_t(coords), _t(valid), GRID, B)),
        np.asarray(j_index.build_dense_row_table(
            jnp.asarray(coords), jnp.asarray(valid), GRID, B)))


def test_bev_scatter_is_z_major():
    feats, coords, valid = _voxels(2)
    sp_t = TSV.create(_t(feats), _t(coords), _t(valid), B, GRID, VOXEL, PCR)
    sp_j = JSV.create(jnp.asarray(feats), jnp.asarray(coords),
                      jnp.asarray(valid), B, GRID, VOXEL, PCR,
                      with_index=False)
    np.testing.assert_array_equal(_np(sp_t.bev()), np.asarray(sp_j.bev()))


# ------------------------------------------------------------- ops/window
@pytest.mark.parametrize("scales", ["two", "single"])
def test_window_partition_and_gather_match(scales):
    """Every buffer (ind, packed offsets, mask, even start) and the
    voxel -> (window, slot) inverse map, exactly."""
    _, coords, valid = _voxels(3)
    if scales == "two":
        w1, w2, cap1, cap2, maxw = (3, 3, 4), (9, 9, 4), 24, 48, 96
        buffers = ("odd", "even", "win1", "win2")
    else:
        w1, w2, cap1, cap2, maxw = (2, 2, 4), None, 16, None, 64
        buffers = None
    jt = j_window.build_query_tables(w1, w2)
    tt = t_window.build_query_tables(w1, w2)
    for f in ("offsets", "eligibility", "deltas", "col_src", "inv_src",
              "k_own_lut"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    jr = j_window.window_partition(jnp.asarray(coords), jnp.asarray(valid),
                                   GRID, w1, maxw, batch_size=B,
                                   return_ranks=True)
    tr = t_window.window_partition(_t(coords), _t(valid), GRID, w1, maxw, B,
                                   return_ranks=True)
    assert tr[2] == jr[2]
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(_np(tr[i]), np.asarray(jr[i]))
    nv = int(min(int(jr[3]), maxw))
    kw = dict(max_num_win1=cap1, max_num_win2=cap2, batch_size=B,
              buffers=buffers, return_inverse=True)
    jg = j_window.gather_window_voxels(
        jr[0], jr[1], jnp.asarray(coords), jnp.asarray(valid), GRID, w1, jt,
        num_valid=jnp.asarray(nv), voxel_win_row=jr[4], **kw)
    tg = t_window.gather_window_voxels(
        tr[0], tr[1], _t(coords), _t(valid), GRID, w1, tt,
        num_valid=torch.tensor(nv), voxel_win_row=tr[4], **kw)
    assert set(tg) == set(jg)
    for name in tg:
        for key in tg[name]:
            np.testing.assert_array_equal(_np(tg[name][key]),
                                          np.asarray(jg[name][key]),
                                          err_msg=f"{name}/{key}")


# ------------------------------------------------------------ ops/sampling
def test_sampling_ops_match():
    rng = np.random.default_rng(4)
    nb, n, m = 6, 24, 12
    u = [rng.integers(-3, 4, (nb, n)).astype(np.float32) * 0.4
         for _ in range(3)]
    k = [rng.integers(-3, 4, (nb, m)).astype(np.float32) * 0.4
         for _ in range(3)]  # integer grid: distance ties are common
    np.testing.assert_allclose(
        _np(t_sampling.three_interp_weights_planes(*map(_t, u + k))),
        np.asarray(j_sampling.three_interp_weights_planes(
            *map(jnp.asarray, u + k))), rtol=1e-6, atol=1e-7)
    # integer planes, as the blocks feed FPS (unpacked offsets): the
    # distances are exact, so XLA's fused arithmetic cannot reorder ties
    ui = [np.round(p / 0.4) for p in u]
    np.testing.assert_array_equal(
        _np(t_sampling.farthest_point_sample_planes(*map(_t, ui), 8)),
        np.asarray(j_sampling.farthest_point_sample_planes(
            *map(jnp.asarray, ui), 8)))
    vals = rng.normal(size=(nb, n, 5)).astype(np.float32)
    idx = rng.integers(0, n, (nb, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(t_sampling.gather_along_batch(_t(vals), _t(idx))),
        np.asarray(j_sampling.gather_along_batch(jnp.asarray(vals),
                                                 jnp.asarray(idx))))
    feats = rng.normal(size=(30, 5)).astype(np.float32)
    gidx = rng.integers(-1, 32, (4, 9)).astype(np.int32)  # -1 and >= V
    np.testing.assert_array_equal(
        _np(t_sampling.group_features(_t(feats), _t(gidx))),
        np.asarray(j_sampling.group_features(jnp.asarray(feats),
                                             jnp.asarray(gidx))))
    # paired forms on a real inverse map
    _, coords, valid = _voxels(5)
    x = rng.normal(size=(V, 8)).astype(np.float32)
    tt = t_window.build_query_tables((3, 3, 4), (9, 9, 4))
    tr = t_window.window_partition(_t(coords), _t(valid), GRID, (3, 3, 4),
                                   96, B, return_ranks=True)
    g = t_window.gather_window_voxels(
        tr[0], tr[1], _t(coords), _t(valid), GRID, (3, 3, 4), tt,
        max_num_win1=24, max_num_win2=48, batch_size=B,
        buffers=("odd", "win1", "win2"), return_inverse=True,
        num_valid=torch.clamp(tr[3], max=96), voxel_win_row=tr[4])
    ind, inv = g["win1"]["ind"], g["inv_win1"]
    args = (ind, inv["win_row"], inv["slot"], inv["valid"])
    got = t_sampling.group_features_paired(_t(x), *args)
    want = j_sampling.group_features_paired(jnp.asarray(x),
                                            *(jnp.asarray(_np(a)) for a in args))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    upd = rng.normal(size=tuple(got.shape)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(t_sampling.writeback_inverse_paired(_t(upd), _t(x), *args)),
        np.asarray(j_sampling.writeback_inverse_paired(
            jnp.asarray(upd), jnp.asarray(x),
            *(jnp.asarray(_np(a)) for a in args))))


# ------------------------------------------------------- attention module
@pytest.mark.parametrize("path", ["assembled", "assembled_pad_keys",
                                  "einsum"])
def test_mixed_scale_attention_matches(path, monkeypatch):
    monkeypatch.setenv("MSSVT_PALLAS", "off")  # JAX: fallback assembly + einsum
    rng = np.random.default_rng(11)
    nw, n1cap, nk1, nk2, nq, d = 10, 24, 8, 8, 12, 64
    num_heads = (2, 2) if path != "einsum" else (4,)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    qm = rng.random((nw, nq)) < 0.2
    if path == "einsum":
        km = rng.random((nw, 16)) < 0.2
        kwargs = dict(query=f(nw, 1, d), keys=f(nw, 16, d), key_masks=km)
    else:
        km = rng.random((nw, nk1 + nk2)) < 0.2
        asm = dict(win1_fea=f(nw, n1cap, d), k2_fea=f(nw, nk2, d),
                   fps1=rng.integers(0, n1cap, (nw, nk1)).astype(np.int32),
                   k_mask1=km[:, :nk1], q_ext=None,
                   q_keep=(~qm).astype(np.float32),
                   q_rel=tuple(f(nw, nq) for _ in range(3)),
                   k_rel=tuple(f(nw, nk1 + nk2) for _ in range(3)),
                   pos_base=f(nw, d), pos_w=f(3, d), nq=nq)
        if path == "assembled_pad_keys":
            asm["pad1"] = rng.random((nw, nk1)) < 0.3
            asm["pad_row"] = f(nw, d)
        kwargs = dict(query_mask=qm, key_masks=km, assembled=asm)

    def conv(fn):
        """Apply ``fn`` to every array in kwargs (one level of dicts and
        tuples deep)."""
        def one(v):
            if isinstance(v, np.ndarray):
                return fn(v)
            if isinstance(v, tuple):
                return tuple(map(fn, v))
            if isinstance(v, dict):
                return {a: one(b) for a, b in v.items()}
            return v
        return {k: one(v) for k, v in kwargs.items()}

    jm = JAttn(embed_dim=d, num_heads=num_heads)
    jkw = conv(jnp.asarray)
    params = jm.init(jax.random.PRNGKey(0), **jkw)
    want = np.asarray(jm.apply(params, **jkw))
    tm = TAttn(d, num_heads).eval()
    load_flax_variables(tm, _to_np_tree(params))
    with torch.no_grad():
        got = _np(tm(**conv(_t)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------- MsSVT blocks
def _block_cfgs():
    p = [dict(b) for b in tiny_model_cfg()["BACKBONE_3D"]["PARAMS"]]
    even = dict(p[0], cbs_pattern=0)
    return {"block_odd": p[0], "block_even": even, "compress": p[1]}


def _build_blocks(cfg):
    common = dict(in_channels=cfg["channels"][0],
                  ff_channels=cfg["channels"][1],
                  out_channels=cfg["channels"][2],
                  num_heads=tuple(cfg["num_heads"]),
                  window_size=tuple(tuple(w) for w in cfg["window_size"]),
                  max_windows=cfg["max_num_wins"],
                  max_num_win1=cfg["max_num_win1"])
    if cfg["name"] == "MixedScaleSparseTransformerBlock":
        extra = dict(max_num_win2=cfg["max_num_win2"],
                     cbs_pattern=cfg["cbs_pattern"],
                     key_num_sample=cfg["key_num_sample"])
        return (j_mssvt.MsSVTBlock(**common, **extra),
                t_mssvt.MsSVTBlock(**common, **extra).eval())
    return (j_mssvt.MsSVTCompressBlock(**common),
            t_mssvt.MsSVTCompressBlock(**common).eval())


@pytest.mark.parametrize("which", ["block_odd", "block_even", "compress"])
def test_mssvt_block_matches(which):
    """One block on the same voxels and weights: output features, coords
    and validity (compress blocks make new voxels)."""
    feats, coords, valid = _voxels(6)
    jb, tb = _build_blocks(_block_cfgs()[which])

    def run(variables, f, c, m):
        sp = JSV.create(f, c, m, B, GRID, VOXEL, PCR, with_index=False)
        out = jb.apply(variables, sp, deterministic=True)
        return out.features, out.coords, out.valid

    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid))
    sp0 = JSV.create(*args, B, GRID, VOXEL, PCR, with_index=False)
    variables = jax.jit(lambda k: jb.init(k, sp0, deterministic=True))(
        jax.random.PRNGKey(1))
    want = jax.jit(run)(variables, *args)
    load_flax_variables(tb, _to_np_tree(variables))
    with torch.no_grad():
        out = tb(TSV.create(_t(feats), _t(coords), _t(valid), B, GRID, VOXEL,
                            PCR))
    np.testing.assert_allclose(_np(out.features), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(out.coords), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(out.valid), np.asarray(want[2]))


def test_mssvt_backbone_matches():
    """input_proj + block + compress block, end to end (1e-4: two blocks of
    f32 chains)."""
    params_cfg = [dict(b) for b in tiny_model_cfg()["BACKBONE_3D"]["PARAMS"]]
    rng = np.random.default_rng(8)
    _, coords, valid = _voxels(7)
    pts = (rng.normal(size=(V, 5)).astype(np.float32) * valid[:, None])
    jb = j_mssvt.MixedScaleSparseTransformer(params_cfg=tuple(params_cfg))
    args = (jnp.asarray(pts), jnp.asarray(coords), jnp.asarray(valid))

    def run(variables, f, c, m):
        sp = JSV.create(f, c, m, B, GRID, VOXEL, PCR, with_index=False)
        return jb.apply(variables, sp, deterministic=True).features

    sp0 = JSV.create(*args, B, GRID, VOXEL, PCR, with_index=False)
    variables = jax.jit(lambda k: jb.init(k, sp0, deterministic=True))(
        jax.random.PRNGKey(2))
    want = np.asarray(jax.jit(run)(variables, *args))
    tb = t_mssvt.MixedScaleSparseTransformer(params_cfg, in_features=5).eval()
    load_flax_variables(tb, _to_np_tree(variables))
    with torch.no_grad():
        got = tb(TSV.create(_t(pts), _t(coords), _t(valid), B, GRID, VOXEL,
                            PCR)).features
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------- BEV, 2D backbone, head
def test_height_compression_matches():
    feats, coords, valid = _voxels(9)
    grid = (24, 24, 2)
    coords = np.where(valid[:, None], coords % np.array([B, 2, 24, 24]),
                      -1).astype(np.int32)
    # dedup after folding z into two planes
    _, first = np.unique(coords[valid], axis=0, return_index=True)
    keep = np.zeros(V, bool)
    keep[np.flatnonzero(valid)[first]] = True
    coords = np.where(keep[:, None], coords, -1).astype(np.int32)
    feats = feats * keep[:, None]
    jm = JHeight(num_bev_features=2 * C, compress_layer_nums=2,
                 layer_strides=(1, 1), layer_dilations=(1, 2),
                 layer_paddings=(1, 2))
    sp_j = JSV.create(jnp.asarray(feats), jnp.asarray(coords),
                      jnp.asarray(keep), B, grid, VOXEL, PCR, with_index=False)
    variables = _perturb_stats(jax.jit(lambda k: jm.init(k, sp_j))(
        jax.random.PRNGKey(3)), 0)
    want = np.asarray(jax.jit(lambda v: jm.apply(v, sp_j))(variables))
    tm = THeight(2 * C, 2, (1, 1), (1, 2), (1, 2)).eval()
    load_flax_variables(tm, _to_np_tree(variables))
    with torch.no_grad():
        got = tm(TSV.create(_t(feats), _t(coords), _t(keep), B, grid, VOXEL,
                            PCR))
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-5)


def test_base_bev_backbone_matches():
    """Two levels with a stride-2 transposed conv on an odd map (exercises
    the kernel flip and the one-pixel overshoot crop)."""
    x = np.random.default_rng(10).normal(size=(2, 11, 11, 16)).astype(
        np.float32)
    kw = dict(layer_nums=(1, 1), layer_strides=(1, 2), num_filters=(16, 24),
              upsample_strides=(1, 2), num_upsample_filters=(8, 8))
    jm = JBEV(**kw)
    variables = _perturb_stats(jax.jit(lambda k: jm.init(k, jnp.asarray(x)))(
        jax.random.PRNGKey(4)), 1)
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables))
    tm = TBEV(16, **kw).eval()
    load_flax_variables(tm, _to_np_tree(variables))
    with torch.no_grad():
        got = tm(_t(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def head_pair():
    cfg = tiny_model_cfg()["DENSE_HEAD"]
    x = np.random.default_rng(12).normal(size=(2, 12, 12, 32)).astype(
        np.float32)
    kw = dict(model_cfg=cfg, input_channels=32, num_class=2,
              class_names=("Car", "Ped"), grid_size=GRID,
              point_cloud_range=PCR, voxel_size=VOXEL)
    jm = JHead(**kw)
    variables = _perturb_stats(jax.jit(lambda k: jm.init(k, jnp.asarray(x)))(
        jax.random.PRNGKey(5)), 2)
    want = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    tm = THead(**kw).eval()
    load_flax_variables(tm, _to_np_tree(variables))
    with torch.no_grad():
        got = tm(_t(x))
    return jm, variables, want, tm, got


def test_center_head_maps_match(head_pair):
    _, _, want, _, got = head_pair
    for name in want[0]:
        np.testing.assert_allclose(_np(got[0][name]), np.asarray(want[0][name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_decode_and_nms_match(head_pair):
    jm, variables, want, tm, got = head_pair
    hm_j = jax.nn.sigmoid(want[0]["hm"])
    hm_t = torch.sigmoid(got[0]["hm"])
    dec_kw = dict(point_cloud_range=PCR, voxel_size=VOXEL,
                  feature_map_stride=2, k=32, score_thresh=0.1,
                  post_center_limit_range=[-10, -10, -10, 20, 10, 10])
    want_dec = j_centernet.decode_bbox_from_heatmap(
        hm_j, want[0]["rot"][..., 0:1], want[0]["rot"][..., 1:2],
        want[0]["center"], want[0]["center_z"], jnp.exp(want[0]["dim"]),
        **dec_kw)
    got_dec = t_centernet.decode_bbox_from_heatmap(
        hm_t, got[0]["rot"][..., 0:1], got[0]["rot"][..., 1:2],
        got[0]["center"], got[0]["center_z"], torch.exp(got[0]["dim"]),
        **dec_kw)
    for g, w in zip(got_dec, want_dec):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    # rotated NMS on the decoded boxes, and the head's full post-processing
    boxes, scores, _, mask = want_dec
    sel_j, num_j = jax.vmap(lambda b_, s_, m_: j_nms.nms_bev(
        b_, s_, m_, 0.1, 24, 12))(boxes, scores, mask)
    sel_t, num_t = t_nms.nms_bev(_t(boxes), _t(scores), _t(mask), 0.1, 24, 12)
    np.testing.assert_array_equal(_np(sel_t), np.asarray(sel_j))
    np.testing.assert_array_equal(_np(num_t), np.asarray(num_j))
    sel_j, _ = jax.vmap(lambda b_, s_, m_: j_nms.circle_nms(
        b_, s_, m_, 1.5, 24, 12))(boxes, scores, mask)
    sel_t, _ = t_nms.circle_nms(_t(boxes), _t(scores), _t(mask), 1.5, 24, 12)
    np.testing.assert_array_equal(_np(sel_t), np.asarray(sel_j))
    fin_j = jm.apply(variables, want, method=jm.generate_predicted_boxes)
    with torch.no_grad():
        fin_t = tm.generate_predicted_boxes(got)
    for g, w in zip(fin_t, fin_j):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_port_init_is_seeded():
    """Random weights come from the seed alone."""
    a = init_weights(t_mssvt.MsSVTCompressBlock(32, 64, 32, (2,), ((2, 2, 4),),
                                                8), seed=3)
    b = init_weights(t_mssvt.MsSVTCompressBlock(32, 64, 32, (2,), ((2, 2, 4),),
                                                8), seed=3)
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    assert os.environ.get("MSSVT_PALLAS") == "xla_fill"
