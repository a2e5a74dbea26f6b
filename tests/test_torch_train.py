"""The port's training step against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both sides: JAX on the CPU
(windows gathered with ``MSSVT_PALLAS=xla_fill``, the attention backward
kernel in Pallas interpret mode), the port with ``device="cpu"``, i.e. the
kernels' plain versions. Each test states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu_torch.kernels import attention as t_attention
from test_pallas_attention import _rand_proj

torch.set_num_threads(2)


# --------------------------------------------------------------- K5 plain
def _k5_inputs(q_prefix):
    """The shapes and inputs of the JAX suite's assembled-backward test."""
    rng = np.random.default_rng(3)
    num_heads = (2, 2)
    nw, n1cap, nk1, nk2, nq, d = 6, 12, 8, 8, 4, 64
    nk_tot = nk1 + nk2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a = dict(
        win1=f(nw, n1cap, d), k2=f(nw, nk2, d),
        fps1=rng.integers(0, n1cap, (nw, nk1)).astype(np.int32),
        km1=rng.random((nw, nk1)) < 0.25,
        q_ext=np.zeros((nw, 1, d), np.float32) if q_prefix else f(nw, nq, d),
        q_keep=(rng.random((nw, nq)) < 0.9).astype(np.float32),
        k_rel=tuple(f(nw, nk_tot) for _ in range(3)),
        q_rel=tuple(f(nw, nq) for _ in range(3)),
        base=f(nw, d), posw=f(3, d),
        proj=tuple(_rand_proj(rng, num_heads, d)))
    a["bias"] = np.where(rng.random((nw, nk_tot)) < 0.2, -100.0,
                         0.0).astype(np.float32)
    a["pad_row"] = f(nw, d)
    a["g"] = f(nw, nq, d)
    static = dict(num_heads=num_heads, scale=(d // sum(num_heads)) ** -0.5,
                  q_prefix=q_prefix, nq=nq)
    return a, static


@pytest.mark.parametrize("q_prefix", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_jax_backward(q_prefix, dtype):
    """``attention_bwd_plain`` against ``jax.vjp`` through
    ``fused_window_attention_assembled_train(..., interpret=True)`` (the
    Pallas backward itself). f32: rtol/atol 1e-4 (the same f32 math summed
    in another order). bf16: 2^-5 of each cotangent's largest magnitude
    (the same bf16 rounding points; an intermediate may land one bf16 ulp
    apart after a sum in another order)."""
    from mssvt_tpu.ops.pallas_attention import (
        fused_window_attention_assembled_train)

    a, st = _k5_inputs(q_prefix)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    nw = a["win1"].shape[0]

    def fwd(win1, k2, q_ext, base, posw, proj, pad_row):
        return fused_window_attention_assembled_train(
            win1, k2, jnp.asarray(a["fps1"]), jnp.asarray(a["km1"]), q_ext,
            jnp.asarray(a["q_keep"]), tuple(map(jnp.asarray, a["k_rel"])),
            tuple(map(jnp.asarray, a["q_rel"])), base, posw, proj,
            jnp.asarray(a["bias"]), pad_row=pad_row,
            num_valid=jnp.asarray(nw, jnp.int32), interpret=True,
            compute_dtype=jdt, **st)

    primals = (a["win1"], a["k2"], a["q_ext"], a["base"], a["posw"],
               a["proj"], a["pad_row"])
    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(fwd, *jax.tree_util.tree_map(jnp.asarray, primals))
        want = vjp(jnp.asarray(a["g"]))
    T = lambda x: torch.as_tensor(np.asarray(x))
    got = t_attention.attention_bwd_plain(
        T(a["win1"]), T(a["k2"]), T(a["fps1"]), T(a["km1"]),
        None if q_prefix else T(a["q_ext"]), T(a["q_keep"]),
        tuple(map(T, a["k_rel"])), tuple(map(T, a["q_rel"])), T(a["base"]),
        T(a["posw"]), tuple(map(T, a["proj"])), T(a["bias"]), T(a["g"]),
        pad_row=T(a["pad_row"]), num_valid=torch.tensor(nw),
        compute_dtype=tdt, **st)
    dwin1, dk2, dqext, dpad, dbase, dposw, dproj = got
    pairs = [("win1", dwin1, want[0]), ("k2", dk2, want[1]),
             ("pos_base", dbase, want[3]), ("pos_w", dposw, want[4]),
             ("pad_row", dpad, want[6])]
    pairs += [(f"proj[{i}]", gp, wp) for i, (gp, wp) in
              enumerate(zip(dproj, want[5]))]
    if q_prefix:
        assert dqext is None and not np.asarray(want[2]).any()
    else:
        pairs.append(("q_ext", dqext, want[2]))
    for name, g_, w_ in pairs:
        g_, w_ = g_.float().numpy(), np.asarray(w_, np.float32)
        assert g_.shape == w_.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g_, w_, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        else:
            err = np.abs(g_ - w_).max()
            assert err <= 2.0 ** -5 * np.abs(w_).max(), (name, err)


# ------------------------------------------------------- gather gradients
def _dyadic(rng, *shape):
    """Values k/8 with small integer k: every sum of a few of them is exact
    in f32 whatever its order, so gradients that sum several rows can be
    held to exact equality."""
    return (rng.integers(-64, 65, shape) / 8.0).astype(np.float32)


def _paired_tables(rng, v=40, nw=5, cap=6):
    """win1 row table (nw, cap) and its voxel -> (window, slot) inverse:
    a partial permutation (each voxel in at most one slot)."""
    slots = rng.permutation(nw * cap)[:v // 2]
    vox = rng.permutation(v)[:v // 2]
    ind = np.full(nw * cap, -1, np.int32)
    ind[slots] = vox
    win_row = np.full(v, -1, np.int32)
    slot = np.zeros(v, np.int32)
    valid = np.zeros(v, bool)
    win_row[vox], slot[vox], valid[vox] = slots // cap, slots % cap, True
    return ind.reshape(nw, cap), win_row, slot, valid


def test_gather_gradients_match_jax_exactly():
    """The paired gather/write-back (row-gather backward) and the
    many-to-one gathers (k2 keys picked by several windows, the per-window
    pad row, the even-query take) give exactly ``jax.vjp``'s cotangents."""
    from mssvt_tpu.ops import sampling as js
    from mssvt_tpu_torch.ops import sampling as ts

    rng = np.random.default_rng(11)
    v, c = 40, 8
    ind, win_row, slot, valid = _paired_tables(rng, v)
    x = _dyadic(rng, v, c)
    T = lambda a: torch.as_tensor(a)
    J = jnp.asarray

    def both(jfn, tfn, primals, ct):
        _, vjp = jax.vjp(jfn, *map(J, primals))
        want = vjp(J(ct))
        ts_ = [T(p).requires_grad_(True) for p in primals]
        tfn(*ts_).backward(T(ct))
        for w, t in zip(want, ts_):
            np.testing.assert_array_equal(t.grad.numpy(), np.asarray(w))

    both(lambda f: js.group_features_paired(f, J(ind), J(win_row), J(slot),
                                            J(valid)),
         lambda f: ts.group_features_paired(f, T(ind), T(win_row), T(slot),
                                            T(valid)),
         [x], _dyadic(rng, *ind.shape, c))
    upd = _dyadic(rng, *ind.shape, c)
    both(lambda u, s: js.writeback_inverse_paired(u, s, J(ind), J(win_row),
                                                  J(slot), J(valid)),
         lambda u, s: ts.writeback_inverse_paired(u, s, T(ind), T(win_row),
                                                  T(slot), T(valid)),
         [upd, x], _dyadic(rng, v, c))
    # k2 keys: rows picked by up to 9 windows, -1 = empty
    k_ind2 = rng.integers(-1, 6, (9, 4)).astype(np.int32)
    both(lambda f: js.group_features(f, J(k_ind2)),
         lambda f: ts.group_features(f, T(k_ind2)),
         [x], _dyadic(rng, 9, 4, c))
    row0 = np.array([3, 3, 3, 17, 17], np.int32)  # one row per frame
    both(lambda f: jnp.take(f, J(row0), axis=0, mode="clip"),
         lambda f: f[T(row0).long()], [x], _dyadic(rng, 5, c))
    pos_q = rng.integers(0, 6, (5, 3)).astype(np.int32)
    both(lambda f: js.gather_along_batch(f, J(pos_q)),
         lambda f: ts.gather_along_batch(f, T(pos_q)),
         [upd], _dyadic(rng, 5, 3, c))


# --------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("momentum,eps", [(0.9, 1e-5), (0.99, 1e-3)])
def test_batchnorm_train_matches_flax(momentum, eps):
    """Train-mode BatchNorm: output and updated mean/var to 1e-6 (the same
    f32 statistics summed in another order)."""
    import flax.linen as fnn

    from mssvt_tpu_torch.models.model_utils.layers import BatchNorm

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 6, 5, 16)) * 1.5 + 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    mean0 = rng.normal(size=16).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=eps)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tb = BatchNorm(16, eps, momentum=momentum).train()
    with torch.no_grad():
        tb.scale.copy_(torch.as_tensor(scale))
        tb.bias.copy_(torch.as_tensor(bias))
        tb.mean.copy_(torch.as_tensor(mean0))
        tb.var.copy_(torch.as_tensor(var0))
    got = tb(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tb, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


# ------------------------------------------------- CenterHead targets/loss
TINY_YAML = "tools/cfgs/synthetic_models/mssvt_tiny.yaml"


def _tiny_cfgs():
    from pathlib import Path

    from mssvt_tpu.config import cfg_from_yaml_file as j_cfg
    from mssvt_tpu.utils.edict import EasyDict as JDict
    from mssvt_tpu_torch.config import cfg_from_yaml_file as t_cfg
    from mssvt_tpu_torch.utils.edict import EasyDict as TDict

    path = str(Path(__file__).resolve().parent.parent / TINY_YAML)
    return j_cfg(path, JDict()), t_cfg(path, TDict())


def _tiny_geometry(cfg):
    dc = cfg.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vs = tuple(dc.DATA_PROCESSOR[-1].VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    return pcr, vs, grid, len(dc.POINT_FEATURE_ENCODING.used_feature_list)


def _tiny_gt(rng, bsz, max_gt=8):
    """Boxes inside mssvt_tiny.yaml's range (class 0 rows are padding)."""
    gt = np.zeros((bsz, max_gt, 8), np.float32)
    for b in range(bsz):
        n = int(rng.integers(3, max_gt))
        gt[b, :n, 0] = rng.uniform(1.0, 18.0, n)
        gt[b, :n, 1] = rng.uniform(-8.5, 8.5, n)
        gt[b, :n, 2] = rng.uniform(-1.0, 1.0, n)
        gt[b, :n, 3:6] = rng.uniform(0.8, 4.0, (n, 3))
        gt[b, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[b, :n, 7] = rng.integers(1, 4, n)
    return gt


@pytest.mark.parametrize("dense", [True, False])
def test_center_head_targets_and_loss_match_jax(dense, monkeypatch):
    """``assign_targets`` + ``get_loss`` on the same GT and predictions:
    heatmaps and regression targets to 1e-6, indices and masks exactly, the
    loss terms to rtol 1e-5. ``dense=False`` forces the scatter-max drawer
    on both sides."""
    from mssvt_tpu.models.dense_heads import center_head as jch
    from mssvt_tpu_torch.models.dense_heads import center_head as tch

    cfg_j, cfg_t = _tiny_cfgs()
    pcr, vs, grid, _ = _tiny_geometry(cfg_t)
    kw = dict(input_channels=16, num_class=3,
              class_names=tuple(cfg_t.CLASS_NAMES), grid_size=grid,
              point_cloud_range=pcr, voxel_size=vs)
    if not dense:
        monkeypatch.setattr(jch, "draw_gaussians_dense", jch.draw_gaussians)
        monkeypatch.setattr(tch, "draw_gaussians_dense", tch.draw_gaussians)
    rng = np.random.default_rng(8)
    gt = _tiny_gt(rng, 2)
    hw = (24, 24)
    jm = jch.CenterHead(model_cfg=cfg_j.MODEL.DENSE_HEAD, **kw)
    x = jnp.zeros((2, *hw, 16), jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), x)
    preds = [{k: rng.normal(size=(2, *hw, c)).astype(np.float32)
              for k, c in (("hm", 3), ("center", 2), ("center_z", 1),
                           ("dim", 3), ("rot", 2))}]
    want_t = jm.apply(variables, jnp.asarray(gt), hw,
                      method=jch.CenterHead.assign_targets)
    want_l, want_tb = jm.apply(
        variables, jax.tree_util.tree_map(jnp.asarray, preds), want_t,
        method=jch.CenterHead.get_loss)
    tm = tch.CenterHead(model_cfg=cfg_t.MODEL.DENSE_HEAD, **kw)
    got_t = tm.assign_targets(torch.as_tensor(gt), hw)
    got_l, got_tb = tm.get_loss(
        [{k: torch.as_tensor(v) for k, v in p.items()} for p in preds], got_t)
    for w, g in zip(want_t, got_t):
        for k in ("heatmaps", "target_boxes"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        for k in ("inds", "masks"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert np.asarray(want_t[0]["heatmaps"]).max() == 1.0
    assert set(got_tb) == set(want_tb)
    for k in want_tb:
        np.testing.assert_allclose(float(got_tb[k]), float(want_tb[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)


# ---------------------------------------------------------------- optimizer
def test_adam_onecycle_matches_optax():
    """5 steps of ``adam_onecycle`` with ``GRAD_NORM_CLIP: 10`` on a random
    parameter tree, gradients large enough that some steps clip: parameters
    to 1e-6 relative (the same f32 arithmetic)."""
    import optax

    from mssvt_tpu.runtime.optimization import build_optimizer as j_build
    from mssvt_tpu_torch.runtime.optimization import build_optimizer as t_build

    cfg_j, cfg_t = _tiny_cfgs()
    rng = np.random.default_rng(21)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (8.0 if i % 2 else 1.0)).astype(
        np.float32) for k, s in shapes.items()} for i in range(5)]
    tx, _ = j_build(cfg_j.OPTIMIZATION, total_steps=20, steps_per_epoch=5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy()))
          for k, v in params.items()}
    opt, _ = t_build(cfg_t.OPTIMIZATION, tp, total_steps=20, steps_per_epoch=5)
    clipped = 0
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        clipped += float(opt.step()) >= 10.0
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert 0 < clipped < 5


# ------------------------------------------------------------- tiny model
def _tiny_scene(rng, grid, n_feat, bsz=2, max_vox=1024, n=1100):
    """chip_smoke's small-reference scene recipe, plus in-range GT boxes."""
    coords = np.unique(np.stack([
        rng.integers(0, bsz, n), rng.integers(0, grid[2], n),
        rng.integers(0, grid[1], n), rng.integers(0, grid[0], n)], 1),
        axis=0).astype(np.int32)[:max_vox]
    pad = np.full((max_vox, 4), -1, np.int32)
    pad[:len(coords)] = coords
    valid = np.arange(max_vox) < len(coords)
    return {"voxels": (rng.normal(size=(max_vox, 5, n_feat))
                       * valid[:, None, None]).astype(np.float32),
            "voxel_num_points": (rng.integers(1, 6, max_vox)
                                 * valid).astype(np.float32),
            "voxel_coords": pad, "voxel_valid": valid,
            "gt_boxes": _tiny_gt(rng, bsz)}


TRAIN_STEPS = dict(total_steps=40, steps_per_epoch=10)
# The two-step check runs at a tenth of the config's LR: at the full LR the
# first Adam step is so large (loss 19 -> 14) that f32 noise in gradient
# components near zero (Adam scales every component to ~lr) grows into a
# 1e-3 loss difference by the third step on both sides alike; at 0.1x the
# loss still falls by a third over the steps and the two runs track.
LR_SCALE = 0.1
STAGES = ("backbone_3d", "map_to_bev", "backbone_2d", "dense_head")


def _j_stages(jm, variables, jb):
    """JAX's train-mode forward as four stages chained with ``jax.vjp``:
    each stage's input, output, parameter cotangents and input cotangent,
    and the updated BatchNorm statistics."""
    from mssvt_tpu.core.sparse import SparseVoxels as JSV
    from mssvt_tpu.models.detectors.generic_post import apply_vfe, run_dense_head

    stats = variables["batch_stats"]
    rngs = {"dropout": jax.random.PRNGKey(1)}

    def b3d(m, b):
        sp = JSV.create(features=apply_vfe(m.vfe, b), coords=b["voxel_coords"],
                        valid=b["voxel_valid"], batch_size=m.batch_size,
                        spatial_shape=m.grid_size, voxel_size=m.voxel_size,
                        point_cloud_range=m.point_cloud_range,
                        with_index=False)
        return m.backbone_3d(sp, deterministic=False)

    sp = jm.apply(variables, jb, method=b3d, rngs=rngs)
    fns = {
        "backbone_3d": lambda m, _: b3d(m, jb).features,
        "map_to_bev": lambda m, f: m.map_to_bev(sp.with_features(f),
                                                train=True),
        "backbone_2d": lambda m, x: m.backbone_2d(x, train=True),
        "dense_head": lambda m, x: run_dense_head(
            m.dense_head, x, jb, None, train=True)["loss"],
    }
    out, x = {}, jnp.zeros(())
    vjps = {}
    new_stats = {}
    for name in STAGES:
        def f(p, xin, _fn=fns[name]):
            y, upd = jm.apply({"params": p, "batch_stats": stats}, xin,
                              method=_fn, rngs=rngs, mutable=["batch_stats"])
            return y, upd.get("batch_stats", {})

        y, vjps[name], upd = jax.vjp(jax.jit(f), variables["params"], x,
                                     has_aux=True)
        if name in upd:
            new_stats[name] = upd[name]
        out[name] = (x, y)
        x = y
    ct = jnp.ones(())
    grads = {}
    for name in reversed(STAGES):
        gp, gx = vjps[name](ct)
        grads[name] = (gp[name], ct)
        ct = gx
    return sp, out, grads, new_stats


@pytest.fixture(scope="module")
def tiny_pair():
    """``mssvt_tiny.yaml`` in f32 on both sides, the port's weights carried
    from the flax init by ``bridge.py`` (BatchNorm statistics randomised so
    the running update is visible). JAX: value_and_grad of the train-mode
    loss, its four stages chained by ``jax.vjp``, and three optax steps.
    Everything is deterministic: ``dpr`` gives DropPath 0.0 in the config's
    two MsSVT blocks."""
    import copy

    import optax

    from mssvt_tpu.models import build_network as j_build
    from mssvt_tpu.runtime.optimization import build_optimizer as j_opt
    from mssvt_tpu_torch.bridge import load_flax_variables
    from mssvt_tpu_torch.models import build_network as t_build

    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_PALLAS", "xla_fill")
    cfg_j, cfg_t = _tiny_cfgs()
    pcr, vs, grid, n_feat = _tiny_geometry(cfg_t)
    rng = np.random.default_rng(7)
    batch = _tiny_scene(rng, grid, n_feat)
    bkw = dict(num_class=3, class_names=list(cfg_t.CLASS_NAMES),
               grid_size=grid, voxel_size=vs, point_cloud_range=pcr,
               batch_size=2, max_voxels=1024, max_points_per_voxel=5)
    jm = j_build(model_cfg=cfg_j.MODEL, **bkw)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = jax.jit(lambda k, b: jm.init({"params": k, "dropout": k}, b,
                                             train=False))(
        jax.random.PRNGKey(0), jb)
    variables = {**variables, "batch_stats": jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])}

    def loss_fn(params, stats, b):
        out, upd = jm.apply({"params": params, "batch_stats": stats}, b,
                            train=True, rngs={"dropout": jax.random.PRNGKey(1)},
                            mutable=["batch_stats"])
        return out["loss"], upd["batch_stats"]

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params, stats = variables["params"], variables["batch_stats"]
    (loss, new_stats), grads = vg(params, stats, jb)
    opt_cfg = copy.deepcopy(cfg_j.OPTIMIZATION)
    opt_cfg.LR = opt_cfg.LR * LR_SCALE
    tx, _ = j_opt(opt_cfg, **TRAIN_STEPS)
    opt_state = tx.init(params)
    losses = []
    for _ in range(3):
        (l_, stats_), g_ = vg(params, stats, jb)
        losses.append(float(l_))
        upd, opt_state = tx.update(g_, opt_state, params)
        params, stats = optax.apply_updates(params, upd), stats_
    stages = _j_stages(jm, variables, jb)
    tm = t_build(cfg_t.MODEL, device="cpu", num_point_features=n_feat, **bkw)
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    want = dict(loss=float(loss), grads=grads, stats=new_stats,
                losses=losses, stages=stages)
    yield want, tm, {k: torch.as_tensor(v) for k, v in batch.items()}
    mp.undo()


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)}


def _t(x, grad=False):
    return torch.as_tensor(np.array(x)).requires_grad_(grad)


def _near(got, want, name):
    """Activations and their cotangents: within 1e-4 of the tensor's largest
    magnitude (an f32 conv stack normalised by batch statistics, summed in
    another order; a few elements sit near a ReLU's zero, so no relative
    bound per element holds)."""
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (name, err, np.abs(want).max())


def test_tiny_model_loss_grads_and_stats_match_jax(tiny_pair):
    """One train-mode forward/backward of the tiny model against JAX's
    value_and_grad.

    End to end: the loss to rtol 1e-5 and the updated BatchNorm statistics
    to 1e-5. Gradients: every leaf, by flax path, to rtol 2e-4 / atol 2e-5
    (the JAX suite's own gradient tolerance), with each stage (3D backbone,
    BEV compression, head + loss) fed JAX's stage input and output
    cotangent (each stage's output and input cotangent are held to 1e-4 of
    their largest magnitude). End to end, the gradients
    agree to 1e-3 of their global norm only: ~1e-5 of f32 noise at the head
    input flips ReLUs whose inputs sit that close to zero, and JAX's own
    head gradient moves by 1.5% of its largest element under 1e-5 relative
    input noise, so no leaf-wise bound below that holds through the whole
    model."""
    import copy

    from mssvt_tpu_torch.bridge import to_flax_tree
    from mssvt_tpu_torch.core.sparse import SparseVoxels
    from mssvt_tpu_torch.models.detectors.generic_post import (
        apply_vfe,
        run_dense_head,
    )
    from mssvt_tpu_torch.runtime.train_utils import forward_backward

    want, tm, batch = tiny_pair
    init = copy.deepcopy(tm.state_dict())
    tm.zero_grad()
    loss, tb = forward_backward(tm, batch, torch.Generator())
    assert {"hm_loss_head_0", "loc_loss_head_0", "rpn_loss"} == set(tb)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    got_s = _leaves(to_flax_tree(tm, "batch_stats"))
    for k, w in _leaves(want["stats"]).items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    got_g = _leaves(to_flax_tree(tm, "params", grads=True))
    want_g = _leaves(want["grads"])
    assert set(got_g) == set(want_g)
    diff = np.sqrt(sum(((got_g[k] - w) ** 2).sum() for k, w in want_g.items()))
    norm = np.sqrt(sum((w ** 2).sum() for w in want_g.values()))
    assert diff <= 1e-3 * norm, (diff, norm)

    # stage by stage, from JAX's stage inputs and output cotangents
    sp_j, outs, grads, stats = want["stages"]
    tm.load_state_dict(init)
    tm.zero_grad()
    sp = SparseVoxels.create(
        apply_vfe(tm.vfe, batch), batch["voxel_coords"], batch["voxel_valid"],
        tm.batch_size, tm.grid_size, tm.voxel_size, tm.point_cloud_range)
    sp = tm.backbone_3d(sp, torch.Generator())
    fns = {
        "backbone_3d": lambda _: sp.features,
        "map_to_bev": lambda f: tm.map_to_bev(sp.with_features(f)),
        "backbone_2d": tm.backbone_2d,
        "dense_head": lambda x: run_dense_head(tm.dense_head, x, batch,
                                               train=True)["loss"],
    }
    close = dict(rtol=2e-4, atol=2e-5)
    for i, name in enumerate(STAGES):
        if name == "backbone_2d":
            # eight conv+BN+ReLU layers over a sparse BEV map: dozens of
            # ReLU inputs per layer lie within 1e-4 of zero, so f32 noise
            # flips some of them even from identical inputs; its gradients
            # are held leaf by leaf on a dense input instead
            # (test_dense_modules_train_grads_match_flax)
            tm.backbone_2d(_t(outs[name][0]))
            continue
        x_j, y_j = outs[name]
        x = _t(x_j, grad=i > 0)
        y = fns[name](x)
        _near(y.detach().numpy(), y_j, f"{name} output")
        y.backward(_t(grads[name][1]))
        if i > 0 and STAGES[i - 1] != "backbone_2d":
            _near(x.grad.numpy(), grads[STAGES[i - 1]][1],
                  f"{name} input cotangent")
        got = _leaves({name: to_flax_tree(getattr(tm, name), "params",
                                          grads=True)})
        for k, w in _leaves({name: grads[name][0]}).items():
            np.testing.assert_allclose(got[k], w, err_msg=k, **close)
        if name in stats:
            got = _leaves({name: to_flax_tree(getattr(tm, name),
                                              "batch_stats")})
            for k, w in _leaves({name: stats[name]}).items():
                np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5,
                                           err_msg=k)
    assert sum(np.abs(w).sum() > 0 for w in want_g.values()) > 0.9 * len(want_g)
    tm.load_state_dict(init)
    tm.zero_grad()


def test_tiny_model_train_steps_match_jax_optax(tiny_pair):
    """Three ``train_step``s (adam_onecycle with clip 10, at ``LR_SCALE``
    of the config's LR): the loss after one and after two updates against
    JAX + optax, to rtol 1e-4 (f32 updates carried through a second
    forward)."""
    import copy

    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import train_step

    want, tm, batch = tiny_pair
    _, cfg_t = _tiny_cfgs()
    model = copy.deepcopy(tm)
    opt_cfg = copy.deepcopy(cfg_t.OPTIMIZATION)
    opt_cfg.LR = opt_cfg.LR * LR_SCALE
    opt, _ = build_optimizer(opt_cfg, model.named_parameters(), **TRAIN_STEPS)
    losses = [float(train_step(model, opt, batch, torch.Generator())[0])
              for _ in range(3)]
    np.testing.assert_allclose(losses[0], want["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses[1:], want["losses"][1:], rtol=1e-4)
    assert losses[2] < 0.8 * losses[0]


@pytest.mark.parametrize("module", ["backbone_2d", "dense_head"])
def test_dense_modules_train_grads_match_flax(module):
    """Train-mode forward/backward of the 2D backbone and the head (with
    its targets and loss) on a dense random input, the tiny config's
    modules with flax-initialised weights: the output to 1e-4 of its
    largest magnitude, every parameter gradient to rtol 2e-4 plus 1e-5 of
    its leaf's largest magnitude (with a unit cotangent on every output
    pixel, a BatchNorm gradient element is a sum of N*H*W terms that
    largely cancel: its f32 error scales with the terms, not the sum), the
    updated BatchNorm statistics to 1e-5, the input cotangent to 1e-3 of
    its norm.

    The weights are flax's init from PRNGKey(0). Some weights put a ReLU
    input within f32 noise (~1e-6) of zero; the two sides then disagree on
    that ReLU, and as a BatchNorm-bias gradient is a sum over N*H*W terms
    that largely cancel, one such term moves it by a few percent (PRNGKey(2)
    does this in block0: 5.7% on one leaf, while PRNGKey(0) agrees to
    5e-6). The check holds the arithmetic, given the same ReLU decisions."""
    from mssvt_tpu.models.backbones_2d.base_bev_backbone import (
        BaseBEVBackbone as JB)
    from mssvt_tpu.models.dense_heads.center_head import CenterHead as JH
    from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
    from mssvt_tpu_torch.models.backbones_2d.base_bev_backbone import (
        BaseBEVBackbone as TB)
    from mssvt_tpu_torch.models.dense_heads.center_head import CenterHead as TH

    cfg_j, cfg_t = _tiny_cfgs()
    rng = np.random.default_rng(4)
    gt = _tiny_gt(rng, 2)
    if module == "backbone_2d":
        c = cfg_t.MODEL.BACKBONE_2D
        kw = dict(layer_strides=tuple(c.LAYER_STRIDES),
                  num_filters=tuple(c.NUM_FILTERS),
                  upsample_strides=tuple(c.UPSAMPLE_STRIDES),
                  num_upsample_filters=tuple(c.NUM_UPSAMPLE_FILTERS))
        jm = JB(layer_nums=tuple(c.LAYER_NUMS), **kw)
        tm = TB(in_channels=128, layer_nums=tuple(c.LAYER_NUMS), **kw)
        x = rng.normal(size=(2, 24, 24, 128)).astype(np.float32)
        ct = rng.normal(size=(2, 24, 24, 128)).astype(np.float32)
        j_fn = lambda m, x: m(x, train=True)
        t_fn = tm
    else:
        pcr, vs, grid, _ = _tiny_geometry(cfg_t)
        kw = dict(input_channels=128, num_class=3,
                  class_names=tuple(cfg_t.CLASS_NAMES), grid_size=grid,
                  point_cloud_range=pcr, voxel_size=vs)
        jm = JH(model_cfg=cfg_j.MODEL.DENSE_HEAD, **kw)
        tm = TH(model_cfg=cfg_t.MODEL.DENSE_HEAD, **kw)
        x = rng.normal(size=(2, 24, 24, 128)).astype(np.float32)
        ct = np.ones((), np.float32)

        def j_fn(m, x):
            return m.get_loss(m(x, train=True),
                              m.assign_targets(jnp.asarray(gt), (24, 24)))[0]

        def t_fn(x):
            return tm.get_loss(tm(x), tm.assign_targets(_t(gt), (24, 24)))[0]
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), method=j_fn)

    def f(p, x):
        y, upd = jm.apply({"params": p, "batch_stats":
                           variables["batch_stats"]}, x, method=j_fn,
                          mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y_j, vjp, stats = jax.vjp(f, variables["params"], jnp.asarray(x),
                              has_aux=True)
    gp, gx = vjp(jnp.asarray(ct))
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    tm.train()
    xt = _t(x, grad=True)
    y = t_fn(xt)
    _near(y.detach().numpy(), y_j, "output")
    y.backward(_t(ct))
    gx = np.asarray(gx)
    assert np.linalg.norm(xt.grad.numpy() - gx) <= 1e-3 * np.linalg.norm(gx)
    got = _leaves(to_flax_tree(tm, "params", grads=True))
    for k, w in _leaves(gp).items():
        np.testing.assert_allclose(got[k], w, rtol=2e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    got = _leaves(to_flax_tree(tm, "batch_stats"))
    for k, w in _leaves(stats).items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


def test_train_model_checkpoints_rotate_and_resume(tiny_pair, tmp_path):
    """``train_model`` over a list of batches saves one checkpoint per
    epoch, keeps the newest ``max_keep``, and a resume restores the
    parameters, BatchNorm statistics, optimizer state, epoch and iteration
    exactly."""
    import copy

    from mssvt_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        load_training_state,
    )
    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import train_model

    _, tm, batch = tiny_pair
    _, cfg_t = _tiny_cfgs()
    model = copy.deepcopy(tm)
    opt, lr_fn = build_optimizer(cfg_t.OPTIMIZATION, model.named_parameters(),
                                 **TRAIN_STEPS)
    mgr = CheckpointManager(tmp_path, max_keep=2)
    it = train_model(model, opt, [batch], total_epochs=3, ckpt_manager=mgr,
                     generator=torch.Generator(), lr_fn=lr_fn, log_interval=1)
    assert it == 3 and mgr.all_steps() == [2, 3]
    fresh = copy.deepcopy(tm)
    opt2, _ = build_optimizer(cfg_t.OPTIMIZATION, fresh.named_parameters(),
                              **TRAIN_STEPS)
    assert load_training_state(fresh, opt2, mgr.restore()) == (3, 3)
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert opt2.count == opt.count == 3
    for n in opt.mu:
        assert torch.equal(opt.mu[n], opt2.mu[n])
        assert torch.equal(opt.nu[n], opt2.nu[n])
