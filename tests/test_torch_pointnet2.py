"""The PointNet++ ops of the point-based detectors: the port against the JAX
package on the CPU (f32, numpy-seeded inputs).

- FPS (``farthest_point_sample``, the K2b/K2c path's plain version on the
  CPU): the JAX suite's oracle and padding cases, and picks equal to JAX's
  on float coordinates with padding rows at the origin; the masked FPS,
  ``sample_points_with_roi`` and ``sector_fps`` equal to JAX's exactly;
- ``ball_query`` exactly (indices and empty flags; on CPU tensors it is
  ``kernels.ball_query.ball_query_plain``, held to a numpy oracle on the
  edge cases of ``ball_query_cases``), ``query_and_group``
  and ``roipoint_pool3d`` to 1e-5 of the largest magnitude (values and the
  cotangents of the features and the query centres), ``vector_pool``
  against the JAX suite's brute force and against JAX (values and the
  features' cotangent: its per-cell means sum in another order, 1e-5);
- ``three_nn``: JAX's expansion |u|^2 + |k|^2 - 2 u.k rounds its dot and
  its sums in XLA's orders (which change with the fusion around them), so
  a pick may differ only where the two candidates' distances lie within
  1e-3 relative (a near-tie); on coordinates where every product and sum
  is exact in f32 the picks and distances are equal. Where an unknown
  point is a known one the port's d2 is exactly 0 (as pcdet's kernel,
  which subtracts) and JAX's is rounding noise below 1e-6 |u|^2: the
  divergence is pinned here. ``three_interpolate``'s gather form sums the
  three rows in pick order, JAX's dense matrix product in index order:
  1e-5 (values, the cotangents of the features and the weights).

It also holds ``check_module``, the module-level harness the PV-RCNN and
PointRCNN files import.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.ops import pointnet2 as jp
from mssvt_tpu.ops import sampling as js
from ball_query_cases import EDGE_CASES, edge_case, oracle
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.kernels import ball_query as kb
from mssvt_tpu_torch.kernels import work
from mssvt_tpu_torch.ops import pointnet2 as tp
from mssvt_tpu_torch.ops import sampling as ts
from test_sampling import _fps_oracle
from test_torch_roi import _t, leaves, near

torch.set_num_threads(2)

# KITTI's range
LO = np.array([0.0, -40.0, -3.0], np.float32)
HI = np.array([70.4, 40.0, 1.0], np.float32)


def kitti_points(rng, b, n, pad=0):
    """(b, n, 3) f32 points uniform over KITTI's range, the last ``pad``
    rows of each frame at the origin (the collate's padding)."""
    p = rng.uniform(LO, HI, (b, n, 3)).astype(np.float32)
    if pad:
        p[:, n - pad:] = 0.0
    return p


def check_module(jm, tm, inputs, j_call, t_call, grad_inputs=(), tol=1e-5,
                 grad_tol=1e-5, seed=0, zero_grad_leaves=()):
    """A flax module ``jm`` and the port's ``tm`` on the same variables
    (flax-initialised, random BatchNorm statistics) and numpy ``inputs``:
    eval outputs; in training the outputs, the updated statistics, every
    parameter's gradient (each leaf within ``grad_tol`` of its largest
    magnitude) and the cotangents of ``grad_inputs``, all against a random
    cotangent of each output. ``j_call(m, train, **x)`` / ``t_call(m,
    **x)`` return a tuple of float outputs. A leaf whose name ends with one
    of ``zero_grad_leaves`` has an analytically zero gradient (both sides
    hold rounding noise): it is held within ``grad_tol`` of the largest
    gradient magnitude of all leaves instead."""
    rng = np.random.default_rng(seed)
    jx = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = jax.device_get(jax.jit(lambda k: jm.init(
        k, method=lambda m: j_call(m, False, **jx)))(jax.random.PRNGKey(0)))
    variables = jax.tree_util.tree_map(np.array, variables)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                          else rng.normal(size=x.shape) * 0.1).astype(
                np.float32), variables["batch_stats"])
    load_flax_variables(tm, variables)
    want_eval = jax.jit(lambda v: jm.apply(
        v, method=lambda m: j_call(m, False, **jx)))(variables)
    with torch.no_grad():
        got_eval = t_call(tm.eval(), **{k: _t(v) for k, v in inputs.items()})
    for i, (g, w) in enumerate(zip(got_eval, want_eval)):
        near(g, w, f"eval output {i}", tol)
    cots = [rng.normal(size=np.shape(w)).astype(np.float32) for w in want_eval]

    def jf(params, gin):
        x = {**jx, **gin}
        outs, upd = jm.apply({**variables, "params": params},
                             method=lambda m: j_call(m, True, **x),
                             mutable=["batch_stats"])
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        return loss, (outs, upd.get("batch_stats", {}))

    (_, (want, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(
        variables["params"], {k: jx[k] for k in grad_inputs})
    tx = {k: _t(v) for k, v in inputs.items()}
    for k in grad_inputs:
        tx[k].requires_grad_()
    tm.train().zero_grad()
    got = t_call(tm, **tx)
    sum((o * _t(c)).sum() for o, c in zip(got, cots)).backward()
    for i, (g, w) in enumerate(zip(got, want)):
        near(g, w, f"train output {i}", tol)
    got_s = leaves(to_flax_tree(tm, "batch_stats"))
    assert set(got_s) == set(leaves(stats))
    for k, w in leaves(stats).items():
        near(got_s[k], w, k, tol)
    got_g = leaves(to_flax_tree(tm, "params", grads=True))
    want_g = leaves(gp)
    assert set(got_g) == set(want_g)
    top = max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        if k.endswith(tuple(zero_grad_leaves)):
            assert np.abs(got_g[k] - w).max() <= grad_tol * top, k
        else:
            near(got_g[k], w, k, grad_tol)
    for k in grad_inputs:
        near(tx[k].grad, gx[k], f"d {k}", grad_tol)
    return got, want


# --------------------------------------------------------------------- FPS
def test_fps_matches_oracle():
    xyz = np.random.default_rng(0).normal(size=(4, 30, 3)).astype(np.float32)
    got = ts.farthest_point_sample(_t(xyz), 8).numpy()
    np.testing.assert_array_equal(got, _fps_oracle(xyz.astype(np.float64), 8))
    assert got.dtype == np.int32


def test_fps_zero_padding_behaviour():
    xyz = np.zeros((1, 10, 3), np.float32)
    xyz[0, :3] = [[0, 0, 0], [1, 0, 0], [0, 2, 0]]
    got = ts.farthest_point_sample(_t(xyz), 6).numpy()
    assert got[0, 0] == 0 and set(got[0, :3]) == {0, 1, 2}
    assert (got[0, 3:] == 0).all()


@pytest.mark.parametrize("b,n,npoint,pad", [(2, 512, 64, 37), (2, 4096, 512, 37),
                                            (3, 200, 64, 0)])
def test_farthest_point_sample_matches_jax(b, n, npoint, pad):
    """Picks equal to JAX's ``farthest_point_sample`` (the XLA loop) on
    float KITTI-range coordinates, padding rows at the origin included."""
    xyz = kitti_points(np.random.default_rng(n), b, n, pad)
    want = np.asarray(jax.jit(js.farthest_point_sample, static_argnums=1)(
        jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(ts.farthest_point_sample(_t(xyz), npoint)
                                  .numpy(), want)


def test_fps_masked_matches_jax():
    rng = np.random.default_rng(3)
    xyz = kitti_points(rng, 3, 300)
    valid = rng.random((3, 300)) < 0.7
    valid[1, :40] = False  # the first pick is the first valid row
    valid[2] = False
    valid[2, 100:110] = True  # fewer valid rows than picks
    want = np.asarray(jax.jit(js.farthest_point_sample_masked,
                              static_argnums=2)(jnp.asarray(xyz),
                                                jnp.asarray(valid), 32))
    got = ts.farthest_point_sample_masked(_t(xyz), _t(valid), 32).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1, 0] == np.argmax(valid[1]) and valid[0][got[0]].all()


def test_sector_fps_and_roi_sampling():
    """The JAX suite's SPC checks on the port, then both ops against
    JAX's (exact)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-10, 10, (1, 256, 3)).astype(np.float32)
    valid = np.ones((1, 256), bool)
    valid[0, 200:] = False
    pts[0, 200:] = 0
    idx = ts.sector_fps(_t(pts), _t(valid), 64, 4).numpy()
    assert idx.shape == (1, 64) and valid[0][idx[0]].all()
    assert len(np.unique(idx[0])) >= 60
    np.testing.assert_array_equal(idx, np.asarray(js.sector_fps(
        jnp.asarray(pts), jnp.asarray(valid), 64, 4)))
    sel = pts[0, idx[0]]
    az = np.arctan2(sel[:, 1], sel[:, 0])
    assert len(np.unique(np.clip(((az + np.pi) / (2 * np.pi) * 4).astype(int),
                                 0, 3))) == 4

    rois = np.zeros((1, 2, 7), np.float32)
    rois[0, 0, :3], rois[0, 0, 3:6], rois[0, 1, 3:6] = [5, 5, 0], [2, 2, 2], 1
    roi_valid = np.array([[True, False]])
    keep = ts.sample_points_with_roi(_t(pts), _t(valid), _t(rois),
                                     _t(roi_valid), 1.0).numpy()
    d = np.linalg.norm(pts[0] - np.array([5, 5, 0]), axis=-1)
    np.testing.assert_array_equal(
        keep[0], valid[0] & (d < 1.0 + np.linalg.norm([2, 2, 2]) / 2))
    keep2 = ts.sample_points_with_roi(_t(pts), _t(valid), _t(rois),
                                      _t(np.zeros((1, 2), bool)), 1.0).numpy()
    np.testing.assert_array_equal(keep2[0], valid[0])

    # KITTI-range frames, proposals over them, 6 sectors (PV-RCNN++'s)
    pts = kitti_points(rng, 2, 2000, pad=150)
    valid = np.arange(2000)[None] < np.array([[1850], [1700]])
    rois = np.concatenate([rng.uniform(LO, HI, (2, 12, 3)),
                           rng.uniform(1, 4, (2, 12, 3)),
                           rng.uniform(-3, 3, (2, 12, 1))], -1).astype(np.float32)
    roi_valid = np.arange(12)[None] < np.array([[9], [12]])
    args = [jnp.asarray(a) for a in (pts, valid, rois, roi_valid)]
    want_keep = np.asarray(js.sample_points_with_roi(*args, 6.0))
    got_keep = ts.sample_points_with_roi(*map(_t, (pts, valid, rois,
                                                   roi_valid)), 6.0)
    np.testing.assert_array_equal(got_keep.numpy(), want_keep)
    assert 100 < want_keep.sum() < valid.sum()
    want = np.asarray(jax.jit(js.sector_fps, static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(want_keep), 128, 6))
    np.testing.assert_array_equal(
        ts.sector_fps(_t(pts), got_keep, 128, 6).numpy(), want)


# -------------------------------------------------------------- ball query
def test_ball_query_semantics():
    xyz = np.zeros((1, 6, 3), np.float32)
    xyz[0] = [[0, 0, 0], [0.1, 0, 0], [0.2, 0, 0], [5, 5, 5], [0.05, 0, 0],
              [9, 9, 9]]
    idx, empty = tp.ball_query(0.3, 3, _t(xyz), _t(np.zeros((1, 1, 3),
                                                            np.float32)))
    np.testing.assert_array_equal(idx.numpy()[0, 0], [0, 1, 2])
    assert not bool(empty[0, 0]) and idx.dtype == torch.int32
    idx, empty = tp.ball_query(0.3, 8, _t(xyz), _t(np.zeros((1, 1, 3),
                                                            np.float32)))
    np.testing.assert_array_equal(idx.numpy()[0, 0], [0, 1, 2, 4, 0, 0, 0, 0])
    idx2, empty2 = tp.ball_query(0.3, 3, _t(xyz),
                                 _t(np.full((1, 1, 3), 100.0, np.float32)))
    assert bool(empty2[0, 0]) and (idx2.numpy() == 0).all()


@pytest.mark.parametrize("radius,nsample,masked", [(0.8, 16, True),
                                                   (2.4, 32, False),
                                                   (6.0, 8, True)])
def test_ball_query_matches_jax(radius, nsample, masked):
    rng = np.random.default_rng(int(radius * 10))
    xyz = kitti_points(rng, 2, 3000, pad=200)
    xyz[:, :1000] = xyz[:, :1000] * 0.05 + np.array([20, 0, -1], np.float32)
    q = xyz[:, rng.integers(0, 2800, 150)] + rng.normal(size=(2, 150, 3)) \
        .astype(np.float32) * radius * 0.3
    valid = (np.arange(3000) < 2800)[None].repeat(2, 0)
    valid[1, 1500:1700] = False
    v = valid if masked else None
    want = jp.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(q),
                         None if v is None else jnp.asarray(v))
    got = tp.ball_query(radius, nsample, _t(xyz), _t(q),
                        None if v is None else _t(v))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    idx = got[0].numpy()
    full = (idx[..., 1:] != idx[..., :1]).all(-1)  # every slot a new point
    assert full.any() and (~got[1].numpy()).sum() > 100


def _case_tensors(case):
    radius, ns, xyz, q, valid = edge_case(case)
    return radius, ns, _t(xyz), _t(q), None if valid is None else _t(valid)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_ball_query_plain_edge_cases(case):
    """The plain version against the numpy oracle, and what each case
    pins: no hit anywhere (every slot 0, every query empty), every point a
    hit (the first ``nsample`` indices), fewer points than slots (slot 0
    repeated past the hits), a point at exactly d2 == r2 (no hit) beside
    one an ulp inside (a hit)."""
    radius, ns, xyz, q, valid = _case_tensors(case)
    idx, empty = kb.ball_query_plain(radius, ns, xyz, q, valid)
    want = oracle(*edge_case(case))
    assert idx.dtype == torch.int32 and empty.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), want[0])
    np.testing.assert_array_equal(empty.numpy(), want[1])
    if case in ("all_empty", "all_invalid"):
        assert bool(empty.all()) and not bool(idx.any())
    elif case == "all_in_ball":
        assert not bool(empty.any())
        assert bool((idx == torch.arange(ns, dtype=torch.int32)).all())
    elif case == "nsample_over_n":
        hits = 16  # 20 points, 4 of them moved out of every ball
        assert bool((idx[..., hits:] == idx[..., :1]).all())
        assert bool((idx[..., 1:hits] > idx[..., :hits - 1]).all())
    elif case == "boundary":
        np.testing.assert_array_equal(idx.numpy()[:, 0],
                                      [[1, 4, 5, 1, 1, 1, 1, 1]] * 2)
    elif case == "ragged_n":
        assert 0 < int(empty.sum()) < empty.numel()
        assert bool((idx >= 1024).any()) and bool((idx >= 2048).any())


def test_ball_query_on_cpu_is_the_plain_version(monkeypatch):
    """``ops.pointnet2.ball_query`` on CPU tensors calls the plain version
    once and returns its result; no kernel is launched."""
    seen = []
    plain = kb.ball_query_plain
    monkeypatch.setattr(kb, "ball_query_plain",
                        lambda *a: seen.append(a) or plain(*a))
    args = _case_tensors("ragged_n")
    before = kb.launches
    got = tp.ball_query(*args)
    want = plain(*args)
    assert len(seen) == 1 and kb.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad,error", [
    ("bf16", TypeError), ("f64", TypeError), ("shape", ValueError),
    ("frames", ValueError), ("valid_dtype", ValueError),
    ("valid_shape", ValueError), ("nsample", ValueError)])
def test_ball_query_kernel_inputs_refused(bad, error):
    """What the kernel does not take raises before a launch: f32 points and
    queries only, (B, *, 3), the same frames, (B, N) bool valid flags,
    ``nsample`` >= 1."""
    xyz, q = torch.zeros((2, 50, 3)), torch.zeros((2, 7, 3))
    valid, ns = torch.ones((2, 50), dtype=torch.bool), 16
    if bad == "bf16":
        q = q.bfloat16()
    elif bad == "f64":
        xyz = xyz.double()
    elif bad == "shape":
        xyz = torch.zeros((2, 50, 4))
    elif bad == "frames":
        q = torch.zeros((3, 7, 3))
    elif bad == "valid_dtype":
        valid = valid.to(torch.uint8)
    elif bad == "valid_shape":
        valid = valid[:, :49]
    else:
        ns = 0
    with pytest.raises(error):
        kb.kernel_inputs(ns, xyz, q, valid)
    assert kb.kernel_inputs(16, torch.zeros((2, 50, 3)), torch.zeros(
        (2, 7, 3)), torch.ones((2, 50), dtype=torch.bool)) == (2, 50, 7)


def test_ball_query_work():
    """``work.ball_query``: the full walk's 8 f32 operations a pair, the
    points, queries and valid flags read once, the slots and empty flags
    written once; bound by the operations at PointRCNN's first level."""
    xyz, q = torch.zeros((2, 16384, 3)), torch.zeros((2, 4096, 3))
    valid = torch.ones((2, 16384), dtype=torch.bool)
    w = work.ball_query(0.1, 16, xyz, q, valid)
    assert w.flops == 0 and w.ops == 2 * 4096 * 16384 * 8
    assert w.nbytes == (2 * 16384 + 2 * 4096) * 12 + 2 * 16384 \
        + 2 * 4096 * 16 * 4 + 2 * 4096
    assert w.bound()[1] == "operations"
    assert work.ball_query(0.1, 16, xyz, q).nbytes == w.nbytes - 2 * 16384


def test_query_and_group_matches_jax():
    """Values and the cotangents of the features and of the query centres
    (JAX subtracts them: the RoIs' gradient path of the PV-RCNN head)."""
    rng = np.random.default_rng(4)
    xyz = kitti_points(rng, 2, 400, pad=30) * 0.1
    feats = rng.normal(size=(2, 400, 5)).astype(np.float32)
    q = xyz[:, rng.integers(0, 370, 60)] + rng.normal(size=(2, 60, 3)) \
        .astype(np.float32) * 0.5
    q[:, -5:] = 1000.0  # empty
    valid = np.arange(400)[None].repeat(2, 0) < 370
    g = rng.normal(size=(2, 60, 8, 8)).astype(np.float32)

    def jf(f, c):
        out, empty = jp.query_and_group(1.5, 8, jnp.asarray(xyz), c, f,
                                        jnp.asarray(valid))
        return (out * g).sum(), (out, empty)

    (_, (want, wempty)), (gf, gq) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(feats), jnp.asarray(q))
    tf, tq = _t(feats).requires_grad_(), _t(q).requires_grad_()
    got, empty = tp.query_and_group(1.5, 8, _t(xyz), tq, tf, _t(valid))
    (got * _t(g)).sum().backward()
    np.testing.assert_array_equal(empty.numpy(), np.asarray(wempty))
    near(got, want, "grouped")
    near(tf.grad, gf, "d features")
    near(tq.grad, gq, "d queries")
    assert empty[:, -5:].all() and not empty[:, :-5].all()


# --------------------------------------------------------- roipoint_pool3d
def test_roipoint_pool3d():
    """The JAX suite's case on the port (one frame), then JAX's vmapped
    per-frame op against the port's batched one: values, empty flags and
    the features' cotangent (wrapped slots repeat picks)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    feats = rng.normal(size=(50, 4)).astype(np.float32)
    boxes = np.array([[0, 0, 0, 2, 2, 2, 0.3], [50, 50, 50, 1, 1, 1, 0]],
                     np.float32)
    pooled, empty = tp.roipoint_pool3d(_t(pts)[None], _t(feats)[None],
                                       _t(boxes)[None], 16)
    pooled, empty = pooled[0].numpy(), empty[0].numpy()
    assert not empty[0] and empty[1] and (pooled[1] == 0).all()
    inside = tp.points_in_boxes(_t(pooled[0, :, :3]), _t(boxes[:1]))[:, 0]
    n_in = int(tp.points_in_boxes(_t(pts), _t(boxes[:1]))[:, 0].sum())
    assert inside[:min(16, n_in)].all()

    pts = rng.uniform(-4, 4, (2, 600, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 600, 6)).astype(np.float32)
    valid = np.arange(600)[None].repeat(2, 0) < np.array([[550], [480]])
    boxes = np.concatenate([rng.uniform(-3, 3, (2, 10, 3)),
                            rng.uniform(0.3, 3, (2, 10, 3)),
                            rng.uniform(-3, 3, (2, 10, 1))], -1).astype(np.float32)
    boxes[:, -1, :3] = 40.0  # empty
    boxes[:, 0, 3:6] = 5.0  # more points than slots
    g = rng.normal(size=(2, 10, 32, 9)).astype(np.float32)

    def jf(f):
        out, e = jax.vmap(lambda p, f_, b, v: jp.roipoint_pool3d(
            p, f_, b, 32, v))(jnp.asarray(pts), f, jnp.asarray(boxes),
                              jnp.asarray(valid))
        return (out * g).sum(), (out, e)

    (_, (want, wempty)), gf = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(feats))
    tf = _t(feats).requires_grad_()
    got, gempty = tp.roipoint_pool3d(_t(pts), tf, _t(boxes), 32, _t(valid))
    (got * _t(g)).sum().backward()
    np.testing.assert_array_equal(gempty.numpy(), np.asarray(wempty))
    near(got, want, "pooled")
    near(tf.grad, gf, "d features")
    counts = tp.points_in_boxes(_t(pts), _t(boxes)).sum(1).numpy()
    assert ((counts > 0) & (counts < 32)).any() and (counts > 32).any()


# -------------------------------------------------------------- vector pool
def test_vector_pool_oracle():
    """The JAX suite's brute force, on the port."""
    rg = np.random.default_rng(5)
    sx = rg.uniform(-3, 3, (1, 40, 3)).astype(np.float32)
    sf = rg.normal(size=(1, 40, 4)).astype(np.float32)
    sv = np.ones((1, 40), bool)
    sv[0, 35:] = False
    q = rg.uniform(-2, 2, (1, 5, 3)).astype(np.float32)
    radius, ns, g = 1.5, 32, 2
    pooled, empty = tp.vector_pool(_t(q), _t(sx), _t(sf), _t(sv), radius, ns,
                                   g)
    pooled = pooled.numpy().reshape(1, 5, g ** 3, 7)
    for mi in range(5):
        rel_all = sx[0] - q[0, mi]
        inb = (np.sum(rel_all ** 2, -1) < radius ** 2) & sv[0]
        if not inb.any():
            assert empty[0, mi]
            continue
        cells = {}
        for pi in np.where(inb)[0][:ns]:
            rel = rel_all[pi]
            u = np.clip(((rel / radius + 1) * 0.5 * g).astype(int), 0, g - 1)
            cells.setdefault((u[0] * g + u[1]) * g + u[2], []).append(
                (rel, sf[0, pi]))
        for c in range(g ** 3):
            if c in cells:
                np.testing.assert_allclose(
                    pooled[0, mi, c, :3], np.mean([r for r, _ in cells[c]], 0),
                    rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(
                    pooled[0, mi, c, 3:], np.mean([f for _, f in cells[c]], 0),
                    rtol=1e-4, atol=1e-5)
            else:
                np.testing.assert_allclose(pooled[0, mi, c], 0, atol=1e-6)


def test_vector_pool_matches_jax():
    rng = np.random.default_rng(6)
    sx = kitti_points(rng, 2, 500, pad=40) * 0.1
    sf = rng.normal(size=(2, 500, 6)).astype(np.float32)
    sv = np.arange(500)[None].repeat(2, 0) < 460
    q = sx[:, rng.integers(0, 460, 40)] + rng.normal(size=(2, 40, 3)) \
        .astype(np.float32) * 0.3
    q[:, -3:] = 500.0
    g = rng.normal(size=(2, 40, 8 * 9)).astype(np.float32)

    def jf(f):
        out, e = jp.vector_pool(jnp.asarray(q), jnp.asarray(sx), f,
                                jnp.asarray(sv), 1.2, 16, 2)
        return (out * g).sum(), (out, e)

    (_, (want, wempty)), gf = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(sf))
    tf = _t(sf).requires_grad_()
    got, gempty = tp.vector_pool(_t(q), _t(sx), tf, _t(sv), 1.2, 16, 2)
    (got * _t(g)).sum().backward()
    np.testing.assert_array_equal(gempty.numpy(), np.asarray(wempty))
    near(got, want, "pooled")
    near(tf.grad, gf, "d features")
    assert gempty[:, -3:].all()


# ------------------------------------------------- 3-NN and interpolation
def test_three_nn_and_interpolate():
    """The JAX suite's oracle case on the port."""
    rng = np.random.default_rng(0)
    known = rng.normal(size=(2, 7, 3)).astype(np.float32)
    unknown = rng.normal(size=(2, 5, 3)).astype(np.float32)
    d2, idx = ts.three_nn(_t(unknown), _t(known))
    d2, idx = d2.numpy(), idx.numpy()
    full = ((unknown[:, :, None] - known[:, None]) ** 2).sum(-1)
    order = np.argsort(full, axis=-1, kind="stable")[..., :3]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_allclose(d2, np.take_along_axis(full, order, -1),
                               rtol=1e-5)
    feats = rng.normal(size=(2, 7, 4)).astype(np.float32)
    w = 1.0 / np.clip(d2, 1e-10, None)
    w = w / w.sum(-1, keepdims=True)
    out = ts.three_interpolate(_t(feats), _t(idx), _t(w)).numpy()
    expect = (feats[np.arange(2)[:, None, None], idx] * w[..., None]).sum(2)
    np.testing.assert_allclose(out, expect, rtol=1e-5)


def test_three_nn_matches_jax_up_to_near_ties():
    """(2, 4 096) unknown and (2, 1 024) known KITTI-range points (PointRCNN's
    FP level 1 shapes): a pick differs from JAX's only where JAX's own
    distances of the two candidates lie within 1e-3 relative; the
    distances of equal picks agree to 1e-3 relative (the expansion cancels
    at |u|^2 ~ 5e3). Every known point as an unknown one: its d2 is 0
    here, JAX's below 1e-6 |u|^2. Then an exact case: integer coordinates,
    where every product and sum is exact in f32, give JAX's picks and
    distances."""
    rng = np.random.default_rng(7)
    unknown, known = kitti_points(rng, 2, 4096), kitti_points(rng, 2, 1024)
    wd, wi = (np.asarray(a) for a in jax.jit(js.three_nn)(
        jnp.asarray(unknown), jnp.asarray(known)))
    gd, gi = (a.numpy() for a in ts.three_nn(_t(unknown), _t(known)))
    diff = gi != wi
    assert diff.mean() < 1e-3
    # JAX's own distance of the port's pick (exact in float64, then JAX's
    # formula in f32 where the picks coincide)
    exact = ((unknown[:, :, None].astype(np.float64)
              - np.take_along_axis(known[:, None].astype(np.float64),
                                   gi[..., None].astype(np.int64), 2)) ** 2
             ).sum(-1)
    exact_w = ((unknown[:, :, None].astype(np.float64)
                - np.take_along_axis(known[:, None].astype(np.float64),
                                     wi[..., None].astype(np.int64), 2)) ** 2
               ).sum(-1)
    assert np.all(np.abs(exact - exact_w)[diff]
                  <= 1e-3 * np.maximum(exact_w[diff], 1.0))
    np.testing.assert_allclose(gd[~diff], wd[~diff], rtol=1e-3, atol=1e-2)

    # an unknown point that is a known one: exactly 0 here, noise in JAX
    unknown[:, :1024] = known
    wd = np.asarray(jax.jit(js.three_nn)(jnp.asarray(unknown),
                                         jnp.asarray(known))[0])
    gd, gi = ts.three_nn(_t(unknown), _t(known))
    assert (gd.numpy()[:, :1024, 0] == 0).all()
    np.testing.assert_array_equal(gi.numpy()[:, :1024, 0],
                                  np.arange(1024)[None].repeat(2, 0))
    u2 = (unknown[:, :1024].astype(np.float64) ** 2).sum(-1)
    assert (wd[:, :1024, 0] <= 1e-6 * u2).all()

    ints = rng.integers(-60, 60, (2, 300, 3)).astype(np.float32)
    kint = rng.integers(-60, 60, (2, 90, 3)).astype(np.float32)
    valid = np.arange(90)[None].repeat(2, 0) < 80
    wd, wi = jax.jit(js.three_nn)(jnp.asarray(ints), jnp.asarray(kint),
                                  jnp.asarray(valid))
    gd, gi = ts.three_nn(_t(ints), _t(kint), _t(valid))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert (gi.numpy() < 80).all()
    # fewer than 3 candidates: index 0 at 1e38, as JAX pads
    wd, wi = js.three_nn(jnp.asarray(ints), jnp.asarray(kint[:, :2]))
    gd, gi = ts.three_nn(_t(ints), _t(kint[:, :2]))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_three_interpolate_matches_jax():
    """Values and the cotangents of the features and the weights, with
    picks that coincide (their weights add in JAX's dense matrix)."""
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(2, 50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 300, 3)).astype(np.int32)
    idx[:, :20, 1] = idx[:, :20, 0]
    w = rng.uniform(0.1, 1, (2, 300, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    g = rng.normal(size=(2, 300, 7)).astype(np.float32)

    def jf(f, w_):
        out = js.three_interpolate(f, jnp.asarray(idx), w_)
        return (out * g).sum(), out

    (_, want), (gf, gw) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(feats), jnp.asarray(w))
    tf, tw = _t(feats).requires_grad_(), _t(w).requires_grad_()
    got = ts.three_interpolate(tf, _t(idx), tw)
    (got * _t(g)).sum().backward()
    near(got, want, "interpolated")
    near(tf.grad, gf, "d features")
    near(tw.grad, gw, "d weights")


def test_gather_batch_rows_backward_is_a_segment_sum():
    """Many picks of one row (an empty query's slot 0) sum exactly as
    ``index_add_`` in float64; the gather equals advanced indexing."""
    rng = np.random.default_rng(9)
    vals = rng.normal(size=(2, 40, 3))
    idx = rng.integers(0, 40, (2, 500, 4))
    idx[:, :300] = 0
    tv = torch.tensor(vals, requires_grad=True)
    g = torch.tensor(rng.normal(size=(2, 500, 4, 3)))
    out = ts.gather_batch_rows(tv, torch.tensor(idx))
    torch.testing.assert_close(out, tv[torch.arange(2)[:, None, None],
                                       torch.tensor(idx)], rtol=0, atol=0)
    (out * g).sum().backward()
    want = torch.zeros(80, 3, dtype=torch.float64).index_add_(
        0, (torch.tensor(idx) + torch.tensor([0, 40])[:, None, None])
        .reshape(-1), g.reshape(-1, 3))
    torch.testing.assert_close(tv.grad.reshape(80, 3), want, rtol=1e-12,
                               atol=1e-12)
