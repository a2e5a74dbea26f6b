"""The port's sparse-conv engine against the JAX package, on the CPU.

Same numpy-seeded inputs through ``mssvt_tpu`` and ``mssvt_tpu_torch``:
the sorted-key index, lookups, ``unique_compact`` and the three neighbour
tables must be equal; the convolutions, ``MaskedBatchNorm`` and the
SECOND backbones (on weights carried across by ``bridge.py``) agree to
rtol 1e-5 (the same f32 sums in another order). The backbones run at the
JAX suite's tiny sizes (grid 32^3, 256 voxels a frame, batch 2, filters
(8, 16, 16, 16)), JAX eagerly.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.core import index as j_index
from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.models.backbones_3d import spconv_backbone as j_bb
from mssvt_tpu.models.model_utils.layers import MaskedBatchNorm as JMBN
from mssvt_tpu.ops import sparse_conv as j_sc
from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
from mssvt_tpu_torch.core import index as t_index
from mssvt_tpu_torch.core.sparse import SparseVoxels as TSV
from mssvt_tpu_torch.models.backbones_3d import spconv_backbone as t_bb
from mssvt_tpu_torch.models.model_utils.layers import MaskedBatchNorm as TMBN
from mssvt_tpu_torch.ops import sparse_conv as t_sc

torch.set_num_threads(2)
SHAPE = (8, 7, 6)  # x, y, z
GRID = (32, 32, 32)
VS = (0.4, 0.4, 0.125)
PCR = (0.0, -6.4, -2.0, 12.8, 6.4, 2.0)
BATCH, MAX_VOXELS = 2, 256
CLOSE = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sparse(seed, n=40, cap=64, shape=SHAPE, batch=2, cin=3):
    """Unique random (b, z, y, x) sites of ``shape``, padded to ``cap`` rows
    (coords -1, features 0), shuffled so that rows are not in key order."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(batch * shape[0] * shape[1] * shape[2], n,
                       replace=False)
    b, rest = np.divmod(cells, shape[0] * shape[1] * shape[2])
    z, rest = np.divmod(rest, shape[0] * shape[1])
    y, x = np.divmod(rest, shape[0])
    coords = np.full((cap, 4), -1, np.int32)
    coords[:n] = np.stack([b, z, y, x], 1)
    valid = np.arange(cap) < n
    perm = rng.permutation(cap)
    coords, valid = coords[perm], valid[perm]
    feats = (rng.normal(size=(cap, cin)) * valid[:, None]).astype(np.float32)
    return coords, valid, feats


def _indexes(coords, valid, shape=SHAPE):
    return (j_index.build_index(jnp.asarray(coords), jnp.asarray(valid), shape),
            t_index.build_index(_t(coords), _t(valid), shape))


@pytest.mark.parametrize("seed,n,cap", [(0, 40, 64), (1, 64, 64), (2, 5, 96)])
def test_index_and_lookup_equal_jax(seed, n, cap):
    coords, valid, _ = _sparse(seed, n, cap)
    ji, ti = _indexes(coords, valid)
    np.testing.assert_array_equal(_np(ti.sorted_keys), np.asarray(ji.sorted_keys))
    np.testing.assert_array_equal(_np(ti.sorted_rows), np.asarray(ji.sorted_rows))
    rng = np.random.default_rng(seed + 10)
    q = np.stack([rng.integers(-1, 3, 200), rng.integers(-1, 7, 200),
                  rng.integers(-1, 8, 200), rng.integers(-1, 9, 200)],
                 1).astype(np.int32)
    q = np.concatenate([q, coords])
    jk = j_index.linearize_coords(jnp.asarray(q), SHAPE)
    tk = t_index.linearize_coords(_t(q), SHAPE)
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    np.testing.assert_array_equal(_np(t_index.lookup(ti, tk)),
                                  np.asarray(j_index.lookup(ji, jk)))


@pytest.mark.parametrize("capacity", [4, 8, 40])
def test_unique_compact_equals_jax(capacity):
    rng = np.random.default_rng(capacity)
    keys = rng.integers(0, 30, 64).astype(np.int32)
    keys[rng.random(64) < 0.3] = j_index.INVALID_KEY
    got = t_index.unique_compact(_t(keys), capacity)
    want = j_index.unique_compact(jnp.asarray(keys), capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_key_capacity_check_raises_past_int32():
    t_index._check_key_capacity(4, (1408, 1600, 40))  # KITTI at batch 4
    with pytest.raises(ValueError, match="overflows int32"):
        t_index._check_key_capacity(16, (1408, 1600, 80))
    with pytest.raises(ValueError, match="overflows int32"):
        TSV.create(torch.zeros(1, 1), torch.zeros(1, 4, dtype=torch.int32),
                   torch.ones(1, dtype=torch.bool), 64, (1408, 1600, 40),
                   (1, 1, 1), (0,) * 6)


def test_sparse_voxels_index_only_when_asked():
    coords, valid, feats = _sparse(3)
    sp = TSV.create(_t(feats), _t(coords), _t(valid), 2, SHAPE, (1, 1, 1),
                    (0,) * 6)
    jsp = JSV.create(jnp.asarray(feats), jnp.asarray(coords),
                     jnp.asarray(valid), 2, SHAPE, (1, 1, 1), (0,) * 6)
    np.testing.assert_array_equal(_np(sp.index.sorted_rows),
                                  np.asarray(jsp.index.sorted_rows))
    assert TSV.create(_t(feats), _t(coords), _t(valid), 2, SHAPE, (1, 1, 1),
                      (0,) * 6, with_index=False).index is None


def _strided_geometry(kind):
    return {"down": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
            "conv4": ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
            "conv_out": ((1, 1, 3), (1, 1, 2), (0, 0, 0))}[kind]


@pytest.mark.parametrize("seed", [0, 1])
def test_subm_neighbor_table_equals_jax(seed):
    coords, valid, _ = _sparse(seed)
    ji, ti = _indexes(coords, valid)
    want = j_sc.build_subm_neighbor_table(jnp.asarray(coords),
                                          jnp.asarray(valid), ji, SHAPE)
    got = t_sc.build_subm_neighbor_table(_t(coords), _t(valid), ti, SHAPE)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (_np(got) >= 0).sum() > 40  # neighbours beyond the sites


@pytest.mark.parametrize("kind", ["down", "conv4", "conv_out"])
@pytest.mark.parametrize("max_out", [12, 64])
def test_strided_sites_and_tables_equal_jax(kind, max_out):
    coords, valid, _ = _sparse(5)
    ks, st, pd = _strided_geometry(kind)
    ji, ti = _indexes(coords, valid)
    jo = j_sc.downsample_output_sites(jnp.asarray(coords), jnp.asarray(valid),
                                      SHAPE, ks, st, pd, max_out)
    to = t_sc.downsample_output_sites(_t(coords), _t(valid), SHAPE, ks, st,
                                      pd, max_out)
    assert tuple(to[2]) == tuple(jo[2])
    for g, w in zip(to[:2], jo[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    want = j_sc.build_strided_neighbor_table(
        jnp.asarray(coords), jnp.asarray(valid), ji, SHAPE, jo[0], jo[1],
        ks, st, pd)
    got = t_sc.build_strided_neighbor_table(_t(coords), _t(valid), ti, SHAPE,
                                            to[0], to[1], ks, st, pd)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # the inverse (transposed) table, into the output sites
    joi = j_index.build_index(jo[0], jo[1], jo[2])
    toi = t_index.build_index(to[0], to[1], to[2])
    want_i = j_sc.build_inverse_neighbor_table(
        jnp.asarray(coords), jnp.asarray(valid), joi, jo[2], ks, st, pd)
    got_i = t_sc.build_inverse_neighbor_table(_t(coords), _t(valid), toi,
                                              to[2], ks, st, pd)
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))
    # which is the transpose of the strided table: (o, k) -> i iff (i, k) -> o
    fwd = {(o, k, int(i)) for (o, k), i in np.ndenumerate(_np(got)) if i >= 0}
    inv = {(int(o), k, i) for (i, k), o in np.ndenumerate(_np(got_i))
           if o >= 0}
    assert fwd == inv and fwd


def test_downsample_raises_on_a_collapsing_shape():
    coords, valid, _ = _sparse(0)
    for mod in (j_sc, t_sc):
        arrays = ((jnp.asarray(coords), jnp.asarray(valid)) if mod is j_sc
                  else (_t(coords), _t(valid)))
        with pytest.raises(ValueError, match="collapses"):
            mod.downsample_output_sites(*arrays, (8, 7, 2), (3, 3, 3),
                                        (2, 2, 2), (0, 0, 0), 16)


@pytest.mark.parametrize("kind", ["subm", "down", "conv_out"])
def test_conv_and_its_gradients_match_jax(kind):
    """``subm_conv_apply`` on the neighbour table (rtol 1e-5), and
    ``sparse_conv``'s gather backward (the transposed table) against
    ``jax.vjp`` of JAX's gather + product: the input and weight
    cotangents to rtol 1e-5."""
    coords, valid, feats = _sparse(7, cin=5)
    ji, ti = _indexes(coords, valid)
    if kind == "subm":
        k, rows_j = 27, j_sc.build_subm_neighbor_table(
            jnp.asarray(coords), jnp.asarray(valid), ji, SHAPE)
        rows_t = _t(rows_j)
        rows_t_fn = lambda: rows_t.flip(1)
        out_valid = valid
    else:
        ks, st, pd = _strided_geometry(kind)
        k = int(np.prod(ks))
        oc, ov, oshape = t_sc.downsample_output_sites(
            _t(coords), _t(valid), SHAPE, ks, st, pd, 48)
        rows_t = t_sc.build_strided_neighbor_table(
            _t(coords), _t(valid), ti, SHAPE, oc, ov, ks, st, pd)
        rows_j = jnp.asarray(_np(rows_t))
        oi = t_index.build_index(oc, ov, oshape)
        rows_t_fn = lambda: t_sc.build_inverse_neighbor_table(
            _t(coords), _t(valid), oi, oshape, ks, st, pd)
        out_valid = _np(ov)
    rng = np.random.default_rng(1)
    w = rng.normal(size=(k, 5, 4)).astype(np.float32)
    g = (rng.normal(size=(rows_t.shape[0], 4)) * out_valid[:, None]).astype(
        np.float32)
    want, vjp = jax.vjp(lambda f, w_: j_sc.subm_conv_apply(f, rows_j, w_),
                        jnp.asarray(feats), jnp.asarray(w))
    dfe_w, dw_w = vjp(jnp.asarray(g))
    np.testing.assert_allclose(_np(t_sc.subm_conv_apply(_t(feats), rows_t,
                                                        _t(w))),
                               np.asarray(want), **CLOSE)
    f_t = _t(feats).requires_grad_(True)
    w_t = _t(w).requires_grad_(True)
    out = t_sc.sparse_conv(f_t, rows_t, w_t, rows_t_fn)
    np.testing.assert_allclose(_np(out), np.asarray(want), **CLOSE)
    out.backward(_t(g))
    np.testing.assert_allclose(_np(f_t.grad), np.asarray(dfe_w), **CLOSE)
    np.testing.assert_allclose(_np(w_t.grad), np.asarray(dw_w), **CLOSE)


@pytest.mark.parametrize("train", [False, True])
def test_masked_batchnorm_matches_jax(train):
    """Train: the valid-row statistics, the updated running statistics and
    the input/scale/bias cotangents; eval: the running statistics. All to
    rtol 1e-5; padding rows come out zero."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(50, 6)) * 3 + 1).astype(np.float32)
    valid = rng.random(50) < 0.6
    g = rng.normal(size=(50, 6)).astype(np.float32)
    jm = JMBN()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(valid))
    variables = {"params": {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
                            "bias": rng.normal(size=6).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(size=6).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, 6).astype(
                                     np.float32)}}

    def f(params, xin):
        return jm.apply({**variables, "params": params}, xin,
                        jnp.asarray(valid), train=train,
                        mutable=["batch_stats"])

    want, upd = f(variables["params"], jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, xin: f(p, xin)[0], variables["params"],
                     jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))
    tm = TMBN(6)
    load_flax_variables(tm, variables)
    tm.train(train)
    xt = _t(x).requires_grad_(True)
    got = tm(xt, _t(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), **CLOSE)
    assert not _np(got)[~valid].any()
    got.backward(_t(g))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(dx), **CLOSE)
    np.testing.assert_allclose(_np(tm.scale.grad), dparams["scale"], **CLOSE)
    np.testing.assert_allclose(_np(tm.bias.grad), dparams["bias"], **CLOSE)
    stats = to_flax_tree(tm, "batch_stats")
    want_stats = upd["batch_stats"] if train else variables["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(want_stats[k]),
                                   **CLOSE)


# ------------------------------------------------------- the backbones
def _scene(seed):
    rng = np.random.default_rng(seed)
    n = 300
    cells = np.unique(np.stack([
        rng.integers(0, BATCH, n), rng.integers(0, 8, n),
        rng.integers(0, GRID[1], n), rng.integers(0, GRID[0], n)], 1), axis=0)
    cap = BATCH * MAX_VOXELS
    coords = np.full((cap, 4), -1, np.int32)
    valid = np.zeros(cap, bool)
    for b in range(BATCH):
        cb = cells[cells[:, 0] == b][:MAX_VOXELS]
        coords[b * MAX_VOXELS:b * MAX_VOXELS + len(cb)] = cb
        valid[b * MAX_VOXELS:b * MAX_VOXELS + len(cb)] = True
    feats = (rng.normal(size=(cap, 4)) * valid[:, None]).astype(np.float32)
    return coords, valid, feats


def _randomise_stats(variables, seed):
    rng = np.random.default_rng(seed)
    return {**variables, "batch_stats": jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])}


BACKBONE_KW = dict(input_capacity=BATCH * MAX_VOXELS, num_filters=(8, 16, 16, 16),
                   out_channels=32)


@pytest.fixture(scope="module", params=["VoxelBackBone8x", "VoxelResBackBone8x"])
def backbone_pair(request):
    """(name, the port's module on the JAX module's weights (random BN
    statistics), the scene, JAX's results): the eval forward with its
    stages, and the train forward's output features, updated statistics
    and ``jax.vjp`` for a seeded cotangent (each jitted: a jit compiles
    faster than the eager ops of ~15 layers)."""
    coords, valid, feats = _scene(11)
    jm = getattr(j_bb, request.param)(return_stages=True, **BACKBONE_KW)
    mk = lambda f: JSV.create(f, jnp.asarray(coords), jnp.asarray(valid),
                              BATCH, GRID, VS, PCR)
    variables = _randomise_stats(jax.jit(lambda k, f: jm.init(k, mk(f)))(
        jax.random.PRNGKey(0), jnp.asarray(feats)), 3)
    evals = jax.jit(lambda v, f: jm.apply(v, mk(f)))(variables,
                                                      jnp.asarray(feats))

    def f(params, fe):
        (out, _), upd = jm.apply({**variables, "params": params}, mk(fe),
                                 train=True, mutable=["batch_stats"])
        return out.features, upd["batch_stats"]

    y, vjp, stats = jax.vjp(jax.jit(f), variables["params"],
                            jnp.asarray(feats), has_aux=True)
    g = np.random.default_rng(5).normal(size=y.shape).astype(np.float32)
    train = dict(features=y, stats=stats, g=g, grads=vjp(jnp.asarray(g)))
    tm = getattr(t_bb, request.param)(in_channels=4, grid_size=GRID,
                                      return_stages=True, **BACKBONE_KW)
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    return request.param, tm, (coords, valid, feats), evals, train


def _tsp(coords, valid, feats, grad=False):
    return TSV.create(_t(feats).requires_grad_(grad), _t(coords), _t(valid),
                      BATCH, GRID, VS, PCR)


def _sparse_outputs(out):
    """A backbone's SparseVoxels outputs in a fixed order."""
    if isinstance(out, TSV):
        return [out]
    if isinstance(out, dict):
        return [v for _, v in sorted(out.items())]
    return [sp for o in out for sp in _sparse_outputs(o)]


@pytest.mark.parametrize("name", ["VoxelBackBone8x", "UNetV2"])
def test_backbone_builds_the_index_it_reads(name):
    """The sparse-conv backbone that reads the sorted-key index builds it on
    its own grid: voxels without an index give the bits of the same voxels
    with one, every output and stage, their sites and indexes."""
    from mssvt_tpu_torch.models.backbones_3d.spconv_unet import UNetV2
    from mssvt_tpu_torch.models.network import init_weights

    coords, valid, feats = _scene(12)
    if name == "UNetV2":
        tm = UNetV2(in_channels=4, grid_size=GRID, **BACKBONE_KW)
    else:
        tm = t_bb.VoxelBackBone8x(in_channels=4, grid_size=GRID,
                                  return_stages=True, **BACKBONE_KW)
    init_weights(tm, 0).eval()
    bare = TSV.create(_t(feats), _t(coords), _t(valid), BATCH, GRID, VS, PCR,
                      with_index=False)
    assert bare.index is None
    with torch.no_grad():
        got = _sparse_outputs(tm(bare))
        want = _sparse_outputs(tm(_tsp(coords, valid, feats)))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        for field in ("features", "coords", "valid"):
            assert torch.equal(getattr(g, field), getattr(w, field)), field
        assert tuple(g.spatial_shape) == tuple(w.spatial_shape)
        if w.index is not None:
            assert torch.equal(g.index.sorted_keys, w.index.sorted_keys)
            assert torch.equal(g.index.sorted_rows, w.index.sorted_rows)
    assert float(got[0].features.abs().sum()) > 0


def _backbone(name):
    """A seeded tiny 8x backbone in eval: ``VoxelBackBone8x`` (on the grid
    as given, or with ``pcdet_sparse_shape`` one cell deeper) or
    ``UNetV2``."""
    from mssvt_tpu_torch.models.backbones_3d.spconv_unet import UNetV2
    from mssvt_tpu_torch.models.network import init_weights

    if name == "UNetV2":
        tm = UNetV2(in_channels=4, grid_size=GRID, **BACKBONE_KW)
    else:
        tm = t_bb.VoxelBackBone8x(
            in_channels=4, grid_size=GRID,
            pcdet_sparse_shape=name == "pcdet_sparse_shape", **BACKBONE_KW)
    return init_weights(tm, 0).eval()


def _bare(coords, valid, feats):
    return TSV.create(_t(feats), _t(coords), _t(valid), BATCH, GRID, VS, PCR,
                      with_index=False)


def _assert_same_index(got, want):
    assert torch.equal(got.sorted_keys, want.sorted_keys)
    assert torch.equal(got.sorted_rows, want.sorted_rows)


@pytest.mark.parametrize("seed", [13, 14])
@pytest.mark.parametrize("name", ["VoxelBackBone8x", "pcdet_sparse_shape",
                                  "UNetV2"])
def test_rulebook_equals_the_tables_built_layer_by_layer(name, seed):
    """One ``rules`` call gives the tables each layer built for itself: the
    input's index on the backbone's grid, each submanifold stage's table on
    its sites, and each strided layer's output sites, table and index, equal
    to the table functions called one layer at a time."""
    tm = _backbone(name)
    coords, valid, feats = _scene(seed)
    rules = tm.rules(_bare(coords, valid, feats))
    c, v, shape = _t(coords), _t(valid), tuple(tm.sparse_shape)
    index = t_index.build_index(c, v, shape)
    assert rules.sites.features is None
    assert torch.equal(rules.sites.coords, c)
    assert torch.equal(rules.sites.valid, v)
    assert tuple(rules.sites.spatial_shape) == shape
    _assert_same_index(rules.sites.index, index)
    assert set(rules.tables) == set(t_bb.ENCODER)
    for layer_name in t_bb.ENCODER:
        layer, table = getattr(tm, layer_name), rules.tables[layer_name]
        if not isinstance(layer, t_bb.SparseConvDownLayer):
            want = t_sc.build_subm_neighbor_table(c, v, index, shape)
            assert torch.equal(table, want), layer_name
            continue
        geo = (layer.kernel_size, layer.stride, layer.padding)
        oc, ov, oshape = t_sc.downsample_output_sites(c, v, shape, *geo,
                                                      layer.max_out)
        want = t_sc.build_strided_neighbor_table(c, v, index, shape, oc, ov,
                                                 *geo)
        sites, rows = table
        assert torch.equal(rows, want), layer_name
        assert torch.equal(sites.coords, oc) and torch.equal(sites.valid, ov)
        assert tuple(sites.spatial_shape) == tuple(oshape)
        assert sites.features is None
        c, v, shape = oc, ov, tuple(oshape)
        index = t_index.build_index(c, v, shape)
        _assert_same_index(sites.index, index)
    assert int(v.sum()) > 0  # conv_out keeps live sites


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["VoxelBackBone8x", "UNetV2"])
def test_a_second_forward_makes_no_tensor_from_host_data(name, train,
                                                         monkeypatch):
    """The tables' small constants (kernel offsets, strides, paddings,
    candidate sites) are made once a value and device and kept there: after
    a first forward (and, in training, its backward) a second one creates
    no tensor from host data. On the card each would be a pageable copy
    and a host sync, which a CUDA graph cannot capture."""
    tm = _backbone(name).train(train)
    sp = _bare(*_scene(15))

    def forward():
        with torch.set_grad_enabled(train):
            out = tm(sp)
            feats = (out[0] if isinstance(out, tuple) else out).features
            if train:
                feats.sum().backward()
        return feats.detach()

    first = forward()

    def refuse(*a, **k):
        raise AssertionError("a tensor made from host data")

    for fn in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, fn, refuse)
    second = forward()
    monkeypatch.undo()
    if not train:
        assert torch.equal(first, second)
    assert float(second.abs().sum()) > 0


# the route's conditions one at a time; plain forward hooks on a layer that
# ends a stage run after a replay, any other hook sees the ops one by one
SPCONV_ROUTES = {"cpu": False, "train": False, "grad": False,
                 "generator": False, "pre_hook_on_stage_end": False,
                 "hook_inside_stage": False, "hook_on_strided_layer": False,
                 "kwargs_hook_on_stage_end": False, "hook_on_stage_end": True,
                 "card_eval_no_grad": True}


@pytest.mark.parametrize("case", sorted(SPCONV_ROUTES))
def test_spconv_backbone_graph_route(case):
    """Only an inference call on the card (eval, no autograd, no generator,
    no hook but plain forward hooks on the five stage-ending layers) takes
    the CUDA graphs; on the CPU every call runs the eager forward, opens no
    ``mssvt.spconv_graph`` span and keeps no graph."""
    from types import SimpleNamespace

    model = _backbone("VoxelBackBone8x")
    sp = _bare(*_scene(16))
    gen = torch.Generator().manual_seed(1) if case == "generator" else None
    if case == "train":
        model.train()
    hooks = {"pre_hook_on_stage_end": lambda: model.conv1
             .register_forward_pre_hook(lambda m, a: None),
             "hook_inside_stage": lambda: model.conv1.subm_0
             .register_forward_hook(lambda m, a, o: None),
             "hook_on_strided_layer": lambda: model.conv2_down
             .register_forward_hook(lambda m, a, o: None),
             "kwargs_hook_on_stage_end": lambda: model.conv_out
             .register_forward_hook(lambda m, a, k, o: None,
                                    with_kwargs=True),
             "hook_on_stage_end": lambda: model.conv3_subm
             .register_forward_hook(lambda m, a, o: None)}
    handle = hooks[case]() if case in hooks else None
    card_like = SimpleNamespace(
        features=SimpleNamespace(is_cuda=case != "cpu"), index=None)
    with torch.set_grad_enabled(case == "grad"):
        graphed = model._graphed(card_like, gen)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = model(sp, gen)
    if handle is not None:
        handle.remove()
    assert graphed == SPCONV_ROUTES[case]
    names = [e.name for e in prof.events() if e.name.startswith("mssvt.")]
    assert names == ["mssvt.spconv_rules"]
    assert model.graph.key is None
    model.eval()
    with torch.no_grad():
        want = model.layers(sp, model.rules(sp))[-1]
    assert torch.equal(out.valid, want.valid)
    if case == "train":
        assert out.features.shape == want.features.shape
    else:
        assert torch.equal(out.features, want.features)


@pytest.mark.parametrize("how", ["deepcopy", "pickle"])
def test_a_copy_of_the_backbone_starts_without_graphs(how):
    """A copy of a backbone that holds CUDA graphs (which cannot be
    pickled, and read and write the original's tensors) starts with none;
    the original keeps its own."""
    import pickle
    import threading

    model = _backbone("VoxelBackBone8x")
    held = threading.Lock()  # stands in for the captured graphs
    model.graph.key, model.graph.captured = ("a key",), held
    copy_ = (copy.deepcopy(model) if how == "deepcopy"
             else pickle.loads(pickle.dumps(model)))
    assert copy_.graph.key is None and copy_.graph.captured is None
    assert (copy_.graph.name, copy_.graph.what) == (model.graph.name,
                                                    model.graph.what)
    assert model.graph.captured is held
    sp = _bare(*_scene(17))
    with torch.no_grad():
        assert torch.equal(copy_(sp).features,
                           model.layers(sp, model.rules(sp))[-1].features)


def _assert_sites_and_features(got, want, name):
    np.testing.assert_array_equal(_np(got.coords), np.asarray(want.coords),
                                  err_msg=name)
    np.testing.assert_array_equal(_np(got.valid), np.asarray(want.valid),
                                  err_msg=name)
    assert tuple(got.spatial_shape) == tuple(want.spatial_shape), name
    np.testing.assert_allclose(_np(got.features), np.asarray(want.features),
                               err_msg=name, **CLOSE)


def test_backbone_eval_matches_jax(backbone_pair):
    """Every stage's sites, validity and features (rtol 1e-5) and the
    output's z depth: 32 -> 16 -> 8 -> 3 -> 1."""
    name, tm, (coords, valid, feats), (want, want_stages), _ = backbone_pair
    with torch.no_grad():
        got, got_stages = tm.eval()(_tsp(coords, valid, feats))
    for k in want_stages:
        _assert_sites_and_features(got_stages[k], want_stages[k], f"{name} {k}")
    _assert_sites_and_features(got, want, f"{name} out")
    assert tm.out_spatial_shape == (4, 4, 1) == tuple(want.spatial_shape)
    assert tm.num_bev_features == 32 == want.bev().shape[-1]
    assert int(np.asarray(want.valid).sum()) > 10


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_backbone_train_matches_jax(backbone_pair):
    """Train mode: the output features, the updated BN statistics (rtol
    1e-5), and ``jax.vjp`` of the output features for a random cotangent:
    the input cotangent and every parameter leaf within 1e-4 of the leaf's
    largest magnitude (f32 sums in another order through 13 layers)."""
    name, tm, (coords, valid, feats), _, want = backbone_pair
    model = copy.deepcopy(tm).train()
    sp = _tsp(coords, valid, feats, grad=True)
    got, _ = model(sp)
    np.testing.assert_allclose(_np(got.features), np.asarray(want["features"]),
                               **CLOSE)
    got.features.backward(_t(want["g"]))
    got_stats = to_flax_tree(model, "batch_stats")
    for path, w in jax.tree_util.tree_leaves_with_path(want["stats"]):
        np.testing.assert_allclose(_leaf(got_stats, path), np.asarray(w),
                                   err_msg=str(path), **CLOSE)
    dparams, dfeats = want["grads"]
    grads = to_flax_tree(model, "params", grads=True)
    leaves = jax.tree_util.tree_leaves_with_path(dparams)
    assert len(leaves) == sum(1 for _ in model.parameters())
    for path, w in leaves + [((), dfeats)]:
        g = _leaf(grads, path) if path else _np(sp.features.grad)
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (name, path)
