"""SECOND at pcdet's depth (``BACKBONE_3D.PCDET_SPARSE_SHAPE``) in the port,
on the CPU: the sparse backbone against the JAX module run on a grid one
cell deeper in z (the same network: the JAX backbone takes its grid from
its input), the widths ``second.yaml`` states at KITTI's grid, the stage
spans of a SECOND request, the importer's BEV permutation at depth 2, and
the benchmark's two readers of ``mssvt.spconv_rules``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import spec, trace
from benchmark.traffic import kitti_scene
from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.models.backbones_3d import spconv_backbone as j_bb
from mssvt_tpu_torch.bridge import load_flax_variables
from mssvt_tpu_torch.config import cfg_from_yaml_file
from mssvt_tpu_torch.core.sparse import SparseVoxels as TSV
from mssvt_tpu_torch.models import build_network
from mssvt_tpu_torch.models.backbones_3d import spconv_backbone as t_bb
from mssvt_tpu_torch.runtime import torch_import, tracing
from mssvt_tpu_torch.runtime.eval_utils import eval_step
from mssvt_tpu_torch.utils.edict import EasyDict

torch.set_num_threads(2)
GRID = (16, 16, 40)  # x, y, z: z 41 -> 21 -> 11 -> 5 -> 2 on pcdet's grid
DEEPER = (16, 16, 41)
VS = (0.4, 0.4, 0.1)
PCR = (0.0, -3.2, -3.0, 6.4, 3.2, 1.0)
BATCH, MAX_VOXELS = 2, 256
KW = dict(input_capacity=BATCH * MAX_VOXELS, num_filters=(8, 16, 16, 16),
          out_channels=32)
CLOSE = dict(rtol=1e-5, atol=1e-5)
REHEARSAL = spec.load_json(spec.BENCH / "rehearsal" / "second-kitti.json")
STAGES = ("vfe", "backbone_3d", "map_to_bev", "backbone_2d", "head", "post")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scene(seed):
    """A ground patch and a few columns a frame: surface sites, as a sweep
    has them, so the strided stages' capacities do not bind."""
    rng = np.random.default_rng(seed)
    cap = BATCH * MAX_VOXELS
    coords = np.full((cap, 4), -1, np.int32)
    valid = np.zeros(cap, bool)
    for b in range(BATCH):
        ground = np.stack([np.full(120, 12), rng.integers(0, 16, 120),
                           rng.integers(0, 16, 120)], 1)
        cols = np.concatenate([np.stack([np.arange(13, 13 + h),
                                         np.full(h, y), np.full(h, x)], 1)
                               for h, y, x in rng.integers(2, 16, (6, 3))])
        cells = np.unique(np.concatenate([ground, cols]), axis=0)
        cells = cells[rng.permutation(len(cells))][:MAX_VOXELS]
        at = b * MAX_VOXELS
        coords[at:at + len(cells)] = np.concatenate(
            [np.full((len(cells), 1), b), cells], 1)
        valid[at:at + len(cells)] = True
    feats = (rng.normal(size=(cap, 4)) * valid[:, None]).astype(np.float32)
    return coords, valid, feats


@pytest.mark.parametrize("name", ["VoxelBackBone8x", "VoxelResBackBone8x"])
def test_pcdet_depth_matches_jax_on_the_deeper_grid(name):
    """Every stage's sites, validity and grid equal, features to rtol
    1e-5; the input is indexed on its own grid and re-indexed one cell
    deeper by the port's backbone."""
    coords, valid, feats = _scene(3)
    jm = getattr(j_bb, name)(return_stages=True, **KW)

    def mk(f):  # the JAX backbone's input, one cell deeper in z
        return JSV.create(f, jnp.asarray(coords), jnp.asarray(valid), BATCH,
                          DEEPER, VS, PCR)

    variables = jax.jit(lambda k, f: jm.init(k, mk(f)))(jax.random.PRNGKey(1),
                                                         jnp.asarray(feats))
    rng = np.random.default_rng(4)
    variables = {**variables, "batch_stats": jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 2.0, x.shape).astype(np.float32),
        variables["batch_stats"])}
    want, want_stages = jax.jit(lambda v, f: jm.apply(v, mk(f)))(
        variables, jnp.asarray(feats))
    tm = getattr(t_bb, name)(in_channels=4, grid_size=GRID, return_stages=True,
                             pcdet_sparse_shape=True, **KW)
    load_flax_variables(tm, jax.tree_util.tree_map(np.asarray, variables))
    sp = TSV.create(torch.as_tensor(feats), torch.as_tensor(coords),
                    torch.as_tensor(valid), BATCH, GRID, VS, PCR)
    with torch.no_grad():
        got, got_stages = tm.eval()(sp)
    for k, w in list(want_stages.items()) + [("out", want)]:
        g = got if k == "out" else got_stages[k]
        np.testing.assert_array_equal(_np(g.coords), np.asarray(w.coords), k)
        np.testing.assert_array_equal(_np(g.valid), np.asarray(w.valid), k)
        assert tuple(g.spatial_shape) == tuple(w.spatial_shape), k
        np.testing.assert_allclose(_np(g.features), np.asarray(w.features),
                                   err_msg=k, **CLOSE)
        assert 0 < int(_np(g.valid).sum()) < g.valid.shape[0], k  # no cap
    assert tm.sparse_shape == DEEPER
    assert tm.out_spatial_shape == (2, 2, 2) == tuple(want.spatial_shape)
    assert tm.num_bev_features == 64 == want.bev().shape[-1]
    np.testing.assert_allclose(_np(got.bev()), np.asarray(want.bev()),
                               **CLOSE)


def _kitti_model(pcdet):
    cfg = cfg_from_yaml_file(
        str(spec.ROOT / "tools/cfgs/kitti_models/second.yaml"), EasyDict())
    model_cfg = copy.deepcopy(cfg.MODEL)
    if pcdet:
        model_cfg.BACKBONE_3D.PCDET_SPARSE_SHAPE = True
    model = build_network(model_cfg, 3, cfg.CLASS_NAMES, (1408, 1600, 40),
                          (0.05, 0.05, 0.1), (0, -40, -3, 70.4, 40, 1), 4,
                          40000, 5, num_point_features=4, device="cpu")
    return model_cfg, model


@pytest.mark.parametrize("pcdet,depth", [(True, 2), (False, 1)])
def test_kitti_bev_width_from_shapes(pcdet, depth):
    """At KITTI's grid: ``NUM_BEV_FEATURES`` 256 with the key (z 41 -> 2),
    the JAX package's 128 without it; read from the built shapes and the
    importer's depth, no forward."""
    model_cfg, model = _kitti_model(pcdet)
    b3d = model.backbone_3d
    assert b3d.sparse_shape == (1408, 1600, 40 + pcdet)
    assert b3d.out_spatial_shape == (176, 200, depth)
    assert b3d.num_bev_features == 128 * depth
    assert model.backbone_2d.block0_conv0.weight.shape[1] == 128 * depth
    assert model.backbone_2d.num_bev_features == 512
    assert model.dense_head.conv_cls.weight.shape[1] == 512
    assert model.dense_head.anchors.shape == (211200, 7)
    assert torch_import.bev_depth_of(model_cfg, 40) == depth
    assert t_bb.out_spatial_shape_8x((1408, 1600, 40), pcdet) == \
        b3d.out_spatial_shape


def test_importer_permutes_the_first_bev_conv_at_depth_2():
    """A seeded pcdet-named first BEV conv, imported at depth 2: the port's
    conv on its z-major map gives pcdet's conv on its channel-major map
    (``dense.view(N, C * D, H, W)``, map_to_bev/height_compression.py)."""
    model_cfg, model = _kitti_model(True)
    depth = torch_import.bev_depth_of(model_cfg, 40)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(128, 256, 3, 3, generator=gen)
    state, report = torch_import.convert_state_dict(
        {"backbone_2d.blocks.0.1.weight": w}, model, bev_depth=depth)
    assert "backbone_2d.block0_conv0.weight" in report["loaded"]
    assert not torch.equal(state["backbone_2d.block0_conv0.weight"], w)
    conv = model.backbone_2d.block0_conv0
    conv.load_state_dict({"weight": state["backbone_2d.block0_conv0.weight"]})
    dense = torch.randn(1, 128, depth, 6, 5, generator=gen)  # (N, C, D, H, W)
    want = F.conv2d(F.pad(dense.reshape(1, 256, 6, 5), (1, 1, 1, 1)), w)
    port_map = dense.permute(0, 3, 4, 2, 1).reshape(1, 6, 5, 256)  # z-major
    with torch.no_grad():
        got = conv(port_map.permute(0, 3, 1, 2))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# -- the spans of a SECOND request ------------------------------------------


@pytest.fixture(scope="module")
def tiny_second():
    data = REHEARSAL["data"]
    torch.manual_seed(0)
    model = build_network(
        EasyDict(REHEARSAL["MODEL"]), 3, REHEARSAL["class_names"],
        tuple(data["grid_size"]), tuple(data["voxel_size"]),
        tuple(data["point_cloud_range"]), 2,
        int(data["max_voxels_per_frame"]), int(data["max_points_per_voxel"]),
        num_point_features=4, device="cpu")
    host, _ = kitti_scene.make(REHEARSAL["traffic"]["params"], REHEARSAL, 2,
                               2**33 + 1)
    return model.eval(), {k: torch.as_tensor(v) for k, v in host[0].items()}


def test_second_request_spans(tiny_second, tmp_path):
    """The six stages in order and disjoint inside ``mssvt.request``;
    ``mssvt.spconv_rules`` (the input's index, each stage's table, each
    strided layer's sites, table and index) only inside
    ``mssvt.backbone_3d``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eval_step(*tiny_second)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = trace.load(path)
    (req,) = trace.ranges(events, "mssvt.request")
    stages = [trace.ranges(events, "mssvt." + s) for s in STAGES]
    assert all(len(r) == 1 for r in stages)
    stages = [r[0] for r in stages]
    assert req[0] <= stages[0][0] and stages[-1][1] <= req[1]
    for (_, end), (start, _) in zip(stages, stages[1:]):
        assert end <= start
    rules = trace.ranges(events, "mssvt.spconv_rules")
    # the input's index; conv_input's and conv1's tables; conv2-4's strided
    # layers (sites, table and index in one span) and their stages' tables;
    # conv_out's strided layer
    assert len(rules) == 1 + 2 + 3 * 2 + 1
    (bb,) = trace.ranges(events, "mssvt.backbone_3d")
    assert all(bb[0] <= s and e <= bb[1] for s, e in rules)


def test_no_span_without_a_profiler(tiny_second, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    mask = eval_step(*tiny_second)[3]
    assert mask.shape == (2, 500)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError):
            tracing.span("spconv_rules")


# -- the readers of mssvt.spconv_rules ----------------------------------------


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one request of 2 frames: backbone_3d [10, 200) holds two rules spans,
# [20, 40) and [100, 120); kernels launched at 25 (10 us) and 105 (30 us)
# inside them, at 50 (40 us) and 150 (60 us) between them, at 250 (5 us)
# after the backbone
EVENTS = [_ev("mssvt.backbone_3d", "user_annotation", 10, 190),
          _ev("mssvt.spconv_rules", "user_annotation", 20, 20),
          _ev("mssvt.spconv_rules", "user_annotation", 100, 20)] + [
    e for i, (t, d) in enumerate([(25, 10), (105, 30), (50, 40), (150, 60),
                                  (250, 5)])
    for e in (_ev("cudaLaunchKernel", "cuda_runtime", t, 1, i),
              _ev(f"k{i}", "kernel", t + 2, d, i))]


def _read(name, events):
    from types import SimpleNamespace

    rec = SimpleNamespace(events=events, requests=1, batch=2)
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py").read(rec)


@pytest.mark.parametrize("name,want", [
    ("spconv_rules_device_ms.infer", (10 + 30) / 2e3),
    ("spconv_conv_device_ms.infer", (40 + 60) / 2e3)])
def test_spconv_readers(name, want):
    assert _read(name, EVENTS) == pytest.approx(want)
    bare = [e for e in EVENTS if e["name"] != "mssvt.spconv_rules"]
    assert _read(name, bare) is None
