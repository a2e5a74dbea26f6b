"""The port stands alone: it imports nothing of JAX or the JAX package,
imports without nvcc, triton or a card, builds on the card by default, and
its kernel wrappers take the plain versions for CPU tensors."""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mssvt_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mssvt_tpu")
ENTRY_POINTS = tuple(sorted((ROOT / "tools").glob("*_torch.py")))
# imported by the spawned ranks of test_torch_ddp.py, which must not load JAX
RANK_BODIES = (ROOT / "tests" / "torch_ddp_worker.py",)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "bench_torch.py",
                                          *ENTRY_POINTS, *RANK_BODIES]
    # the glob finds the entry points (every tools/*_torch.py is scanned)
    # and the sparse-conv, anchor-head, CaDDN and CT3D families' modules
    assert len(files) > 20 and {"train_torch.py", "test_torch.py"} <= {
        p.name for p in ENTRY_POINTS}
    assert {"sparse_conv.py", "spconv_backbone.py", "anchor_head.py",
            "box_coder.py", "second_net.py", "pointpillar.py",
            "image_vfe.py", "caddn.py", "ctrans.py", "ct3d_head.py",
            "ct3d_3cat.py", "anchor_head_multi.py", "bench_torch.py",
            "convergence.py", "work.py", "mechanisms.py"} <= {
        p.name for p in files}
    # the bench's tools are scanned as entry points
    assert {"profile_top_ops_torch.py", "ablate_e2e_torch.py",
            "bench_attn_kernel_torch.py", "op_bytes_torch.py",
            "dump_ops_torch.py"} <= {p.name for p in ENTRY_POINTS}
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_port_imports_without_nvcc_triton_or_jax():
    """Every module of the port imports in a fresh interpreter with no
    nvcc on PATH, and that leaves jax, flax, triton and mssvt_tpu
    unimported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mssvt_tpu_torch\n"
        "for m in pkgutil.walk_packages(mssvt_tpu_torch.__path__, 'mssvt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'triton', 'mssvt_tpu')]\n"
        "assert not bad, bad\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_import_without_nvcc_or_jax_and_build_nothing():
    """Every torch entry point (``tools/*_torch.py``, ``bench_torch.py``)
    and the DDP tests' rank bodies import in a fresh interpreter with no
    nvcc and no g++ on PATH; that loads nothing of jax, flax, orbax or
    mssvt_tpu, and neither builds the host voxelizer nor the kernels."""
    names = [p.stem for p in ENTRY_POINTS]
    code = (
        "import importlib.util, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_ddp_worker\n"
        "import bench_torch\n"
        "assert callable(bench_torch.main)\n"
        f"for name in {names!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'tools/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert callable(mod.main)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'triton', 'mssvt_tpu')]\n"
        "assert not bad, bad\n"
        "from mssvt_tpu_torch.ops import voxelize\n"
        "from mssvt_tpu_torch.kernels import _lib\n"
        "assert voxelize._LIB is None and _lib._LIB is None\n")
    env = {"PATH": str(Path(sys.executable).parent), "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_build_network_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    from mssvt_tpu_torch.models import build_network
    from test_model_forward import tiny_model_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(model_cfg=tiny_model_cfg(), num_class=2,
              class_names=["Car", "Ped"], grid_size=(24, 24, 8),
              voxel_size=(0.4, 0.4, 0.5),
              point_cloud_range=(0.0, -4.8, -2.0, 9.6, 4.8, 2.0),
              batch_size=2, max_voxels=512, max_points_per_voxel=5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_network(**kw)
    model = build_network(**kw, device="cpu")
    assert not model.training
    assert next(model.parameters()).device.type == "cpu"


def test_unported_names_raise_pointing_at_roadmap():
    """Every name of the JAX registries is ported (Conv2DCollapse, CaDDN
    and CT3D_3CAT last; ``test_torch_registry.py`` builds them all): a name
    neither package knows raises as unknown, listing the known ones."""
    from mssvt_tpu_torch.models.builders import BuildCtx, build_map_to_bev
    from mssvt_tpu_torch.models.detectors import build_detector
    from mssvt_tpu_torch.models.model_utils.attention import MixedScaleAttention

    ctx = BuildCtx(3, ("a", "b", "c"), (8, 8, 8), (1, 1, 1), (0,) * 6, 1, 8, 5)
    with pytest.raises(NotImplementedError,
                       match="unknown MAP_TO_BEV 'NoSuchCollapse'.*"
                             "Conv2DCollapse"):
        build_map_to_bev({"NAME": "NoSuchCollapse"}, ctx)
    with pytest.raises(NotImplementedError,
                       match="unknown detector 'NoSuchNet'.*CT3D_3CAT"):
        build_detector({"NAME": "NoSuchNet"})
    # attention dropout > 0 in training is ported (the per-group einsum,
    # test_torch_dropout.py); its masks need the caller's generator
    attn = MixedScaleAttention(32, (1, 1), dropout=0.1).train()
    kw = dict(query=torch.randn(3, 8, 32), keys=torch.randn(3, 8, 32),
              key_masks=torch.zeros(3, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        attn(**kw)
    assert attn(**kw, generator=torch.Generator()).shape == (3, 8, 32)
    attn.eval()(**kw)


def _einsum_route(attn, **kw):
    """The same call through the per-group einsum path (as for nq < 8)."""
    from mssvt_tpu_torch.models.model_utils import attention as mod

    saved = mod.MIN_KERNEL_QUERIES
    mod.MIN_KERNEL_QUERIES = 10 ** 9
    try:
        return attn(**kw)
    finally:
        mod.MIN_KERNEL_QUERIES = saved


@pytest.mark.parametrize("call", ["query_keys", "assembled_no_pad_inputs"])
def test_training_routes_that_used_to_raise_match_the_einsum_path(call):
    """Training where JAX runs its plain fused attention (K6 forward, K7
    backward): the query path with nq >= 8, and the assembled path without
    ref-compat keys. Both calls raised before K6/K7 were ported; now they
    run (the kernels' plain versions on CPU tensors) and agree with the
    per-group einsum path on the same inputs, output and parameter
    gradients, to 1e-5 in f32 (the same math in another order)."""
    from mssvt_tpu_torch.models.model_utils.attention import MixedScaleAttention

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    nw, nq, nk, d = 3, 8, 8, 32
    km = torch.rand(nw, nk, generator=g) < 0.2
    if call == "query_keys":
        kw = dict(query=r(nw, nq, d), keys=r(nw, nk, d), key_masks=km)
    else:
        kw = dict(key_masks=km, query_mask=torch.rand(nw, nq, generator=g) < 0.2,
                  assembled=dict(
                      win1_fea=r(nw, 12, d), k2_fea=r(nw, nk // 2, d),
                      fps1=torch.randint(0, 12, (nw, nk // 2), generator=g,
                                         dtype=torch.int32),
                      k_mask1=km[:, :nk // 2], q_ext=None,
                      q_keep=torch.ones(nw, nq),
                      q_rel=tuple(r(nw, nq) for _ in range(3)),
                      k_rel=tuple(r(nw, nk) for _ in range(3)),
                      pos_base=r(nw, d), pos_w=r(3, d), nq=nq,
                      num_valid=torch.tensor(nw)))
    attn = MixedScaleAttention(d, (1, 1)).train()
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.2, generator=g)
    gout = r(nw, nq, d)
    res = []
    for route in (attn, lambda **k: _einsum_route(attn, **k)):
        attn.zero_grad()
        out = route(**kw)
        (out * gout).sum().backward()
        res.append((out.detach(), {n: p.grad.clone()
                                   for n, p in attn.named_parameters()}))
    (out_k, g_k), (out_e, g_e) = res
    torch.testing.assert_close(out_k, out_e, rtol=1e-5, atol=1e-5)
    for n in g_e:
        # the key-bias gradient is analytically zero: absolute tolerance only
        torch.testing.assert_close(g_k[n], g_e[n], rtol=1e-5, atol=1e-5,
                                   msg=n)


def test_wrappers_take_plain_versions_on_cpu(monkeypatch):
    """CPU tensors never reach the kernel library, and add no launches."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.kernels import (
        _lib,
        attention,
        attention_bwd,
        attention_qk,
        attention_qk_bwd,
        ball_query,
        ffn,
        fill,
        fps,
    )

    def no_lib():
        raise AssertionError("the CUDA library was requested for CPU tensors")

    monkeypatch.setattr(_lib, "lib", no_lib)
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    box = torch.as_tensor(rng.integers(-1, 50, (6, 20)).astype(np.int32))
    offs = np.arange(20, dtype=np.int32)
    got = fill.fill_capacity_buffer(box, offs, 8)
    want = fill.fill_plain(box, offs, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    planes = [torch.as_tensor(rng.normal(size=(4, 16)).astype(np.float32))
              for _ in range(3)]
    gi, _ = fps.fps_select(*planes, (), 5)
    assert torch.equal(gi, fps.fps_plain(*planes, (), 5)[0])
    for fn in (fps.fps_picks_warp, fps.fps_picks_block, fps.fps_picks):
        assert torch.equal(fn(*planes, 5), gi)
    valid = torch.as_tensor(rng.random((8, 16)) < 0.7)
    assert torch.equal(fps.fps_picks_masked(*planes, valid, 5),
                       fps.fps_masked_plain(*planes, valid, 5))
    x = torch.randn(10, 32)
    p = [torch.ones(32), torch.zeros(32), torch.randn(32, 64), torch.zeros(64),
         torch.randn(64, 32), torch.zeros(32)]
    assert torch.equal(ffn.fused_residual_ffn(x, *p), ffn.ffn_plain(x, *p))
    nw, d = 3, 32
    proj = tuple(t for _ in range(4) for t in (torch.eye(d), torch.zeros(d)))
    args = (torch.randn(nw, 6, d), torch.randn(nw, 4, d),
            torch.zeros(nw, 4, dtype=torch.int32),
            torch.zeros(nw, 4, dtype=torch.bool), None, torch.ones(nw, 4),
            tuple(torch.randn(nw, 8) for _ in range(3)),
            tuple(torch.randn(nw, 4) for _ in range(3)), torch.randn(nw, d),
            torch.randn(3, d), proj, torch.zeros(nw, 8))
    kw = dict(num_heads=(1, 1), scale=0.25, q_prefix=True, nq=4)
    assert torch.equal(attention.fused_window_attention_assembled(*args, **kw),
                       attention.attention_plain(*args, **kw))
    kw.update(pad_row=torch.randn(nw, d), num_valid=torch.tensor(2))
    g = torch.randn(nw, 4, d)
    got = attention_bwd.fused_window_attention_assembled_bwd(*args, g, **kw)
    want = attention.attention_bwd_plain(*args, g, **kw)
    for a, b in zip(got[:2] + got[3:6] + got[6], want[:2] + want[3:6] + want[6]):
        assert torch.equal(a, b)
    assert got[2] is None and want[2] is None
    qk = (torch.randn(nw, 4, d), torch.randn(nw, 8, d), proj,
          torch.zeros(nw, 8))
    kw = dict(num_heads=(1, 1), scale=0.25)
    assert torch.equal(attention_qk.fused_window_attention(*qk, **kw),
                       attention_qk.attention_qk_plain(*qk, **kw))
    got = attention_qk_bwd.fused_window_attention_bwd(*qk, g, **kw)
    want = attention_qk_bwd.attention_qk_bwd_plain(*qk, g, **kw)
    for a, b in zip(got[:2] + got[2], want[:2] + want[2]):
        assert torch.equal(a, b)
    xyz = torch.as_tensor(rng.uniform(0, 2, (2, 40, 3)).astype(np.float32))
    live = torch.as_tensor(rng.random((2, 40)) < 0.7)
    got = ball_query.ball_query(0.8, 8, xyz, xyz[:, :5], live)
    want = ball_query.ball_query_plain(0.8, 8, xyz, xyz[:, :5], live)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(kernels.KERNELS) == 11
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


def test_kernel_sources_are_present():
    names = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert names == {"fill.cu", "fps.cu", "attention.cu", "attention_bwd.cu",
                     "attention_qk.cu", "attention_qk_bwd.cu", "ffn.cu",
                     "nms.cu", "nms_iou.cu", "ball_query.cu"}
    headers = {p.name for p in (PORT / "csrc").glob("*.cuh")}
    assert headers == {"attention_common.cuh", "attention_bwd_common.cuh"}
    # the host voxelizer's C++ lies outside the nvcc glob (csrc/*.cu)
    assert [p.name for p in (PORT / "csrc" / "host").iterdir()
            if p.suffix == ".cpp"] == ["voxelizer.cpp"]
    mods = {m.name for m in pkgutil.iter_modules([str(PORT / "kernels")])}
    assert {"fill", "fps", "attention", "attention_bwd", "attention_qk",
            "attention_qk_bwd", "ffn", "nms", "nms_iou", "ball_query",
            "_lib"} <= mods
    assert importlib.import_module("mssvt_tpu_torch.kernels._lib").BUILD_DIR \
        == ROOT / "build" / "kernels"
