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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mssvt_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
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
    from mssvt_tpu_torch.models.builders import BuildCtx, build_backbone_3d
    from mssvt_tpu_torch.models.model_utils.attention import MixedScaleAttention

    ctx = BuildCtx(3, ("a", "b", "c"), (8, 8, 8), (1, 1, 1), (0,) * 6, 1, 8, 5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_backbone_3d({"NAME": "VoxelBackBone8x"}, ctx)
    # training where JAX would run its plain fused attention K6/K7: query
    # path with nq >= 8, or the assembled path without ref-compat keys
    attn = MixedScaleAttention(32, (1, 1)).train()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attn(query=torch.randn(3, 8, 32), keys=torch.randn(3, 8, 32),
             key_masks=torch.zeros(3, 8, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attn(key_masks=torch.zeros(3, 8, dtype=torch.bool),
             assembled={"nq": 8, "num_valid": torch.tensor(3)})


def test_wrappers_take_plain_versions_on_cpu(monkeypatch):
    """CPU tensors never reach the kernel library, and add no launches."""
    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.kernels import (
        _lib,
        attention,
        attention_bwd,
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
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


def test_kernel_sources_are_present():
    names = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert names == {"fill.cu", "fps.cu", "attention.cu", "attention_bwd.cu",
                     "ffn.cu"}
    mods = {m.name for m in pkgutil.iter_modules([str(PORT / "kernels")])}
    assert {"fill", "fps", "attention", "attention_bwd", "ffn", "_lib"} <= mods
    assert importlib.import_module("mssvt_tpu_torch.kernels._lib").BUILD_DIR \
        == ROOT / "build" / "kernels"
