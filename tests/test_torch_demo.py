"""``tools/demo_torch.py`` on the CPU against the JAX package's demo
pipeline (``tools/demo.py``'s ``DemoDataset``, the flax model's eval
apply) on the same two seeded ``.npy`` frames and bridged weights
(``mssvt_tiny.yaml``, f32, BatchNorm statistics randomised)."""

import importlib.util
import pickle
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = ROOT / "tools" / "cfgs" / "synthetic_models" / "mssvt_tiny.yaml"

torch.set_num_threads(2)


def _tool(name, tag):
    spec = importlib.util.spec_from_file_location(
        f"{name}_{tag}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(folder):
    """Two frames of (x, y, z, intensity) in mssvt_tiny.yaml's range."""
    rng = np.random.default_rng(21)
    folder.mkdir()
    for i in range(2):
        n = 4000
        pts = np.stack([rng.uniform(0.0, 19.2, n), rng.uniform(-9.6, 9.6, n),
                        rng.uniform(-2.0, 2.0, n), rng.uniform(0, 1, n)],
                       1).astype(np.float32)
        np.save(folder / f"{i:06d}.npy", pts)
    return folder


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """JAX: the demo dataset's batches and the eval apply per frame. Port:
    the bridged weights as a checkpoint, then ``demo_torch.main``."""
    from mssvt_tpu.config import cfg_from_yaml_file as j_cfg
    from mssvt_tpu.models import build_network as j_build
    from mssvt_tpu.utils.edict import EasyDict as JDict
    from mssvt_tpu_torch.bridge import load_flax_variables
    from mssvt_tpu_torch.config import cfg_from_yaml_file as t_cfg
    from mssvt_tpu_torch.runtime.cli import build_model
    from mssvt_tpu_torch.utils.edict import EasyDict as TDict

    root = tmp_path_factory.mktemp("demo")
    data = _frames(root / "frames")
    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_PALLAS", "xla_fill")
    jdemo = _tool("demo", "jax_under_test")
    cfg = j_cfg(str(TINY_YAML), JDict())
    ds = jdemo.DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, str(data),
                           ext=".npy")
    jm = j_build(model_cfg=cfg.MODEL, num_class=3,
                 class_names=cfg.CLASS_NAMES, grid_size=ds.grid_size,
                 voxel_size=ds.voxel_size,
                 point_cloud_range=ds.point_cloud_range, batch_size=1,
                 max_voxels=ds.max_voxels,
                 max_points_per_voxel=ds.max_points_per_voxel)
    batches = [ds.collate_batch([ds[i]]) for i in range(len(ds))]
    variables = jax.jit(lambda k, b: jm.init({"params": k, "dropout": k}, b,
                                             train=False))(
        jax.random.PRNGKey(0), batches[0])
    rng = np.random.default_rng(2)
    variables = jax.device_get({
        **variables, "batch_stats": jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                          else rng.normal(size=x.shape) * 0.1
                          ).astype(np.float32), variables["batch_stats"])})
    infer = jax.jit(lambda v, b: jm.apply(v, b, train=False))
    want = []
    for b in batches:
        out = jax.device_get(infer(variables, b))
        m = np.asarray(out["final_mask"][0])
        want.append({k: np.asarray(out[f"final_{k}"][0])[m]
                     for k in ("boxes", "scores", "labels")})
    mp.undo()

    tdemo = _tool("demo_torch", "under_test")
    tcfg = t_cfg(str(TINY_YAML), TDict())
    tds = tdemo.DemoDataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, str(data),
                            ext=".npy")
    model = build_model(tcfg, tds, 1, "cpu")
    load_flax_variables(model, variables)
    ckpt = root / "checkpoint_1.pt"
    torch.save({"model": model.state_dict()}, ckpt)
    out_file = root / "dets.pkl"
    args = ["--cfg_file", str(TINY_YAML), "--data_path", str(data), "--ext",
            ".npy", "--ckpt", str(ckpt), "--device", "cpu", "--out_file",
            str(out_file), "--vis_dir", str(root / "bev")]
    got, ms = tdemo.main(args)
    yield dict(want=want, got=got, ms=ms, out_file=out_file, root=root,
               batches=batches, tds=tds, tdemo=tdemo, args=args)


def test_demo_frames_match_jax_demo_dataset(demo):
    """Both demo datasets prepare the same voxels from the same files."""
    tds = demo["tds"]
    for i, jb in enumerate(demo["batches"]):
        tb = tds.collate_batch([tds[i]])
        for k in ("voxels", "voxel_coords", "voxel_num_points", "voxel_valid"):
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]), err_msg=k)


def test_demo_detections_match_jax(demo):
    """Per frame the same detections: counts and labels exactly, boxes and
    scores to 1e-4 (f32 through the same layers, summed in another order),
    compared as sets ordered by score; the pickle holds them."""
    got, want = demo["got"], demo["want"]
    assert len(got) == len(want) == 2 and demo["ms"] > 0
    assert sum(len(w["scores"]) for w in want) > 0
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"])
        go, wo = np.argsort(-g["scores"]), np.argsort(-w["scores"])
        np.testing.assert_allclose(g["scores"][go], w["scores"][wo],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g["boxes"][go], w["boxes"][wo],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(g["labels"][go], w["labels"][wo])
    with open(demo["out_file"], "rb") as f:
        saved = pickle.load(f)
    assert [d["frame_id"] for d in saved] == [0, 1]
    np.testing.assert_array_equal(saved[1]["boxes"], got[1]["boxes"])


def test_demo_draws_bev_pngs_and_refuses_vis_without_matplotlib(demo,
                                                                monkeypatch):
    """``--vis_dir`` wrote one PNG a frame; without matplotlib the option
    raises before any frame is read."""
    pngs = sorted(p.name for p in (demo["root"] / "bev").glob("*.png"))
    assert pngs == ["frame_0000.png", "frame_0001.png"]
    assert (demo["root"] / "bev" / pngs[0]).read_bytes()[:4] == b"\x89PNG"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        demo["tdemo"].main(demo["args"])
