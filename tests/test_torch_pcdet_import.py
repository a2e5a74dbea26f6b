"""The port's pcdet checkpoint importer (``runtime/torch_import.py``,
``tools/import_ckpt_torch.py``) against the JAX package's
(``mssvt_tpu/runtime/torch_import.py``), the counterpart of
``tests/test_torch_import.py``.

No pcdet checkpoint can be fetched, so the reference state dicts are made
here: for every leaf of the JAX tiny model the JAX importer names the pcdet
key and its layout transform, and a seeded array is written under that key
in pcdet's layout (the transform inverted). Both importers then read the
same state dict: the port's directly, the JAX one followed by
``bridge.load_flax_variables``. Both start from the same initialisation
(the flax init carried into the port), so the tensors pcdet lacks
(``input_proj``) agree too.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.config import cfg_from_yaml_file as j_cfg
from mssvt_tpu.models import build_network as j_build
from mssvt_tpu.runtime import torch_import as jti
from mssvt_tpu.utils.edict import EasyDict as JDict
from mssvt_tpu_torch.bridge import load_flax_variables
from mssvt_tpu_torch.config import cfg_from_yaml_file as t_cfg
from mssvt_tpu_torch.models import build_network as t_build
from mssvt_tpu_torch.runtime import torch_import as tti
from mssvt_tpu_torch.utils.edict import EasyDict as TDict
from test_torch_detector import _stages

ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = ROOT / "tools" / "cfgs" / "synthetic_models" / "mssvt_tiny.yaml"
KEYS = ("voxels", "voxel_num_points", "voxel_coords", "voxel_valid")

torch.set_num_threads(2)

# pcdet layout from the flax layout: the inverse of each JAX transform
_TO_PCDET = {
    "_t_linear": lambda f: f.T,
    "_t_conv2d": lambda f: f.transpose(3, 2, 0, 1),
    "_t_conv1d_k1": lambda f: f.T[:, :, None],
    "_t_deconv2d": lambda f: f[::-1, ::-1].transpose(2, 3, 0, 1),
}


def _pcdet_state(variables, rng):
    """A seeded pcdet-named ``model_state`` for the flax ``variables``, plus
    what a real checkpoint also holds: ``num_batches_tracked`` counters and
    a tensor no port module takes."""
    flat = jti._flatten(variables)
    heads = {}
    for path in flat:  # SeparateHead: the output conv follows the conv tiers
        if path[1] == "dense_head" and path[-2].endswith("_out"):
            tiers = {p[-2] for p in flat if p[:3] == path[:3]
                     and p[-2].startswith(path[-2][:-4] + "_conv")}
            heads[path] = len(tiers)
    state = {}
    for path, leaf in flat.items():
        key, tf = jti.flax_to_torch_key(path)
        if key is None:
            continue
        if "LAST" in key:
            key = key.replace("LAST", str(heads[path]))
        shape = np.shape(leaf)
        val = rng.normal(size=shape).astype(np.float32)
        if path[-1] == "kernel":  # LeCun-normal scale: finite activations
            val /= np.sqrt(np.prod(shape[:-1]))
        elif path[-1] in ("bias", "mean"):
            val *= 0.1
        elif path[-1] == "scale":
            val = 1.0 + 0.1 * val
        else:  # var
            val = 0.5 + np.abs(val)
        state[key] = np.array(
            _TO_PCDET[tf.__name__](val) if tf is not None else val, order="C")
        if key.endswith("running_var"):
            state[key.replace("running_var", "num_batches_tracked")] = \
                np.asarray(7)
    state["backbone_3d.backbone.0.pos_proj.9.weight"] = np.zeros((1,),
                                                                np.float32)
    return state


@pytest.fixture(scope="module")
def imported():
    """The tiny model: JAX variables, the pcdet state dict, both imports,
    and the JAX eval forward on the JAX-imported variables."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_PALLAS", "xla_fill")
    cfg_j, cfg_t = j_cfg(str(TINY_YAML), JDict()), t_cfg(str(TINY_YAML), TDict())
    dc = cfg_t.DATA_CONFIG
    pcr = tuple(dc.POINT_CLOUD_RANGE)
    vs = tuple(dc.DATA_PROCESSOR[-1].VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    kw = dict(num_class=3, class_names=list(cfg_t.CLASS_NAMES),
              grid_size=grid, voxel_size=vs, point_cloud_range=pcr,
              batch_size=1, max_voxels=512, max_points_per_voxel=5)
    rng = np.random.default_rng(3)
    c = np.unique(np.stack([np.zeros(300, int), rng.integers(0, grid[2], 300),
                            rng.integers(0, grid[1], 300),
                            rng.integers(0, grid[0], 300)], 1), axis=0)
    batch = {"voxel_coords": np.full((512, 4), -1, np.int32),
             "voxel_valid": np.arange(512) < len(c)}
    batch["voxel_coords"][:len(c)] = c
    batch["voxels"] = (rng.normal(size=(512, 5, 4)) * batch["voxel_valid"][
        :, None, None]).astype(np.float32)
    batch["voxel_num_points"] = (rng.integers(1, 6, 512)
                                 * batch["voxel_valid"]).astype(np.float32)
    jm = j_build(model_cfg=cfg_j.MODEL, **kw)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = jax.device_get(jax.jit(lambda k, b: jm.init(
        {"params": k, "dropout": k}, b, train=False))(jax.random.PRNGKey(0), jb))
    state = _pcdet_state(variables, np.random.default_rng(9))
    depth = tti.bev_depth_of(cfg_t.MODEL, grid[2])

    new_vars, report_j = jti.convert_state_dict(state, dict(variables),
                                                bev_depth=depth)
    new_vars = jax.device_get(new_vars)
    via_jax = t_build(cfg_t.MODEL, num_point_features=4, device="cpu", **kw)
    load_flax_variables(via_jax, new_vars)
    port = t_build(cfg_t.MODEL, num_point_features=4, device="cpu", **kw)
    load_flax_variables(port, variables)  # the same initialisation
    torch_state = {k: torch.as_tensor(v) for k, v in state.items()}
    got, report_t = tti.convert_state_dict(torch_state, port, bev_depth=depth)
    want_out = jax.jit(lambda v, b: jm.apply(v, b, method=_stages))(new_vars,
                                                                    jb)
    mp.undo()
    yield dict(state=state, got=got, report_t=report_t,
               want=via_jax.state_dict(), report_j=report_j, batch=batch,
               want_out=jax.device_get(want_out), port=port, cfg=cfg_t,
               depth=depth, variables=variables)


def test_import_matches_jax_importer_and_bridge_leaf_for_leaf(imported):
    """Every tensor of the port's state dict equals, bit for bit, what the
    JAX importer and the bridge give, and both importers report the same:
    the same pcdet keys unused, as many tensors loaded and kept."""
    got, want = imported["got"], imported["want"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)
    rt, rj = imported["report_t"], imported["report_j"]
    assert rt["unused"] == rj["unused"] == [
        "backbone_3d.backbone.0.pos_proj.9.weight"]
    assert len(rt["loaded"]) == len(rj["loaded"]) > 50
    assert not rt["shape_mismatch"] and not rj["shape_mismatch"]
    assert sorted(rt["missing"]) == ["backbone_3d.input_proj.bias",
                                     "backbone_3d.input_proj.weight"]
    assert len(rj["missing"]) == 2
    # the first BEV convolution was permuted (not a plain copy)
    key = "map_to_bev.compress_conv_0.weight"
    raw = imported["state"]["map_to_bev_module.compress_layers.0.weight"]
    assert not np.array_equal(got[key].numpy(), raw)
    perm = tti.bev_channel_perm(raw.shape[1], imported["depth"])
    np.testing.assert_array_equal(got[key].numpy(), raw[:, perm])


def test_imported_model_outputs_match_jax(imported):
    """The port with its imported weights against the JAX model with the
    JAX-imported variables, eval mode on one frame: the head's maps to 1e-4
    of their largest magnitude (as test_torch_detector.py), and the
    detections as sets of boxes (to 1e-4 relative) and their scores."""
    port = imported["port"]
    port.load_state_dict(imported["got"])
    batch = imported["batch"]
    with torch.no_grad():
        out = port({k: torch.as_tensor(batch[k]) for k in KEYS},
                   return_intermediates=True)
    want = imported["want_out"]
    for k, w in want["preds"][0].items():
        w = np.asarray(w)
        err = np.abs(out["pred_dicts"][0][k].numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err)
    want = {"final_" + k: want[k] for k in ("mask", "scores", "boxes")}
    gm, wm = out["final_mask"][0].numpy(), np.asarray(want["final_mask"][0])
    assert gm.sum() == wm.sum() > 0
    order = lambda s: np.argsort(-s, kind="stable")
    gs = out["final_scores"][0].numpy()[gm]
    ws = np.asarray(want["final_scores"][0])[wm]
    gb = out["final_boxes"][0].numpy()[gm][order(gs)]
    wb = np.asarray(want["final_boxes"][0])[wm][order(ws)]
    np.testing.assert_allclose(np.sort(gs), np.sort(ws), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-4)


def test_import_tool_writes_a_checkpoint_test_torch_loads(imported,
                                                          tmp_path):
    """``tools/import_ckpt_torch.py`` on a pcdet checkpoint file: a port
    checkpoint under ``--out`` at the reference's epoch whose model state
    is the importer's (the tool builds its own model, whose fresh
    initialisation differs only in the tensors pcdet lacks), loadable by
    the port's model."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "import_ckpt_torch_under_test", ROOT / "tools" / "import_ckpt_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ckpt = tmp_path / "checkpoint_epoch_30.pth"
    torch.save({"epoch": 30, "it": 900, "version": "pcdet+0.5.2",
                "model_state": {k: torch.as_tensor(v) for k, v in
                                imported["state"].items()}}, ckpt)
    path, report = tool.main(["--cfg_file", str(TINY_YAML), "--ckpt",
                              str(ckpt), "--out", str(tmp_path / "out")])
    assert path == tmp_path.resolve() / "out" / "checkpoint_30.pt"
    saved = torch.load(path, weights_only=False)
    assert saved["epoch"] == 30 and saved["it"] == 900
    got = imported["got"]
    for k, v in saved["model"].items():
        if k not in report["missing"]:
            np.testing.assert_array_equal(v.numpy(), got[k].numpy(),
                                          err_msg=k)
    imported["port"].load_state_dict(saved["model"])
    assert report["unused"] == imported["report_t"]["unused"]
