"""The port's entry points, ``tools/train_torch.py`` and
``tools/test_torch.py``, driven in-process on the CPU (``--device cpu``) as
a user runs them: two epochs of a 2-block tiny MsSVT on the synthetic
dataset (the config ``tests/test_train_cli_e2e.py`` gives the JAX CLI, 4
frames), checkpoints, auto-resume, eval after training, then eval of a
checkpoint and the watch mode. The port's loader hands the CLI the batches
the JAX loader gives the JAX CLI for the same config and seed. The model's
own parity with JAX is held by ``test_torch_train.py`` and
``test_torch_detector.py``.
"""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
TRAIN = ["--epochs", "2", "--batch_size", "2", "--workers", "1",
         "--extra_tag", "ci", "--fix_random_seed", "--device", "cpu"]

torch.set_num_threads(2)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_cfg(root):
    sys.path.insert(0, str(REPO))
    from __graft_entry__ import _model_cfg
    from test_pipeline import synthetic_cfg

    model = json.loads(json.dumps(_model_cfg()))  # plain dicts
    model["BACKBONE_3D"]["PARAMS"] = model["BACKBONE_3D"]["PARAMS"][:2]
    model["MAP_TO_BEV"]["NUM_BEV_FEATURES"] = 64 * 2
    data = json.loads(json.dumps(synthetic_cfg()))
    data["NUM_FRAMES"] = 4
    cfg = {
        "CLASS_NAMES": CLASSES, "DATA_CONFIG": data, "MODEL": model,
        "OPTIMIZATION": {
            "BATCH_SIZE_PER_GPU": 2, "NUM_EPOCHS": 2,
            "OPTIMIZER": "adam_onecycle", "LR": 0.003,
            "WEIGHT_DECAY": 0.01, "MOMENTUM": 0.9, "MOMS": [0.95, 0.85],
            "PCT_START": 0.4, "DIV_FACTOR": 10, "GRAD_NORM_CLIP": 10,
        },
    }
    p = root / "cfgs" / "synthetic_models" / "tiny_mssvt.yaml"
    p.parent.mkdir(parents=True)
    p.write_text(yaml.safe_dump(cfg))
    return p


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One training run (2 epochs, eval after training), its rerun, and the
    two tools' modules; outputs under a temporary MSSVT_OUTPUT_ROOT."""
    root = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_OUTPUT_ROOT", str(root / "output"))
    try:
        cfg_path = _tiny_cfg(root)
        train, test = _tool("train_torch"), _tool("test_torch")
        args = ["--cfg_file", str(cfg_path), *TRAIN]
        first = train.main(args + ["--eval_after_train"])
        again = train.main(args)
        yield dict(root=root, cfg=cfg_path, args=args, train=train,
                   test=test, first=first, again=again, mp=mp)
    finally:
        mp.undo()


def test_two_epochs_write_checkpoints_and_eval_products(run):
    from mssvt_tpu_torch.runtime.checkpoint import CheckpointManager

    first = run["first"]
    out = first["output_dir"]
    assert out == run["root"] / "output" / "cfgs" / "synthetic_models" / \
        "tiny_mssvt" / "ci"
    assert CheckpointManager(first["ckpt_dir"]).all_steps() == [1, 2]
    assert (first["start_epoch"], first["start_iter"]) == (0, 0)
    assert [h["epoch"] for h in first["history"]] == [0, 0, 1, 1]
    assert [h["it"] for h in first["history"]] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in first["history"])
    assert len(first["loader_make_seconds"]) == 4
    with open(out / "eval" / "result.pkl", "rb") as f:
        dets = pickle.load(f)
    assert len(dets) == 4 and set(dets[0]) == {"boxes", "scores", "labels"}
    metrics = first["metrics"]
    assert {"mAP", "sec_per_example", "recall/rcnn_0.3"} <= set(metrics)
    assert all(np.isfinite(v) or np.isnan(v) for v in metrics.values())
    logs = "".join(p.read_text() for p in out.glob("log_train_*.txt"))
    assert "saved checkpoint @ epoch 2" in logs
    # set once by the entry point (train_utils.set_deterministic)
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark


def test_rerun_resumes_after_the_last_epoch_and_trains_no_more(run):
    again = run["again"]
    assert (again["start_epoch"], again["start_iter"]) == (2, 4)
    assert again["history"] == [] and again["iterations"] == 4
    from mssvt_tpu_torch.runtime.checkpoint import CheckpointManager

    assert CheckpointManager(again["ckpt_dir"]).all_steps() == [1, 2]


def test_test_tool_reproduces_the_eval_after_training(run):
    got = run["test"].main(["--cfg_file", str(run["cfg"]), "--ckpt", "2",
                            "--batch_size", "2", "--workers", "0",
                            "--extra_tag", "ci", "--device", "cpu"])
    assert list(got) == [2]
    want = run["first"]["metrics"]
    assert set(got[2]) == set(want)
    for k in want:
        if k != "sec_per_example":
            np.testing.assert_equal(got[2][k], want[k], err_msg=k)
    out = run["first"]["output_dir"] / "eval" / "epoch_2" / "result.pkl"
    assert out.exists()


def test_eval_all_evaluates_every_checkpoint(run):
    got = run["test"].main(["--cfg_file", str(run["cfg"]), "--eval_all",
                            "--max_waiting_mins", "0", "--batch_size", "2",
                            "--workers", "0", "--extra_tag", "ci",
                            "--device", "cpu"])
    assert sorted(got) == [1, 2]
    record = run["first"]["output_dir"] / "eval" / "eval_list_val.txt"
    assert sorted(int(x) for x in record.read_text().split()) == [1, 2]


def test_ckpt_flag_starts_a_fresh_run_from_checkpoint_weights(run):
    ckpt = run["first"]["ckpt_dir"] / "checkpoint_2.pt"
    res = run["train"].main(["--cfg_file", str(run["cfg"]), "--epochs", "1",
                             "--batch_size", "2", "--workers", "0",
                             "--extra_tag", "from_ckpt", "--ckpt", str(ckpt),
                             "--device", "cpu"])
    assert (res["start_epoch"], len(res["history"])) == (0, 2)
    text = next(res["output_dir"].glob("log_train_*.txt")).read_text()
    n = len(torch.load(ckpt, weights_only=False)["model"])
    assert f"partial load: {n}/{n} tensors restored" in text


def test_first_batch_equals_the_jax_loaders(run):
    """What the port's CLI trains on first (--fix_random_seed: the dataset
    seeded with 666, shuffle seed 0) is the JAX loader's first batch after
    ``np.random.seed(666)``, which the JAX CLI's --fix_random_seed does."""
    from mssvt_tpu.config import cfg_from_yaml_file as j_cfg
    from mssvt_tpu.datasets.loader import build_dataloader as j_loader
    from mssvt_tpu.utils.edict import EasyDict as JDict
    from mssvt_tpu_torch.datasets.loader import build_dataloader as t_loader
    from mssvt_tpu_torch.runtime.cli import load_run_config
    from test_torch_pipeline import _equal

    cfg_t = load_run_config(str(run["cfg"]))
    cfg_j = j_cfg(str(run["cfg"]), JDict())
    np.random.seed(run["train"].FIXED_SEED)
    _, jl = j_loader(cfg_j.DATA_CONFIG, CLASSES, 2, True, workers=0)
    _, tl = t_loader(cfg_t.DATA_CONFIG, CLASSES, 2, True, workers=0,
                     data_seed=run["train"].FIXED_SEED)
    _equal(next(iter(tl)), next(iter(jl)), "first batch")


def test_entry_points_refuse_a_missing_card_and_several_devices(
        run, monkeypatch):
    """No card: the default device and several devices on cards are
    refused before any rank starts (never a fallback to the CPU); JAX's
    ``jax`` launcher has no torch meaning and is not a choice. Several CPU
    ranks run (``test_torch_ddp.py``)."""
    cfg = ["--cfg_file", str(run["cfg"])]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (run["train"], run["test"]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tool.main(cfg)  # --device cuda is the default
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tool.main(cfg + ["--num_devices", "2"])
        with pytest.raises(SystemExit):
            tool.main(cfg + ["--launcher", "jax", "--device", "cpu"])


def test_set_overrides_reach_the_config(run):
    from mssvt_tpu_torch.runtime.cli import load_run_config

    cfg = load_run_config(str(run["cfg"]), [
        "DATA_CONFIG.NUM_FRAMES", "6", "OPTIMIZATION.LR", "0.01",
        "DATA_CONFIG.POINT_CLOUD_RANGE", "0,-9.6,-2,19.2,9.6,2.5"])
    assert cfg.DATA_CONFIG.NUM_FRAMES == 6 and cfg.OPTIMIZATION.LR == 0.01
    assert cfg.DATA_CONFIG.POINT_CLOUD_RANGE[-1] == 2.5
    assert cfg.TAG == "tiny_mssvt"
    assert cfg.EXP_GROUP_PATH == "cfgs/synthetic_models"
    with pytest.raises(KeyError, match="NotFoundKey"):
        load_run_config(str(run["cfg"]), ["DATA_CONFIG.NOPE", "1"])
