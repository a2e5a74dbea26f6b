"""The port's data parallelism (DDP + SyncBN over ``torch.distributed``) on
the CPU: two gloo ranks in spawned processes, against the port's own
one-process step and against the JAX package's ``make_sharded_train_step``
on a 2-device CPU mesh, then the entry points with ``--num_devices 2``.

The frames of a batch are fed collated, as ``tests/test_ddp_equivalence.py``
feeds them: the augmenting loader draws another order of augmentations on
each rank's dataset. The model is ``mssvt_tiny.yaml`` in f32; its DropPath
rates are 0 in both MsSVT blocks, so the step is deterministic. The rank
bodies live in ``torch_ddp_worker.py``, which spawned children import
without JAX.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_ddp_worker as W
from mssvt_tpu_torch.parallel import dist

REPO = Path(__file__).resolve().parent.parent
TINY_YAML = REPO / "tools" / "cfgs" / "synthetic_models" / "mssvt_tiny.yaml"
SLOTS = 1024  # voxel slots a frame
VOXELS = 600  # random cells a frame
# every block's window cap a frame (max_num_wins; the frames of a batch
# share it): ample, so that no window is dropped, else the batch of two
# and the ranks of one frame would keep other windows (a padding artefact,
# not a DDP semantic; the JAX suite's SECOND DDP test sizes its voxel
# capacity ample for the same reason)
MAX_NUM_WINS = 1024
LR = 1e-2     # SGD, as the JAX suite's DDP test: see its note on adam
CLASSES_A_FRAME = [1, 2, 3, 1, 2]

torch.set_num_threads(2)


def _frames(seed, world=2):
    """``world`` frames in per-frame voxel slots, ``VOXELS`` random cells
    each. Every frame holds one box
    of each class of ``CLASSES_A_FRAME`` (distinct heatmap peaks), so the
    ranks' loss normalisers (positives, regression targets) are equal and
    the mean of the ranks' losses is the loss of the whole batch: DDP
    averages the ranks' losses, each normalised by its own count."""
    rng = np.random.default_rng(seed)
    grid = (48, 48, 8)
    voxels = np.zeros((world * SLOTS, 5, 4), np.float32)
    coords = np.full((world * SLOTS, 4), -1, np.int32)
    valid = np.zeros(world * SLOTS, bool)
    gt = np.zeros((world, 8, 8), np.float32)
    for b in range(world):
        c = np.unique(np.stack([
            np.full(VOXELS, b), rng.integers(0, grid[2], VOXELS),
            rng.integers(0, grid[1], VOXELS),
            rng.integers(0, grid[0], VOXELS)], 1),
            axis=0)
        n, s = len(c), b * SLOTS
        coords[s:s + n], valid[s:s + n] = c, True
        voxels[s:s + n] = rng.normal(size=(n, 5, 4))
        k = len(CLASSES_A_FRAME)
        gt[b, :k, 0] = 1.0 + 3.5 * np.arange(k) + rng.uniform(0, 1, k)
        gt[b, :k, 1] = rng.uniform(-8.0, 8.0, k)
        gt[b, :k, 2] = rng.uniform(-1.0, 1.0, k)
        gt[b, :k, 3:6] = rng.uniform(0.8, 4.0, (k, 3))
        gt[b, :k, 6] = rng.uniform(-np.pi, np.pi, k)
        gt[b, :k, 7] = CLASSES_A_FRAME
    num = (rng.integers(1, 6, world * SLOTS) * valid).astype(np.float32)
    return {"voxels": voxels, "voxel_num_points": num,
            "voxel_coords": coords, "voxel_valid": valid, "gt_boxes": gt}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def runs():
    """Initial flax variables (BatchNorm statistics randomised) carried into
    the port; the two-rank port step, the one-process port step on the
    whole batch, JAX's sharded step on a 2-device mesh and JAX's
    one-device step on the whole batch, from them."""
    import optax

    from mssvt_tpu.config import cfg_from_yaml_file as j_cfg
    from mssvt_tpu.models import build_network as j_build
    from mssvt_tpu.parallel.mesh import (
        make_mesh,
        make_sharded_train_step,
        shard_batch_for_mesh,
    )
    from mssvt_tpu.utils.edict import EasyDict as JDict
    from mssvt_tpu_torch.bridge import load_flax_variables

    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_PALLAS", "xla_fill")
    batch = _frames(3)
    cfg = W.set_window_caps(j_cfg(str(TINY_YAML), JDict()), MAX_NUM_WINS)
    pcr = tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    vs = tuple(cfg.DATA_CONFIG.DATA_PROCESSOR[-1].VOXEL_SIZE)
    grid = tuple(int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3))
    jm = j_build(model_cfg=cfg.MODEL, num_class=3,
                 class_names=list(cfg.CLASS_NAMES), grid_size=grid,
                 voxel_size=vs, point_cloud_range=pcr, batch_size=1,
                 max_voxels=SLOTS, max_points_per_voxel=5)
    mesh = make_mesh(2)
    sharded = shard_batch_for_mesh(batch, mesh, 2)
    one = jax.tree_util.tree_map(lambda x: x[0], sharded)
    variables = jax.jit(lambda k, b: jm.init({"params": k, "dropout": k}, b,
                                             train=False))(
        jax.random.PRNGKey(0), one)
    rng = np.random.default_rng(4)
    variables = jax.device_get({
        **variables, "batch_stats": jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                          else rng.normal(size=x.shape) * 0.1
                          ).astype(np.float32), variables["batch_stats"])})

    port = W.tiny_model(TINY_YAML, 2, SLOTS, max_num_wins=MAX_NUM_WINS)
    load_flax_variables(port, variables)
    state = {k: v.clone() for k, v in port.state_dict().items()}
    shards = [W.shard(batch, r, 2) for r in range(2)]
    ranks = dist.launch_local(functools.partial(
        W.ddp_rank, TINY_YAML, SLOTS, MAX_NUM_WINS, state, shards, LR), 2)
    torch.use_deterministic_algorithms(True)
    try:
        one_proc = W.sgd_step(port, batch, LR)
    finally:
        torch.use_deterministic_algorithms(False)

    tx = optax.sgd(LR)
    jm2 = j_build(model_cfg=cfg.MODEL, num_class=3,
                  class_names=list(cfg.CLASS_NAMES), grid_size=grid,
                  voxel_size=vs, point_cloud_range=pcr, batch_size=2,
                  max_voxels=SLOTS, max_points_per_voxel=5)

    def loss_fn(params):
        out, _ = jm2.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, batch,
                           train=True, rngs={"dropout": jax.random.PRNGKey(7)},
                           mutable=["batch_stats"])
        return out["loss"]

    g = jax.jit(jax.grad(loss_fn))(variables["params"])
    jax_one = jax.device_get(optax.apply_updates(
        variables["params"], tx.update(g, tx.init(variables["params"]))[0]))
    step = make_sharded_train_step(jm, tx, mesh)
    p, bs, _, loss, tb = step(variables["params"], variables["batch_stats"],
                              tx.init(variables["params"]), sharded,
                              jax.random.PRNGKey(7))
    jax_run = dict(loss=float(loss), params=jax.device_get(p),
                   stats=jax.device_get(bs),
                   tb={k: float(v) for k, v in jax.device_get(tb).items()},
                   one_params=jax_one)
    mp.undo()
    yield dict(ranks=ranks, one=one_proc, jax=jax_run,
               params0=variables["params"])


def test_two_rank_step_equals_one_process_step(runs):
    """Two gloo ranks of one frame each against the one-process step on
    both frames: the loss (the ranks' mean) to rtol 1e-5, and after one SGD
    step every parameter and every BatchNorm statistic per leaf to atol
    2e-5 / rtol 1e-3 (the JAX suite's DDP tolerance). The ranks hold
    bit-equal parameters and statistics (SyncBN), every parameter got a
    gradient (no ``find_unused_parameters``), and the averaging helpers
    give the ranks' means."""
    ranks, (loss1, tb1, p1, s1, no_grad1) = runs["ranks"], runs["one"]
    (la, tba, pa, sa, no_grad), (lb, tbb, pb, sb, _) = (
        r["step"] for r in ranks)
    assert no_grad == [] and no_grad1 == []
    assert la == lb and tba == tbb
    np.testing.assert_allclose(la, loss1, rtol=1e-5)
    for k in tb1:
        np.testing.assert_allclose(tba[k], tb1[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for got, other, want in ((pa, pb, p1), (sa, sb, s1)):
        got, other, want = _leaves(got), _leaves(other), _leaves(want)
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], other[k], err_msg=k)
            np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=1e-3,
                                       err_msg=k)
    for r in ranks:
        assert r["world"] == 2
        assert r["hosts"] == (0.5, (0.5, 5.0))
        assert r["ranks_mean"] == (0.5, 1.0)


def test_two_rank_step_matches_jax_sharded_step(runs):
    """The same two-rank port step against JAX's ``make_sharded_train_step``
    on a 2-device CPU mesh from bridged weights: the loss and ``tb_dict`` to
    rtol 1e-5, the updated BatchNorm statistics to 1e-5, and the gradients
    (the SGD update over the LR) to 2e-3 of their global norm. That is
    the end-to-end bound of the one-process gradients, not of the data
    parallelism: on these frames the port's one-process gradient lies 1.8e-3
    of the norm from JAX's one-device gradient (f32 noise flips ReLUs in the
    dense BEV tail, whose leaves differ most; ``test_torch_train.py`` holds
    that tail stage by stage), while each side's two-rank step lies within
    1e-4 of the norm from its own one-process step (the test above; JAX's
    sharded step measured 9e-5 from its one-device step)."""
    la, tba, pa, sa, _ = runs["ranks"][0]["step"]
    want = runs["jax"]
    np.testing.assert_allclose(la, want["loss"], rtol=1e-5)
    for k, v in want["tb"].items():
        np.testing.assert_allclose(tba[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    got_s, want_s = _leaves(sa), _leaves(want["stats"])
    assert set(got_s) == set(want_s)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    p0 = _leaves(runs["params0"])
    got_g = {k: (p0[k] - v) / LR for k, v in _leaves(pa).items()}
    want_g = {k: (p0[k] - v) / LR for k, v in _leaves(want["params"]).items()}
    assert set(got_g) == set(want_g)
    diff = np.sqrt(sum(((got_g[k] - w) ** 2).sum() for k, w in want_g.items()))
    norm = np.sqrt(sum((w ** 2).sum() for w in want_g.values()))
    assert 0 < diff <= 2e-3 * norm, (diff, norm)


def test_two_rank_gap_matches_jax_sharded_gap(runs):
    """The data-parallel part alone, per gradient leaf: what two ranks
    change against one process on the whole batch in the port (two gloo
    ranks minus the one-process step) is no larger than what they change
    in JAX (the sharded step minus the one-device step): within 1.5x of
    JAX's change plus 1e-5 of the leaf's gradient norm. Measured: each gap
    is at most 2.2e-4 of its leaf's norm and the port's within 1.0x of
    JAX's on every leaf, so a data-parallel fault in a few leaves (a missed
    all-reduce, a leaf scaled by the world size), which moves a leaf by the
    order of its own norm, shows here although it hides in the end-to-end
    bound above. The gaps are compared by size, not element for element:
    they are the same size and point opposite ways (correlation -0.98 on
    these frames), the mark of a discrete event such as activations near
    zero that land on the other side of it in the two implementations."""
    p0 = _leaves(runs["params0"])

    def grads(params):
        return {k: (p0[k] - v) / LR for k, v in _leaves(params).items()}

    port_two, port_one = grads(runs["ranks"][0]["step"][2]), grads(
        runs["one"][2])
    jax_two, jax_one = grads(runs["jax"]["params"]), grads(
        runs["jax"]["one_params"])
    assert set(port_two) == set(port_one) == set(jax_two) == set(jax_one)
    for k, g in jax_one.items():
        port_gap = np.linalg.norm(port_two[k] - port_one[k])
        jax_gap = np.linalg.norm(jax_two[k] - g)
        assert port_gap <= 1.5 * jax_gap + 1e-5 * np.linalg.norm(g), (
            k, port_gap, jax_gap)


def test_masked_batchnorm_syncs_sums_and_counts_over_unequal_ranks():
    """``MaskedBatchNorm`` under SyncBN on two gloo ranks holding 11 and 53
    valid rows (of 40 and 70): each rank's output rows and input
    cotangents, the ranks' summed scale/bias cotangents and both ranks'
    running statistics equal one process's on the concatenated rows (rtol
    1e-5: the same f32 sums, reduced in another order). The mean of the
    two ranks' means, what ``layers.BatchNorm`` syncs, would be off by far
    more here."""
    rng = np.random.default_rng(6)
    c, rows, live = 6, (40, 70), (11, 53)
    xs = [(rng.normal(size=(n, c)) * (1 + 2 * r) + r).astype(np.float32)
          for r, n in enumerate(rows)]
    valids = [rng.permutation(np.arange(n) < k) for n, k in zip(rows, live)]
    gs = [rng.normal(size=(n, c)).astype(np.float32) for n in rows]
    from mssvt_tpu_torch.models.model_utils.layers import MaskedBatchNorm

    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 2.0)
        bn.bias.normal_()
        bn.mean.normal_()
        bn.var.uniform_(0.5, 2.0)
    state = bn.state_dict()
    ranks = dist.launch_local(functools.partial(
        W.masked_bn_rank, state, xs, valids, gs), 2)
    one = W.masked_bn(state, np.concatenate(xs), np.concatenate(valids),
                      np.concatenate(gs))
    close = dict(rtol=1e-5, atol=1e-5)
    split = np.cumsum(rows)[:-1]
    for key in ("y", "dx"):
        for r, part in enumerate(np.split(one[key], split)):
            np.testing.assert_allclose(ranks[r][key], part, err_msg=key,
                                       **close)
    for key in ("dscale", "dbias"):
        np.testing.assert_allclose(ranks[0][key] + ranks[1][key], one[key],
                                   err_msg=key, **close)
    for key in ("mean", "var"):
        for r in range(2):
            np.testing.assert_allclose(ranks[r][key], one[key], err_msg=key,
                                       **close)
    means = [x[v].mean(0) for x, v in zip(xs, valids)]
    assert np.abs((means[0] + means[1]) / 2
                  - np.concatenate(xs)[np.concatenate(valids)].mean(0)).max() \
        > 0.1


def test_merge_result_parts_orders_twelve_ranks_by_integer_rank(tmp_path):
    """``part_10`` and ``part_11`` follow ``part_9``: frames come back in
    rank order from twelve parts, counts and recall summed, time the max."""
    import pickle

    from mssvt_tpu_torch.runtime.eval_utils import merge_result_parts

    for r in range(12):
        with open(tmp_path / f"part_{r}.pkl", "wb") as f:
            pickle.dump({"det": [{"rank": r}], "gt": [{"rank": r}],
                         "recall": {0.5: r}, "gt_total": 2, "n": 1,
                         "t": float(r % 5)}, f)
    det, gt, recall, gt_total, n, t = merge_result_parts(tmp_path, (0.5,))
    assert [d["rank"] for d in det] == list(range(12))
    assert [g["rank"] for g in gt] == list(range(12))
    assert recall == {0.5: sum(range(12))} and gt_total == 24 and n == 12
    assert t == 4.0


# ------------------------------------------------------------ entry points
def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_ddp_under_test", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``tools/train_torch.py --num_devices 2 --device cpu``: one epoch (2
    steps of 1 frame a rank), then two (it resumes at epoch 1); then
    ``tools/test_torch.py`` on checkpoint 2 with two ranks and with one
    process. The config is test_torch_cli.py's tiny one (4 frames)."""
    from test_torch_cli import _tiny_cfg

    root = tmp_path_factory.mktemp("ddp_cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("MSSVT_OUTPUT_ROOT", str(root / "output"))
    try:
        cfg_path = _tiny_cfg(root)
        train, test = _tool("train_torch"), _tool("test_torch")
        common = ["--cfg_file", str(cfg_path), "--batch_size", "2",
                  "--workers", "0", "--extra_tag", "ddp", "--device", "cpu"]
        first = train.main(common + ["--num_devices", "2", "--epochs", "1",
                                     "--fix_random_seed"])
        second = train.main(common + ["--num_devices", "2", "--epochs", "2",
                                      "--fix_random_seed"])
        two = test.main(common + ["--num_devices", "2", "--ckpt", "2"])
        one = test.main(common + ["--ckpt", "2"])
        yield dict(first=first, second=second, two=two, one=one)
    finally:
        mp.undo()


def test_train_cli_two_ranks_steps_checkpoints_and_resumes(cli):
    first, second = cli["first"], cli["second"]
    assert [r["world_size"] for r in first["ranks"]] == [2, 2]
    assert (first["start_epoch"], first["start_iter"]) == (0, 0)
    assert [len(r["history"]) for r in first["ranks"]] == [2, 2]
    # the loss is averaged over the ranks: both ranks log the same
    assert ([h["loss"] for h in first["ranks"][0]["history"]]
            == [h["loss"] for h in first["ranks"][1]["history"]])
    assert all(np.isfinite(h["loss"]) for h in first["history"])
    assert (second["start_epoch"], second["start_iter"]) == (1, 2)
    assert second["iterations"] == 4
    steps = sorted(int(p.stem.split("_")[1])
                   for p in first["ckpt_dir"].glob("checkpoint_*.pt"))
    assert steps == [1, 2]
    state = torch.load(first["ckpt_dir"] / "checkpoint_2.pt",
                       weights_only=False)
    assert not any(k.startswith("module.") for k in state["model"])
    logs = list(first["output_dir"].glob("log_train_*.txt"))
    assert len(logs) == 2  # rank 0 of each run writes one log


def test_test_cli_two_ranks_merge_equals_one_process(cli):
    """Two ranks of one frame a request, merged by rank 0, against one
    process of two frames a request: the same number of frames and
    ground-truth boxes, and every metric but the timing within 1e-6."""
    (step, two), = cli["two"].items()
    (_, one), = cli["one"].items()
    assert step == 2 and set(two) == set(one)
    for k in one:
        if k != "sec_per_example":
            np.testing.assert_allclose(two[k], one[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
