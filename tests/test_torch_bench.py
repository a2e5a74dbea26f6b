"""The port's bench and its tools on the CPU: ``bench_torch.py``'s scenes
against ``bench.py``'s, the golden convergence scene against
``__graft_entry__``'s, the bench's JSON line on the tiny model, the FLOP
counting of ``kernels/work.py``, ``tools/profile_top_ops_torch.py`` on a
trace that ``torch.profiler`` wrote here, and every cut of
``tools/ablate_e2e_torch.py`` on the tiny model."""

import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402  (imports JAX only inside its functions)
import bench_torch  # noqa: E402
from mssvt_tpu_torch.datasets import synthetic_scene  # noqa: E402
from mssvt_tpu_torch.kernels import (  # noqa: E402
    attention,
    attention_qk,
    attention_qk_bwd,
    ffn,
    fill,
    fps,
    work,
)
from mssvt_tpu_torch.runtime import convergence  # noqa: E402

torch.set_num_threads(2)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- inputs
@pytest.mark.parametrize("max_voxels,grid,seed,batch", [
    (360_000, (480, 480, 32), 0, 4),   # the bench scene, seed 0
    (360_000, (480, 480, 32), 3, 4),   # ... and the last of its four
    (90_000, (480, 480, 32), 1, 1),    # --batch1
    (8_192, (48, 48, 8), 2, 4),        # --tiny
])
def test_bench_scenes_equal_bench_py(max_voxels, grid, seed, batch):
    got, n_got = synthetic_scene.make_waymo_scale_scene(
        max_voxels, grid, seed=seed, batch=batch)
    want, n_want = bench.make_waymo_scale_scene(
        max_voxels, grid, seed=seed, batch=batch)
    assert n_got == n_want and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for s in range(4):
        np.testing.assert_array_equal(
            synthetic_scene.add_synth_gt({}, batch, seed=s)["gt_boxes"],
            bench.add_synth_gt({}, batch, seed=s)["gt_boxes"])


def test_golden_config_and_batch_equal_graft_entry():
    import __graft_entry__ as graft

    assert (convergence.GRID, convergence.VOXEL_SIZE, convergence.PC_RANGE,
            convergence.MAX_PTS, convergence.MAX_GT) == (
        graft.GRID, graft.VOXEL_SIZE, graft.PC_RANGE, graft.MAX_PTS,
        graft.MAX_GT)
    assert json.dumps(convergence.model_cfg(), sort_keys=True) == \
        json.dumps(graft._model_cfg(), sort_keys=True)
    for args in ((1, convergence.MAX_VOXELS, convergence.SCENE_SEED),
                 (2, 512, 0)):
        got, want = convergence.make_batch(*args), graft._make_batch(*args)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------- the bench
INFERENCE_KEYS = {"metric", "value", "unit", "mfu", "sync_ms_per_frame",
                  "sync_ms_per_frame_median", "device"}
TRAIN_KEYS = {"train_ms_per_step", "train_ms_per_frame", "train_compile_s"}


def _bench_line(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench_torch.main(argv) == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("mode", ["--no-train", "--train"])
def test_bench_torch_tiny_cpu_prints_one_line(mode, tmp_path):
    """One parseable JSON line with bench.py's names; off the card ``mfu``
    is null (no device peak applies) and ``device`` says ``cpu``. The
    ``--profile`` traces are read by profile_top_ops_torch."""
    out = _bench_line(["--tiny", "--device", "cpu", mode,
                       "--profile", str(tmp_path)])
    if mode == "--train":
        assert set(out) == {"metric", "value", "unit", "device"} | TRAIN_KEYS
        assert out["metric"] == "train_step_ms_single_chip_batch4"
        assert out["value"] == out["train_ms_per_step"] > 0
        assert out["unit"] == "ms/step"
        trace = tmp_path / "train_steps.json"
    else:
        assert set(out) == INFERENCE_KEYS
        assert out["metric"] == "e2e_inference_fps_single_chip"
        assert out["unit"] == "frames/sec" and out["value"] > 0
        assert out["mfu"] is None
        assert 0 < out["sync_ms_per_frame_median"]
        trace = tmp_path / "requests.json"
    assert out["device"] == "cpu"
    buf = io.StringIO()
    with redirect_stdout(buf):
        _tool("profile_top_ops_torch").main([str(trace), "--host",
                                             "--n", "5"])
    text = buf.getvalue()
    assert "device busy 0.000" in text and "aten::" in text


def test_bench_torch_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_torch.main(["--tiny", "--no-train"])


# ------------------------------------------------------------ counting
def _flop_counter(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def test_ffn_count_equals_flop_counter_of_its_plain_version():
    g = torch.Generator().manual_seed(0)
    v, c, f = 37, 64, 128
    args = (torch.randn(v, c, generator=g), torch.ones(c), torch.zeros(c),
            torch.randn(c, f, generator=g), torch.zeros(f),
            torch.randn(f, c, generator=g), torch.zeros(c))
    assert work.ffn(*args).flops == _flop_counter(
        lambda: ffn.ffn_plain(*args)) == 4 * v * c * f


def _asm_inputs(nw, q_prefix, pad, g):
    n1cap, nk1, nk2, nq, d = 12, 8, 8, 6, 32
    r = lambda *s: torch.randn(*s, generator=g)
    proj = tuple(r(*s) for s in [(d, d), (d,)] * 4)
    args = (r(nw, n1cap, d), r(nw, nk2, d),
            torch.randint(0, n1cap, (nw, nk1), generator=g,
                          dtype=torch.int32),
            torch.rand(nw, nk1, generator=g) < 0.2,
            None if q_prefix else r(nw, nq, d), torch.ones(nw, nq),
            tuple(r(nw, nk1 + nk2) for _ in range(3)),
            tuple(r(nw, nq) for _ in range(3)), r(nw, d), r(3, d), proj,
            torch.zeros(nw, nk1 + nk2))
    kw = dict(num_heads=(4,), scale=0.25, q_prefix=q_prefix, nq=nq,
              pad_row=r(nw, d) if pad else None,
              num_valid=torch.tensor(nw))
    return args, kw, (n1cap, nk1, nk2, nq, d)


@pytest.mark.parametrize("q_prefix,pad", [(True, True), (False, False)])
def test_attention_counts_match_flop_counter_at_all_windows_live(q_prefix,
                                                                pad):
    """K3, K5, K6 and K7 at one head group (so the block-diagonal
    projections the formulas count are the plain versions' dense ones) and
    every window live (the plain versions compute all of them). K3, K6 and
    K7: equal. K5: the plain version also computes two sets of products
    the kernel does as a scatter and as FMAs, so its count exceeds the
    formula's by exactly those: the one-hot product that scatters the
    picks' cotangents into win1 (NW x n1cap x nk1 x D multiply-adds) and
    the three position-weight products (NW x 3 x (nk_tot + nq) x D). The
    tolerance is that difference, counted, and nothing else."""
    g = torch.Generator().manual_seed(1)
    nw = 5
    args, kw, (n1cap, nk1, nk2, nq, d) = _asm_inputs(nw, q_prefix, pad, g)
    assert work.attention(*args, **kw).flops == _flop_counter(
        lambda: attention.attention_plain(*args, **kw)) > 0
    gout = torch.randn(nw, nq, d, generator=g)
    extra = 2 * nw * (n1cap * nk1 * d + 3 * (nk1 + nk2 + nq) * d)
    plain = _flop_counter(
        lambda: attention.attention_bwd_plain(*args, gout, **kw))
    assert plain - work.attention_bwd(*args, gout, **kw).flops == extra
    assert extra / plain < 0.05  # the scatter and FMA share at this layout
    qk = (torch.randn(nw, nq, d, generator=g),
          torch.randn(nw, nk1 + nk2, d, generator=g), args[10],
          torch.zeros(nw, nk1 + nk2))
    qkw = dict(num_heads=(4,), scale=0.25)
    assert work.attention_qk(*qk, **qkw).flops == _flop_counter(
        lambda: attention_qk.attention_qk_plain(*qk, **qkw))
    assert work.attention_qk_bwd(*qk, gout, **qkw).flops == _flop_counter(
        lambda: attention_qk_bwd.attention_qk_bwd_plain(*qk, gout, **qkw))


def test_live_windows_only_are_counted():
    g = torch.Generator().manual_seed(2)
    args, kw, _ = _asm_inputs(6, True, True, g)
    full = work.attention(*args, **kw).flops
    kw["num_valid"] = torch.tensor(2)
    assert work.attention(*args, **kw).flops * 3 == full
    gout = torch.randn(6, 6, 32, generator=g)
    gout[4:] = 0
    qk = (torch.randn(6, 6, 32, generator=g), torch.randn(6, 16, 32,
                                                           generator=g),
          args[10], torch.zeros(6, 16))
    qkw = dict(num_heads=(4,), scale=0.25)
    assert work.live_windows(gout) == 4
    assert work.attention_qk_bwd(*qk, gout, **qkw).flops * 6 == \
        work.attention_qk_bwd(*qk, torch.ones_like(gout), **qkw).flops * 4


PLAIN = ((fill, "fill_plain"), (fps, "fps_plain"),
         (attention, "attention_plain"), (attention, "attention_bwd_plain"),
         (ffn, "ffn_plain"))


def _tiny_run(model, scene, train):
    if train:
        gen = torch.Generator().manual_seed(0)
        model.train()
        model(scene, generator=gen)["loss"].backward()
        model.eval()
        model.zero_grad()
    else:
        with torch.no_grad():
            model(scene)


@pytest.mark.parametrize("train", [False, True])
def test_count_is_the_same_with_the_plain_versions_or_their_formulas(
        train, monkeypatch):
    """A tiny forward (and, in training, its backward with K5) counted with
    the plain versions running, and again with each plain version replaced
    by a replay of its recorded output (no aten work, as a kernel does):
    the same FLOPs by kernel and in aten, so the plain versions' inner
    products are not counted twice."""
    args = bench_torch.parse_args(["--tiny", "--device", "cpu",
                                   "--batch", "2"])
    _, model, (grid, max_voxels), batch, dev = bench_torch.setup(args)
    scene = bench_torch.make_scenes(grid, max_voxels, batch, dev,
                                    with_gt=train)[0][0]
    recorded = []
    for mod, name in PLAIN:
        real = getattr(mod, name)

        def rec(*a, _real=real, **k):
            out = _real(*a, **k)
            recorded.append(out)
            return out
        monkeypatch.setattr(mod, name, rec)
    _tiny_run(model, scene, train)
    monkeypatch.undo()
    assert len(recorded) >= 4
    with work.counting() as plain:
        _tiny_run(model, scene, train)
    queue = list(recorded)
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, lambda *a, **k: queue.pop(0))
    with work.counting() as formula:
        _tiny_run(model, scene, train)
    assert not queue
    assert plain.kernels == formula.kernels
    assert plain.aten_flops() == formula.aten_flops() > 0
    want = {"attention", "attention_bwd"} if train else {"attention", "ffn"}
    assert want <= {k for k, v in plain.kernels.items() if v > 0}
    assert plain.total() == plain.kernel_flops() + plain.aten_flops()


def test_counting_context_does_not_nest():
    with work.counting():
        with pytest.raises(RuntimeError, match="already open"):
            with work.counting():
                pass


# ------------------------------------------------------ profile reader
def test_profile_top_ops_reads_a_cpu_trace(tmp_path):
    """A trace written by torch.profiler on the CPU, with device events
    appended in the CUDA trace's form: host tables from the real events,
    device sums, families and busy share from the appended ones."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            a = torch.relu(a @ a)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    spans = [e for e in data["traceEvents"] if e.get("ph") == "X"]
    t0 = min(e["ts"] for e in spans)
    window = max(e["ts"] + e["dur"] for e in spans) - t0
    kernels = [  # (name, start offset us, duration us)
        ("void fill_kernel<2>(FillArgs)", 0.0, 10.0),
        ("void attention_kernel<__nv_bfloat16>(Args, Layout)", 5.0, 20.0),
        ("void attention_qk_kernel<float>(QkArgs, Layout)", 40.0, 4.0),
        ("void wgrad_wgmma_kernel(WArgs)", 50.0, 2.0),
        ("nvjet_tst_64x8_64x16_1x1_v_bz_NNT", 60.0, 3.0),
        ("void at::native::vectorized_elementwise_kernel<4>()", 70.0, 1.0),
    ]
    for name, off, dur in kernels:
        data["traceEvents"].append({"ph": "X", "cat": "kernel", "name": name,
                                    "pid": 0, "tid": 7, "ts": t0 + off,
                                    "dur": dur})
    data["traceEvents"].append({"ph": "X", "cat": "gpu_memcpy",
                                "name": "Memcpy DtoH (Device -> Pinned)",
                                "pid": 0, "tid": 7, "ts": t0 + 80.0,
                                "dur": 2.0})
    path.write_text(json.dumps(data))
    tool = _tool("profile_top_ops_torch")
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = tool.main([str(path), "--group"])
        tool.main([str(path), "--host", "--match", "mm"])
    totals, busy, win = res[str(path)]
    assert dict(totals) == pytest.approx({
        "K1 fill": 0.010, "K3 attention": 0.020, "K6 attention_qk": 0.004,
        "K5/K7 weight product and sums": 0.002, "cuBLAS GEMM": 0.003,
        "elementwise": 0.001, "memcpy": 0.002})
    # 0-25 us overlap into one interval; the others are apart
    assert busy == pytest.approx((25 + 4 + 2 + 3 + 1 + 2) / 1e3)
    assert win == pytest.approx(max(window, 82.0) / 1e3)
    text = buf.getvalue()
    assert "aten::mm" in text and "device busy 0.037" in text


# ----------------------------------------------------------- ablations
ABLATE = _tool("ablate_e2e_torch")


@pytest.fixture(scope="module")
def tiny_runs():
    return {train: (*ABLATE.setup(2, tiny=True, train=train, device="cpu"),
                    train) for train in (False, True)}


@pytest.mark.parametrize("name", ABLATE.ALL)
def test_every_ablation_cut_runs_on_the_tiny_model(name, tiny_runs):
    """Each cut patches and restores the port's modules and times its loop;
    on the CPU no kernel launches (the plain versions run)."""
    from mssvt_tpu_torch.models.backbones_3d import mssvt as M

    before = (M.gather_window_voxels, M.MsSVTBlock.forward,
              ffn.fused_residual_ffn)
    ms, launches = ABLATE.measure(name, tiny_runs[False], n_iter=1)
    assert ms > 0 and launches == {}
    assert (M.gather_window_voxels, M.MsSVTBlock.forward,
            ffn.fused_residual_ffn) == before


@pytest.mark.parametrize("name", ["attn", "head", "gather"])
def test_ablation_cuts_train(name, tiny_runs):
    ms, _ = ABLATE.measure(name, tiny_runs[True], n_iter=1)
    assert ms > 0


def test_ablation_cut_removes_its_mechanism(tiny_runs, monkeypatch):
    """Under a cut the stubbed function runs at the warm-up only (once per
    signature), never in the timed loop."""
    from mssvt_tpu_torch.models.backbones_3d import mssvt as M

    calls = []
    real = M.farthest_point_sample_planes_select

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(M, "farthest_point_sample_planes_select", counted)
    ABLATE.measure("fps", tiny_runs[False], n_iter=3)
    first = len(calls)  # the warm-up's calls: one a block and signature
    assert 0 < first <= 2
    calls.clear()
    ABLATE.measure("none", tiny_runs[False], n_iter=3)
    assert len(calls) == 2 * (3 + len(tiny_runs[False][2]))


def test_attention_microbench_rehearses_on_the_cpu():
    """The K3 microbench at a small --nw: its check against the plain
    version on the first windows (the wrapper takes the plain version for
    CPU tensors) and its bound, work.py's K3 formula at its inputs."""
    tool = _tool("bench_attn_kernel_torch")
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = tool.main(["--device", "cpu", "--nw", "40", "--nv", "30",
                         "--iters", "1"])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == res
    win1s, rest, kw = tool.make_inputs(40, 30, torch.device("cpu"))
    assert (res["bound_ms"], res["bound_by"]) == \
        work.attention(win1s[0], *rest, **kw).bound()
    assert res["max_abs_err"] == 0.0 and res["nv"] == 30
    # the projections are block-diagonal over the head groups, as the
    # model's folded projections are (the kernel reads those blocks only)
    wq = rest[9][0]
    assert not wq[:64, 64:].any() and not wq[64:, :64].any()
