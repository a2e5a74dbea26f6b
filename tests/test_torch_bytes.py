"""The byte side of ``kernels/work.py``'s counting on the CPU: a hand-counted
op chain, views, the device filter, in-place ops and scatters, parity with
``tools/hlo_bytes.py``'s rule on a hand-written HLO module of the same ops,
the tiny model's request and training step counted with the plain versions
and with replays of them, the backward's charges, the mechanism keys,
``tools/dump_ops_torch.py``'s log read back by ``tools/op_bytes_torch.py
--log``, and ``bench_torch.py``'s byte keys."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
from mssvt_tpu_torch.kernels import (  # noqa: E402
    attention,
    ffn,
    fill,
    fps,
    work,
)
from mssvt_tpu_torch.runtime.optimization import build_optimizer  # noqa: E402
from mssvt_tpu_torch.runtime.train_utils import train_step  # noqa: E402

torch.set_num_threads(2)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _charges(fn, device="cpu"):
    """(op name, bytes) of each charge made while ``fn`` ran."""
    with work.counting(device, log=True) as tally:
        fn()
    assert sum(op[4] for op in tally.ops) == tally.total_bytes()
    return [(op[1], op[4]) for op in tally.ops]


# ------------------------------------------------------------ the rules
def test_hand_counted_chain():
    """mm, an elementwise op on one tensor twice, a view, a gather by
    index and an accumulating in-place ``index_add_``, in f32."""
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    idx = torch.tensor([3, 1, 5, 7, 2])
    acc = torch.zeros(8, 64)
    out = {}

    def chain():
        y = a @ b
        z = y + y
        v = z.view(16, 64)
        g = v[idx]
        acc.index_add_(0, idx, g)
        out["g"] = g

    assert _charges(chain) == [
        ("aten.mm.default", (64 * 32 + 32 * 16 + 64 * 16) * 4),
        ("aten.add.Tensor", (64 * 16 + 64 * 16) * 4),   # y read once
        ("aten.view.default", 0),
        # the index and the 5 picked rows read, the 5 rows written
        ("aten.index.Tensor", 5 * 8 + 2 * 5 * 64 * 4),
        # index, the values, the 5 rows written and (accumulating) read
        ("aten.index_add_.default", 5 * 8 + 5 * 64 * 4 + 2 * 5 * 64 * 4)]
    torch.testing.assert_close(acc[idx], out["g"], rtol=0, atol=0)


VIEWS = {
    "view": lambda x: x.view(4, 12),
    "reshape as a view": lambda x: x.reshape(48),
    "expand": lambda x: x[:1].expand(8, 6),
    "permute": lambda x: x.permute(1, 0),
    "transpose": lambda x: x.transpose(0, 1),
    "t": lambda x: x.t(),
    "slice": lambda x: x[2:5],
    "select": lambda x: x[3],
    "as_strided": lambda x: x.as_strided((3, 3), (6, 1)),
    "squeeze": lambda x: x[None].squeeze(0),
    "unsqueeze": lambda x: x.unsqueeze(1),
    "alias": lambda x: torch.ops.aten.alias(x),
    "detach": lambda x: x.detach(),
    "_unsafe_view": lambda x: torch.ops.aten._unsafe_view(x, (48,)),
    "squeeze_ (in-place view)": lambda x: x.clone()[None].squeeze_(0),
    "unbind": lambda x: x.unbind(0),
    "empty": lambda x: torch.empty(100, 100),
    "empty_like": lambda x: torch.empty_like(x),
}


@pytest.mark.parametrize("name", sorted(VIEWS))
def test_views_and_empty_cost_nothing(name):
    x = torch.randn(8, 6)
    charges = _charges(lambda: VIEWS[name](x))
    # the clone that makes squeeze_'s operand is the one charge
    want = [("aten.clone.default", 2 * 48 * 4)] if "squeeze_" in name else []
    assert [c for c in charges if c[1]] == want, charges
    assert charges, "no op was dispatched"


def test_reshape_of_a_transpose_charges_its_copy_once():
    """``reshape`` of a non-contiguous tensor is a copy, then
    ``_unsafe_view`` of it, which shares the copy's storage: one copy."""
    x = torch.randn(8, 6)
    assert [c for c in _charges(lambda: x.t().reshape(48)) if c[1]] == [
        ("aten.clone.default", 2 * 48 * 4)]


def test_fills_charge_their_output_and_broadcasts_their_elements():
    x = torch.randn(8, 6)
    bias = torch.randn(6)
    charges = _charges(lambda: (torch.zeros(10, 10), torch.full((5,), 2.0),
                                x.fill_(1.0), x + bias.expand(8, 6)))
    assert [c for c in charges if c[1]] == [
        ("aten.zeros.default", 400), ("aten.full.default", 20),
        ("aten.fill_.Scalar", 8 * 6 * 4),
        # the broadcast operand's 6 elements read once
        ("aten.add.Tensor", (48 + 6 + 48) * 4)]


def test_only_the_counting_device_counts():
    """A copy onto the counting device is charged its write there alone
    (``meta`` stands for the card here); a CPU-to-CPU copy is charged in
    and out; counting another device charges CPU work nothing."""
    x = torch.randn(100, 10)
    assert _charges(lambda: x.to("meta"), "meta") == [
        ("aten._to_copy.default", 4000)]
    assert _charges(lambda: x.to(torch.float64)) == [
        ("aten._to_copy.default", 4000 + 8000)]
    assert _charges(lambda: x.to(torch.float64), "cuda") == [
        ("aten._to_copy.default", 0)]


def test_in_place_and_out_ops():
    """``add_`` reads its destination and operand and writes the
    destination once; ``copy_`` and an ``out=`` argument are not read."""
    x, y = torch.randn(10, 10), torch.randn(10, 10)
    out = torch.empty(10, 10)
    assert _charges(lambda: x.add_(y)) == [("aten.add_.Tensor", 3 * 400)]
    assert _charges(lambda: x.add_(x)) == [("aten.add_.Tensor", 2 * 400)]
    assert _charges(lambda: x.copy_(y)) == [("aten.copy_.default", 800)]
    assert _charges(lambda: torch.add(x, y, out=out)) == [
        ("aten.add.out", 3 * 400)]
    assert _charges(lambda: float(x.sum())) == [
        ("aten.sum.default", 404), ("aten._local_scalar_dense.default", 4)]


@pytest.mark.parametrize("case", ["put", "put accumulate", "put mask",
                                  "scatter_add_", "scatter_ value",
                                  "index_copy_", "out-of-place put"])
def test_scatters_charge_what_their_indices_touch(case):
    dest = torch.zeros(100, 8)
    idx = torch.tensor([4, 9, 9, 30])
    vals = torch.randn(4, 8)
    row = 8 * 4
    if case == "put":
        fn, want = lambda: dest.index_put_((idx,), vals), \
            ("aten.index_put_.default", 32 + 4 * row + 4 * row)
    elif case == "put accumulate":
        fn, want = lambda: dest.index_put_((idx,), vals, accumulate=True), \
            ("aten.index_put_.default", 32 + 4 * row + 2 * 4 * row)
    elif case == "put mask":  # a scalar into the 3 true rows
        mask = torch.zeros(100, dtype=torch.bool)
        mask[[1, 5, 7]] = True
        two = torch.tensor(2.0)
        fn, want = lambda: dest.index_put_((mask,), two), \
            ("aten.index_put_.default", 100 + 4 + 3 * row)
    elif case == "scatter_add_":
        ix = idx[:, None].expand(4, 8)
        fn, want = lambda: dest.scatter_add_(0, ix, vals), \
            ("aten.scatter_add_.default", 32 + 4 * row + 2 * 4 * row)
    elif case == "scatter_ value":
        ix = torch.tensor([[1], [2]])
        fn, want = lambda: dest.scatter_(1, ix, 3.0), \
            ("aten.scatter_.value", 16 + 2 * 4)
    elif case == "index_copy_":
        at = torch.tensor([0, 3, 6, 99])
        fn, want = lambda: dest.index_copy_(0, at, vals), \
            ("aten.index_copy_.default", 32 + 4 * row + 4 * row)
    else:  # a full copy of the destination, then the write
        fn, want = lambda: dest.index_put((idx,), vals), \
            ("aten.index_put.default", 100 * row + 32 + 4 * row + 100 * row)
    assert _charges(fn) == [want]


# ------------------------------------------------- parity with hlo_bytes
HLO_CHAIN = """HloModule chain

ENTRY %main (a: f32[500,500], b: f32[500,500]) -> f64[250000] {
  %a = f32[500,500]{1,0} parameter(0)
  %b = f32[500,500]{1,0} parameter(1)
  %y = f32[500,500]{1,0} dot(f32[500,500]{1,0} %a, f32[500,500]{1,0} %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(chain)/aten.mm.default"}
  %z = f32[500,500]{1,0} add(f32[500,500]{1,0} %y, f32[500,500]{1,0} %y), metadata={op_name="jit(chain)/aten.add.Tensor"}
  %v = f32[250000]{0} bitcast(f32[500,500]{1,0} %z)
  %w = f32[250000]{0} exponential(f32[250000]{0} %v), metadata={op_name="jit(chain)/aten.exp.default"}
  %t = (f32[250000]{0}, f32[250000]{0}) tuple(f32[250000]{0} %w, f32[250000]{0} %v)
  %e = f32[250000]{0} get-tuple-element((f32[250000]{0}, f32[250000]{0}) %t), index=0
  ROOT %d = f64[250000]{0} convert(f32[250000]{0} %e), metadata={op_name="jit(chain)/aten._to_copy.default"}
}
"""


def test_parity_with_hlo_bytes_analyze():
    """The same chain (a product, ``add(y, y)``, a view, ``exp``, a
    widening cast) as eager ops and as an HLO module: ``analyze`` and the
    port's counter give the same bytes per op and in total (each op a
    multiple of 1e6 bytes, so that analyze's printed GB are exact)."""
    hlo_bytes = _tool("hlo_bytes")
    buf = io.StringIO()
    with redirect_stdout(buf):
        hlo_bytes.analyze(HLO_CHAIN, False, 10)
    lines = buf.getvalue().splitlines()
    total = re.match(r"total materialized bytes .*: ([\d.]+) GB", lines[0])
    hlo = {}
    for line in lines[1:]:
        gb, _, key = line.split(None, 2)
        hlo[key.split("/", 1)[1]] = round(float(gb) * 1e9)
    a, b = torch.randn(500, 500), torch.randn(500, 500)

    def chain():
        y = a @ b
        z = y + y
        v = z.view(250000)
        w = v.exp()
        w.to(torch.float64)
    port = dict(c for c in _charges(chain) if c[1])
    assert port == hlo == {"aten.mm.default": 3_000_000,
                           "aten.add.Tensor": 2_000_000,
                           "aten.exp.default": 2_000_000,
                           "aten._to_copy.default": 3_000_000}
    assert float(total.group(1)) * 1e9 == sum(port.values())


# ------------------------------------------------------ the tiny model
PLAIN = ((fill, "fill_plain"), (fps, "fps_plain"),
         (attention, "attention_plain"), (attention, "attention_bwd_plain"),
         (ffn, "ffn_plain"))


def _tiny(train):
    """A fresh seeded tiny model, its optimizer and first scene."""
    args = bench_torch.parse_args(["--tiny", "--device", "cpu",
                                   "--batch", "2"])
    cfg, model, (grid, max_voxels), batch, dev = bench_torch.setup(args)
    scene = bench_torch.make_scenes(grid, max_voxels, batch, dev,
                                    with_gt=train)[0][0]
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model.named_parameters(),
                                   total_steps=1000, steps_per_epoch=100)
    return model, optimizer, scene


def _run(model, optimizer, scene, train):
    if train:
        train_step(model, optimizer, scene,
                   torch.Generator().manual_seed(0))
    else:
        with torch.no_grad():
            model(scene)


@pytest.mark.parametrize("train", [False, True])
def test_bytes_are_the_same_with_the_plain_versions_or_replays(
        train, monkeypatch):
    """A request (and a ``train_step`` with its backward, K5 and the
    optimizer) counted with the plain versions running, and again with
    each plain version replaced by a replay of its recorded output (no
    aten work, as a kernel does): the same bytes by kernel, the same aten
    bytes, and the same FLOPs."""
    recorded = []
    for mod, name in PLAIN:
        real = getattr(mod, name)

        def rec(*a, _real=real, **k):
            out = _real(*a, **k)
            recorded.append(out)
            return out
        monkeypatch.setattr(mod, name, rec)
    _run(*_tiny(train), train)
    monkeypatch.undo()
    with work.counting("cpu") as plain:
        _run(*_tiny(train), train)
    queue = list(recorded)
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, lambda *a, **k: queue.pop(0))
    with work.counting("cpu") as replayed:
        _run(*_tiny(train), train)
    assert not queue
    assert plain.kernel_bytes == replayed.kernel_bytes
    assert plain.aten_bytes() == replayed.aten_bytes() > 0
    assert plain.groups == replayed.groups
    assert (plain.kernels, plain.aten_flops()) == \
        (replayed.kernels, replayed.aten_flops())
    want = {"attention", "attention_bwd"} if train else {"attention", "ffn"}
    assert want <= {k for k, v in plain.kernel_bytes.items() if v > 0}


def test_backward_is_counted_and_keyed_by_its_forward():
    """A training step moves more than its forward; the backward's charges
    (K5 among them) carry ``[bwd]`` and the forward module's path."""
    model, optimizer, scene = _tiny(True)
    gen = torch.Generator().manual_seed(0)
    model.train()
    with work.counting("cpu") as fwd:
        model(scene, generator=gen)["loss"]
    assert fwd.backward_bytes == 0 and "attention_bwd" not in \
        fwd.kernel_bytes
    with work.counting("cpu") as step:
        train_step(model, optimizer, scene, torch.Generator().manual_seed(0))
    assert step.total_bytes() > fwd.total_bytes() + step.backward_bytes / 2
    assert step.kernel_bytes["attention_bwd"] > 0
    bwd_keys = [k for k in step.groups if k.startswith(work.BWD)]
    assert sum(step.groups[k] for k in bwd_keys) == step.backward_bytes
    assert step.backward_bytes > step.kernel_bytes["attention_bwd"]
    k5 = [k for k in bwd_keys if k.endswith("[attention_bwd]")]
    assert k5 and all("/ms_attn" in k for k in k5), k5
    assert not any(k.startswith(work.BWD + "Global") for k in bwd_keys)


@dataclasses.dataclass
class _Box:  # a dataclass between modules, as SparseVoxels is
    x: torch.Tensor


class _Inner(torch.nn.Module):
    def forward(self, x):
        return x * 2


class _Outer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = _Inner()

    def forward(self, box):
        return _Box(self.inner(box.x).exp())  # exp after the last submodule


class _Top(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a, self.b = _Outer(), _Outer()

    def forward(self, x):
        return self.b(self.a(_Box(x))).x.sum()


def test_backward_charges_land_on_the_module_that_made_them():
    """Each backward op takes the key of the forward code that made its
    autograd node: ``a``'s ``exp`` is ``a``'s though ``b`` ran after it
    and the modules pass a dataclass."""
    x = torch.randn(10, requires_grad=True)
    with work.counting("cpu", log=True) as tally:
        _Top()(x).backward()
    bwd = [(op[1], op[4], op[5]) for op in tally.ops
           if op[5].startswith(work.BWD) and op[4]]
    assert bwd == [("aten.mul.Tensor", 84, "[bwd] _Top/b"),  # exp's
                   ("aten.mul.Tensor", 80, "[bwd] _Top/b/inner"),
                   ("aten.mul.Tensor", 120, "[bwd] _Top/a"),
                   ("aten.mul.Tensor", 80, "[bwd] _Top/a/inner")]
    assert tally.backward_bytes == 84 + 80 + 120 + 80
    assert {op[5] for op in tally.ops if op[1] == "aten.exp.default"} == \
        {"_Top/a", "_Top/b"}


def test_groups_and_the_log_sum_to_the_total_with_scoped_mechanisms():
    """Every charge lands in one group and one log line; the four scoped
    functions and the kernels get keys of their own."""
    from mssvt_tpu_torch.runtime import mechanisms

    model, optimizer, scene = _tiny(False)
    with mechanisms.function_scopes(), \
            work.counting("cpu", log=True) as tally, torch.no_grad():
        model(scene)
    assert sum(tally.groups.values()) == tally.total_bytes() == \
        sum(op[4] for op in tally.ops) == \
        tally.aten_bytes() + sum(tally.kernel_bytes.values())
    assert sum(tally.group_ops.values()) == len(tally.ops)
    keys = " ".join(tally.groups)
    for name in mechanisms.FUNCTIONS.values():
        assert f"/{name}" in keys, name
    assert "gather_window_voxels [fill]" in keys
    assert "farthest_point_sample_planes_select [fps]" in keys
    assert "ms_attn [attention]" in keys
    from mssvt_tpu_torch.models.backbones_3d import mssvt as M
    assert M.gather_window_voxels.__module__ != work.__name__  # restored


def test_group_key_cuts_the_path_and_keeps_the_marks():
    assert work.group_key("CenterPoint/backbone_3d/blocks_0/ms_attn") == \
        "CenterPoint/backbone_3d/blocks_0"
    assert work.group_key("[bwd] CenterPoint/backbone_3d/blocks_0/ms_attn "
                          "[attention_bwd]", 2) == \
        "[bwd] CenterPoint/backbone_3d [attention_bwd]"
    assert work.group_key("Global") == "Global"


def test_flop_count_is_unchanged_with_the_byte_mode(monkeypatch):
    """The tiny request's FLOPs with the byte mode stacked on the FLOP
    counter are those counted without it."""
    model, optimizer, scene = _tiny(False)
    with work.counting("cpu") as stacked, torch.no_grad():
        model(scene)

    class Off(contextlib.nullcontext):
        def __init__(self, tally):
            super().__init__()
    monkeypatch.setattr(work, "_ByteMode", Off)
    with work.counting("cpu") as alone, torch.no_grad():
        model(scene)
    assert alone.aten_bytes() == 0 < stacked.aten_bytes()
    assert stacked.total() == alone.total() > 0
    assert stacked.kernels == alone.kernels


# ------------------------------------------------------------ the tools
def test_dump_ops_log_reads_back_to_the_same_total(tmp_path):
    dump, op_bytes = _tool("dump_ops_torch"), _tool("op_bytes_torch")
    path = tmp_path / "tiny.ops"
    buf = io.StringIO()
    with redirect_stdout(buf):
        tally = dump.main(["--tiny", "--device", "cpu", "--batch", "2",
                           "--out", str(path), "--map",
                           "aten::mm,attention,gather_window_voxels,nope"])
    text = buf.getvalue()
    assert "=== attention: " in text and "kernel:attention\t" in text
    assert "=== aten::mm: " in text and "aten.mm.default" in text
    assert "=== nope: not in the log" in text
    groups, ops, total, what = op_bytes.read_log(path)
    assert (total, what) == (tally.total_bytes(), "request")
    assert groups == tally.groups and ops == tally.group_ops
    buf = io.StringIO()
    with redirect_stdout(buf):
        op_bytes.main(["--log", str(path), "--group", "--n", "5"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == ("total materialized bytes (per request): "
                        f"{tally.total_bytes() / 1e9:.2f} GB")
    assert len(lines) == 6 and all(" GB  x" in ln for ln in lines[1:])


def test_op_bytes_counts_a_tiny_step():
    op_bytes = _tool("op_bytes_torch")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert op_bytes.main(["--tiny", "--device", "cpu", "--batch", "2",
                              "--train", "--n", "200"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("total materialized bytes (per step): ")
    keys = [ln.split(None, 3)[3] for ln in lines[1:]]
    assert "Global/optimizer" in keys
    assert any(k.startswith("[bwd] ") and k.endswith("[attention_bwd]")
               for k in keys)


def test_bench_torch_prints_its_byte_keys_on_the_cpu(monkeypatch):
    """``gb_per_frame`` is a count, printed on the CPU too; ``hbm_util``,
    a share of the card's rate, is null off the card (two timed requests
    of each kind keep the test short)."""
    monkeypatch.setattr(bench_torch, "SYNC_REQUESTS", 2)
    monkeypatch.setattr(bench_torch, "PIPELINED_REQUESTS", 2)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench_torch.main(["--tiny", "--device", "cpu",
                                 "--no-train"]) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["gb_per_frame"] > 0 and out["hbm_util"] is None
    assert out["mfu"] is None
