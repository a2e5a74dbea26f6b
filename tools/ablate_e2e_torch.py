"""Ablation harness of the port: attribute ms/frame to the MsSVT path's
mechanisms by stubbing one at a time (the counterpart of
``tools/ablate_e2e.py``).

    python tools/ablate_e2e_torch.py --ablate none|block|...|head
        [--all] [--train] [--tiny] [--batch 4] [--iters 12]
        [--device cuda|cpu]

Runs ``bench_torch.py``'s inference requests (each with a host readback of
``final_scores``; with ``--train``, its ``train_step``s with a loss
readback) with ONE mechanism stubbed by a stand-in of the same shapes,
patched into the port's modules for the cut's run only:

  none       nothing stubbed (the baseline)
  block      every MsSVTBlock returns its input (windowing, gather, FPS,
             attention, interpolation, write-back and FFN removed)
  ffn        K4, the fused residual LayerNorm FFN, returns its input
             (inference; training runs the plain chain, which stays)
  writeback  the inverse write-back returns the shortcut
  interp     the dense 3-NN interpolation weights are replayed
  attn       MixedScaleAttention (K3 in the blocks, the per-group path in
             the compress blocks; K5 in training) is replayed
  fps        the FPS key selection (K2) is replayed
  gather     gather_window_voxels (K1 and the index chain) is replayed
  compress   each MsSVTCompressBlock is replayed
  bev2d      the BaseBEVBackbone is replayed
  head       the CenterHead (its convolutions, decode and NMS) is replayed

A replayed mechanism returns, detached, the output that it gave at its
first call with the same inputs' shapes (or, for a module, at that
module's first call): the cut's untimed warm-up (one request or step on
each scene) records it. What follows the stub then runs on real-looking
values.

Eager PyTorch does not dead-code-eliminate. In the JAX tool XLA removes a
stubbed mechanism together with everything that only feeds it, so its
deltas attribute chains; here a stub removes its own work only, and
``ms(none) - ms(cut)`` attributes the mechanism itself. In training a
replayed mechanism passes no gradient back (the head's stand-in keeps a
zero-weighted link to its input, so that the backward still runs).

Each cut prints one JSON line, ``{"ablate", "ms_per_frame", "launches"}``
(``train_ms_per_frame`` with ``--train``): ``launches`` are the kernel
launches of its timed loop (``kernels.launch_counts()``), which show that
the cut removed what it names (``attn``: no ``attention``, ``fps``: no
``fps``, ``gather``: no ``fill``). ``--all`` runs every cut and prints the
deltas.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ALL = ["none", "block", "ffn", "writeback", "interp", "attn", "fps",
       "gather", "compress", "bev2d", "head"]


def _detach(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_detach(v) for v in x)
    if hasattr(x, "with_features"):  # SparseVoxels
        return x.with_features(x.features.detach())
    return x


def _signature(x):
    """A key for a call's inputs: tensors by shape and dtype, containers
    element by element, other values by value (or identity)."""
    import torch

    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    try:
        hash(x)
        return x
    except TypeError:
        return ("id", id(x))


def replay(fn, method=False):
    """Stand-in for ``fn``: its first call for a key runs ``fn`` and keeps
    the output, detached; every call with that key returns it. The key is
    the module (``method``) or the call's signature."""
    seen = {}

    def stub(*args, **kwargs):
        key = id(args[0]) if method else _signature((args, kwargs))
        if key not in seen:
            seen[key] = _detach(fn(*args, **kwargs))
        return seen[key]
    return stub


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def cut(name):
    """A context manager applying the named ablation."""
    from mssvt_tpu_torch.kernels import ffn
    from mssvt_tpu_torch.models.backbones_2d import base_bev_backbone
    from mssvt_tpu_torch.models.backbones_3d import mssvt as M
    from mssvt_tpu_torch.models.dense_heads import center_head
    from mssvt_tpu_torch.models.model_utils import attention
    from mssvt_tpu_torch.runtime.mechanisms import FUNCTIONS

    if name == "none":
        return contextlib.nullcontext()
    if name == "block":
        return _patched(M.MsSVTBlock, "forward",
                        lambda self, sp, generator=None: sp)
    if name == "ffn":
        return _patched(ffn, "fused_residual_ffn", lambda x, *a, **k: x)
    if name == "writeback":
        return _patched(M, FUNCTIONS[name],
                        lambda upd_fea, shortcut, *a, **k: shortcut)
    if name in FUNCTIONS:
        return _patched(M, FUNCTIONS[name],
                        replay(getattr(M, FUNCTIONS[name])))
    modules = {"attn": attention.MixedScaleAttention,
               "compress": M.MsSVTCompressBlock,
               "bev2d": base_bev_backbone.BaseBEVBackbone}
    if name in modules:
        cls = modules[name]
        return _patched(cls, "forward", replay(cls.forward, method=True))
    if name == "head":
        head = center_head.CenterHead
        preds = replay(head.forward, method=True)

        def forward(self, x):
            out = preds(self, x)
            if not self.training:
                return out
            # keep the backward alive through the rest of the model
            link = x.reshape(-1)[0] * 0
            return [{k: v + link.to(v.dtype) for k, v in d.items()}
                    for d in out]
        stack = contextlib.ExitStack()
        stack.enter_context(_patched(head, "forward", forward))
        stack.enter_context(_patched(
            head, "generate_predicted_boxes",
            replay(head.generate_predicted_boxes, method=True)))
        return stack
    raise SystemExit(f"unknown ablation {name!r}")


def setup(batch_size=4, tiny=False, train=False, device="cuda"):
    """(cfg, model, scenes, batch, device): ``bench_torch.py``'s model and
    scenes, shared by every cut of a run."""
    import bench_torch

    args = bench_torch.parse_args(
        ["--batch", str(batch_size), "--device", device]
        + (["--tiny"] if tiny else []))
    cfg, model, (grid, max_voxels), batch, dev = bench_torch.setup(args)
    scenes, _ = bench_torch.make_scenes(grid, max_voxels, batch, dev,
                                        with_gt=train)
    return cfg, model, scenes, batch, dev


def measure(ablate, run, n_iter=12):
    """ms a frame of the cut's timed loop; prints its JSON line."""
    import torch

    from mssvt_tpu_torch import kernels
    from mssvt_tpu_torch.runtime.optimization import build_optimizer
    from mssvt_tpu_torch.runtime.train_utils import train_step

    cfg, model, scenes, batch, dev, train = run
    if train:
        optimizer, _ = build_optimizer(cfg.OPTIMIZATION,
                                       model.named_parameters(),
                                       total_steps=1000, steps_per_epoch=100)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step(scene):
            return float(train_step(model, optimizer, scene, gen)[0])
    else:
        def step(scene):
            with torch.no_grad():
                return float(model(scene)["final_scores"].cpu().sum())

    # the backbone's CUDA graphs hold the code they captured: capture anew
    # under the cut (its warm-up), and again after it
    model.backbone_3d.graph.clear()
    with cut(ablate):
        t0 = time.perf_counter()
        for s in scenes:  # warm-up: records the replayed outputs
            step(s)
        print(f"# [{ablate}] warm-up: {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(n_iter):
            step(scenes[i % len(scenes)])
        ms = (time.perf_counter() - t0) / n_iter / batch * 1e3
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
    model.backbone_3d.graph.clear()
    key = "train_ms_per_frame" if train else "ms_per_frame"
    print(json.dumps({"ablate": ablate, key: round(ms, 4),
                      "launches": launches}), flush=True)
    return ms, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ablate", default="none", choices=ALL)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--tiny", action="store_true",
                    help="mssvt_tiny.yaml (CPU rehearsals)")
    ap.add_argument("--train", action="store_true",
                    help="ablate the training step (forward, backward, "
                         "optimizer)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = ALL if args.all else [args.ablate]
    run = (*setup(args.batch, args.tiny, args.train, args.device), args.train)
    results = {name: measure(name, run, args.iters) for name in names}
    if args.all:
        base = results["none"][0]
        print("# --- attribution (ms/frame deltas vs none) ---",
              file=sys.stderr)
        for name in ALL[1:]:
            print(f"# {name:>10}: {base - results[name][0]:+8.3f}",
                  file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
