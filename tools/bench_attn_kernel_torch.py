"""Microbenchmark of K3, the assembled window attention, alone (the
counterpart of ``tools/bench_attn_kernel.py``).

    python tools/bench_attn_kernel_torch.py [--nw 96000] [--nv 53937]
        [--iters 30] [--device cuda|cpu]

Block-0 shapes of ``mssvt.yaml`` at batch 4: nw windows (96 000), n1cap 48,
nk1 = nk2 = 32, nq 32 (a prefix of win1), D 128, heads (2, 2), bf16, with
pad rows and the f32 projections, block-diagonal over the two head groups
as the model's are; seeded inputs made on the device.
``--nv`` is the live-window prefix the kernel computes (default 53 937,
block 0's live windows in the bench scene); pass ``--nv`` equal to ``--nw``
for the worst case. Each timed iteration calls the kernel on REPS distinct
win1 buffers (rolled copies), timed with CUDA events. Prints the first
call's seconds (the kernel build on a fresh checkout), ms a call, the
bound from ``kernels/work.py`` and a check against the plain version on
the first ``CHECK_WINDOWS`` windows (outputs after the query mask within
2^-5 of the largest magnitude, chip_smoke's bf16 tolerance), then one JSON
line. ``--device cpu`` rehearses it at a small ``--nw`` (the wrapper takes
the plain version, timed by the host clock).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REPS = 4  # distinct win1 buffers, each called once an iteration
CHECK_WINDOWS = 2048
BF16_TOL = 2.0 ** -5
N1CAP, NK1, NK2, NQ, D = 48, 32, 32, 32, 128
HEADS = (2, 2)


def make_inputs(nw, nv, device, seed=0):
    """(win1 buffers, the other positional inputs, keyword inputs)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def normal(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dtype)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=device)

    def block_diagonal(w):
        """The head groups' (D, D) weight: zero outside each group's
        diagonal block, as the model's folded projections are (the kernel
        reads those blocks only)."""
        keep = torch.zeros_like(w)
        s = 0
        for h in HEADS:
            n = D // sum(HEADS) * h
            keep[s:s + n, s:s + n] = 1
            s += n
        return w * keep

    base = normal(nw, N1CAP, D, dtype=bf)
    win1s = [torch.roll(base, 17 * r, dims=0) for r in range(REPS)]
    del base
    nkt = NK1 + NK2
    rest = (
        normal(nw, NK2, D, dtype=bf),                              # k2
        torch.randint(0, N1CAP, (nw, NK1), generator=g, device=device,
                      dtype=torch.int32),                          # fps1
        uniform(nw, NK1) < 0.1,                                    # k_mask1
        None,                                                      # q_ext
        (uniform(nw, NQ) < 0.9).float(),                           # q_keep
        tuple(normal(nw, nkt) for _ in range(3)),                  # k_rel
        tuple(normal(nw, NQ) for _ in range(3)),                   # q_rel
        normal(nw, D, dtype=bf),                                   # pos_base
        normal(3, D, dtype=bf),                                    # pos_w
        tuple(p for _ in range(4)
              for p in (block_diagonal(normal(D, D, scale=0.05)),
                        normal(D, scale=0.05))),
        torch.where(uniform(nw, nkt) < 0.1, -100.0, 0.0),          # key_bias
    )
    kw = dict(num_heads=HEADS, scale=0.125, q_prefix=True, nq=NQ,
              pad_row=normal(nw, D, dtype=bf),
              num_valid=torch.tensor(min(nv, nw), dtype=torch.int32,
                                     device=device))
    return win1s, rest, kw


PER_WINDOW = (0, 1, 2, 4, 5, 6, 7, 10)  # inputs of ``rest`` with NW rows


def window_slice(win1, rest, kw, n):
    """The same call on the first ``n`` windows."""
    import torch

    def head(x):
        return tuple(v[:n] for v in x) if isinstance(x, tuple) else x[:n]

    rest = tuple(head(x) if i in PER_WINDOW else x for i, x in enumerate(rest))
    kw = dict(kw, pad_row=kw["pad_row"][:n],
              num_valid=torch.clamp(kw["num_valid"], max=n))
    return win1[:n], rest, kw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nw", type=int, default=96_000)
    ap.add_argument("--nv", type=int, default=53_937)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from mssvt_tpu_torch.kernels import attention, work
    from mssvt_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    kernel = attention.fused_window_attention_assembled
    win1s, rest, kw = make_inputs(args.nw, args.nv, device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    out = kernel(win1s[0], *rest, **kw)
    sync()
    first_s = time.perf_counter() - t0

    n = min(CHECK_WINDOWS, args.nw)
    sw, srest, skw = window_slice(win1s[0], rest, kw, n)
    want = attention.attention_plain(sw, *srest, **skw).float()
    keep = (srest[4] > 0)[..., None]  # q_keep: compare after the query mask
    got = out[:n].float() * keep
    want = want * keep
    if not torch.isfinite(got).all():
        raise AssertionError("attention: non-finite kernel output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > BF16_TOL * max(scale, 1e-6):
        raise AssertionError(f"attention: max abs error {err} > {BF16_TOL} "
                             f"x max |plain| {scale}")
    del out, got, want

    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    else:
        t0 = time.perf_counter()
    for _ in range(args.iters):
        for w in win1s:
            kernel(w, *rest, **kw)
    if cuda:
        end.record()
        sync()
        total_ms = start.elapsed_time(end)
    else:
        total_ms = (time.perf_counter() - t0) * 1e3
    ms = total_ms / (args.iters * REPS)
    bound_ms, bound_by = work.attention(win1s[0], *rest, **kw).bound()
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(f"# first call: {first_s:.3f} s; check on the first {n} windows: "
          f"max abs error {err:.4g} (limit {BF16_TOL:.4g} x max |plain| "
          f"{scale:.4g})", file=sys.stderr)
    print(f"# steady: {ms:.4f} ms a call (nw={args.nw}, nv="
          f"{int(kw['num_valid'])}, {args.iters} x {REPS} calls; "
          f"{'CUDA events' if cuda else 'host clock, plain version'}); "
          f"bound {bound_ms:.4f} ms ({bound_by}) [{name}]", file=sys.stderr)
    result = {"kernel": "attention", "ms": ms, "bound_ms": bound_ms,
              "bound_by": bound_by,
              "max_abs_err": err, "nw": args.nw,
              "nv": int(kw["num_valid"]), "device": name}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
