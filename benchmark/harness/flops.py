"""The benchmark's own count of a request's FLOPs: ``FlopCounterMode``
over the plain reference, with the assembled attention's products (the
reference's dense einsum over every window) replaced by K3's formula
(``work.attention``: the block-diagonal products of the live windows),
which is what the configuration needs. The same count stands whatever
implementation the program runs."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import work
from benchmark.reference.detector.models.model_utils.attention import (
    MixedScaleAttention,
)


@dataclass
class Count:
    flops: float = 0.0
    k3: list = field(default_factory=list)  # the K3 calls' Work

    @property
    def k3_bound_ms(self):
        return sum(w.bound()[0] for w in self.k3)


def k3_work(module, a):
    return work.attention(
        a["win1_fea"], a["k2_fea"], a["fps1"], a["k_mask1"], a.get("q_ext"),
        a["q_keep"], a["k_rel"], a["q_rel"], a["pos_base"], a["pos_w"],
        None, None, module.num_heads, None, a.get("q_ext") is None,
        nq=a["nq"], pad_row=a.get("pad_row"), num_valid=a.get("num_valid"))


@contextlib.contextmanager
def counting(model):
    """Count the FLOPs of what runs on ``model`` inside the block."""
    fc = FlopCounterMode(display=False)
    count = Count()
    taken = []
    saved = []
    for m in model.modules():
        if isinstance(m, MixedScaleAttention):
            def fwd(*args, assembled=None, _orig=m.forward, _m=m, **kw):
                if assembled is None:
                    return _orig(*args, **kw)
                before = fc.get_total_flops()
                out = _orig(*args, assembled=assembled, **kw)
                taken.append(fc.get_total_flops() - before)
                count.k3.append(k3_work(_m, assembled))
                return out
            saved.append(m)
            m.forward = fwd
    try:
        with fc:
            yield count
    finally:
        for m in saved:
            del m.forward
    count.flops = (fc.get_total_flops() - sum(taken)
                   + sum(w.flops for w in count.k3))
