"""K3 (``csrc/attention.cu``) against its roofline: the bound of the
profiled requests' K3 calls (``harness/work.py``'s frozen formula at the
shapes the reference computes for the same batches) over K3's device time
in their trace, found by the kernel's name."""

from benchmark.harness import trace


def read(rec):
    win = trace.window(rec.events, "bench.request")
    if win is None or not getattr(rec, "k3_bound_ms", 0):
        return None
    ms = sum(e["dur"] for e in trace.device(rec.events, ("kernel",))
             if trace.family(e.get("name", "")) == "K3 attention"
             and win[0] <= e["ts"] <= win[1]) / 1e3
    return 100.0 * rec.k3_bound_ms / ms if ms else None
