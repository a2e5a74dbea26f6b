"""Kernels (the program's own and the libraries') that ran on the card in
the profiled requests, a frame. A count."""

from benchmark.harness import trace


def read(rec):
    win = trace.window(rec.events, "bench.request")
    if win is None:
        return None
    n = sum(1 for e in trace.device(rec.events, ("kernel",))
            if win[0] <= e["ts"] <= win[1])
    return n / (rec.requests * rec.batch) if n else None
