"""Device time of the kernels launched inside the 3-D backbone's forward
(the benchmark's ``bench.backbone_3d`` range), a frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "bench.backbone_3d")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    if not ks:
        return None
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
