"""Device time of the kernels launched inside the program's
``mssvt.pfe`` spans (the keypoints' BEV sample, raw-point pooling and vector pool, their fusion and the point head), a frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.pfe")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
