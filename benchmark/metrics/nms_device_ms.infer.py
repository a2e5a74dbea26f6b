"""Device time of the kernels launched inside the program's ``mssvt.nms``
spans (each greedy NMS call: candidates, suppression mask, scan), a
frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.nms")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
