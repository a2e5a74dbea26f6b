"""Device time of the kernels launched inside the program's ``mssvt.sa``
spans (PointNet++'s set abstraction levels of the 3-D backbone: FPS, ball
queries, grouping, shared MLPs and max), a frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.sa")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
