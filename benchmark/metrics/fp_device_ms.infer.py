"""Device time of the kernels launched inside the program's ``mssvt.fp``
spans (PointNet++'s feature propagation levels of the 3-D backbone: the
3-NN, the interpolation and the shared MLPs), a frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.fp")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
