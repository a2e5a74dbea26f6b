"""Device time of the kernels launched inside the program's
``mssvt.ball_query`` spans (PointNet++'s ball queries: the set abstractions'
neighbours, the head's inside every RoI, PV-RCNN's raw-point, vector-pool
and RoI-grid pooling), a frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.ball_query")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
