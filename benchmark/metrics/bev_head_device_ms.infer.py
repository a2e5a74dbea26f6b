"""Device time of the kernels launched inside the BEV and head stages (the
program's ``mssvt.map_to_bev``, ``mssvt.backbone_2d`` and ``mssvt.head``
spans: sparse to dense BEV, the 2-D backbone, the head's conv maps), a
frame."""

from benchmark.harness import trace

STAGES = ("mssvt.map_to_bev", "mssvt.backbone_2d", "mssvt.head")


def read(rec):
    rs = sorted(r for s in STAGES for r in trace.ranges(rec.events, s))
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
