"""Device time of the kernels launched inside the program's
``mssvt.roi_head`` spans (RoI-grid pooling over the keypoints, the shared FCs and the refinement), a frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.roi_head")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
