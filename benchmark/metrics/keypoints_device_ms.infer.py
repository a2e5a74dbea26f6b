"""Device time of the kernels launched inside the program's
``mssvt.keypoints`` spans (the raw points by frame, the RoI mask and the sector FPS's two masked FPS passes), a frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.keypoints")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
