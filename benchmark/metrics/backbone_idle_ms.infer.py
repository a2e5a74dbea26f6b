"""Device idle time inside the 3-D backbone's stage, a frame: each of the
program's ``mssvt.backbone_3d`` spans less the union of the kernels,
copies and fills clipped to it."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.backbone_3d")
    if not rs:
        return None
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in trace.device(rec.events)]
    idle = sum(r[1] - r[0] - trace.union(trace.clip(dev, r)) for r in rs)
    return idle / 1e3 / (rec.requests * rec.batch)
