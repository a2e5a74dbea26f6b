"""Device idle time inside the profiled requests' window (``bench.request``,
as ``device_idle_pct.infer`` takes it) that lies in none of the program's
six stage spans, a frame: the request's prologue and epilogue, the
readback and the loop between requests. With the stages' own idle it adds
up to the window's idle."""

from benchmark.harness import trace

STAGES = ("mssvt.vfe", "mssvt.backbone_3d", "mssvt.map_to_bev",
          "mssvt.backbone_2d", "mssvt.head", "mssvt.post")


def read(rec):
    stages = [r for s in STAGES for r in trace.ranges(rec.events, s)]
    win = trace.window(rec.events, "bench.request")
    if not stages or win is None:
        return None
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in trace.device(rec.events)]
    covered = trace.union(trace.clip(dev + stages, win))
    return (win[1] - win[0] - covered) / 1e3 / (rec.requests * rec.batch)
