"""Share of the 3-D backbone's forwards (the benchmark's
``bench.backbone_3d`` ranges) that replayed the sparse-conv backbone's
CUDA graphs, in %: those holding a ``mssvt.spconv_graph`` range. A
forward whose graphs failed to capture (``mssvt.spconv_graph_eager``) or
were being captured (``mssvt.spconv_graph_capture``) counts as none. None
where the trace holds none of the three ranges: a program without the
graph route."""

from benchmark.harness import trace

ROUTE = ("mssvt.spconv_graph", "mssvt.spconv_graph_eager",
         "mssvt.spconv_graph_capture")


def read(rec):
    rs = trace.ranges(rec.events, "bench.backbone_3d")
    if not rs or not any(trace.ranges(rec.events, n) for n in ROUTE):
        return None
    gs = trace.ranges(rec.events, ROUTE[0])
    hit = sum(any(s <= g0 and g1 <= t for g0, g1 in gs) for s, t in rs)
    return 100.0 * hit / len(rs)
