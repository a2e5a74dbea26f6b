"""Device time of the kernels launched inside the program's
``mssvt.spconv_rules`` spans (the sparse-conv engine's sorted-key
indexes, output-site sets and neighbour tables), a frame."""

from benchmark.harness import trace


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.spconv_rules")
    if not rs:
        return None
    ks = trace.launched_within(rec.events, rs)
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
