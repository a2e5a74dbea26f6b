"""Device time of the kernels launched inside the program's
``mssvt.backbone_3d`` spans and outside its ``mssvt.spconv_rules`` spans
(the sparse-conv engine's gathers, products and BatchNorm), a frame.
Nothing to read where the program opens no ``mssvt.spconv_rules``."""

from benchmark.harness import trace


def read(rec):
    rules = trace.ranges(rec.events, "mssvt.spconv_rules")
    stage = trace.ranges(rec.events, "mssvt.backbone_3d")
    if not rules or not stage:
        return None
    inside = {id(e) for e in trace.launched_within(rec.events, rules)}
    ks = [e for e in trace.launched_within(rec.events, stage)
          if id(e) not in inside]
    return sum(e["dur"] for e in ks) / 1e3 / (rec.requests * rec.batch)
