"""The masked FPS kernel (``csrc/fps.cu`` ``fps_masked_kernel``, PV-RCNN++'s
sector FPS) against its roofline: the bound of the profiled requests'
two passes (``harness/sector_fps.py``'s formula at the rows, points and
picks of ``configs/pvrcnnpp-kitti.json``; the trace's record carries no
configuration) over the kernel's device time in their trace, found by
the kernel's name. Where the trace gives the launches' grids (a CTA a
row), they must be the configuration's rows a pass, else nothing is
read: another configuration's launches."""

import re

from benchmark.harness import sector_fps, spec, trace

KERNEL = re.compile(r"\bfps_masked_kernel\b")
CONFIG = spec.BENCH / "configs" / "pvrcnnpp-kitti.json"


def read(rec):
    win = trace.window(rec.events, "bench.request")
    if win is None:
        return None
    launches = [e for e in trace.device(rec.events, ("kernel",))
                if KERNEL.search(e.get("name", ""))
                and win[0] <= e["ts"] <= win[1]]
    ms = sum(e["dur"] for e in launches) / 1e3
    if not ms:
        return None
    config = spec.load_json(CONFIG)
    _, _, s, _ = sector_fps.sizes(config)
    grids = [e.get("args", {}).get("grid") for e in launches]
    if all(grids) and sorted(g[0] for g in grids) != sorted(
            [rec.batch * s, rec.batch] * rec.requests):
        return None
    bound = sum(w.bound()[0] for w in sector_fps.work(config, rec.batch))
    return 100.0 * rec.requests * bound / ms
