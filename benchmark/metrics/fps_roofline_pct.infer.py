"""The selection-free FPS kernels (``csrc/fps.cu``: K2c
``fps_block_kernel``, K2b ``fps_kernel``) against their roofline: the bound
of every FPS call of the profiled requests (``harness/pointnet_fps.py``'s
formula at the rows, points and picks of ``configs/pointrcnn-kitti.json``;
the trace's record carries no configuration) over the kernels' device time
in their trace, found by name. The launches must be the configuration's
calls, one a call, and where the trace gives K2c's grids (a CTA a row)
they must be its rows; else nothing is read: another configuration's
launches."""

import re

from benchmark.harness import pointnet_fps, spec, trace

BLOCK = re.compile(r"\bfps_block_kernel\b")
WARP = re.compile(r"\bfps_kernel\b")
CONFIG = spec.BENCH / "configs" / "pointrcnn-kitti.json"


def read(rec):
    win = trace.window(rec.events, "bench.request")
    if win is None:
        return None
    inside = [e for e in trace.device(rec.events, ("kernel",))
              if win[0] <= e["ts"] <= win[1]]
    block = [e for e in inside if BLOCK.search(e.get("name", ""))]
    warp = [e for e in inside if WARP.search(e.get("name", ""))]
    ms = sum(e["dur"] for e in block + warp) / 1e3
    if not ms:
        return None
    config = spec.load_json(CONFIG)
    calls = pointnet_fps.levels(config, rec.batch)
    rows = pointnet_fps.block_rows(config, rec.batch)
    if len(block) + len(warp) != len(calls) * rec.requests or \
            len(block) != len(rows) * rec.requests:
        return None
    grids = [e.get("args", {}).get("grid") for e in block]
    if all(grids) and sorted(g[0] for g in grids) != sorted(
            rows * rec.requests):
        return None
    bound = sum(w.bound()[0] for w in pointnet_fps.work(config, rec.batch))
    return 100.0 * rec.requests * bound / ms
