"""Host waits for the device inside the program's ``mssvt.request`` spans,
a frame: CUDA API calls named ``cuda*Synchronize`` or ``cu*Synchronize``,
and copies whose device event is a device-to-host ``Memcpy``. A copy and
the synchronize right after it (PyTorch's ``memcpy_and_sync``:
``.item()``, ``.cpu()``, a ``nonzero``'s count) are one wait. 0.0 where
the spans hold none."""

import re

from benchmark.harness import trace

SYNC = re.compile(r"^cu(da)?\w*Synchronize$")


def read(rec):
    rs = trace.ranges(rec.events, "mssvt.request")
    if not rs:
        return None
    dtoh = {e["args"].get("correlation")
            for e in trace.device(rec.events, ("gpu_memcpy",))
            if "DtoH" in e.get("name", "") and "args" in e}
    calls = sorted((e for e in trace.complete(rec.events)
                    if e.get("cat") in trace.LAUNCH_CATS
                    and any(s <= e["ts"] <= t for s, t in rs)),
                   key=lambda e: e["ts"])
    n, after_copy = 0, False
    for e in calls:
        corr = e.get("args", {}).get("correlation")
        copy = corr is not None and corr in dtoh
        if copy or (SYNC.match(e.get("name", "")) and not after_copy):
            n += 1
        after_copy = copy
    return n / (rec.requests * rec.batch)
