"""Share of the profiled requests' wall window (the first request's start
to the last one's end) in which no kernel, copy or fill ran on the card."""

from benchmark.harness import trace


def read(rec):
    win = trace.window(rec.events, "bench.request")
    if win is None or win[1] <= win[0]:
        return None
    return 100.0 * (1.0 - trace.busy(rec.events, win) / (win[1] - win[0]))
