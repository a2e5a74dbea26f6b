"""``backbone_graph_pct.infer`` on hand-made chrome traces."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spec


def ev(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "user_annotation", "ts": ts,
            "dur": dur}


def read(events):
    path = spec.BENCH / "metrics" / "backbone_graph_pct.infer.py"
    return spec.load_module(path).read(SimpleNamespace(events=events))


@pytest.mark.parametrize("graphs,want", [
    ([(20, 50), (220, 30), (420, 10)], 100.0),  # every forward replays
    ([(220, 30)], 100.0 / 3),                   # one of three
    ([(190, 30)], 0.0),                         # a range across the edge
    ([], None),                                 # no graph route: nothing
])
def test_backbone_graph_pct(graphs, want):
    events = [ev("bench.backbone_3d", t, 100) for t in (10, 210, 410)]
    events += [ev("mssvt.backbone_graph", t, d) for t, d in graphs]
    got = read(events)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name,want", [
    ("mssvt.backbone_graph_eager", 0.0),    # the capture failed: eager
    ("mssvt.backbone_graph_capture", 0.0),  # captured inside the window
    ("mssvt.backbone_graph", 100.0),
])
def test_backbone_graph_pct_reads_a_failed_capture(name, want):
    """A program that has the route but did not replay reads 0, not
    nothing."""
    events = [ev("bench.backbone_3d", t, 100) for t in (10, 210, 410)]
    events += [ev(name, t + 20, 50) for t in (10, 210, 410)]
    got = read(events)
    assert got == (None if want is None else pytest.approx(want))


def test_backbone_graph_pct_without_backbone_ranges():
    assert read([ev("mssvt.backbone_graph", 0, 5)]) is None
