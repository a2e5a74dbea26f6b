"""``BENCHMARK.json`` and the files it names: the contract's shapes and
characters, and discovery by name without an edit to the harness."""

import json
import re
import shutil

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
BENCH_JSON = spec.ROOT / "BENCHMARK.json"


@pytest.fixture(scope="module")
def bench():
    return spec.load_json(BENCH_JSON)


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH_JSON.stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert all(one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries(bench):
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for e in bench[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") \
                else set()
            assert keys <= set(e) <= keys | extra, (group, e)
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in names
            names.add((group, e["name"]))
            for k in TEXT_KEYS:
                if k in e:
                    assert one_line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
    for c in bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert (spec.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_end_to_end_bounds(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_loads_and_reports(bench):
    cells = [w["name"] for w in bench["workloads"]]
    configs = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for name in cells:
        cell = spec.load_cell(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, name
        assert cell.per_layer, name
        assert cell.loop().run
        assert cell.generator().make
        ref = cell.reference()
        assert ref.build and ref.candidates and ref.forward
        assert set(cell.own["limits"]) == {"backbone_rel", "bev_rel",
                                           "head_rel", "det_gap",
                                           "count_gap"}
        assert ref.capture and ref.judge
        for m in cell.per_layer:
            assert m["moves"] in e2e, (name, m["name"])
            assert cell.reader(m).read


def test_per_layer_moves_is_reported_by_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", []):
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        layers = {x["layer"] for x in bench["per_layer"]
                  if x["name"].split(".")[0] == m["name"].split(".")[0]}
        assert len(layers) == 1, m["name"]


def test_a_new_metric_and_cell_are_found_by_name(tmp_path, bench):
    """Adding a cell and a per-layer metric adds files and entries only."""
    root = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    cell0 = bench["workloads"][0]
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [
        dict(cell0, name="dummy-cell", traffic="dummy-mix")]
    new["per_layer"] = bench["per_layer"] + [
        {"name": "dummy_count.infer", "unit": "launches", "better": "lower",
         "source": "program_counter", "layer": "entry",
         "moves": "infer_frames_per_s", "workloads": ["dummy-cell"]}]
    for m in new["end_to_end"]:
        if "workloads" in m and cell0["name"] in m["workloads"]:
            m["workloads"] = m["workloads"] + ["dummy-cell"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    traffic = spec.load_json(root / "traffic" / f"{cell0['traffic']}.json")
    (root / "traffic" / "dummy-mix.json").write_text(
        json.dumps(dict(traffic, batch=1)))
    (root / "workloads" / "dummy-cell.json").write_text(
        (root / "workloads" / f"{cell0['name']}.json").read_text())
    (root / "metrics" / "dummy_count.infer.py").write_text(
        "def read(rec):\n    return 7.0\n")
    cell = spec.load_cell("dummy-cell", tmp_path / "BENCHMARK.json", root)
    assert cell.batch == 1
    assert "dummy_count.infer" in [m["name"] for m in cell.per_layer]
    reader = cell.reader([m for m in cell.per_layer
                          if m["name"] == "dummy_count.infer"][0])
    assert reader.read(None) == 7.0
    assert cell.loop().run
