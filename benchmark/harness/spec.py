"""What a run of one cell is made of, found by name: the cell's entry in
``BENCHMARK.json``, its configuration (``configs/<config>.json``), its
traffic mix (``traffic/<traffic>.json``), its own file
(``workloads/<cell>.json``: the limits of its correctness check), the
loop and generator the mix names (``loops/<loop>.py``,
``traffic/<generator>.py``), the configuration's plain reference
(``reference/<config>.py``) and one reader a per-layer metric
(``metrics/<metric>.py``). Adding a cell, a configuration or a metric adds
files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """Import the Python file at ``path`` (its name may hold ``-`` or
    ``.``) as a module of its own."""
    path = Path(path).resolve()
    name = "benchmark_plugin_" + "".join(
        ch if ch.isalnum() else "_" for ch in str(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    own: dict              # workloads/<cell>.json
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)   # metric entries
    bench: Path = BENCH    # the directory the plug-ins are found in

    @property
    def batch(self):
        return int(self.traffic["batch"])

    def loop(self):
        return load_module(self.bench / "loops" / f"{self.traffic['loop']}.py")

    def generator(self):
        return load_module(self.bench / "traffic" /
                           f"{self.traffic['generator']}.py")

    def reference(self):
        return load_module(self.bench / "reference" /
                           f"{self.entry['config']}.py")

    def reader(self, metric):
        return load_module(self.bench / "metrics" / f"{metric['name']}.py")


def reports(metric, cell_name, e2e_names):
    """Whether a cell reports ``metric``: the cells its ``workloads`` list,
    or, without the key, every cell that reports its ``moves``."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name, bench_json=None, bench=BENCH):
    """The cell ``name`` of ``bench_json`` (the checkout's
    ``BENCHMARK.json``), its files found under ``bench``."""
    spec = load_json(bench_json or ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (known: "
                         f"{', '.join(sorted(entries))})")
    entry = entries[name]
    config = load_json(bench / "configs" / f"{entry['config']}.json")
    traffic = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    own = load_json(bench / "workloads" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if reports(m, name, names)]
    return Cell(name, entry, config, traffic, own, e2e, per_layer, bench)
