"""A cell found by its name in BENCHMARK.json, and everything that belongs to
it found by name: the configuration file it names, `traffic/<mix>.json`,
`limits/<cell>.json`, the driver `drivers/<kind>.py` of the mix's "kind",
and a reader `metrics/<metric>.py` (a function `read(record)` that returns
the number, or None where the run has nothing to read) for each metric.
A configuration, a mix, a limit file or a metric is added by adding its
file and its entry; no file that is there needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: ModuleType
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def find(name: str, root: str = ROOT) -> Cell:
    bench_dir = os.path.join(root, "benchmarks")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(bench_dir, "limits", name + ".json")) as f:
        limits = json.load(f)
    driver = load_module(os.path.join(bench_dir, "drivers", traffic["kind"] + ".py"),
                         "benchmarks.drivers." + traffic["kind"])
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(cell["chips"]), config, traffic, limits, driver, e2e, per_layer)


def read_metrics(metrics: list, record: dict, root: str = ROOT) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds a number."""
    out = {}
    for m in metrics:
        reader = load_module(os.path.join(root, "benchmarks", "metrics", m["name"] + ".py"),
                             "benchmarks.metrics." + m["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
