"""The harness finds what belongs to a cell by name: a configuration, a
traffic mix, a limit file and a per-layer metric are added as new files
(and entries in BENCHMARK.json), without an edit to a file that is there.
BENCHMARK.json itself keeps to the contract's shapes."""
import hashlib
import json
import os
import re
import shutil

import pytest

from benchmarks.harness import cell as cellmod

ROOT = cellmod.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmarks")):
        for f in files:
            if f.endswith((".py", ".json")):
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_config_mix_limit_and_metric_are_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmarks"), os.path.join(root, "benchmarks"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    before = digests(root)
    bench = os.path.join(root, "benchmarks")
    with open(os.path.join(bench, "configs", "dit-b.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "configs", "dit-s.json"), "w") as f:
        json.dump(dict(cfg, model="DiT-S", hidden_size=384, num_heads=6), f)
    with open(os.path.join(bench, "traffic", "sample-f32.json")) as f:
        mix = json.load(f)
    with open(os.path.join(bench, "traffic", "sample-short.json"), "w") as f:
        json.dump(dict(mix, lengths=[64, 96]), f)
    with open(os.path.join(bench, "limits", "dit-s.sample-short.json"), "w") as f:
        json.dump({"decode_mismatches": 0, "featurize_mismatches": 0, "chain_gap": 1e-3}, f)
    with open(os.path.join(bench, "metrics", "maps_done.py"), "w") as f:
        f.write('def read(record):\n    return len(record.get("requests", [])) or None\n')
    spec["configs"].append({"name": "dit-s", "source": "https://arxiv.org/abs/2212.09748",
                            "file": "benchmarks/configs/dit-s.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dit-s.sample-short", "config": "dit-s", "traffic": "sample-short",
                              "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "map_points_per_s")["workloads"].append(
        "dit-s.sample-short")
    spec["per_layer"].append({"name": "maps_done", "unit": "maps", "better": "higher", "source": "host_clock",
                              "layer": "product loop", "moves": "map_points_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    cell = cellmod.find("dit-s.sample-short", root)
    assert cell.config["hidden_size"] == 384 and cell.traffic["lengths"] == [64, 96]
    assert cell.driver.__name__.endswith("sample") and cell.limits["chain_gap"] == 1e-3
    assert "maps_done" in [m["name"] for m in cell.per_layer]
    record = {"kind": "sample", "requests": [{"length": 64}, {"length": 96}], "window_s": 2.0}
    got = cellmod.read_metrics([m for m in cell.per_layer if m["name"] == "maps_done"]
                               + [m for m in cell.end_to_end if m["name"] == "map_points_per_s"], record, root)
    assert got == {"maps_done": {"value": 2.0, "unit": "maps"},
                   "map_points_per_s": {"value": 80.0, "unit": "points/s"}}
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    cell = cellmod.find(workload)
    assert cell.chips == 1
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert os.path.isfile(os.path.join(ROOT, "benchmarks", "metrics", m["name"] + ".py"))
    for m in cell.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entries_keep_to_the_contract(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_spec_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks"] and 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    assert len(json.dumps(SPEC)) < 64 * 1024
