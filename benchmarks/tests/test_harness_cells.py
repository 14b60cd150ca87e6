"""On a card, at each cell's own size: a short run of the cell comes out
correct; its control (the precision just below the configuration's,
benchmarks/harness/controls.py) comes out not correct by the run's own
comparison; and a run whose graphed train calls replay on stale inputs
comes out not correct.
Run on the card: `python -m pytest benchmarks/tests -q -m cuda -s`."""
import json

import pytest

import benchmarks.run as run
from benchmarks.harness import controls
from benchmarks.harness.cell import find

CELLS = [w["name"] for w in json.load(open(run.os.path.join(run.ROOT, "BENCHMARK.json")))["workloads"]]
# the cells whose timed path replays a train call's CUDA graph that their set-up captured
REPLAYED = [n for n in CELLS if find(n).traffic["kind"] == "train" and find(n).traffic["steps_per_call"] > 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_run_is_correct(cuda_device, name):
    cell = find(name)
    result, lines = run.run_cell(cell, 2 ** 31 + 101, 5.0, False, cuda_device)
    print("\n".join(lines))
    assert result["correct"] and result["failed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(cuda_device, name):
    cell = find(name)
    seed = 2 ** 31 + 202
    if cell.traffic["kind"] == "sample":
        got = controls.sample_control(cell, seed, cuda_device)
    else:
        got = controls.train_control(cell, seed, cuda_device, which=("control",))["control"]
    print(name, got["readings"])
    assert got["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", REPLAYED)
def test_planted_replay_fault_run_is_not_correct(cuda_device, name):
    cell = find(name)
    with controls.stale_inputs():
        result, lines = run.run_cell(cell, 2 ** 31 + 303, 5.0, False, cuda_device)
    print("\n".join(lines))
    assert result["correct"] is False
