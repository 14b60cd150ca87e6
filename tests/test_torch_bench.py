"""The port's measurement harness and bench tools against the JAX package's,
on the CPU.

- `headline_inputs`: the shapes, the times `o` and the CFG-doubled labels
  `y` equal JAX's for odd and even batches (z and c are random draws of
  two different generators and are not compared).
- `measure_grouped`: `dispatch(j)` with j = g * runs + i in order, one
  rate per group.
- bench_train's `model_flops_per_step` and `attention_flops_per_step`
  equal the JAX tool's (tools/bench_train.py, loaded by path) exactly.
- Each of the five tools' `main` with `--device cpu` at a tiny size (DiT-S,
  batch 2, 2-3 steps, one group; the plain versions run): its JSON lines
  carry every key of the JAX tool's lines but the TPU-only ones, and the
  device they ran on; with no CUDA device and no `--device cpu` each tool
  exits non-zero instead of running on the CPU. bench_train also with
  `--steps-per-call 2` (its calls of 2 steps, eager on the CPU).

Torch's intra-op threads are capped at 2 for this module: at its default
(one thread a core) beside other busy processes, bench_train's step crawls
(four copies of its case at once on 8 cores each ran ~110 s and printed
samples_per_sec 0.0; capped at 2 threads each passed in ~8 s).
"""
import ast
import importlib
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from osu_diffusion_tpu.utils.benchmark import headline_inputs as jax_headline_inputs
from osu_diffusion_tpu_torch.utils.benchmark import headline_inputs, measure_grouped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bench_sample", "bench_accel", "bench_quant", "bench_train", "bench_flash")
# the JAX tools' keys that name TPU-only knobs (Pallas tilings, the Pallas
# switch): no counterpart in the port
TPU_ONLY_KEYS = {"use_pallas", "flash_block", "slim_stats", "block", "skipped"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Torch's intra-op threads at 2 while this module runs, then as they were."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_tool(name):
    """tools/<name>.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n", [2, 3, 8])
def test_headline_inputs_match_jax(n):
    t_len, classes = 16, 100
    want = jax_headline_inputs(n, t_len, classes)[:4]
    got = headline_inputs(n, t_len, classes, "cpu", torch.Generator().manual_seed(1))
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # o
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # y
    assert (got[3] == classes).sum() == n - n // 2
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.float32


def test_measure_grouped_dispatch_order_and_rates():
    seen = []

    def dispatch(j):
        seen.append(j)
        return torch.zeros(1)

    rates = measure_grouped(dispatch, steps=7, groups=3, runs=4)
    assert seen == list(range(12))
    assert len(rates) == 3 and all(math.isfinite(r) and r > 0 for r in rates)


@pytest.mark.parametrize("band", [None, 5, 40], ids=["full", "band_below_t", "band_above_t"])
def test_train_flops_match_jax(band):
    from osu_diffusion_tpu_torch.tools import bench_train

    jax_tool = _jax_tool("bench_train")
    for depth, hidden, batch, t in ((12, 768, 256, 128), (2, 32, 3, 37)):
        assert bench_train.attention_flops_per_step(depth, hidden, batch, t, band) == \
            jax_tool.attention_flops_per_step(depth, hidden, batch, t, band)
        assert bench_train.model_flops_per_step(130_000_000, batch, t) == \
            jax_tool.model_flops_per_step(130_000_000, batch, t)


def _jax_tool_keys(name) -> set[str]:
    """The string keys the JAX tool puts in its JSON lines: the keys of its
    dict literals and of its subscript stores (`results["speedup"] = ...`)."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", f"{name}.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                and isinstance(node.slice, ast.Constant) and isinstance(node.slice.value, str):
            keys.add(node.slice.value)
    return keys


def _keys(obj) -> set[str]:
    if isinstance(obj, dict):
        return set(obj).union(*(_keys(v) for v in obj.values()))
    if isinstance(obj, list):
        return set().union(*(_keys(v) for v in obj))
    return set()


# tiny settings; the module constants cut the chains the JAX tools fix (100
# steps, T 128, 8 steps a group)
TOOL_RUNS = {
    "bench_sample": (["--model", "DiT-S", "--batch", "2", "--seq-len", "16", "--steps", "2",
                      "--groups", "1", "--runs", "1"], {}),
    "bench_accel": (["--model", "DiT-S", "--num-classes", "100", "--intervals", "1,2", "--taus", "0.05",
                     "--groups", "1", "--runs", "1"], {"STEPS": 3, "T_LEN": 16}),
    "bench_quant": (["--model", "DiT-S", "--num-classes", "100", "--batch", "2", "--seq-len", "16",
                     "--groups", "1", "--runs", "1"], {"STEPS": 2}),
    "bench_train": (["--model", "DiT-S", "--num-classes", "100", "--batch", "2", "--seq-len", "32",
                     "--calls", "1", "--mlp-bwd", "fused"], {"GROUP_STEPS": 1}),
    "bench_flash": (["--batch", "1", "--heads", "2", "--seq-len", "64", "--head-dim", "64", "--band", "16",
                     "--iters", "1", "2", "--reps", "1", "--dense"], {}),
}


@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_on_cpu_with_the_jax_tools_keys(name, capsys, monkeypatch):
    tool = importlib.import_module(f"osu_diffusion_tpu_torch.tools.{name}")
    argv, consts = TOOL_RUNS[name]
    for const, value in consts.items():
        monkeypatch.setattr(tool, const, value)
    tool.main(argv + ["--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert lines
    want = _jax_tool_keys(name) - TPU_ONLY_KEYS
    assert want, name
    missing = want - _keys(lines)
    assert not missing, f"{name} lacks the JAX tool's keys {sorted(missing)}"
    assert lines[-1]["device"] == "cpu" and lines[-1]["card"] is None
    rates = [v for line in lines for k, v in line.items()
             if k in ("steps_per_sec_best", "steps_per_sec", "samples_per_sec")]
    rates += [r["steps_per_sec_best"] for line in lines for r in line.get("results", {}).values()
              if isinstance(r, dict)]
    assert all(math.isfinite(r) and r > 0 for r in rates)


def test_bench_train_steps_per_call_on_cpu(capsys):
    """bench_train --steps-per-call 2 --device cpu: the warm-up call and one
    timed call of 2 eager steps (train_step.TrainCall; no graph on the CPU,
    so no capture time); its JSON line names k, carries the JAX tool's keys
    and a finite positive rate."""
    from osu_diffusion_tpu_torch.tools import bench_train

    argv, _ = TOOL_RUNS["bench_train"]
    out = bench_train.main(argv + ["--steps-per-call", "2", "--device", "cpu"])
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert line == out
    assert (out["steps_per_call"], out["capture_ms"], out["device"]) == (2, None, "cpu")
    assert not (_jax_tool_keys("bench_train") - TPU_ONLY_KEYS) - set(out)
    assert all(math.isfinite(out[k]) and out[k] > 0 for k in ("steps_per_sec", "samples_per_sec"))


@pytest.mark.parametrize("name", TOOLS)
def test_tool_without_a_card_exits_nonzero(name, monkeypatch):
    tool = importlib.import_module(f"osu_diffusion_tpu_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tool.main([])
    assert exc.value.code not in (0, None)


def test_jax_tool_keys_are_read_from_the_source():
    """The key reader sees the JAX tools' printed keys (a guard on the
    reader itself: a few keys each tool is known to print)."""
    assert {"steps_per_sec_best", "per_group", "compile_s"} <= _jax_tool_keys("bench_sample")
    assert {"speedup_vs_exact", "full_model_steps", "drift"} <= _jax_tool_keys("bench_accel")
    assert {"speedup", "variant"} <= _jax_tool_keys("bench_quant")
    assert {"mfu", "samples_per_sec", "loss"} <= _jax_tool_keys("bench_train")
    assert {"fwd_bwd_ms", "ideal_fwdbwd_ms_at_peak", "shapes"} <= _jax_tool_keys("bench_flash")
