"""Run one cell of the benchmark once, on the machine it is started on:

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json. Its driver sets the
program up (weights and traffic from --seed, every shape it will use warmed
up), runs its traffic for --seconds, checks what the timed path produced
against the plain reference, and hands back a record; the metrics' readers
take their numbers from it. With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from a
profiled slice of the window. The last line on standard output is one JSON
object; each number compared with the reference is printed beside its limit
as the last lines on standard error and under "checks", the line's last key.

Exits with 3, and prints no result, without as many CUDA devices as the
cell asks for; with 4 if JAX, flax or the JAX package was imported.
"""
from __future__ import annotations

import os
import sys
import time

PERF_T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = {"jax", "jaxlib", "flax", "osu_diffusion_tpu"}


def process_age_s() -> float:
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_T0 = process_age_s()


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, chips: int = 1) -> tuple[dict, list[str]]:
    """The result's line and the check lines of one run of `cell` on `device`."""
    from benchmarks.harness.cell import read_metrics
    from benchmarks.harness.checks import keeps

    record = cell.driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                             setup_t0=PERF_T0 - AGE_AT_T0)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, record)
    checks = [dict(c, value=float(c["value"]), limit=float(c["limit"])) for c in record["checks"]]
    correct = keeps(checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": record["device_kind"], "count": chips,
           "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        from benchmarks.harness.trace import breakdown

        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = breakdown(record["trace"])
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    lines = [f"check {c['name']} {c['value']!r} limit {c['limit']!r}" for c in checks]
    return result, lines


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    from benchmarks.harness.cell import find

    cell = find(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {count}",
              file=sys.stderr)
        return 3
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                             cell.chips)
    bad = forbidden_modules()
    if bad:
        print(f"the run imported {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
