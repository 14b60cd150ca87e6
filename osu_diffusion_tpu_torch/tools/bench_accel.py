"""Δ-cache sampling throughput (port of tools/bench_accel.py).

The headline harness (utils/benchmark.py: DiT-B, dispatch batch 2 with CFG
doubling, T = 128, 100 denoise steps, grouped measurement) at several
`accel_interval` settings, then at adaptive `accel_tau` settings. Interval
1 is the exact chain; interval k runs every block every k-th step (and on
the last) and adds the cached middle-span residual Δ in between
(sampling.py). On the card the full steps run the inference kernels at the
sample CLI's default band (128).

Rows report wall-clock chain throughput in denoise steps per second (chain
steps completed, not model calls: the accelerated chain does less work a
step, which is the point), the adaptive rows also the number of full
model steps, and every row its speedup over interval 1.

    python -m osu_diffusion_tpu_torch.tools.bench_accel --intervals 1,2,3 --taus 0.05

`--ckpt` takes what the sample CLI takes (a torch .pt); adaptive skip
counts depend on the weights, so the frontier belongs on trained weights.
"""
from __future__ import annotations

import argparse
import json

import torch

from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.sampling import Sampler
from osu_diffusion_tpu_torch.utils.benchmark import (
    bench_device,
    device_fields,
    headline_inputs,
    measure_sampler,
    serving_model,
    significant,
)

BAND = 128  # the sample CLI's default --seq-len, its attention band
STEPS = 100
T_LEN = 128


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--intervals", type=str, default="1,2,3")
    parser.add_argument("--taus", type=str, default="",
                        help="comma-separated adaptive accel_tau values to sweep after the fixed "
                             "intervals (rows report the measured number of full model steps)")
    parser.add_argument("--max-skip", type=int, default=7)
    parser.add_argument("--drift", type=str, default="global", choices=["global", "per_sample_max"],
                        help="how per-row drifts reduce to the one skip decision in adaptive mode")
    parser.add_argument("--batch", type=int, default=2,
                        help="CFG-doubled dispatch batch (e.g. 32 probes the multi-variant drift "
                             "coupling)")
    parser.add_argument("--groups", type=int, default=10)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--model", type=str, default="DiT-B")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="trained checkpoint (torch .pt, as the sample CLI takes)")
    parser.add_argument("--num-classes", type=int, default=52670)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = bench_device(args.device)

    model = serving_model(args.model, args.num_classes, device, args.ckpt)
    diffusion = create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2", device=device)
    n = args.batch
    inputs = headline_inputs(n, T_LEN, args.num_classes, device,
                             torch.Generator(device=device).manual_seed(1))

    results = {}
    base = None
    for interval in [int(s) for s in args.intervals.split(",")]:
        sampler = Sampler(model, diffusion, cfg_scale=1.0, band=BAND, bucket=T_LEN,
                          accel_interval=interval)
        results[interval], _ = measure_sampler(sampler, inputs, STEPS, args.groups, args.runs)
        if interval == 1:
            base = results[interval]["steps_per_sec_best"]
        print(json.dumps({"interval": interval, **results[interval]}), flush=True)

    for tau in [float(s) for s in args.taus.split(",") if s]:
        sampler = Sampler(model, diffusion, cfg_scale=1.0, band=BAND, bucket=T_LEN, accel_tau=tau,
                          accel_max_skip=args.max_skip, accel_drift=args.drift)
        row, full_steps = measure_sampler(sampler, inputs, STEPS, args.groups, args.runs)
        results[f"tau{tau}"] = {**row, "full_model_steps": full_steps, "chain_steps": STEPS,
                                "drift": args.drift}
        print(json.dumps({"tau": tau, **results[f"tau{tau}"]}), flush=True)

    # speedups once the base is known, so any --intervals order reports every row
    for row in results.values():
        row["speedup_vs_exact"] = significant(row["steps_per_sec_best"] / base) if base else None
    result = {"model": args.model, "batch": n, "band": BAND, "results": results, **device_fields(device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
