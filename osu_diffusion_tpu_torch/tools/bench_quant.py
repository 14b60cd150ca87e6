"""int8 weight-only serving throughput (port of tools/bench_quant.py).

The headline harness (utils/benchmark.py) run once per variant: the exact
f32 chain and the int8 weight-only chain (the sample CLI's
--quantize-weights model, models/quantize.py: every block's projection
weights as symmetric per-output-channel int8 codes, read as int8 by the
int8 kernels). Reports chain steps per second per variant and the int8
speedup. On the card the f32 blocks run banded attention and the fused
adaLN-MLP, the int8 blocks banded attention and the four int8 kernels
(adaLN projection, modulated qkv, out projection with residual, int8
MLP); the band is the sample CLI's default (128).

    python -m osu_diffusion_tpu_torch.tools.bench_quant --batch 8 --seq-len 768

`--accel-interval` / `--accel-tau` apply the Δ-cache to every variant. The
JAX tool's --max-rows sets a Pallas tile cap and has no counterpart.
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
VARIANTS = ("f32", "int8")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--groups", type=int, default=10)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--model", type=str, default="DiT-B")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--variants", type=str, default="f32,int8",
                        help="comma list from {f32,int8}; order is measurement order")
    parser.add_argument("--accel-tau", type=float, default=None,
                        help="adaptive Δ-cache tau applied to every measured variant")
    parser.add_argument("--max-skip", type=int, default=7)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="trained checkpoint (torch .pt, as the sample CLI takes); adaptive-tau "
                             "skip counts are weight-dependent")
    parser.add_argument("--num-classes", type=int, default=52670)
    parser.add_argument("--accel-interval", type=int, default=1,
                        help="Δ-cache interval applied to every measured variant")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    variants = args.variants.split(",")
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        parser.error(f"unknown variants {unknown}: choose from {VARIANTS}")
    device = bench_device(args.device)

    diffusion = create_diffusion(str(STEPS), noise_schedule="squaredcos_cap_v2", device=device)
    t_len, n = args.seq_len, args.batch
    inputs = headline_inputs(n, t_len, args.num_classes, device,
                             torch.Generator(device=device).manual_seed(1))

    results = {}
    for name in variants:
        model = serving_model(args.model, args.num_classes, device, args.ckpt, quant=name == "int8")
        sampler = Sampler(model, diffusion, cfg_scale=1.0, band=BAND, bucket=t_len,
                          accel_interval=args.accel_interval, accel_tau=args.accel_tau,
                          accel_max_skip=args.max_skip)
        row, full_steps = measure_sampler(sampler, inputs, STEPS, args.groups, args.runs)
        results[name] = {**row, "full_model_steps": full_steps if sampler.accel else STEPS}
        print(json.dumps({"variant": name, **results[name]}), flush=True)
        del sampler, model

    if "f32" in results and "int8" in results:
        results["speedup"] = significant(results["int8"]["steps_per_sec_best"]
                                         / results["f32"]["steps_per_sec_best"])
    result = {"model": args.model, "batch": n, "seq_len": t_len, "band": BAND, "results": results,
              **device_fields(device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
