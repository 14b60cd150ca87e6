"""Sampling throughput of any registry model, batch and T (port of
tools/bench_sample.py).

The headline harness (utils/benchmark.py): an exact f32 chain of `--steps`
denoise steps (squaredcos schedule, CFG-doubled inputs, cfg scale 1),
seeded reference-init weights, `--groups` groups of `--runs` chains. On the
card every block runs the inference kernels: banded attention at the
sample CLI's default band (128, its --seq-len; at T <= 128 that is full
attention, the JAX tool's band=None) and the fused adaLN-MLP.

    python -m osu_diffusion_tpu_torch.tools.bench_sample --model DiT-L

prints one JSON line. The JAX tool's --scan-blocks is a TPU layout and has
no counterpart.
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
)

BAND = 128  # the sample CLI's default --seq-len, its attention band
NUM_CLASSES = 52670


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="DiT-L")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--groups", type=int, default=10)
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = bench_device(args.device)

    model = serving_model(args.model, NUM_CLASSES, device)
    diffusion = create_diffusion(str(args.steps), noise_schedule="squaredcos_cap_v2", device=device)
    inputs = headline_inputs(args.batch, args.seq_len, NUM_CLASSES, device,
                             torch.Generator(device=device).manual_seed(1))
    sampler = Sampler(model, diffusion, cfg_scale=1.0, band=BAND, bucket=args.seq_len)
    row, _ = measure_sampler(sampler, inputs, args.steps, args.groups, args.runs)
    result = {"model": args.model, "batch": args.batch, "seq_len": args.seq_len, "band": BAND, **row,
              **device_fields(device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
