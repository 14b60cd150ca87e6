"""Shared measurement harness of the bench tools (port of
osu_diffusion_tpu/utils/benchmark.py).

tools/bench_{sample,accel,quant}.py must measure identically or their
numbers are not comparable, so the grouped methodology lives here once:
``groups`` groups of ``runs`` chains dispatched back to back, one fence per
group, chain steps per second per group by the host clock; callers take
the best group (under additive noise the max estimates the program's
throughput at the noise floor). The sampling chains are partly host-bound
(the host launches every kernel of every step), so wall time, not device
time, is what a user of the sampler feels.

`cuda_ms` is the kernel timer (CUDA events, the stream held by a spin
kernel while the host enqueues), and `device_line` the card's name and
power limit, which every tool prints beside its numbers.
"""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch

from osu_diffusion_tpu_torch import CONTEXT_SIZE


def headline_inputs(n: int = 2, t_len: int = 128, num_classes: int = 52670, device="cpu",
                    generator: torch.Generator | None = None):
    """The headline input set: dispatch batch n (CFG-doubled), T = t_len.
    Returns (z (n, T, 2), o (n, T), c (n, T, CONTEXT_SIZE), y (n,)); z and
    c are normals from `generator`, o = 150, 300, ... along T, and y the
    CFG-doubling convention for any n: the first n // 2 labels 1, the rest
    the null label `num_classes` (so a toy checkpoint with a small label
    table takes the harness too)."""
    z = torch.randn((n, t_len, 2), generator=generator, device=device)
    o = torch.cumsum(torch.full((n, t_len), 150.0, device=device), dim=1)
    c = torch.randn((n, t_len, CONTEXT_SIZE), generator=generator, device=device)
    y = torch.tensor([1] * (n // 2) + [num_classes] * (n - n // 2), dtype=torch.long, device=device)
    return z, o, c, y


def significant(x: float, digits: int = 4) -> float:
    """x rounded to `digits` significant figures, so that a small positive
    rate or time never prints as 0 (as rounding to decimals can)."""
    return float(f"{x:.{digits}g}")


def fence(out=None) -> None:
    """Wait until every queued kernel has run (`out`, the work's result, is
    not read): on CUDA `torch.cuda.synchronize()` is a real execution fence,
    so the JAX harness's fetch of every leaf, a workaround for its TPU
    runtime, has no counterpart here. On the CPU the work is already done."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure_grouped(dispatch: Callable[[int], object], steps: int, groups: int = 10,
                    runs: int = 10) -> list[float]:
    """Grouped throughput: ``dispatch(j)`` fires the j-th chain (j = g *
    runs + i, the global dispatch index: derive its generator seed from it)
    and returns without waiting for it; one fence per group. Returns chain
    steps per second per group, by the host clock around work that ends in
    the fence."""
    per_group = []
    for g in range(groups):
        start = time.perf_counter()
        outs = [dispatch(g * runs + i) for i in range(runs)]
        fence(outs)
        per_group.append(steps * runs / (time.perf_counter() - start))
    return per_group


def measure_sampler(sampler, inputs, steps: int, groups: int, runs: int) -> tuple[dict, int | None]:
    """The sampling tools' row for one sampler: a first chain (generator
    seed 3) that builds the kernels, timed as `compile_s`, then
    `measure_grouped` over chains of seeds 4 + j. `inputs`: (z, o, c, y).
    Returns the row (best and median steps/s, per group) and the first
    chain's full model steps (None for the exact chain)."""
    device = inputs[0].device

    def dispatch(j):
        return sampler(*inputs, generator=torch.Generator(device=device).manual_seed(4 + j))

    t0 = time.perf_counter()
    fence(sampler(*inputs, generator=torch.Generator(device=device).manual_seed(3)))
    compile_s = time.perf_counter() - t0
    full_steps = sampler.last_full_model_steps
    per_group = measure_grouped(dispatch, steps, groups, runs)
    return {
        "steps_per_sec_best": significant(max(per_group)),
        "steps_per_sec_median": significant(statistics.median(per_group)),
        "per_group": [significant(v) for v in per_group],
        "compile_s": significant(compile_s),
    }, full_steps


def cuda_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of fn(), with CUDA events. A spin
    kernel holds the stream while the host enqueues the timed calls, so the
    events time the calls' device work back to back and not the host's
    launch path (the card runs a 20-us kernel faster than the host launches
    it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host = time.perf_counter()
    fn()
    host = time.perf_counter() - host  # one call's enqueue while the card is idle
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2 GHz bounds the SM clock from above, so this spins at least as long
    torch.cuda._sleep(int(min(2.0, 2 * iters * host + 1e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (a card
    set below its maximum runs slower under load)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def bench_device(name: str) -> torch.device:
    """The device a tool measures on: the card unless `--device cpu` was
    asked for; a CUDA device that is not there fails the tool instead of
    falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {name} (pass --device cpu to run the plain "
                         "versions on the CPU)")
    return device


def device_fields(device: torch.device) -> dict:
    """The JSON fields naming what a tool measured on: the device, and on a
    card its name and power limit."""
    return {"device": str(device), "card": device_line() if device.type == "cuda" else None}


def serving_model(model: str, num_classes: int, device: torch.device, ckpt: str | None = None,
                  quant: bool = False, seed: int = 0):
    """A sampling tool's DiT in eval mode on `device`: the f32 weights of
    `ckpt` (what the sample CLI loads), else the reference init from a
    seeded generator (adaLN-Zero, as the JAX tools' `model.init`); with
    `quant` those weights quantized to int8 blocks (--quantize-weights)."""
    from osu_diffusion_tpu_torch.models.dit import DiT_models
    from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict
    from osu_diffusion_tpu_torch.train.checkpoint import load_checkpoint

    ctor = DiT_models[model]
    net = ctor(num_classes=num_classes, context_size=CONTEXT_SIZE)
    if ckpt is not None:
        net.load_state_dict(load_checkpoint(ckpt))
    else:
        net.initialize_weights(torch.Generator().manual_seed(seed))
    if quant:
        sd = quantize_state_dict(net.state_dict())
        net = ctor(num_classes=num_classes, context_size=CONTEXT_SIZE, quant=True)
        net.load_state_dict(sd)
    return net.to(device).eval()
