"""Training throughput: the train step's steps and samples per second, MFU
and peak device memory (port of tools/bench_train.py).

Times the port's train step (train/train_step.py) with the train CLI's
settings: the reference init from a seeded generator, label dropout 0.2,
the bf16 stream over f32 master weights (`--no-bf16`: f32), per-block
remat (`--no-remat`), AdamW and the in-step EMA, on one synthetic batch
built as the JAX tool builds its batches. On the card every block runs the
training kernels (banded attention with LSE, dq and dk/dv at band =
seq-len unless `--band` narrows it, kernel B's training forward, and with
`--mlp-bwd fused` the MLP backward's two kernels).

One group of GROUP_STEPS steps warms up (the kernels build in it), then
`--calls` groups are timed by the host clock up to a synchronize. With
`--steps-per-call k` > 1 a group is one call of k steps
(train_step.TrainCall, as the JAX tool times its `multi`): on the card
one CUDA graph of the k steps, which the warm-up call captures after
running its steps eagerly (the JSON's `capture_ms`); on the CPU the k
steps eagerly. MFU is
the 6·P·tokens estimate plus the banded attention's ideal FLOPs over the
H100's published dense bf16 peak (989 TFLOP/s, SXM at 700 W: the JSON
prints the card's power limit beside it).

    python -m osu_diffusion_tpu_torch.tools.bench_train --model DiT-B --mlp-bwd fused

The JAX tool's TPU-only flags (--use-pallas, --scan-blocks,
--attn-layout, --pallas-ops, --flash-block, --slim-stats) have no
counterpart. --steps-per-call defaults to 1 here, not the JAX tool's 8
(the trainer's default, train/trainer.py).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from osu_diffusion_tpu_torch import CONTEXT_SIZE
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.models.dit import DiT_models
from osu_diffusion_tpu_torch.train.train_step import TrainCall, make_ema, make_optimizer, train_step
from osu_diffusion_tpu_torch.train.trainer import CLASS_DROPOUT_PROB
from osu_diffusion_tpu_torch.utils.benchmark import bench_device, device_fields, fence, significant

H100_BF16_PEAK_FLOPS = 989e12  # NVIDIA H100 SXM, dense bf16, 700 W
GROUP_STEPS = 8  # steps per timed group (the JAX tool's default steps per call)


def model_flops_per_step(n_params_active: int, batch: int, seq_len: int) -> float:
    """6·P·tokens forward+backward estimate for the parameterized matmuls."""
    return 6.0 * n_params_active * batch * seq_len


def attention_flops_per_step(depth: int, hidden: int, batch: int, seq_len: int,
                             band: int | None) -> float:
    """Ideal forward+backward FLOPs of the attention score and value
    matmuls (which 6·P·tokens misses): the exact banded pair count per query
    row (keys q - band < k <= q + band, clipped at the sequence edges),
    4·pairs·D forward (QK^T and PV at 2 FLOPs a multiply-add), x3 for
    forward+backward; like 6·P·tokens it leaves out the remat recompute."""
    q = np.arange(seq_len)
    if band is None:
        pairs = seq_len * seq_len
    else:
        lo = np.maximum(0, q - band + 1)
        hi = np.minimum(seq_len, q + band + 1)
        pairs = int((hi - lo).sum())
    return depth * 12.0 * hidden * pairs * batch


def synthetic_batch(n: int, t: int, num_classes: int, device) -> tuple:
    """Raw windows (N, T, 19) with positions on the playfield and rising
    times, the predecessors' coordinates and labels, from seed 0."""
    r = np.random.RandomState(0)
    raw = r.rand(n, t, 19).astype(np.float32)
    raw[..., :2] *= [512, 384]
    raw[..., 2] = np.cumsum(r.rand(n, t), axis=-1) * 200
    prev = np.tile([256.0, 192.0], (n, 1)).astype(np.float32)
    y = r.randint(0, num_classes, (n,))
    return (torch.from_numpy(raw).to(device), torch.from_numpy(prev).to(device),
            torch.from_numpy(y).long().to(device))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="DiT-B")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--calls", type=int, default=3,
                        help="timed groups: calls of --steps-per-call steps, or GROUP_STEPS steps at 1")
    parser.add_argument("--steps-per-call", type=int, default=1,
                        help="optimizer steps a call: > 1 times TrainCall's calls (one CUDA graph of "
                             "the k steps on the card)")
    parser.add_argument("--num-classes", type=int, default=52670)
    parser.add_argument("--no-bf16", action="store_true")
    parser.add_argument("--no-remat", action="store_true", help="disable per-block rematerialization")
    parser.add_argument("--mlp-bwd", choices=["fused", "xla"], default="xla",
                        help="the MLP half's backward: the fused kernels or plain torch")
    parser.add_argument("--band", type=int, default=None,
                        help="banded attention half-width (default: seq-len, as the trainer)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the timed calls there")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = bench_device(args.device)
    on_card = device.type == "cuda"
    model = DiT_models[args.model](num_classes=args.num_classes, context_size=CONTEXT_SIZE,
                                   class_dropout_prob=CLASS_DROPOUT_PROB, remat=not args.no_remat,
                                   mlp_bwd=args.mlp_bwd)
    model.initialize_weights(torch.Generator().manual_seed(0))
    # active parameters leave out the label table (a step touches 1-2 rows an item)
    n_params = sum(p.numel() for p in model.parameters())
    n_active = n_params - model.y_embedder.embedding_table.weight.numel()
    ema = make_ema(model)
    model.to(device).train()
    ema.to(device).eval()
    opt = make_optimizer(model.parameters())
    diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True, device=device)
    n, t = args.batch, args.seq_len
    band = t if args.band is None else args.band
    dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    batch = synthetic_batch(n, t, args.num_classes, device)
    generator = torch.Generator(device=device).manual_seed(1)

    k = args.steps_per_call
    call = None
    if k > 1:
        call = TrainCall(model, ema, opt, diffusion, generator=generator, graphed=on_card,
                         band=band, dtype=dtype)
        batches = tuple(a.unsqueeze(0).expand(k, *a.shape) for a in batch)

    def group():
        if call is not None:
            return call(batches)
        for _ in range(GROUP_STEPS):
            metrics = train_step(model, ema, opt, diffusion, batch, band=band, dtype=dtype,
                                 generator=generator)
        return metrics

    fence(group())  # builds the kernels and warms up (at k > 1 on the card: captures the graph)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
        prof.start()
    start = time.perf_counter()
    for _ in range(args.calls):
        metrics = group()
    fence(metrics)  # the steps chain through the weights: one fence covers them all
    elapsed = time.perf_counter() - start
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))

    steps_per_sec = args.calls * (GROUP_STEPS if call is None else k) / elapsed
    depth, hidden = len(model.blocks), model.t_embedder.mlp[2].out_features
    mm_flops = model_flops_per_step(n_active, n, t)
    attn_flops = attention_flops_per_step(depth, hidden, n, t, band)
    flops = mm_flops + attn_flops
    result = {
        "model": args.model, "remat": not args.no_remat, "bf16": not args.no_bf16,
        "mlp_bwd": args.mlp_bwd, "band": band, "batch": n, "seq_len": t, "steps_per_call": k,
        "capture_ms": None if call is None or call.graph is None else call.graph.capture_ms,
        "steps_per_sec": significant(steps_per_sec),
        "samples_per_sec": significant(steps_per_sec * n),
        "est_flops_per_step": flops,
        "attn_flops_per_step": attn_flops,
        "mfu": significant(steps_per_sec * flops / H100_BF16_PEAK_FLOPS),
        "peak_flops": H100_BF16_PEAK_FLOPS,
        "loss": float(metrics["loss"]),
        "peak_mem_gb": significant(torch.cuda.max_memory_allocated(device) / 1e9) if on_card else None,
        **device_fields(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
