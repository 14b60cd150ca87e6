"""The banded attention core at the training shapes (port of
tools/bench_flash.py).

Measures one attention core, bf16 q/k/v (batch, heads, T, head dim): the
forward with LSE alone (the training forward, row 2 of PERF.md's kernel
table) and forward + backward (rows 2, 3 and 4: the LSE forward, dq and
dk/dv). Defaults are DiT-B's long-window training shape (batch 16, 12
heads, T 1024, head dim 64, band 128); `--head-dim 72` is DiT-XL's.

Method: a data-dependent chain of the op (each iteration's output, for
forward + backward dq + 1e-3 (dk + dv), feeds the next iteration's q
through a tanh that keeps it bounded), timed with CUDA events at two chain
lengths (`--iters`), the best of `--reps`; the time per iteration is the
slope between the two, which cancels every fixed cost. The backward
differentiates q, k and v, so neither gradient kernel can drop out.

`--dense` adds the plain version (the masked softmax attention in plain
torch over the band mask) and `scaled_dot_product_attention` with the
band as a bool mask: yardsticks only, the port never calls them.

    python -m osu_diffusion_tpu_torch.tools.bench_flash --head-dim 72 --dense

The JAX tool's --blocks and --slim-stats choose Pallas tilings; the
kernels here have one tiling per build, so one row stands where the JAX
tool prints one per block.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from osu_diffusion_tpu_torch.ops import banded_attention as ba
from osu_diffusion_tpu_torch.utils.benchmark import bench_device, cuda_ms, device_fields, significant

H100_BF16_PEAK_FLOPS = 989e12  # NVIDIA H100 SXM, dense bf16, 700 W


def banded_pairs(t: int, band: int) -> int:
    """(query, key) pairs in the band, per (batch, head)."""
    q = np.arange(t)
    return int((np.minimum(t, q + band + 1) - np.maximum(0, q - band + 1)).sum())


def fwd_bwd(attend):
    """q -> dq + 1e-3 (dk + dv) of sum(attend(q, k, v)^2)."""
    def op(q, k, v):
        with torch.enable_grad():
            q, k, v = (a.detach().requires_grad_() for a in (q, k, v))
            loss = attend(q, k, v).float().square().sum()
            dq, dk, dv = torch.autograd.grad(loss, (q, k, v))
        return dq + dk * 1e-3 + dv * 1e-3
    return op


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--band", type=int, default=128)
    p.add_argument("--iters", type=int, nargs=2, default=[10, 50],
                   help="short/long chain lengths; per-iteration time is the slope between them")
    p.add_argument("--reps", type=int, default=4, help="timed chains per length; the best is kept")
    p.add_argument("--dense", action="store_true",
                   help="also time the plain version and SDPA over the band mask")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = bench_device(args.device)
    on_card = device.type == "cuda"

    n, h, t, dh, band = args.batch, args.heads, args.seq_len, args.head_dim, args.band
    g = torch.Generator(device=device).manual_seed(0)
    # bf16 operands (the training stream's type) in the model's layout: head
    # views (N, H, T, Dh) of (N, T, H, Dh) buffers, the kernels' outputs' too
    q, k, v = (torch.randn((n, t, h, dh), generator=g, device=device).to(torch.bfloat16)
               .permute(0, 2, 1, 3) for _ in range(3))
    l_short, l_long = args.iters

    def chain(op, length):
        x = q
        with torch.no_grad():
            for _ in range(length):
                # the kernels take q, k and v with one set of strides: q's
                x = torch.empty_like(q).copy_(torch.tanh(op(x, k, v).float()))
        return x

    def run_ms(fn) -> float:
        if on_card:
            return cuda_ms(fn, iters=1, warmup=0)
        start = time.perf_counter()
        fn()
        return (time.perf_counter() - start) * 1e3

    def timed(op) -> float:
        """ms per chained iteration: the slope between the two lengths, each
        the best of `reps` chains after one warm-up."""
        ms = {}
        for length in (l_short, l_long):
            chain(op, length)
            ms[length] = min(run_ms(lambda: chain(op, length)) for _ in range(args.reps))
        return (ms[l_long] - ms[l_short]) / (l_long - l_short)

    def kernels(q, k, v):
        return ba.banded_attention(q, k, v, band)

    def lse_forward(q, k, v):
        return ba.banded_attention_fwd_lse(q, k, v, band)[0]

    rows = [{"path": "kernels", "fwd_ms": significant(timed(lse_forward)),
             "fwd_bwd_ms": significant(timed(fwd_bwd(kernels)))}]
    print(json.dumps(rows[0]), flush=True)

    if args.dense:
        mask = ba.banded_attention_mask(t, band, device)

        def plain(q, k, v):
            return ba.banded_attention_fwd_lse_reference(q, k, v, band, t, torch.bfloat16)[0]

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        for name, attend in (("plain_dense", plain), ("sdpa_dense", sdpa)):
            rows.append({"path": name, "fwd_ms": significant(timed(attend)),
                         "fwd_bwd_ms": significant(timed(fwd_bwd(attend)))})
            print(json.dumps(rows[-1]), flush=True)

    # ideal banded attention FLOPs for context (forward 4·pairs·dh; the
    # backward ~3.5x the forward: dq 3 matmuls and dk/dv 4 over the same pairs)
    flops_fwd = 4.0 * banded_pairs(t, band) * dh * n * h
    summary = {
        "shapes": {"batch": n, "heads": h, "t": t, "dh": dh, "band": band},
        "ideal_fwd_ms_at_peak": significant(flops_fwd / H100_BF16_PEAK_FLOPS * 1e3),
        "ideal_fwdbwd_ms_at_peak": significant(4.5 * flops_fwd / H100_BF16_PEAK_FLOPS * 1e3),
        **device_fields(device),
    }
    print(json.dumps(summary), flush=True)
    return rows + [summary]


if __name__ == "__main__":
    main()
