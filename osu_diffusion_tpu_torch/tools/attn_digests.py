"""Digests of the banded-attention kernels' outputs at head dim 64 on fixed
seeded inputs, one line per output: run it over two source trees on one
card (e.g. the parent commit unpacked by `git archive` and this one) and
compare the lines to show that a change kept the kernels' bits.

Covers rows 1-6 at DiT-B's shapes: the inference forward on f32 q/k/v
(head views of a packed qkv, o in f32 and in bf16) and on bf16 ones, at the
sampling shape and three ragged ones; the forward with LSE, dq and dk/dv
on bf16 q/k/v at the training window (batch cut to 32); the ranged
forward (with and without LSE), dq and dk/dv on a context-parallel shard.
Run on a card, once per tree (DIR: the root of a checkout, `.` for this
one; each builds its kernels into its own build directory):

    python osu_diffusion_tpu_torch/tools/attn_digests.py --tree DIR

(as a script: `python -m` would import this checkout's package first).
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import types

import torch


def digest(a: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of a's bytes."""
    return hashlib.sha256(a.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, help="the root of the source tree to import the package from")
    sys.path.insert(0, parser.parse_args().tree)
    from osu_diffusion_tpu_torch.ops import banded_attention as ba
    from osu_diffusion_tpu_torch.parallel.context import shard_bounds

    if not torch.cuda.is_available():
        raise SystemExit("attn_digests: no CUDA device")
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"package {ba.__file__}")

    def show(name, *outs):
        torch.cuda.synchronize()
        print(f"{name}: " + " ".join(digest(o) for o in outs))

    # row 1: (name, N, H, T, valid_len, band), head views of a packed qkv
    for name, n, h, t, valid, band in [("main", 2, 12, 768, 757, 128), ("band20", 1, 3, 200, 190, 20),
                                       ("t50", 2, 2, 50, 50, 128), ("masked_rows", 1, 2, 256, 60, 16)]:
        qkv = torch.randn((n, t, 3 * h * 64), generator=g, device=dev)
        q, k, v = (a.view(n, t, h, 64).transpose(1, 2) for a in qkv.split(h * 64, dim=-1))
        show(f"row 1 {name} f32", ba.banded_attention(q, k, v, band, valid),
             ba.banded_attention(q, k, v, band, valid, out_dtype=bf16))
        q, k, v = (a.to(bf16) for a in (q, k, v))
        show(f"row 1 {name} bf16", ba.banded_attention(q, k, v, band, valid))

    # rows 2-4: the training window, bf16 (batch cut to 32)
    q, k, v = (torch.randn((32, 12, 128, 64), generator=g, device=dev).to(bf16) for _ in range(3))
    o, lse = ba.banded_attention_fwd_lse(q, k, v, 128, 128)
    do = torch.randn((32, 128, 12, 64), generator=g, device=dev).to(bf16).permute(0, 2, 1, 3)
    show("row 2", o, lse)
    show("row 3", ba.banded_attention_bwd_dq(q, k, v, o, lse, do, 128, 128))
    show("row 4", *ba.banded_attention_bwd_dkv(q, k, v, o, lse, do, 128, 128))

    # rows 5-6: a CP shard (T_loc 256 of 2, halo 128), f32 and bf16
    bounds = shard_bounds(256, 128, types.SimpleNamespace(model_rank=0, num_model=2), None)
    for stream in (torch.float32, bf16):
        q, k, v = (torch.randn((4, 12, 512, 64), generator=g, device=dev).to(stream) for _ in range(3))
        do = torch.randn((4, 512, 12, 64), generator=g, device=dev).to(stream).permute(0, 2, 1, 3)
        o, lse = ba.banded_attention_ranged_fwd_lse(q, k, v, 128, bounds)
        show(f"row 5 {stream}", ba.banded_attention_ranged(q, k, v, 128, bounds), o, lse)
        show(f"row 6 {stream}", ba.banded_attention_ranged_bwd_dq(q, k, v, o, lse, do, 128, bounds),
             *ba.banded_attention_ranged_bwd_dkv(q, k, v, o, lse, do, 128, bounds))


if __name__ == "__main__":
    main()
