"""Time variants of the bf16 Hopper dq body on the card, in turns.

Builds five copies of csrc/banded_attention_bwd.cu side by side, one nvcc
each, into the package's build directory: the committed body, QBUF = 3
query blocks in flight, STAGES = 2 and 6 K/V tiles in flight, and one CTA
per item in place of the persistent grid. Times each variant's dq at the
DiT-B training shape (q/k/v (256, 12, 128, 64) bf16, band 128) and its
ranged dq at the CP training shard ((32, 12, 512, 64), left edge), in
turns from the first variant to the last and back, and checks that every
variant gives the committed body's bits (the same sums in the same order).
Run from the repository root on a card:

    python -m osu_diffusion_tpu_torch.tools.dq_variants
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import types

import torch

from osu_diffusion_tpu_torch.ops import banded_attention as ba
from osu_diffusion_tpu_torch.ops import cuda_build
from osu_diffusion_tpu_torch.parallel.context import shard_bounds

GRID = "const int grid = min(per_sm * sms, (t + BQB - 1) / BQB * n * h);"


def variant_sources() -> dict[str, str]:
    src = open(os.path.join(cuda_build.CSRC_DIR, "banded_attention_bwd.cu")).read()
    edits = {
        "committed": None,
        "qbuf3": ("constexpr int QBUF = 2;", "constexpr int QBUF = 3;"),
        "stages2": ("constexpr int STAGES = 4;", "constexpr int STAGES = 2;"),
        "stages6": ("constexpr int STAGES = 4;", "constexpr int STAGES = 6;"),
        "cta_per_item": (GRID, "const int grid = (t + BQB - 1) / BQB * n * h;"),
    }
    out = {}
    for name, edit in edits.items():
        if edit is not None and src.count(edit[0]) != 1:
            raise RuntimeError(f"variant {name}: {edit[0]!r} is not in the source once")
        out[name] = src if edit is None else src.replace(*edit)
    return out


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once; prints each dq body's ptxas line."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "dq_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR,
             "-o", os.path.join(out_dir, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "banded_attn_bwd_dq_sm90" in line:
                ranged = "ranged " if "ILb1E" in line else ""
                print(f"[dq-variants] {name} {ranged}dq: "
                      + "; ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]))
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs


def main() -> None:
    from osu_diffusion_tpu_torch.utils.benchmark import cuda_ms, device_line

    if not torch.cuda.is_available():
        raise SystemExit("dq_variants: no CUDA device")
    print(device_line())
    libs = build(variant_sources())
    load = cuda_build.load_library

    def use(name):
        cuda_build.load_library = lambda lib: libs[name] if lib == "banded_attention_bwd" else load(lib)
        ba._bwd_lib.cache_clear()

    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    n, h, t, band = 256, 12, 128, 128
    qkv = torch.randn((n, t, 3 * h * 64), generator=g, device=dev).to(bf16)
    q, k, v = (a.view(n, t, h, 64).transpose(1, 2) for a in qkv.split(h * 64, dim=-1))
    do = torch.randn((n, t, h, 64), generator=g, device=dev).to(bf16).permute(0, 2, 1, 3)
    o, lse = ba.banded_attention_fwd_lse(q, k, v, band, t)
    bounds = shard_bounds(256, 128, types.SimpleNamespace(model_rank=0, num_model=2), None)
    cq, ck, cv = (torch.randn((32, 12, 512, 64), generator=g, device=dev).to(bf16) for _ in range(3))
    cdo = torch.randn((32, 512, 12, 64), generator=g, device=dev).to(bf16).permute(0, 2, 1, 3)
    co, clse = ba.banded_attention_ranged_fwd_lse(cq, ck, cv, band, bounds)

    def dq():
        return ba.banded_attention_bwd_dq(q, k, v, o, lse, do, band, t)

    def ranged_dq():
        return ba.banded_attention_ranged_bwd_dq(cq, ck, cv, co, clse, cdo, band, bounds)

    want = None
    for name in [*libs, *reversed(libs)]:
        use(name)
        got = (dq(), ranged_dq())
        torch.cuda.synchronize()
        want = want or got
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"[dq-variants] {name}: dq {cuda_ms(dq, iters=50):.4f} ms, ranged dq "
              f"{cuda_ms(ranged_dq, iters=50):.4f} ms, bits equal to the committed body's {same}",
              flush=True)
        if not same:
            raise SystemExit(f"dq_variants: {name} gives other bits")
    cuda_build.load_library = load
    ba._bwd_lib.cache_clear()


if __name__ == "__main__":
    main()
