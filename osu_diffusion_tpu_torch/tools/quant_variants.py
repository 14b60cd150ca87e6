"""Time variants of the int8 serving kernels' Hopper body (rows 10 and 11:
the modulate pass and kernel B's GEMM over int8 codes, csrc/gemm_sm90.cuh's
B_INT8) on the card, in turns.

Builds copies of csrc/adaln_mlp.cu side by side (one nvcc each, into the
package's build directory), each with its own csrc/gemm_sm90.cuh: the
committed body (the 256 consumer threads upcast each their share of slab
g + 1 while their warpgroup's products of slab g run), one in which the
producer warpgroup's three idle warps upcast instead, variants of the
upcast loop (how far it is unrolled) and of the ring (a stage fewer at
128-wide tiles: 256-wide ones have the fewest the upcast allows), and
four that are wrong on purpose and only timed: one that skips the upcast
(the stage's bf16 slab is left as it was), one without the proxy fence,
one that stores the codes' bytes unconverted (the upcast's shared-memory
traffic without its arithmetic) and one that converts but stores one word
a thread (its arithmetic without most of its stores). Times, at the
DiT-B sampling shape (x (2, 768, 768) f32, fc1 (3072, 768), qkv (2304,
768) codes), row 10's up and down GEMMs and row 11's GEMM alone, beside row
7's bf16 GEMMs over the same codes as bf16 weights, in turns from the first
variant to the last and back; a variant that must compute the same function
must give the committed body's bits. Run from the repository root on a
card:

    python -m osu_diffusion_tpu_torch.tools.quant_variants
"""
from __future__ import annotations

import os

import torch

from osu_diffusion_tpu_torch.ops import adaln_mlp as am
from osu_diffusion_tpu_torch.ops import cuda_build
from osu_diffusion_tpu_torch.ops import quant as tq
from osu_diffusion_tpu_torch.tools.mlp_variants import build

LOOP = "#pragma unroll 2\n  for (int p = threadIdx.x; p < BN * 4; p += CONSUMERS) {"
FENCE = "  sm90::fence_proxy_async();  // the stores, before wgmma reads them\n"
STAGES = "BL == B_INT8 ? (BN == 256 ? 3 : 5)"
UPCAST = """    const uint2 e0 = tile_io::int8x4_to_bf16x4(v.x);
    const uint2 e1 = tile_io::int8x4_to_bf16x4(v.y);
    const uint2 e2 = tile_io::int8x4_to_bf16x4(v.z);
    const uint2 e3 = tile_io::int8x4_to_bf16x4(v.w);
"""
STORES = """    *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) = make_uint4(e0.x, e0.y, e1.x, e1.y);
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ (r & 7)) << 4)) = make_uint4(e2.x, e2.y, e3.x, e3.y);
"""
# the producer warpgroup's three idle warps (96 threads) upcast instead of
# the consumers, each slab as soon as its codes land, one arrival per warp
# on the stage's `full` barrier; they keep 56 registers a thread, the
# consumers 224
CONVERTER_WARPS = (
    ("constexpr int PRODUCER_REGS = 40;", "constexpr int PRODUCER_REGS = 56;"),
    ("constexpr int CONSUMER_REGS = 232;", "constexpr int CONSUMER_REGS = 224;"),
    ("      bar_init(&sm.full[s], 1);", "      bar_init(&sm.full[s], INT8 ? 4 : 1);"),
    (LOOP, LOOP.replace("p = threadIdx.x;", "p = threadIdx.x - CONSUMERS - 32;")
               .replace("p += CONSUMERS", "p += 96")),
    ("    }\n    return;\n  }\n",
     "    } else if constexpr (INT8) {\n"
     "      const int own = (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;\n"
     "      if (threadIdx.x >= CONSUMERS + 32) {\n"
     "        for (int g = 0; g < own * ktiles; ++g) {\n"
     "          upcast_slab<BN>(sm, g);\n"
     "          __syncwarp();\n"
     "          if (threadIdx.x % 32 == 0) sm90::bar_arrive(&sm.full[g % C::STAGES]);\n"
     "        }\n"
     "      }\n"
     "    }\n    return;\n  }\n"),
    ("  if constexpr (INT8) {\n    upcast_slab<BN>(sm, 0);\n    consumers_sync();\n  }\n", ""),
    ("      if constexpr (INT8) {  // the next slab, while these products run\n"
     "        if (g + 1 < slabs) upcast_slab<BN>(sm, g + 1);\n      }\n", ""),
    ("      if constexpr (INT8) consumers_sync();  // every share of the next slab is upcast\n", ""),
)
# name -> (gemm_sm90.cuh edits (old, new), whether it computes the committed function)
VARIANTS = {
    "committed": ((), True),
    "converter_warps": (CONVERTER_WARPS, True),
    "unroll1": (((LOOP, LOOP.replace("unroll 2", "unroll 1")),), True),
    "unroll4": (((LOOP, LOOP.replace("unroll 2", "unroll 4")),), True),
    "stage_fewer": (((STAGES, "BL == B_INT8 ? (BN == 256 ? 3 : 4)"),), True),
    "no_upcast": (((LOOP, LOOP.replace("p < BN * 4", "p < 0")),), False),
    "no_fence": (((FENCE, ""),), False),
    "stores_only": (((UPCAST, "    const uint2 e0 = make_uint2(v.x, v.y), e1 = make_uint2(v.z, v.w), "
                              "e2 = e0, e3 = e1;\n"),), False),
    "math_only": (((STORES, "    if (((e0.x ^ e0.y ^ e1.x ^ e1.y ^ e2.x ^ e2.y ^ e3.x ^ e3.y) & 0xFFFF) == 0x7FC1)\n"
                            "      *reinterpret_cast<unsigned*>(row) = e0.x;\n"),), False),
}


def variant_sources() -> dict[str, dict[str, str]]:
    def read(name):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            return f.read()

    src, header = read("adaln_mlp.cu"), read("gemm_sm90.cuh")
    sources = {}
    for name, (edits, _) in VARIANTS.items():
        text = header
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"quant_variants: {name}'s edit does not match gemm_sm90.cuh once")
            text = text.replace(old, new)
        sources[name] = {"adaln_mlp.cu": src, "gemm_sm90.cuh": text}
    return sources


def main() -> None:
    from osu_diffusion_tpu_torch.utils.benchmark import cuda_ms, device_line

    if not torch.cuda.is_available():
        raise SystemExit("quant_variants: no CUDA device")
    print(device_line())
    libs, logs = build(variant_sources(), out="quant_variants")
    for name, log in logs.items():
        spills = sorted({line.strip() for line in log.splitlines() if "spill stores" in line})
        print(f"[quant-variants] {name} ptxas: {'; '.join(spills)}")
    load = cuda_build.load_library

    def use(lib):
        cuda_build.load_library = lambda name: libs[lib] if name == "adaln_mlp" else load(name)
        am._lib.cache_clear()
        tq._gemm_lib.cache_clear()

    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    n, t, d = 2, 768, 768

    def codes(m, k):
        return tq.quantize_weight(torch.randn((m, k), generator=g, device=dev) * k ** -0.5)

    mod = torch.randn((n, 6 * d), generator=g, device=dev) * 0.3
    x = torch.randn((n, t, d), generator=g, device=dev)
    (w1q, s1), (w2q, s2), (wq, s) = codes(4 * d, d), codes(d, 4 * d), codes(3 * d, d)
    b1, b2, b = (torch.randn(k, generator=g, device=dev) * 0.02 for k in (4 * d, d, 3 * d))
    mlp_args = (x, mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:], w1q, s1, b1, w2q, s2, b2)
    qkv_args = (x, mod[:, :d], mod[:, d:2 * d], wq, s, b)
    wide = (*mlp_args[:4], w1q.to(bf16), b1, w2q.to(bf16), b2)

    def whole():
        return (am.adaln_mlp_quant(*mlp_args), tq.int8_modulated_matmul(*qkv_args))

    use("committed")
    want = whole()
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for name in order:
        use(name)
        same = all(torch.equal(u, v) for u, v in zip(whole(), want))
        if VARIANTS[name][1] and not same:
            raise RuntimeError(f"quant_variants: {name} gave other bits than the committed body")
        ms = {"row 10 up": cuda_ms(lambda: am._quant_launch(*mlp_args, 1e-6, bf16, stages=2)),
              "row 10 down": cuda_ms(lambda: am._quant_launch(*mlp_args, 1e-6, bf16, stages=4)),
              "row 11 GEMM": cuda_ms(lambda: tq._modulated_launch(*qkv_args, 1e-6, bf16, stages=2)),
              "row 7 up": cuda_ms(lambda: am._launch(am.adaln_mlp, *wide, 1e-6, bf16, residuals=False,
                                                     stages=2)),
              "row 7 down": cuda_ms(lambda: am._launch(am.adaln_mlp, *wide, 1e-6, bf16,
                                                       residuals=False, stages=4))}
        print(f"[quant-variants] {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" ms; bits equal to the committed body's {same}")


if __name__ == "__main__":
    main()
