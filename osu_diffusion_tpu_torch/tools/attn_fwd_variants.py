"""Time variants of the banded-attention forward's Hopper body on the card,
in turns, and hold the bf16 stream's bits to another checkout's.

Builds copies of csrc/banded_attention.cu side by side (one nvcc each, into
the package's build directory), which differ in how f32 q/k/v reach the
bf16 slabs that wgmma reads:
- committed: each consumer thread copies its own 16-byte chunks of tile
  i + 2's f32 rows (cp.async) into a one-tile f32 staging buffer before
  tile i's softmax, and rounds them to bf16 into the swizzled slab while
  tile i + 1's Q.K^T runs;
- register_loads: the first form the issue named: the same, with each
  thread's chunks loaded into registers (8 float4) instead of shared
  memory (ptxas's spills are printed);
- tma_staging: the second form, gemm_sm90.cuh's B_INT8 pattern: a producer
  warp loads each f32 tile by TMA, unswizzled, into a one-tile f32 staging
  buffer (q's 128 rows first), and the consumers convert it from there into
  the swizzled slab while the current tile's Q.K^T runs (a proxy fence and
  a barrier before the next tile's products), releasing the buffer for the
  next tile's load;
- with `--baseline DIR`: the forward of another checkout of the repository
  at DIR (e.g. the parent commit unpacked by `git archive`), whose bf16
  entries (rows 2 and 5 with LSE) must give the committed body's bits.
Times, in turns from the first variant to the last and back: row 1 (f32
q/k/v head views of the packed (2, 768, 2304) qkv, valid 757, band 128; o
in f32 and in bf16), row 5 without LSE (the CP sampling shard, (2, 12, 640,
64) f32, shard 0 of 2), and, for the committed body and the baseline, row
1's shape with bf16 q/k/v (the same walk without the conversion), row 2
(bf16 (256, 12, 128, 64), band 128) and row 5 with LSE (the CP training
shard, (32, 12, 512, 64) bf16, shard 0 of 2). The f32 variants must give
the committed body's bits (the same conversion and products). Run from the
repository root on a card:

    python -m osu_diffusion_tpu_torch.tools.attn_fwd_variants [--baseline DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import math
import os
import re
import subprocess
import types

import torch

from osu_diffusion_tpu_torch.ops import banded_attention as ba
from osu_diffusion_tpu_torch.ops import cuda_build
from osu_diffusion_tpu_torch.parallel.context import shard_bounds
from osu_diffusion_tpu_torch.tools.mlp_variants import build

# the committed way in: F32Stage's definition (cp.async into the f32 staging buffer)
STAGE_START = "struct F32Stage {\n"
STAGE_END = "\n};\n\ntemplate <typename TO>\n__device__ __forceinline__ void store_pair("

# the register form: each thread loads its 16-byte chunks of the next tile
# into 8 float4 registers (q: the same 8), held until they are rounded and
# stored into the slab
REGISTER_STAGE = """struct F32Stage {
  float4 r[BQ * (DH / 4) / CONSUMERS];  // the block in flight: q's rows, or a tile's K then V

  template <int ROWS>
  __device__ __forceinline__ void load(int off, const float* src, int r0, int t, long long st) {
#pragma unroll
    for (int j = 0; j < ROWS * (DH / 4) / CONSUMERS; ++j) {
      const int idx = j * CONSUMERS + static_cast<int>(threadIdx.x);
      const int row = r0 + idx / (DH / 4);
      r[off + j] = row < t ? *reinterpret_cast<const float4*>(src + row * st + 4 * (idx % (DH / 4)))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  template <int ROWS>
  __device__ __forceinline__ void store(int off, __nv_bfloat16* tile) const {
    unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
    for (int j = 0; j < ROWS * (DH / 4) / CONSUMERS; ++j) {
      const int idx = j * CONSUMERS + static_cast<int>(threadIdx.x);
      *reinterpret_cast<uint2*>(base + sm90::swizzled(idx / (DH / 4), 4 * (idx % (DH / 4)))) =
          make_uint2(sm90::pack_bf16(r[off + j].x, r[off + j].y), sm90::pack_bf16(r[off + j].z, r[off + j].w));
    }
  }
  __device__ __forceinline__ void copy_q(SmemF32&, const F32Src& src, long long base, int q0, int t) {
    load<BQ>(0, src.q + base, q0, t, src.st);
  }
  __device__ __forceinline__ void land_q(SmemF32& sm) { store<BQ>(0, sm.q[0]); }
  __device__ __forceinline__ void copy_tile(SmemF32&, const F32Src& src, long long base, int kbase,
                                            int t) {
    load<BK>(0, src.k + base, kbase, t, src.st);
    load<BK>(BK * (DH / 4) / CONSUMERS, src.v + base, kbase, t, src.st);
  }
  __device__ __forceinline__ void land_tile(SmemF32& sm, int s) {
    store<BK>(0, sm.k[s]);
    store<BK>(BK * (DH / 4) / CONSUMERS, sm.v[s]);
  }"""

# the TMA form: a producer warp loads each f32 block by TMA, unswizzled,
# into the staging buffer; the consumers convert it (fill 0: q, then one a
# tile) and hand the buffer back on `f32_empty`
TMA_STAGE = """struct F32Stage {
  int fill = 0;  // the staging buffer's next fill

  template <int ROWS>
  static __device__ __forceinline__ void convert(const float* from, __nv_bfloat16* tile) {
    unsigned char* b = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
    for (int j = 0; j < ROWS * (DH / 4) / CONSUMERS; ++j) {
      const int idx = j * CONSUMERS + static_cast<int>(threadIdx.x);
      const float4 v = reinterpret_cast<const float4*>(from)[idx];
      *reinterpret_cast<uint2*>(b + sm90::swizzled(idx / (DH / 4), 4 * (idx % (DH / 4)))) =
          make_uint2(sm90::pack_bf16(v.x, v.y), sm90::pack_bf16(v.z, v.w));
    }
  }
  __device__ __forceinline__ void take(SmemF32& sm, __nv_bfloat16* a, __nv_bfloat16* b) {
    bar_wait(&sm.f32_full, fill++ & 1);
    if (b == nullptr) {
      convert<BQ>(sm.f32, a);
    } else {
      convert<BK>(sm.f32, a);
      convert<BK>(sm.f32 + BK * DH, b);
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) bar_arrive(&sm.f32_empty);
  }
  __device__ __forceinline__ void copy_q(SmemF32&, const F32Src&, long long, int, int) {}
  __device__ __forceinline__ void land_q(SmemF32& sm) { take(sm, sm.q[0], nullptr); }
  __device__ __forceinline__ void copy_tile(SmemF32&, const F32Src&, long long, int, int) {}
  __device__ __forceinline__ void land_tile(SmemF32& sm, int s) { take(sm, sm.k[s], sm.v[s]); }"""
CONSUMERS_SYNC = 'asm volatile("bar.sync 1, 256;\\n" ::: "memory");'
TMA_STAGING = (
    ("struct SmemF32 : Smem {\n  alignas(128) float f32[2 * BK * DH];\n};",
     "struct SmemF32 : Smem {\n  alignas(128) float f32[2 * BK * DH];\n"
     "  unsigned long long f32_full, f32_empty;\n};"),
    ("  return std::is_same_v<TI, float> ? CONSUMERS : CONSUMERS + 32;", "  return CONSUMERS + 32;"),
    ("  if constexpr (!F32) {\n    if (threadIdx.x == 0) {\n      bar_init(&sm.q_full, 1);",
     """  if constexpr (F32) {
    if (threadIdx.x == 0) {
      bar_init(&sm.f32_full, 1);
      bar_init(&sm.f32_empty, CONSUMERS / 32);
      sm90::bar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x >= CONSUMERS) {
      if (threadIdx.x == CONSUMERS && ntiles > 0) {
        bar_expect(&sm.f32_full, BQ * DH * 4);
        tma_load(sm.f32, &q_map, &sm.f32_full, q0, hb, nb);
        for (int i = 0; i < ntiles; ++i) {
          bar_wait(&sm.f32_empty, i & 1);
          bar_expect(&sm.f32_full, 2 * BK * DH * 4);
          tma_load(sm.f32, &k_map, &sm.f32_full, (kt0 + i) * BK, hb, nb);
          tma_load(sm.f32 + BK * DH, &v_map, &sm.f32_full, (kt0 + i) * BK, hb, nb);
        }
      }
      return;
    }
  }
  if constexpr (!F32) {
    if (threadIdx.x == 0) {
      bar_init(&sm.q_full, 1);"""),
    ("      sm90::fence_proxy_async();  // the stores, before wgmma reads them\n      __syncthreads();",
     "      sm90::fence_proxy_async();  // the stores, before wgmma reads them\n      " + CONSUMERS_SYNC),
    ("      __syncthreads();  // tile i + 1 is stored, and stage s is free", "      " + CONSUMERS_SYNC),
    ("""  if constexpr (!std::is_same_v<TI, float>) {
    int err = sm90::make_map(&q_map, q, n, h, t, sn, sh, st, BQ);
    if (err == 0) err = sm90::make_map(&k_map, k, n, h, t, sn, sh, st, BK);
    if (err == 0) err = sm90::make_map(&v_map, v, n, h, t, sn, sh, st, BK);""",
     """  {
    const auto map = std::is_same_v<TI, float> ? make_map_f32 : sm90::make_map;
    int err = map(&q_map, q, n, h, t, sn, sh, st, BQ);
    if (err == 0) err = map(&k_map, k, n, h, t, sn, sh, st, BK);
    if (err == 0) err = map(&v_map, v, n, h, t, sn, sh, st, BK);"""),
    ("template <bool RANGED, typename TI, typename TO>\nint launch(",
     """// a map of the (N, H, T, 64) f32 tensor, boxes of `rows` x 64, unswizzled
int make_map_f32(CUtensorMap* map, const void* base, int n, int h, int t, long long sn,
                 long long sh, long long st, int rows) {
  const sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return sm90::TMA_ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 4, static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(sn) * 4};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : sm90::TMA_ENCODE_ERROR + static_cast<int>(r);
}

template <bool RANGED, typename TI, typename TO>
int launch("""),
)
# name -> (F32Stage's definition or None for the committed one, other edits)
VARIANTS = {"committed": (None, ()), "register_loads": (REGISTER_STAGE, ()),
            "tma_staging": (TMA_STAGE, TMA_STAGING)}


def variant_sources(baseline: str | None) -> dict[str, dict[str, str]]:
    """Each variant's files (name -> text): its banded_attention.cu, and for
    the baseline the other checkout's csrc/ files."""
    with open(os.path.join(cuda_build.CSRC_DIR, "banded_attention.cu")) as f:
        src = f.read()
    out = {}
    for name, (stage, edits) in VARIANTS.items():
        text = src
        if stage is not None:  # F32Stage's body, from its opening line to its closing brace
            head, rest = text.split(STAGE_START, 1)
            text = head + stage + STAGE_END + rest.split(STAGE_END, 1)[1]
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"attn_fwd_variants: {name}'s edit does not match once: {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = {"banded_attention.cu": text}
    if baseline is not None:
        csrc = os.path.join(baseline, "osu_diffusion_tpu_torch", "csrc")
        out["baseline"] = {}
        for path in glob.glob(os.path.join(csrc, "*.cu*")):
            with open(path) as f:
                out["baseline"][os.path.basename(path)] = f.read()
    return out


def bind(lib: ctypes.CDLL, out_flag: bool) -> ctypes.CDLL:
    """The four forward entries' argument types; `out_flag`: the inference
    entry takes o's type (this tree's interface, not an older one's)."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for name, lse, ranged in (("banded_attention_fwd", 0, 0), ("banded_attention_fwd_lse", 1, 0),
                              ("banded_attention_fwd_ranged", 0, 1), ("banded_attention_fwd_ranged_lse", 1, 1)):
        fn = getattr(lib, name)
        fn.restype = i
        extra = [i] if out_flag and name == "banded_attention_fwd" else []
        fn.argtypes = [p] * (4 + lse) + [i] * 3 + [ll] * 6 + [i] * (5 if ranged else 2) + [f, i] + extra + [p]
    lib.banded_attention_error_string.restype = ctypes.c_char_p
    lib.banded_attention_error_string.argtypes = [i]
    return lib


def forward(lib, out_flag, q, k, v, band, mask, lse=False, out_dtype=None):
    """One forward entry of `lib`: (o, lse or None). `mask`: (valid_len,) or
    the ranged bounds."""
    n, h, t, dh = q.shape
    o = ba._heads_out(q, out_dtype)
    lse_t = torch.empty((n * h, t), device=q.device, dtype=torch.float32) if lse else None
    name = "banded_attention_fwd" + ("_ranged" if len(mask) == 4 else "") + ("_lse" if lse else "")
    out_arg = [int(o.dtype == torch.bfloat16)] if out_flag and name == "banded_attention_fwd" else []
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *([lse_t.data_ptr()] if lse else []),
        n, h, t, *q.stride()[:3], *o.stride()[:3], band, *mask, 1.0 / math.sqrt(dh),
        int(q.dtype == torch.bfloat16), *out_arg, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: error {err} ({lib.banded_attention_error_string(err).decode()})")
    return o, lse_t


def cases(dev):
    """name -> (q, k, v, band, mask, lse, out_dtype, f32 stream)."""
    g = torch.Generator(device=dev).manual_seed(3)

    def heads(n, t, h, dtype):
        qkv = torch.randn((n, t, 3 * h * 64), generator=g, device=dev).to(dtype)
        return [a.view(n, t, h, 64).transpose(1, 2) for a in qkv.split(h * 64, dim=-1)]

    def shard(n, t_loc, dtype, valid):
        bounds = shard_bounds(t_loc, 128, types.SimpleNamespace(model_rank=0, num_model=2), valid)
        return [torch.randn((n, 12, t_loc + 256, 64), generator=g, device=dev).to(dtype)
                for _ in range(3)], bounds

    f32, bf16 = torch.float32, torch.bfloat16
    row1 = heads(2, 768, 12, f32)
    row5, b5 = shard(2, 384, f32, 757)
    row2 = heads(256, 128, 12, bf16)
    row5l, b5l = shard(32, 256, bf16, None)
    return {"row 1": (*row1, 128, (757,), False, None, True),
            "row 1, bf16 o": (*row1, 128, (757,), False, bf16, True),
            "row 1's shape in bf16": (*(a.to(bf16) for a in row1), 128, (757,), False, None, False),
            "row 5 no LSE": (*row5, 128, b5, False, None, True),
            "row 2": (*row2, 128, (128,), True, None, False),
            "row 5 with LSE": (*row5l, 128, b5l, True, None, False)}


def resources(log: str) -> str:
    """ptxas's registers and spills of each forward build in an nvcc log."""
    from chip_smoke import attn_build_name

    kernel = "banded_attn_fwd_sm90_kernel"
    out, entry, spills = [], None, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), None
        elif entry and kernel in entry:
            if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                spills = int(m[1]) + int(m[2])
            if (m := re.search(r"Used (\d+) registers", line)):
                out.append(f"{attn_build_name(entry, kernel, 'fwd')} {m[1]} registers, {spills} spill bytes")
    return "; ".join(out)


def main() -> None:
    from chip_smoke import cuda_ms  # the repository's kernel timer (run from the root)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="another checkout of the repository, whose bf16 forward "
                        "must give the committed body's bits")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_fwd_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs, logs = build(variant_sources(opts.baseline), main="banded_attention.cu", out="attn_fwd_variants")
    for name, log in logs.items():
        print(f"[attn-fwd-variants] {name} (ptxas): {resources(log)}", flush=True)
    libs = {name: (bind(lib, name != "baseline"), name != "baseline") for name, lib in libs.items()}
    work = cases("cuda")
    order = list(libs)
    want = {}
    for name in order + order[::-1]:
        lib, out_flag = libs[name]
        times = []
        for case, (q, k, v, band, mask, lse, out_dtype, f32) in work.items():
            if not f32 and name not in ("committed", "baseline"):
                continue  # the variants' bf16 path is the committed one
            if out_dtype is not None and not out_flag:
                continue  # an older interface has no bf16 o for f32 inputs
            got = forward(lib, out_flag, q, k, v, band, mask, lse, out_dtype)
            torch.cuda.synchronize()
            ref = want.setdefault(case, got)
            same = all(a is None or torch.equal(a, b) for a, b in zip(got, ref))
            if not same and (not f32 or name != "baseline"):
                raise SystemExit(f"attn_fwd_variants: {name} gives other bits than the committed body "
                                 f"for {case}")
            ms = cuda_ms(lambda: forward(lib, out_flag, q, k, v, band, mask, lse, out_dtype), iters=50)
            times.append(f"{case} {ms:.4f} ms (bits equal to the committed body's: {same})")
        print(f"[attn-fwd-variants] {name}: " + "; ".join(times), flush=True)


if __name__ == "__main__":
    main()
