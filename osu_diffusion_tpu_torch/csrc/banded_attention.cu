// Banded attention forward for Hopper, sm_90a: inference, and training with
// the per-row log-sum-exp; each also ranged, for context parallelism. One
// body for both stream types (f32 or bf16 q/k/v).
//
// Replaces: osu_diffusion_tpu/ops/pallas_attention.py,
//   _banded_attn_fwd_kernel without LSE (called via _banded_flash_fwd_impl,
//   entry banded_attention_fwd) and with LSE (with_lse=True via _fwd,
//   entry banded_attention_fwd_lse); and the same kernel body with its
//   bounds_ref, called via _ranged_fwd_impl (entries
//   banded_attention_fwd_ranged and banded_attention_fwd_ranged_lse).
//
// Ranged (the RANGED template flag; the unranged build is the same code):
// q/k/v are one context-parallel shard's halo-extended rows, and the
// runtime bounds mask keys outside [k_lo, k_hi) (the halo an edge shard has
// no neighbour for, and the global padded tail). Query rows outside
// [q_lo, q_hi) are the pad rows of q: whole 64-row halves there are not
// computed (0 and LSE -1e30 are written), and the key loop walks only the
// tiles that meet [k_lo, k_hi).
//
// Computes, per (batch, head) and query row q, for a head dim Dh of 64
// (DiT-S/B/L) or 72 (DiT-XL), in every entry:
//   o[q] = sum_k softmax_k(s[q, k]) v[k],  s = bf16(q * Dh^-1/2) . bf16(k)
// over the keys allowed by the band  q - L < k <= q + L  and k < valid_len,
// with bf16 operands, f32 accumulation and an f32 online softmax, and with
// LSE the row's m + log(max(l, 1e-30)) into an (N*H, T) f32 array (the one
// layout the port keeps: the TPU kernel's lane-broadcast and sublane-packed
// layouts only work around Mosaic's (8, 128) tile). q/k/v are f32 (the
// sampling stream) or bf16 (the training stream), one type per call; o is
// q's type, or bf16 for an f32 q (the inference entries' `out_bf16`,
// unranged and ranged: the int8 block's out projection rounds o to bf16
// first, so the forward writes it so, which equals rounding the f32 o). valid_len is a runtime
// argument, so one build serves every sequence length; the inference entry
// also takes it from device memory (`valid_ptr`, read once by each CTA, as
// the TPU kernel reads valid_ref from SMEM), so a CUDA graph captured
// around it serves every length of its bucket. A row whose band
// holds no valid key writes 0, never NaN: such rows are padding, and the
// next layer reads them as K/V rows, where 0 * NaN would poison the valid
// rows. Its LSE is about -1e30; the backward masks such rows itself.
//
// What bounds it on the card: at the training shape (N*H = 3072, T = L =
// 128, bf16) it moves 4 x 3072 x 128 x 64 x 2 B = 201 MB plus a 1.6 MB LSE
// (60 us at 3.35 TB/s) against 6.4 GFLOP (6.5 us at 989 TFLOP/s): bytes. At
// the sampling shape (N*H = 24, T = 768, valid 757, L = 128, f32) it reads
// 14 MB of q/k/v and writes 4.7 MB of o (5.6 us) against 1.3 GFLOP of
// band-limited products (1.3 us): bytes too, but only 144 CTAs, each
// walking up to six key tiles in series, so the time is the length of that
// chain. At DiT-XL's (N*H = 32, Dh = 72, f32) it reads 21.2 MB and writes
// 7.1 MB (8.5 us) against 1.6 GFLOP (1.7 us): bytes; at its training shape
// (N*H = 4096, T = L = 128, Dh = 72, bf16, with LSE) 304 MB (91 us) against
// 19.3 GFLOP (20 us): bytes. At the context-parallel training shard (N*H = 384, T_ext = 512 of
// which 256 are pad query rows, L = 128, bf16) the ranged call reads 3 x 25
// MB of q/k/v and writes o and the LSE; the pad query blocks return at
// once, so the work is that of the shard's 256 real rows. DiT-XL's shard
// (N*H = 512, Dh = 72) reads and writes 1.5x that, as the unranged entry
// at Dh 72 does: the same build computes the ranged LSE (the LSE is a
// runtime pointer, so the ranged inference builds serve it).
//
// What the design does about it:
// - One CTA per (n*h, 128-row query block): two consumer warpgroups of 64
//   rows share every K/V tile, so at T = L = 128 one CTA holds the whole
//   (n, h) and reads its q, k and v from device memory once. Two CTAs share
//   an SM, each one's loads overlapping the other's products and stores;
//   at the sampling shape all 144 CTAs are resident at once. (A persistent
//   version, CTAs walking the items as the dk/dv body does, needs more
//   registers than that and so ran 1 CTA an SM: slower, 0.1316 against
//   0.1005 ms at the training shape on an H100.)
// - bf16 q/k/v: one producer warp issues TMA loads (tensor maps built on
//   the host from the strides the wrapper passes; rows past T read as 0)
//   into a ring of STAGES K/V tiles on mbarriers, so the next tile lands
//   while the current one is multiplied (96 registers: 9 warps a CTA put 5
//   of the pair's 18 on one of the SM's four register files). At Dh = 72
//   the wider accumulators spilled at 96, so there is no producer warp:
//   consumer thread 0 issues the same loads, each tile's when a barrier over
//   the CTA shows its stage free (as the f32 stream's copies are paced),
//   and the consumers get the 128 registers of 8 warps a CTA.
// - f32 q/k/v: TMA cannot convert, so there is no producer warp. Each of
//   the 256 consumer threads copies its own 16-byte chunks of tile i + 2's
//   f32 rows (cp.async, rows past T as 0) into a one-tile f32 staging
//   buffer in shared memory, in flight through tile i's softmax and P.V;
//   while tile i + 1's Q.K^T runs, it waits for its own copies, rounds its
//   chunks to bf16 into the same 128-byte-swizzled slabs TMA writes for
//   bf16 (two stages), and issues the next tile's copies; a proxy fence
//   and a barrier over the CTA make the slab visible to the next tile's
//   wgmma. The 128 query rows go the same way once, before the first tile.
//   No cast pass, and no register holds a copy in flight: 16-byte loads
//   into registers (the other way in) spilled at the 128-register cap of 2
//   CTAs an SM, as did the TMA form with its producer warp at 96 (three
//   forms timed in turns on an H100: PERF.md, Findings).
// - S = Q.K^T runs as wgmma from the swizzled tiles into registers; the
//   mask, the row max and sum (quad shuffles) and exp stay there, P is
//   packed to bf16 in registers and is the A operand of O += P.V (V the
//   MN-major B operand). No S, P or O tile touches shared memory; O and the
//   LSE are stored from registers.
// - Scale folding: for Dh = 64, bf16(q * 1/8) = bf16(q) / 8 exactly and so
//   is the f32 product, so raw q (rounded to bf16) is the operand and S is
//   scaled in f32, bit-identical to the contract. For Dh = 72 the scale is
//   no power of two, so q is scaled in f32 and then rounded, as the TPU
//   kernel does, and S is not scaled again: the f32 stream multiplies as it
//   rounds q's rows into the slabs; the bf16 stream's q lands unscaled by
//   TMA, and each warpgroup rescales its own half in shared memory (f32
//   multiply, bf16 round), then a proxy fence and a barrier over the
//   warpgroup before its first wgmma reads it.
// - Dh = 72: the 128-byte swizzle holds 64 bf16 columns, so a head takes a
//   second slab of 16 columns in the 32-byte swizzle (columns 72..79 zero:
//   TMA's fill past the map's head-dim extent of 72 for bf16, stores of
//   zeros once per CTA for f32; columns 72..79 of a head view are the next
//   head's, so the map's extent, not the stride, bounds the load). Q.K^T
//   runs over the 80-deep padded reduction (four k16 steps on the first
//   slab, one on the second); P.V is an n64 product on the first slab and
//   an n16 one on the second, whose columns 72..79 are never stored.
// - A warpgroup skips the tiles outside its own rows' band; a pad query
//   block (ranged) loads nothing and writes 0 and -1e30.
// Resources (ptxas, printed by chip_smoke.py [attn], [attn-train],
// [attn-cp] and [attn-xl]): 0 spill bytes in every build; at Dh = 64,
// 50216 bytes of dynamic shared memory a CTA for bf16 q/k/v, 83072 for f32
// (the staging buffer); at Dh = 72 the second slabs add 12288 and the f32
// staging buffer 4096; 2 CTAs an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "wgmma_tma.cuh"

namespace {

using sm90::bar_arrive;
using sm90::bar_expect;
using sm90::bar_init;
using sm90::bar_wait;
using sm90::desc;
using sm90::tma_load;

constexpr int BQ = 128;                   // query rows per CTA: two consumer warpgroups
constexpr int BK = 64;                    // keys per tile
constexpr int STAGES = 2;                 // K/V tiles in flight
constexpr int CONSUMERS = 256;            // two warpgroups of 64 rows
constexpr int SLAB = 64;                  // head-dim columns of the first slab (128-byte swizzle)

// head-dim columns of the second slab (32-byte swizzle): 16 for Dh = 72
// (72..79 zero), none for Dh = 64
template <int DH>
__host__ __device__ constexpr int x_cols() {
  static_assert(DH == 64 || DH == 72, "the head dims the kernel takes");
  return DH == 64 ? 0 : 16;
}
// bytes TMA lands for 64 rows of one head: both slabs
template <int DH>
__host__ __device__ constexpr unsigned tile_bytes() {
  return 64 * (SLAB + x_cols<DH>()) * 2;
}
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// a TMA producer warp beside the consumers: bf16 q/k/v at Dh = 64 (at Dh =
// 72 one consumer thread issues the loads: see the kernel)
template <typename TI, int DH>
__host__ __device__ constexpr bool producer() {
  return !std::is_same_v<TI, float> && DH == SLAB;
}

// threads a CTA: the consumers, and the producer warp where there is one
template <typename TI, int DH>
constexpr int threads() {
  return producer<TI, DH>() ? CONSUMERS + 32 : CONSUMERS;
}

// runtime bounds of the ranged entries: keys in [k_lo, k_hi), query rows in
// [q_lo, q_hi); unused by the unranged entries
struct Bounds {
  int k_lo, k_hi, q_lo, q_hi;
};

// f32 q/k/v as the consumers read them: (N, H, T, Dh) with element strides
// (sn, sh, st), 16-byte aligned rows
struct F32Src {
  const float *q, *k, *v;
  long long sn, sh, st;
};

template <bool RANGED>
__device__ __forceinline__ bool key_allowed(int kj, int qi, int band, int valid, const Bounds& b) {
  bool ok = kj > qi - band && kj <= qi + band && kj < valid;
  if constexpr (RANGED) ok = ok && kj >= b.k_lo && kj < b.k_hi;
  return ok;
}

// the second slabs (columns 64 .. 64 + X), each 64-row block 2048 bytes
// (256-byte aligned: the 32-byte swizzle's period); rows of q1, k1, v1 run
// on from one array to the next
template <int X>
struct SlabX {
  __nv_bfloat16 q1[2][64 * X];  // one 64-row half per warpgroup
  __nv_bfloat16 k1[STAGES][BK * X];
  __nv_bfloat16 v1[STAGES][BK * X];
};
template <>
struct SlabX<0> {};
static_assert(sizeof(SlabX<16>) % 1024 == 0, "the first slabs after it stay 1024-byte aligned");

template <int DH>
struct Smem : SlabX<x_cols<DH>()> {  // every first-slab tile 1024-byte aligned (the 128-byte swizzle's period)
  __nv_bfloat16 q[2][64 * SLAB];  // one 64-row half per warpgroup, one TMA box
  __nv_bfloat16 k[STAGES][BK * SLAB];
  __nv_bfloat16 v[STAGES][BK * SLAB];
  unsigned long long q_full, full[STAGES], empty[STAGES];
};
// f32 q/k/v: also the f32 rows of one K/V tile (K, then V) or of q's 128,
// as the consumers' copies land them
template <int DH>
struct SmemF32 : Smem<DH> {
  alignas(128) float f32[2 * BK * DH];
};
template <typename TI, int DH>
using SmemOf = std::conditional_t<std::is_same_v<TI, float>, SmemF32<DH>, Smem<DH>>;
template <typename TI, int DH>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(SmemOf<TI, DH>)) + 1024;  // + alignment slack
}

// f32 q/k/v reach the bf16 slabs through the consumers' own hands: consumer
// thread tid copies (cp.async, 16 bytes, rows past t as 0) and later
// converts the 16-byte chunks tid, tid + CONSUMERS, ... of a block of
// Dh-wide f32 rows, so it waits for its own copies only and no barrier sits
// between the copies landing and their conversion; 16 neighbouring threads
// copy one 256-byte row (Dh = 72: 18 a row, and the last pass over a K/V
// tile's 1152 chunks has work for half the threads). No register holds a
// copy in flight.
template <int DH>
struct F32Stage {
  static constexpr int ROW_CHUNKS = DH / 4;  // 16-byte chunks of an f32 row

  // rows r0 .. r0 + ROWS of the head at `src` (row stride st) into `stage`
  template <int ROWS>
  static __device__ __forceinline__ void copy(float* stage, const float* src, int r0, int t,
                                              long long st) {
    constexpr int CHUNKS = ROWS * ROW_CHUNKS;
#pragma unroll
    for (int j = 0; j < (CHUNKS + CONSUMERS - 1) / CONSUMERS; ++j) {
      const int idx = j * CONSUMERS + static_cast<int>(threadIdx.x);
      if (CHUNKS % CONSUMERS != 0 && idx >= CHUNKS) break;
      const int r = r0 + idx / ROW_CHUNKS;
      const bool in = r < t;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(sm90::smem_addr(stage + 4 * idx)),
                     "l"(src + (in ? r * st + 4 * (idx % ROW_CHUNKS) : 0)), "r"(in ? 16 : 0)
                   : "memory");
    }
  }

  // once this thread's copies landed: its chunks of `stage` (times `scale`
  // first when SCALED) rounded to bf16 into the slabs of ROWS rows from
  // `tile` (128-byte swizzled 64-wide rows, 1024-byte aligned) and `tile1`
  // (Dh = 72: columns 64..71 of 32-byte swizzled 16-wide rows), 8 bytes a
  // store: a half warp writes one whole 128-byte row, every bank once
  template <int ROWS, bool SCALED = false>
  static __device__ __forceinline__ void convert(const float* stage, __nv_bfloat16* tile,
                                                 [[maybe_unused]] __nv_bfloat16* tile1,
                                                 [[maybe_unused]] float scale = 1.f) {
    constexpr int CHUNKS = ROWS * ROW_CHUNKS;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
    for (int j = 0; j < (CHUNKS + CONSUMERS - 1) / CONSUMERS; ++j) {
      const int idx = j * CONSUMERS + static_cast<int>(threadIdx.x);
      if (CHUNKS % CONSUMERS != 0 && idx >= CHUNKS) break;
      float4 v = reinterpret_cast<const float4*>(stage)[idx];
      if constexpr (SCALED) {
        v.x *= scale;
        v.y *= scale;
        v.z *= scale;
        v.w *= scale;
      }
      const uint2 packed = make_uint2(sm90::pack_bf16(v.x, v.y), sm90::pack_bf16(v.z, v.w));
      const int r = idx / ROW_CHUNKS, c = 4 * (idx % ROW_CHUNKS);
      if (DH == SLAB || c < SLAB)
        *reinterpret_cast<uint2*>(base + sm90::swizzled(r, c)) = packed;
      else
        *reinterpret_cast<uint2*>(reinterpret_cast<unsigned char*>(tile1) +
                                  sm90::swizzled32(r, c - SLAB)) = packed;
    }
  }

  // the block's 128 query rows (both warpgroups' halves: one swizzled tile
  // a slab), at Dh = 72 scaled by Dh^-1/2 before the rounding
  __device__ __forceinline__ void copy_q(SmemF32<DH>& sm, const F32Src& src, long long base, int q0,
                                         int t) {
    copy<BQ>(sm.f32, src.q + base, q0, t, src.st);
  }
  __device__ __forceinline__ void land_q(SmemF32<DH>& sm, float scale) {
    if constexpr (DH == SLAB)
      convert<BQ>(sm.f32, sm.q[0], nullptr);
    else
      convert<BQ, true>(sm.f32, sm.q[0], sm.q1[0], scale);
  }

  // the K/V tile of keys kbase .. + BK of the head at `base`, then into stage s
  __device__ __forceinline__ void copy_tile(SmemF32<DH>& sm, const F32Src& src, long long base,
                                            int kbase, int t) {
    copy<BK>(sm.f32, src.k + base, kbase, t, src.st);
    copy<BK>(sm.f32 + BK * DH, src.v + base, kbase, t, src.st);
  }
  __device__ __forceinline__ void land_tile(SmemF32<DH>& sm, int s) {
    if constexpr (DH == SLAB) {
      convert<BK>(sm.f32, sm.k[s], nullptr);
      convert<BK>(sm.f32 + BK * DH, sm.v[s], nullptr);
    } else {
      convert<BK>(sm.f32, sm.k[s], sm.k1[s]);
      convert<BK>(sm.f32 + BK * DH, sm.v[s], sm.v1[s]);
    }
  }

  // Dh = 72: columns 72..79 of every second-slab row (q's, and each
  // stage's K and V) to 0, once: the conversions never write them
  __device__ __forceinline__ void zero_pad(SmemF32<DH>& sm) {
    if constexpr (DH != SLAB) {
      constexpr int ROWS = 2 * 64 + 2 * STAGES * BK;  // q1, k1 and v1 in a row
      unsigned char* base = reinterpret_cast<unsigned char*>(sm.q1[0]);
      for (int r = threadIdx.x; r < ROWS; r += CONSUMERS)
        *reinterpret_cast<uint4*>(base + sm90::swizzled32(r, 8)) = make_uint4(0, 0, 0, 0);
    }
  }
};

// Dh = 72, bf16 q: this warpgroup's half of q (both slabs, as TMA landed it
// in shared memory) scaled by Dh^-1/2 in f32 and rounded back to bf16, the
// TPU kernel's rounding of the scaled query; 16 bytes a thread a pass
template <int DH>
__device__ __forceinline__ void scale_q_half(Smem<DH>& sm, int wg, float scale) {
  constexpr int CHUNKS0 = 64 * SLAB * 2 / 16, CHUNKS = 64 * (SLAB + x_cols<DH>()) * 2 / 16;
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int j = 0; j < CHUNKS / 128; ++j) {
    const int c = j * 128 + tid;
    uint4* p = c < CHUNKS0 ? reinterpret_cast<uint4*>(sm.q[wg]) + c
                           : reinterpret_cast<uint4*>(sm.q1[wg]) + (c - CHUNKS0);
    uint4 v = *p;
    unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      w[e] = sm90::pack_bf16(f.x * scale, f.y * scale);
    }
    *p = v;
  }
}

template <typename TO>
__device__ __forceinline__ void store_pair(TO* p, float a, float b) {
  if constexpr (std::is_same_v<TO, float>)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the TMA maps of bf16 q, k and v: the first slab's, and at Dh = 72 the
// second slab's (unused at Dh = 64)
struct Maps {
  CUtensorMap q, k, v, q1, k1, v1;
};

// TI: the type of q/k/v (bf16: TMA maps; f32: `src`); TO: the type of o;
// DH: the head dim (64 or 72)
template <bool RANGED, typename TI, typename TO, int DH>
__global__ void __launch_bounds__(threads<TI, DH>(), 2)
banded_attn_fwd_sm90_kernel(const __grid_constant__ Maps maps, const F32Src src,
                            TO* __restrict__ o, float* __restrict__ lse, int h, int t,
                            long long osn, long long osh, long long ost, int band, int valid,
                            const int* __restrict__ valid_ptr, float scale, Bounds bounds) {
  constexpr bool F32 = std::is_same_v<TI, float>;
  constexpr int X = x_cols<DH>();  // second-slab columns
  constexpr unsigned TILE_BYTES = tile_bytes<DH>();
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<SmemOf<TI, DH>*>(smem_raw + (-sm90::smem_addr(smem_raw) & 1023));  // 1024-aligned

  if constexpr (!RANGED) {  // the device operand, if given (the ranged entries have none)
    if (valid_ptr != nullptr) valid = min(*valid_ptr, t);
  }
  const int q0 = blockIdx.x * BQ;
  const int nb = blockIdx.y / h;
  const int hb = blockIdx.y % h;
  // keys any row of this block may attend: (q0 - L, q0 + BQ - 1 + L], < valid
  // (ranged: in [k_lo, k_hi), and none for a block of pad query rows)
  int k_lo = max(0, q0 - band + 1);
  int k_hi = min(valid - 1, q0 + BQ - 1 + band);
  if constexpr (RANGED) {
    k_lo = max(k_lo, bounds.k_lo);
    k_hi = min(k_hi, bounds.k_hi - 1);
    if (q0 + BQ <= bounds.q_lo || q0 >= bounds.q_hi) k_hi = -1;
  }
  const int kt0 = k_lo / BK;
  const int ntiles = k_lo <= k_hi ? k_hi / BK - kt0 + 1 : 0;

  constexpr bool PRODUCER = producer<TI, DH>();
  // bf16: q's 128 rows, and the K/V tile i into stage i % STAGES, by TMA
  [[maybe_unused]] const auto load_q = [&] {
    bar_expect(&sm.q_full, 2 * TILE_BYTES);
    tma_load(sm.q[0], &maps.q, &sm.q_full, q0, hb, nb);
    if constexpr (X != 0) tma_load(sm.q1[0], &maps.q1, &sm.q_full, q0, hb, nb, SLAB);
  };
  [[maybe_unused]] const auto load_tile = [&](int i) {
    const int s = i % STAGES;
    bar_expect(&sm.full[s], 2 * TILE_BYTES);
    tma_load(sm.k[s], &maps.k, &sm.full[s], (kt0 + i) * BK, hb, nb);
    tma_load(sm.v[s], &maps.v, &sm.full[s], (kt0 + i) * BK, hb, nb);
    if constexpr (X != 0) {
      tma_load(sm.k1[s], &maps.k1, &sm.full[s], (kt0 + i) * BK, hb, nb, SLAB);
      tma_load(sm.v1[s], &maps.v1, &sm.full[s], (kt0 + i) * BK, hb, nb, SLAB);
    }
  };
  if constexpr (!F32) {
    if (threadIdx.x == 0) {
      bar_init(&sm.q_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        bar_init(&sm.full[s], 1);
        bar_init(&sm.empty[s], CONSUMERS / 32);  // one arrival per consumer warp
      }
      sm90::bar_init_fence();
    }
    __syncthreads();

    if constexpr (PRODUCER) {
      if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread issues every load
        if (threadIdx.x == CONSUMERS && ntiles > 0) {
          load_q();
          for (int i = 0; i < ntiles; ++i) {
            if (i >= STAGES) bar_wait(&sm.empty[i % STAGES], (i / STAGES - 1) & 1);
            load_tile(i);
          }
        }
        return;
      }
    } else if (threadIdx.x == 0 && ntiles > 0) {
      // Dh = 72: no producer warp (its 32 threads would hold the CTA pair
      // at 96 registers a thread, where this body spilled): consumer thread
      // 0 issues q's load and the first STAGES tiles', and each later tile's
      // once the CTA is done with its stage (the end of the loop below)
      load_q();
      for (int i = 0; i < STAGES && i < ntiles; ++i) load_tile(i);
    }
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int cq = 2 * (lane % 4);  // this thread's first column in each 8-column chunk
  const int qw = q0 + wg * 64;    // this warpgroup's first row
  const int row0 = qw + warp * 16 + lane / 4;  // its rows: row0 and row0 + 8
  // the keys this warpgroup's rows may attend; none for rows past T or
  // (ranged) a half of pad query rows
  int w_lo = max(k_lo, qw - band + 1);
  int w_hi = min(k_hi, qw + 63 + band);
  if (qw >= t) w_hi = -1;
  if constexpr (RANGED) {
    if (qw + 64 <= bounds.q_lo || qw >= bounds.q_hi) w_hi = -1;
  }

  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  // Dh = 72: o's columns 64..79 (72..79 never stored)
  [[maybe_unused]] float acc1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  [[maybe_unused]] const long long base = nb * src.sn + hb * src.sh;
  [[maybe_unused]] F32Stage<DH> stage;
  if constexpr (F32) {
    if (ntiles > 0) {
      stage.zero_pad(sm);
      stage.copy_q(sm, src, base, q0, t);
      stage.land_q(sm, scale);
      // Dh = 72: a tile's V rows start 1152 chunks in, 4.5 passes of the
      // consumers, so a thread's V copies land where another thread's q
      // chunks lay: every thread converts its q chunks first
      if constexpr (X != 0) __syncthreads();
      stage.copy_tile(sm, src, base, kt0 * BK, t);
      stage.land_tile(sm, 0);
      if (ntiles > 1) stage.copy_tile(sm, src, base, (kt0 + 1) * BK, t);
      sm90::fence_proxy_async();  // the stores, before wgmma reads them
      __syncthreads();
    }
  } else {
    if (ntiles > 0) {
      bar_wait(&sm.q_full, 0);
      if constexpr (X != 0) {
        scale_q_half(sm, wg, scale);
        sm90::fence_proxy_async();  // the stores, before this warpgroup's wgmma reads them
        sm90::warpgroup_sync(1 + wg);
      }
    }
  }
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const int kbase = (kt0 + i) * BK;
    if constexpr (!F32) bar_wait(&sm.full[s], (i / STAGES) & 1);
    const bool mine = kbase <= w_hi && kbase + BK - 1 >= w_lo;  // uniform over the warpgroup
    float sc[32];
    if (mine) {
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < SLAB / 16; ++kk)
        sm90::mma_ss(sc, desc(sm.q[wg], 32 * kk), desc(sm.k[s], 32 * kk), kk);
      if constexpr (X != 0) sm90::mma_ss(sc, sm90::desc32(sm.q1[wg], 0), sm90::desc32(sm.k1[s], 0), 1);
      sm90::commit();
    }
    if constexpr (F32) {
      // while Q.K^T runs: tile i + 1 into the other stage (its last readers,
      // tile i - 1's products, passed the barrier), then tile i + 2's
      // copies, in flight through tile i's softmax and P.V
      if (i + 1 < ntiles) {
        stage.land_tile(sm, (i + 1) % STAGES);
        sm90::fence_proxy_async();
        if (i + 2 < ntiles) stage.copy_tile(sm, src, base, kbase + 2 * BK, t);
      }
    }
    unsigned pa[4][4];  // P, the A operand of P.V
    if (mine) {
      sm90::wait_all();
      sm90::pin(sc);

      // online softmax on the accumulator: register 4n + 2r + j is row
      // row0 + 8r, key kbase + 8n + cq + j
      unsigned ok = 0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;
        const int key = kbase + 8 * (j >> 2) + cq + (j & 1);
        if (key_allowed<RANGED>(key, row0 + 8 * r, band, valid, bounds)) {
          ok |= 1u << j;
          if constexpr (X == 0) sc[j] *= scale;  // exact: a power of two (scale folding)
          mx[r] = fmaxf(mx[r], sc[j]);
        }
      }
      float alpha[2], ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
        m[r] = mx[r];
        ml[r] = mx[r] * LOG2E;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;
        // explicit 0 for masked keys: while a row's max is still NEG_INF,
        // exp(s - m) would be 1 for them
        const float p = (ok >> j) & 1 ? exp2f(fmaf(sc[j], LOG2E, -ml[r])) : 0.f;
        l[r] += p;
        sc[j] = p;
        acc[j] *= alpha[r];
      }
      if constexpr (X != 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc1[j] *= alpha[(j >> 1) & 1];
      }

#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::a_fragment(pa[kk], sc, kk);
    }
    if (mine) {
      // O += P.V, P the register A operand, V an MN-major tile
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::mma_rs(acc, pa[kk], desc(sm.v[s], 2048 * kk));
      if constexpr (X != 0) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) sm90::mma_rs16(acc1, pa[kk], sm90::desc32(sm.v1[s], 512 * kk));
      }
      sm90::commit();
      sm90::wait_all();
      sm90::pin(acc);
      if constexpr (X != 0) sm90::pin(acc1);
    }
    if constexpr (F32) {
      __syncthreads();  // tile i + 1 is stored, and stage s is free
    } else if constexpr (PRODUCER) {
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.empty[s]);  // this warp is done with stage s
    } else {
      __syncthreads();  // stage s is free: tile i + STAGES into it
      if (threadIdx.x == 0 && i + STAGES < ntiles) load_tile(i + STAGES);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= t) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    TO* orow = o + nb * osn + hb * osh + row * ost + cq;
#pragma unroll
    for (int n = 0; n < SLAB / 8; ++n)
      store_pair(orow + 8 * n, acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
    if constexpr (X != 0) store_pair(orow + SLAB, acc1[2 * r] / denom, acc1[2 * r + 1] / denom);
    if (lse != nullptr && lane % 4 == 0) lse[(long long)blockIdx.y * t + row] = m[r] + logf(denom);
  }
}

template <bool RANGED, typename TI, typename TO, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int n, int h, int t,
           long long sn, long long sh, long long st, long long osn, long long osh, long long ost,
           int band, int valid_len, const int* valid_ptr, float scale, Bounds bounds,
           cudaStream_t stream) {
  Maps maps{};
  if constexpr (!std::is_same_v<TI, float>) {
    int err = 0;
    const void* bases[3] = {q, k, v};
    CUtensorMap* firsts[3] = {&maps.q, &maps.k, &maps.v};
    CUtensorMap* seconds[3] = {&maps.q1, &maps.k1, &maps.v1};
    for (int i = 0; i < 3 && err == 0; ++i) {
      const int rows = i == 0 ? BQ : BK;
      err = sm90::make_map(firsts[i], bases[i], n, h, t, sn, sh, st, rows, DH);
      if (err == 0 && x_cols<DH>() != 0)
        err = sm90::make_map(seconds[i], bases[i], n, h, t, sn, sh, st, rows, DH, x_cols<DH>(),
                             CU_TENSOR_MAP_SWIZZLE_32B);
    }
    if (err != 0) return err;
  }
  const F32Src src{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), sn, sh, st};
  const auto kernel = banded_attn_fwd_sm90_kernel<RANGED, TI, TO, DH>;
  constexpr int smem = smem_bytes<TI, DH>();
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t + BQ - 1) / BQ, n * h);
  kernel<<<grid, threads<TI, DH>(), smem, stream>>>(maps, src, static_cast<TO*>(o), lse, h, t, osn,
                                                      osh, ost, band, valid_len, valid_ptr, scale,
                                                      bounds);
  return static_cast<int>(cudaGetLastError());
}

// "sm90" once any entry launched: every call takes the Hopper body
const char* last_body = "none";

// the build for q/k/v of type in_bf16 (1: bf16, 0: f32) and o of type
// out_bf16, head dim DH; bf16 o from f32 q/k/v for the int8 block's
// inference, on one device and on a context-parallel shard
template <bool RANGED, int DH>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, float* lse, int n, int h,
                int t, long long sn, long long sh, long long st, long long osn, long long osh,
                long long ost, int band, int valid_len, const int* valid_ptr, float scale,
                Bounds bounds, int in_bf16, int out_bf16, cudaStream_t s) {
  if (in_bf16 && out_bf16)
    return launch<RANGED, __nv_bfloat16, __nv_bfloat16, DH>(q, k, v, o, lse, n, h, t, sn, sh, st,
                                                             osn, osh, ost, band, valid_len,
                                                             valid_ptr, scale, bounds, s);
  if (!in_bf16 && !out_bf16)
    return launch<RANGED, float, float, DH>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh, ost,
                                            band, valid_len, valid_ptr, scale, bounds, s);
  if (!in_bf16)
    return launch<RANGED, float, __nv_bfloat16, DH>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh,
                                                    ost, band, valid_len, valid_ptr, scale, bounds,
                                                    s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// head dim dh: 64 or 72, in every entry
template <bool RANGED>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int n, int h,
             int t, int dh, long long sn, long long sh, long long st, long long osn, long long osh,
             long long ost, int band, int valid_len, const int* valid_ptr, float scale,
             Bounds bounds, int in_bf16, int out_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    last_body = "sm90";
    return dispatch_dh<RANGED, 64>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh, ost, band,
                                   valid_len, valid_ptr, scale, bounds, in_bf16, out_bf16, s);
  }
  if (dh == 72) {
    last_body = "sm90";
    return dispatch_dh<RANGED, 72>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh, ost, band,
                                   valid_len, valid_ptr, scale, bounds, in_bf16, out_bf16, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v: (N, H, T, dh), dh 64 or 72, f32 (bf16 = 0) or bf16 (bf16 = 1), with shared
// strides (sn, sh, st), unit stride over the head dim and 16-byte aligned
// rows (bf16: strides multiples of 8 elements, for TMA; f32: of 4); o: q's
// type (out_bf16 = bf16) or, for f32 q, bf16 (out_bf16 = 1), with strides
// (osn, osh, ost). valid_ptr: null, or a device int read in place of
// valid_len when the kernel runs (clamped to T; the caller checks it is in
// [1, T]). Launches on `stream` without synchronizing; returns 0, a
// CUDA error code, or TMA_ENCODE_ERROR + a CUresult
// (banded_attention_error_string names either).
extern "C" int banded_attention_fwd(const void* q, const void* k, const void* v, void* o, int n,
                                    int h, int t, int dh, long long sn, long long sh, long long st,
                                    long long osn, long long osh, long long ost, int band,
                                    int valid_len, const int* valid_ptr, float scale, int bf16,
                                    int out_bf16, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, n, h, t, dh, sn, sh, st, osn, osh, ost, band,
                         valid_len, valid_ptr, scale, Bounds{}, bf16, out_bf16, stream);
}

// The same with o in q's type, also writing lse: f32 (N*H, T) contiguous,
// row n*H + h; dh 64 or 72.
extern "C" int banded_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int n, int h, int t, int dh, long long sn,
                                        long long sh, long long st, long long osn, long long osh,
                                        long long ost, int band, int valid_len, float scale,
                                        int bf16, void* stream) {
  return dispatch<false>(q, k, v, o, lse, n, h, t, dh, sn, sh, st, osn, osh, ost, band, valid_len,
                         nullptr, scale, Bounds{}, bf16, bf16, stream);
}

// Ranged: as banded_attention_fwd over all T (halo-extended) rows (o in
// q's type or, for f32 q, bf16 with out_bf16 = 1), with keys masked to
// [k_lo, k_hi) and only the query halves that meet [q_lo, q_hi) computed
// (the others get 0).
extern "C" int banded_attention_fwd_ranged(const void* q, const void* k, const void* v, void* o,
                                           int n, int h, int t, int dh, long long sn, long long sh,
                                           long long st, long long osn, long long osh,
                                           long long ost, int band, int k_lo, int k_hi,
                                           int q_lo, int q_hi, float scale, int bf16,
                                           int out_bf16, void* stream) {
  return dispatch<true>(q, k, v, o, nullptr, n, h, t, dh, sn, sh, st, osn, osh, ost, band, t,
                        nullptr, scale, Bounds{k_lo, k_hi, q_lo, q_hi}, bf16, out_bf16, stream);
}

// Ranged with lse (rows of uncomputed halves get -1e30); dh 64 or 72.
extern "C" int banded_attention_fwd_ranged_lse(const void* q, const void* k, const void* v,
                                               void* o, float* lse, int n, int h, int t, int dh,
                                               long long sn, long long sh, long long st,
                                               long long osn, long long osh, long long ost,
                                               int band, int k_lo, int k_hi, int q_lo, int q_hi,
                                               float scale, int bf16, void* stream) {
  return dispatch<true>(q, k, v, o, lse, n, h, t, dh, sn, sh, st, osn, osh, ost, band, t, nullptr,
                        scale, Bounds{k_lo, k_hi, q_lo, q_hi}, bf16, bf16, stream);
}

extern "C" const char* banded_attention_error_string(int err) { return sm90::error_string(err); }

// "sm90" (after any launch) or "none": the body the last call of any entry took
extern "C" const char* banded_attention_last_body() { return last_body; }

// the forward's dynamic shared memory per CTA, bytes, for bf16 (f32 = 0) or
// f32 (f32 = 1) q/k/v at head dim dh (64 or 72; else 0)
extern "C" int banded_attention_sm90_smem_bytes(int f32, int dh) {
  if (dh == 64) return f32 ? smem_bytes<float, 64>() : smem_bytes<__nv_bfloat16, 64>();
  if (dh == 72) return f32 ? smem_bytes<float, 72>() : smem_bytes<__nv_bfloat16, 72>();
  return 0;
}
