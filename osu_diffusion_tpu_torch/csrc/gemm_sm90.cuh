// The persistent wgmma GEMM of the adaLN-MLP Hopper bodies: kernel B's
// forward over bf16 weights or int8 codes and the int8 qkv projection
// (csrc/adaln_mlp.cu: the up, down and qkv products) and the fused backward
// (csrc/adaln_mlp_bwd.cu: dgelu and dh1). Each source defines its own
// __global__ kernel, which calls `run` with its epilogue.
//
// C[m, ncols] = A[m, kdim] . B, f32 sums, where A is a bf16 row-major (m,
// kdim) matrix (the N*T token rows) and B is bf16 in torch's Linear layout:
// - K-major (B_K_MAJOR): B given as (ncols, kdim) row-major, the reduction
//   dim contiguous: fc1 (H, D) in h . W1^T, fc2 (D, H) in g . W2^T;
// - MN-major (B_MN_MAJOR): B given as (kdim, ncols) row-major, the output
//   columns contiguous: fc2 (D, H) in dgelu = dmlp . W2, fc1 (H, D) in
//   dh1 = da . W1. Each BK-row slab of a BN-wide column block is BN / 64
//   TMA boxes of 64 rows x 64 columns (8 KB), which one wgmma reads through
//   a descriptor whose leading byte offset steps from box to box.
// So neither product needs a transposed or packed copy of a weight.
// - int8 (B_INT8): B given as int8 codes in the K-major layout, (ncols,
//   kdim) row-major (QuantLinear's weight), for the int8 serving products;
//   the caller scales each column's f32 sum in its epilogue. The producer
//   thread loads each (BN rows, 64 bytes) slab of codes by TMA (unswizzled)
//   into the stage beside A, completing on the stage's `qfull` barrier. The
//   consumers upcast it to bf16, exactly (|q| <= 127, tile_io.cuh's
//   byte-permute upcast), into the stage's B slab in the 128-byte-swizzled
//   K-major layout that TMA writes for B_K_MAJOR, each thread its share of
//   slab g + 1 while its warpgroup's products of slab g run; they fence the
//   stores to the async proxy and meet at a barrier before slab g + 1's
//   products. Column blocks may be ragged: rows of B past ncols read as 0,
//   and the epilogue stores no column past ncols. No bf16 copy of the
//   weight exists outside the ring. (On an H100 at DiT-B sampling the
//   upcast makes the up and down GEMMs 1.3x and 1.6x the same GEMMs over
//   bf16 weights, which they match with the upcast skipped; the producer
//   warpgroup's three idle warps upcasting instead were up to 13% slower:
//   tools/quant_variants.py, PERF.md.)
//
// Persistent: CTA c walks tiles c, c + gridDim.x, ... of the (ceil(m / BM)
// row blocks) x (tiles_n = ceil(ncols / BN) column blocks) grid, tile = row
// block * tiles_n + column block (the wrapper's tile plan, ops/gemm_plan.py,
// numbers them the same way; column blocks fastest, so the CTAs at work at
// one time share their A rows in L2). One producer thread keeps the tiles'
// BK-deep slabs of A and B in flight by TMA (128-byte swizzle, rows of A
// past m read as 0) through a ring of STAGES; two consumer warpgroups each
// multiply 64 rows by the BN columns (wgmma m64nBNk16, f32 accumulators in
// registers: 128 a thread at BN = 256, so the producer's warpgroup hands its
// registers over by setmaxnreg, 232 a consumer thread), keep one slab's
// products in flight while the next is issued, and release each stage as
// its products retire; so the next tile's slabs load while a tile's
// epilogue runs. Producer and consumers derive every walk from the tile
// number alone, and the ring position runs on over tiles the same on both
// sides. No split-K and no atomics: one CTA owns each output tile and sums
// its whole reduction in one order, so the result is the same bits run to
// run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "wgmma_tma.cuh"

namespace gemm_sm90 {

using sm90::bar_arrive;
using sm90::bar_expect;
using sm90::bar_init;
using sm90::bar_wait;
using sm90::desc;

constexpr int BM = 128;                 // rows per tile: two consumer warpgroups of 64
constexpr int BK = 64;                  // reduction slab: one 128-byte swizzled row
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (one thread loads)
// setmaxnreg: the producer warpgroup gives its registers to the consumers
// (168 a thread at launch: 384 x 168 fits the SM's 64K)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(CONSUMERS * CONSUMER_REGS + 128 * PRODUCER_REGS <= THREADS * 168, "register pool");
constexpr unsigned A_BYTES = BM * BK * 2;
constexpr unsigned BOX_BYTES = BK * 64 * 2;  // one MN-major B box: BK rows x 64 columns

enum BLayout { B_K_MAJOR, B_MN_MAJOR, B_INT8 };

template <int BN, int BL = B_K_MAJOR>
struct Cfg {
  // bf16 B: 192 KB of slabs either way; int8 B: a stage also holds the
  // codes (64 KB a stage at BN = 256, 40 KB at 128)
  static constexpr int STAGES = BL == B_INT8 ? (BN == 256 ? 3 : 5) : (BN == 256 ? 4 : 6);
  static constexpr unsigned B_BYTES = BN * BK * 2;
  static constexpr unsigned Q_BYTES = BN * BK;  // an int8 slab of codes
};

constexpr int STAGE_ROW = 128;  // bytes of a staged row: 64 bf16 columns

template <int BN>
struct Smem {  // every slab 1024-byte aligned (the 128-byte swizzle's period)
  __nv_bfloat16 a[Cfg<BN>::STAGES][BM * BK];
  __nv_bfloat16 b[Cfg<BN>::STAGES][BN * BK];
  // each consumer warp's (16 rows, 64 columns) bf16 staging tile of the
  // epilogues, its 16-byte chunks XOR-swizzled by row
  unsigned char stage[CONSUMERS / 32][16 * STAGE_ROW];
  unsigned long long full[Cfg<BN>::STAGES], empty[Cfg<BN>::STAGES];
};

// B_INT8's: the stage's codes beside its A and upcast B slabs, and the
// barrier their TMA completes on
template <int BN>
struct SmemInt8 {
  using C = Cfg<BN, B_INT8>;
  __nv_bfloat16 a[C::STAGES][BM * BK];
  __nv_bfloat16 b[C::STAGES][BN * BK];
  int8_t q[C::STAGES][BN * BK];  // row r of a slab at byte 64 r
  unsigned char stage[CONSUMERS / 32][16 * STAGE_ROW];
  unsigned long long full[C::STAGES], empty[C::STAGES], qfull[C::STAGES];
};

template <int BN, int BL>
using SmemOf = std::conditional_t<BL == B_INT8, SmemInt8<BN>, Smem<BN>>;

// the Smem of a kernel's dynamic shared memory (aligned up to 1024 bytes:
// the launch adds that much slack)
template <typename S>
__device__ __forceinline__ S& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<S*>(raw + (-sm90::smem_addr(raw) & 1023));
}

// the staging tile's slot of the packed pair at row lane / 4 + 8 i,
// columns 8 n + 2 (lane % 4), +1 of a (16 rows, 64 columns) block
__device__ __forceinline__ unsigned* stage_slot(unsigned char* st, int n, int i, int lane) {
  const int r = lane / 4 + 8 * i;
  return reinterpret_cast<unsigned*>(st + r * STAGE_ROW + ((n ^ (r & 7)) << 4) + (lane % 4) * 4);
}

// the warp's staged block to rows row0 + r, columns col0 .. + 64 of `dst`
// (row stride ld) for rows below m, as whole-row 16-byte stores
__device__ __forceinline__ void stage_flush(const unsigned char* st, __nv_bfloat16* dst, int row0,
                                            int col0, int m, long long ld, int lane) {
  __syncwarp();  // the warp's pairs are staged
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = it * 4 + lane / 8;
    const int ch = lane % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(st + r * STAGE_ROW + ((ch ^ (r & 7)) << 4));
    if (row0 + r < m) *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * ld + col0 + ch * 8) = v;
  }
}

// One warp's (16 rows, 64 columns) block of a bf16 output through its
// staging tile `st`: vals[n][i] is the packed pair at row lane / 4 + 8 i,
// columns 8 n + 2 (lane % 4), +1 of the block (the accumulator's layout),
// written to row row0 + r, columns col0 .. + 64 of `dst` (row stride ld)
// for rows below m, as 16-byte stores that each cover 4 whole 128-byte rows
// (stored straight from the accumulator layout, each warp store touches 8
// rows at 16 bytes each: on an H100 at the training shape the up GEMM then
// took 0.56-0.57 ms against 0.36-0.37, tools/mlp_variants.py).
__device__ __forceinline__ void stage_store(unsigned char* st, const unsigned (&vals)[8][2],
                                            __nv_bfloat16* dst, int row0, int col0, int m,
                                            long long ld, int lane) {
  __syncwarp();  // the warp's reads of the last block are done
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) *stage_slot(st, n, i, lane) = vals[n][i];
  stage_flush(st, dst, row0, col0, m, ld, lane);
}

// The mirror of stage_store: one warp's (16 rows, 64 columns) block of a
// bf16 input, rows row0 .., columns col0 .. + 64 of `src` (row stride ld),
// fetched as whole-row 16-byte loads (`fetch`, rows from m on read as 0) and
// handed out in the accumulator's layout (`load`: vals[n][i] the packed
// pair at row lane / 4 + 8 i, columns 8 n + 2 (lane % 4), +1) through the
// warp's staging tile.
struct StagedLoad {
  uint4 v[4];  // lane's chunks: row it * 4 + lane / 8, chunk lane % 8

  __device__ __forceinline__ void fetch(const __nv_bfloat16* src, int row0, int col0, int m,
                                        long long ld, int lane) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = it * 4 + lane / 8;
      v[it] = row0 + r < m ? *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld +
                                                              col0 + (lane % 8) * 8)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void load(unsigned char* st, unsigned (&vals)[8][2], int lane) const {
    __syncwarp();  // the warp's reads of the last block are done
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = it * 4 + lane / 8;
      *reinterpret_cast<uint4*>(st + r * STAGE_ROW + (((lane % 8) ^ (r & 7)) << 4)) = v[it];
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) vals[n][i] = *stage_slot(st, n, i, lane);
  }
};

// the tensor maps of one GEMM: A (m, kdim) in BM-row boxes; B (ncols, kdim)
// in BN-row boxes (K-major; int8: 64-byte rows) or (kdim, ncols) in BK-row
// boxes (MN-major). Returns 0 or sm90::TMA_ENCODE_ERROR + the CUresult.
template <int BN, int BL>
int make_maps(CUtensorMap* a_map, CUtensorMap* b_map, const void* a, const void* b, int m,
              int ncols, int kdim) {
  const int err = sm90::make_map_2d(a_map, a, m, kdim, BM);
  if (err != 0) return err;
  if (BL == B_INT8) return sm90::make_map_2d_int8(b_map, b, ncols, kdim, BN);
  return BL == B_K_MAJOR ? sm90::make_map_2d(b_map, b, ncols, kdim, BN)
                         : sm90::make_map_2d(b_map, b, kdim, ncols, BK);
}

// a barrier over the CONSUMERS threads alone (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// A consumer thread's share of upcasting slab g of the CTA's walk, once the
// slab's codes land, into the stage's B slab, the stores then fenced to the
// async proxy. A thread takes 16 codes at a time (row r = p / 4, codes 16
// (p % 4) ..), which become the row's bf16 chunks 2 (p % 4) and 2 (p % 4)
// + 1, each at its swizzled place (chunk c of row r at c ^ (r % 8)); a
// quarter warp reads 128 contiguous bytes and writes all eight chunk
// positions of two rows, so neither side conflicts on a bank.
template <int BN>
__device__ __forceinline__ void upcast_slab(SmemInt8<BN>& sm, int g) {
  using C = Cfg<BN, B_INT8>;
  const int s = g % C::STAGES;
  sm90::bar_wait(&sm.qfull[s], (g / C::STAGES) & 1);
  const unsigned char* q = reinterpret_cast<const unsigned char*>(sm.q[s]);
  unsigned char* b = reinterpret_cast<unsigned char*>(sm.b[s]);
#pragma unroll 2
  for (int p = threadIdx.x; p < BN * 4; p += CONSUMERS) {
    const uint4 v = *reinterpret_cast<const uint4*>(q + p * 16);
    const int r = p >> 2;
    const int c = 2 * (p & 3);
    const uint2 e0 = tile_io::int8x4_to_bf16x4(v.x);
    const uint2 e1 = tile_io::int8x4_to_bf16x4(v.y);
    const uint2 e2 = tile_io::int8x4_to_bf16x4(v.z);
    const uint2 e3 = tile_io::int8x4_to_bf16x4(v.w);
    unsigned char* row = b + r * 128;
    *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) = make_uint4(e0.x, e0.y, e1.x, e1.y);
    *reinterpret_cast<uint4*>(row + (((c + 1) ^ (r & 7)) << 4)) = make_uint4(e2.x, e2.y, e3.x, e3.y);
  }
  sm90::fence_proxy_async();  // the stores, before wgmma reads them
}

// The GEMM's body, called by every thread of a THREADS-thread CTA: the
// producer loads, the consumers (upcasting B_INT8's codes) call begin(r0,
// c0) as a tile's products start (to issue loads the epilogue will need)
// and epi(acc, r0, c0) once they are done, with the tile's rows r0 .. + BM
// and columns c0 .. + BN in the accumulator layout (register 4n + 2i + j
// of consumer thread (warpgroup wg, warp w of it, lane l) holds row r0 +
// 64 wg + 16 w + l / 4 + 8 i, column c0 + 8 n + 2 (l % 4) + j). The
// producer warpgroup returns early: an epilogue synchronises the consumers
// alone (named barriers over CONSUMERS threads). `sm` is SmemOf<BN, BL>.
template <int BN, int BL, typename S, typename Begin, typename Epi>
__device__ __forceinline__ void run(const CUtensorMap& a_map, const CUtensorMap& b_map, S& sm,
                                    int m, int ncols, int kdim, Begin&& begin, Epi&& epi) {
  using C = Cfg<BN, BL>;
  constexpr bool INT8 = BL == B_INT8;
  // the consumers upcast slab g + 1 while slabs g and g - 1 may be in
  // flight, into a stage whose last slab g + 1 - STAGES was released before
  static_assert(!INT8 || C::STAGES >= 3, "B_INT8 needs three stages");
  const int tiles_n = (ncols + BN - 1) / BN;
  const int tiles = (m + BM - 1) / BM * tiles_n;
  const int ktiles = kdim / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], CONSUMERS / 32);  // one arrival per consumer warp
      if constexpr (INT8) bar_init(&sm.qfull[s], 1);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread issues every load
    sm90::registers_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      int g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int r0 = tile / tiles_n * BM;
        const int c0 = tile % tiles_n * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++g) {
          const int s = g % C::STAGES;
          if (g >= C::STAGES) bar_wait(&sm.empty[s], (g / C::STAGES - 1) & 1);
          bar_expect(&sm.full[s], INT8 ? A_BYTES : A_BYTES + C::B_BYTES);
          sm90::tma_load_2d(sm.a[s], &a_map, &sm.full[s], kt * BK, r0);
          if constexpr (INT8) {
            bar_expect(&sm.qfull[s], C::Q_BYTES);
            sm90::tma_load_2d(sm.q[s], &b_map, &sm.qfull[s], kt * BK, c0);
          } else if constexpr (BL == B_K_MAJOR) {
            sm90::tma_load_2d(sm.b[s], &b_map, &sm.full[s], kt * BK, c0);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              sm90::tma_load_2d(sm.b[s] + j * (BOX_BYTES / 2), &b_map, &sm.full[s], c0 + 64 * j,
                                kt * BK);
          }
        }
      }
    }
    return;
  }

  // the two consumer warpgroups: warpgroup wg owns rows r0 + 64 wg .. + 64
  sm90::registers_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  // B_INT8: the slabs of this CTA's walk, the first upcast before the loop
  [[maybe_unused]] const int slabs =
      ((tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1) * ktiles;
  if constexpr (INT8) {
    upcast_slab<BN>(sm, 0);
    consumers_sync();
  }
  int g = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile / tiles_n * BM;
    const int c0 = tile % tiles_n * BN;
    begin(r0, c0);
    for (int kt = 0; kt < ktiles; ++kt, ++g) {
      const int s = g % C::STAGES;
      bar_wait(&sm.full[s], (g / C::STAGES) & 1);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (BL != B_MN_MAJOR)
          sm90::mma_ss_n<BN>(acc, desc(sm.a[s] + wg * 64 * BK, 32 * kk), desc(sm.b[s], 32 * kk),
                             kt > 0 || kk > 0);
        else
          sm90::mma_ss_n<BN, 1>(acc, desc(sm.a[s] + wg * 64 * BK, 32 * kk),
                                sm90::desc_mn(sm.b[s], 2048 * kk, BOX_BYTES), kt > 0 || kk > 0);
      }
      sm90::commit();
      if constexpr (INT8) {  // the next slab, while these products run
        if (g + 1 < slabs) upcast_slab<BN>(sm, g + 1);
      }
      // the previous slab's products have retired: its stage takes a new slab
      sm90::wait<1>();
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) bar_arrive(&sm.empty[(g - 1) % C::STAGES]);
      }
      if constexpr (INT8) consumers_sync();  // every share of the next slab is upcast
    }
    sm90::wait<0>();
    __syncwarp();
    if (lane == 0) bar_arrive(&sm.empty[(g - 1) % C::STAGES]);
    sm90::pin(acc);
    epi(acc, r0, c0);
  }
}

}  // namespace gemm_sm90
