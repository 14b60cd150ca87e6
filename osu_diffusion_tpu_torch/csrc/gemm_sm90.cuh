// The persistent wgmma GEMM of the adaLN-MLP Hopper bodies: kernel B's
// forward (csrc/adaln_mlp.cu: the up and down products) and the fused
// backward (csrc/adaln_mlp_bwd.cu: dgelu and dh1). Each source defines its
// own __global__ kernel, which calls `run` with its epilogue.
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
//
// Persistent: CTA c walks tiles c, c + gridDim.x, ... of the (ceil(m / BM)
// row blocks) x (ncols / BN column blocks) grid, tile = row block * (ncols /
// BN) + column block (the wrapper's tile plan, ops/adaln_mlp.py gemm_plan,
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

enum BLayout { B_K_MAJOR, B_MN_MAJOR };

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;  // 192 KB of slabs either way
  static constexpr unsigned B_BYTES = BN * BK * 2;
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
// in BN-row boxes (K-major) or (kdim, ncols) in BK-row boxes (MN-major).
// Returns 0 or sm90::TMA_ENCODE_ERROR + the CUresult.
template <int BN, int BL>
int make_maps(CUtensorMap* a_map, CUtensorMap* b_map, const void* a, const void* b, int m,
              int ncols, int kdim) {
  const int err = sm90::make_map_2d(a_map, a, m, kdim, BM);
  if (err != 0) return err;
  return BL == B_K_MAJOR ? sm90::make_map_2d(b_map, b, ncols, kdim, BN)
                         : sm90::make_map_2d(b_map, b, kdim, ncols, BK);
}

// The GEMM's body, called by every thread of a THREADS-thread CTA: the
// producer loads, the consumers call begin(r0, c0) as a tile's products
// start (to issue loads the epilogue will need) and epi(acc, r0, c0) once
// they are done, with the tile's rows r0 .. + BM and columns c0 .. + BN in
// the accumulator layout (register 4n + 2i + j of consumer thread
// (warpgroup wg, warp w of it, lane l) holds row r0 + 64 wg + 16 w + l / 4 +
// 8 i, column c0 + 8 n + 2 (l % 4) + j). The producer warpgroup returns
// early: an epilogue synchronises the consumers alone (named barriers over
// CONSUMERS threads).
template <int BN, int BL, typename Begin, typename Epi>
__device__ __forceinline__ void run(const CUtensorMap& a_map, const CUtensorMap& b_map,
                                    Smem<BN>& sm, int m, int ncols, int kdim, Begin&& begin,
                                    Epi&& epi) {
  using C = Cfg<BN>;
  const int tiles_n = ncols / BN;
  const int tiles = (m + BM - 1) / BM * tiles_n;
  const int ktiles = kdim / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], CONSUMERS / 32);  // one arrival per consumer warp
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
          bar_expect(&sm.full[s], A_BYTES + C::B_BYTES);
          sm90::tma_load_2d(sm.a[s], &a_map, &sm.full[s], kt * BK, r0);
          if constexpr (BL == B_K_MAJOR) {
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
        if constexpr (BL == B_K_MAJOR)
          sm90::mma_ss_n<BN>(acc, desc(sm.a[s] + wg * 64 * BK, 32 * kk), desc(sm.b[s], 32 * kk),
                             kt > 0 || kk > 0);
        else
          sm90::mma_ss_n<BN, 1>(acc, desc(sm.a[s] + wg * 64 * BK, 32 * kk),
                                sm90::desc_mn(sm.b[s], 2048 * kk, BOX_BYTES), kt > 0 || kk > 0);
      }
      sm90::commit();
      // the previous slab's products have retired: its stage takes a new slab
      sm90::wait<1>();
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) bar_arrive(&sm.empty[(g - 1) % C::STAGES]);
      }
    }
    sm90::wait<0>();
    __syncwarp();
    if (lane == 0) bar_arrive(&sm.empty[(g - 1) % C::STAGES]);
    sm90::pin(acc);
    epi(acc, r0, c0);
  }
}

// a barrier over the CONSUMERS threads alone (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

}  // namespace gemm_sm90
