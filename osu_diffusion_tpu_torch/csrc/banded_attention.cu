// Banded attention forward for Hopper, sm_90a: inference, and training with
// the per-row log-sum-exp; each also ranged, for context parallelism.
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
// [q_lo, q_hi) are the pad rows of q: whole 64-row tiles there are not
// computed (0 and LSE -1e30 are written), and the key loop walks only the
// tiles that meet [k_lo, k_hi).
//
// Computes, per (batch, head) and query row q:
//   o[q] = sum_k softmax_k(s[q, k]) v[k],  s = bf16(q * Dh^-1/2) . bf16(k)
// over the keys allowed by the band  q - L < k <= q + L  and k < valid_len,
// with bf16 operands, f32 accumulation and an f32 online softmax, and with
// LSE the row's m + log(max(l, 1e-30)) into an (N*H, T) f32 array (the one
// layout the port keeps: the TPU kernel's lane-broadcast and sublane-packed
// layouts only work around Mosaic's (8, 128) tile). q/k/v/o are f32 or bf16
// (the training stream), one type per call. valid_len is a runtime
// argument, so one build serves every sequence length. A row whose band
// holds no valid key writes 0, never NaN: such rows are padding, and the
// next layer reads them as K/V rows, where 0 * NaN would poison the valid
// rows. Its LSE is about -1e30; the backward masks such rows itself.
//
// What bounds it on the card: at the sampling shape (N*H = 24, T = 768,
// Dh = 64, L = 128, f32) the call reads ~14 MB of q/k/v and does ~1.5 GFLOP
// of band-limited matmul work: ~4 us of HBM time, ~2 us of tensor-core
// time. At the training shape (N*H = 3072, T = L = 128, bf16) it moves
// 4 x 3072 x 128 x 64 x 2 B = 201 MB plus a 1.6 MB LSE (60 us at 3.35 TB/s)
// against 6.4 GFLOP (6.5 us at 989 TFLOP/s): bound by memory. Both shapes
// are short per CTA, so the serial tile loop of each CTA (load, sync, two
// small products, softmax) and the CTAs in flight decide the time. At the
// context-parallel training shard (N*H = 384, T_ext = 512 of which 256 are
// pad query rows, L = 128, bf16) the ranged call reads 3 x 25 MB of q/k/v
// and writes o and the LSE; the pad query tiles return at once, so the
// work is that of the shard's 256 real rows.
//
// What the design does about it: one CTA per (n*h, 64-row query tile), four
// warps of 16 rows each, so the grid spreads over the SMs (6144 CTAs at the
// training shape). Each CTA walks only the 64-key tiles that meet the band
// (the GPU form of the TPU kernel's static trim), stages each K/V tile once
// in shared memory as bf16, and runs both products on the tensor cores
// through WMMA (bf16 16x16x16, f32 accumulate). The softmax state (row max,
// row sum and the 64-wide output row) lives in registers, two lanes per
// row. Inputs are read through strides, so q/k/v can be head views of the
// packed qkv projection without a transpose copy; the output is written
// through strides too. This WMMA body serves the f32 stream (rows 1 and 5
// without LSE on the sampling path, and f32 training calls).
//
// The bf16 stream (the training forward with LSE, rows 2 and 5, and every
// other bf16 call of the four entries) takes the Hopper body below the
// WMMA one; the C entries choose the body by dtype (`dispatch`). What
// bounds it: bytes, 201 MB at the training shape (60 us). What its design
// does about it:
// - One CTA per (n*h, 128-row query block): two consumer warpgroups of 64
//   rows share every K/V tile, so at T = L = 128 one CTA holds the whole
//   (n, h) and reads its q, k and v from device memory once.
// - One producer warp issues TMA loads (tensor maps built on the host from
//   the strides the wrapper passes; rows past T read as 0) into a ring of
//   STAGES K/V tiles on mbarriers, so the next tile lands while the
//   current one is multiplied. Two CTAs share an SM (96 registers: 9 warps
//   a CTA put 5 of the pair's 18 on one of the SM's four register files),
//   each one's loads overlapping the other's products and stores. A
//   persistent version (CTAs walking the items, as the dk/dv body does)
//   needs more registers than that and so ran 1 CTA an SM: slower, 0.1316
//   against 0.1005 ms at the training shape on an H100.
// - S = Q.K^T runs as wgmma from the swizzled tiles into registers; the
//   mask, the row max and sum (quad shuffles) and exp stay there, P is
//   packed to bf16 in registers and is the A operand of O += P.V (V the
//   MN-major B operand). No S, P or O tile touches shared memory; O and the
//   LSE are stored from registers.
// - Scale folding: for Dh = 64, bf16(q * 1/8) = bf16(q) / 8 exactly and so
//   is the f32 product, so raw q goes through TMA and S is scaled in f32,
//   bit-identical to the contract (static_assert(DH == 64) marks it).
// - A warpgroup skips the tiles outside its own rows' band; a pad query
//   block (ranged) loads nothing and writes 0 and -1e30.
// Resources (ptxas, printed by chip_smoke.py [attn-train]): 96 registers,
// 0 spill bytes, 50216 bytes of dynamic shared memory a CTA, 2 CTAs an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tile_io.cuh"
#include "wgmma_tma.cuh"

using namespace nvcuda;

namespace {

constexpr int DH = 64;         // head dim the kernel takes
constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per tile
constexpr int WARPS = BQ / 16;  // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int LDB = DH + 8;    // bf16 row stride in shared memory (elements)
constexpr int LDS = BK + 4;    // f32 row stride of the score scratch
constexpr float NEG_INF = -1e30f;

// runtime bounds of the ranged entries: keys in [k_lo, k_hi), query rows in
// [q_lo, q_hi); unused by the unranged entries
struct Bounds {
  int k_lo, k_hi, q_lo, q_hi;
};

template <bool RANGED>
__device__ __forceinline__ bool key_allowed(int kj, int qi, int band, int valid, const Bounds& b) {
  bool ok = kj > qi - band && kj <= qi + band && kj < valid;
  if constexpr (RANGED) ok = ok && kj >= b.k_lo && kj < b.k_hi;
  return ok;
}

struct __align__(128) Smem {
  __nv_bfloat16 q[BQ * LDB];
  __nv_bfloat16 k[BK * LDB];
  __nv_bfloat16 v[BK * LDB];
  __nv_bfloat16 p[WARPS][16 * LDB];  // softmax numerators, bf16
  float s[WARPS][16 * LDS];          // scores, then the P.V tile
};

template <typename T, bool RANGED>
__global__ void __launch_bounds__(THREADS)
banded_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int h, int t, long long sn,
                       long long sh, long long st, long long osn, long long osh,
                       long long ost, int band, int valid, float scale, Bounds bounds) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int q0 = blockIdx.x * BQ;
  const int nb = blockIdx.y / h;
  const int hb = blockIdx.y % h;
  const long long base = nb * sn + hb * sh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // two lanes per query row: lane pair (2r, 2r+1) owns row r of this warp's
  // 16, each lane 32 of the 64 columns
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  const int qi = q0 + warp * 16 + r;
  T* const orow = o + nb * osn + hb * osh + (long long)qi * ost + c0;

  if constexpr (RANGED) {
    // a tile of pad query rows (outside [q_lo, q_hi)) is not computed
    if (q0 + BQ <= bounds.q_lo || q0 >= bounds.q_hi) {
      if (qi < t) {
#pragma unroll
        for (int j = 0; j < 32; j += 4) tile_io::store4(orow + j, make_float4(0.f, 0.f, 0.f, 0.f));
        if (lse != nullptr && c0 == 0) lse[(long long)blockIdx.y * t + qi] = NEG_INF;
      }
      return;
    }
  }

  tile_io::load_tile<BQ, DH, LDB, THREADS>(sm.q, q + base, q0, t, st, scale);

  float m = NEG_INF;
  float l = 0.f;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;

  // keys any row of this tile may attend: (q0 - L, q0 + BQ - 1 + L], < valid
  // (ranged: and in [k_lo, k_hi))
  int k_lo = max(0, q0 - band + 1);
  int k_hi = min(valid - 1, q0 + BQ - 1 + band);
  if constexpr (RANGED) {
    k_lo = max(k_lo, bounds.k_lo);
    k_hi = min(k_hi, bounds.k_hi - 1);
  }
  float* srow = sm.s[warp] + r * LDS + c0;
  __nv_bfloat16* prow = sm.p[warp] + r * LDB + c0;

  for (int kt = k_lo / BK; k_lo <= k_hi && kt <= k_hi / BK; ++kt) {
    const int kbase = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    tile_io::load_tile<BK, DH, LDB, THREADS>(sm.k, k + base, kbase, t, st, 1.f);
    tile_io::load_tile<BK, DH, LDB, THREADS>(sm.v, v + base, kbase, t, st, 1.f);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sf[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sm.q + warp * 16 * LDB + kk * 16, LDB);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, sm.k + n * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(sf[n], a, b, sf[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n)
      wmma::store_matrix_sync(sm.s[warp] + n * 16, sf[n], LDS, wmma::mem_row_major);
    __syncwarp();

    // online softmax over this lane's 32 columns, combined across the pair
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool ok = key_allowed<RANGED>(kbase + c0 + j, qi, band, valid, bounds);
      sv[j] = ok ? srow[j] : NEG_INF;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool ok = key_allowed<RANGED>(kbase + c0 + j, qi, band, valid, bounds);
      // explicit 0 for masked keys: while a row's max is still NEG_INF,
      // exp(s - m_new) would be exp(0) = 1 for them
      const float p = ok ? expf(sv[j] - m_new) : 0.f;
      psum += p;
      prow[j] = __float2bfloat16_rn(p);
      acc[j] *= alpha;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // O_tile = P V, staged through the score scratch into the row registers
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DH / 16];
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(of[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sm.p[warp] + kk * 16, LDB);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sm.v + kk * 16 * LDB + n * 16, LDB);
        wmma::mma_sync(of[n], a, b, of[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < DH / 16; ++n)
      wmma::store_matrix_sync(sm.s[warp] + n * 16, of[n], LDS, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += srow[j];
    __syncwarp();  // the scratch is rewritten by the next tile's scores
  }

  if (qi < t) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      tile_io::store4(orow + j, make_float4(acc[j] / denom, acc[j + 1] / denom,
                                            acc[j + 2] / denom, acc[j + 3] / denom));
    }
    if (lse != nullptr && c0 == 0) lse[(long long)blockIdx.y * t + qi] = m + logf(denom);
  }
}

// ---- the bf16 body for Hopper (sm_90a): wgmma, TMA ring, softmax in registers
namespace hopper {

using sm90::bar_arrive;
using sm90::bar_expect;
using sm90::bar_init;
using sm90::bar_wait;
using sm90::desc;
using sm90::tma_load;

static_assert(DH == 64, "scale folding: bf16(q * 1/8) == bf16(q) / 8 only for Dh = 64");
constexpr int BQ = 128;                   // query rows per CTA: two consumer warpgroups
constexpr int STAGES = 2;                 // K/V tiles in flight
constexpr int CONSUMERS = 256;            // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr unsigned TILE_BYTES = 64 * DH * 2;
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {  // every tile 1024-byte aligned (the 128-byte swizzle's period)
  __nv_bfloat16 q[2][64 * DH];  // one 64-row half per warpgroup, one TMA box
  __nv_bfloat16 k[STAGES][BK * DH];
  __nv_bfloat16 v[STAGES][BK * DH];
  unsigned long long q_full, full[STAGES], empty[STAGES];
};
constexpr int SMEM_BYTES = static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack

template <bool RANGED>
__global__ void __launch_bounds__(THREADS, 2)
banded_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int h, int t,
                            long long osn, long long osh, long long ost, int band, int valid,
                            float scale, Bounds bounds) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + (-sm90::smem_addr(smem_raw) & 1023));  // 1024-aligned

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

  if (threadIdx.x == 0) {
    bar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS && ntiles > 0) {
      bar_expect(&sm.q_full, 2 * TILE_BYTES);
      tma_load(sm.q[0], &q_map, &sm.q_full, q0, hb, nb);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) bar_wait(&sm.empty[s], (i / STAGES - 1) & 1);
        bar_expect(&sm.full[s], 2 * TILE_BYTES);
        tma_load(sm.k[s], &k_map, &sm.full[s], (kt0 + i) * BK, hb, nb);
        tma_load(sm.v[s], &v_map, &sm.full[s], (kt0 + i) * BK, hb, nb);
      }
    }
    return;
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
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  if (ntiles > 0) bar_wait(&sm.q_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const int kbase = (kt0 + i) * BK;
    bar_wait(&sm.full[s], (i / STAGES) & 1);
    if (kbase <= w_hi && kbase + BK - 1 >= w_lo) {  // uniform over the warpgroup
      float sc[32];
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        sm90::mma_ss(sc, desc(sm.q[wg], 32 * kk), desc(sm.k[s], 32 * kk), kk);
      sm90::commit();
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
          sc[j] *= scale;  // exact: a power of two (scale folding)
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

      // O += P.V, P the register A operand, V an MN-major tile
      unsigned pa[4][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::a_fragment(pa[kk], sc, kk);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) sm90::mma_rs(acc, pa[kk], desc(sm.v[s], 2048 * kk));
      sm90::commit();
      sm90::wait_all();
      sm90::pin(acc);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&sm.empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= t) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + nb * osn + hb * osh + row * ost + cq;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
    if (lse != nullptr && lane % 4 == 0) lse[(long long)blockIdx.y * t + row] = m[r] + logf(denom);
  }
}

template <bool RANGED>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int n, int h, int t,
           long long sn, long long sh, long long st, long long osn, long long osh, long long ost,
           int band, int valid_len, float scale, Bounds bounds, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = sm90::make_map(&q_map, q, n, h, t, sn, sh, st, BQ);
  if (err == 0) err = sm90::make_map(&k_map, k, n, h, t, sn, sh, st, BK);
  if (err == 0) err = sm90::make_map(&v_map, v, n, h, t, sn, sh, st, BK);
  if (err != 0) return err;
  const auto kernel = banded_attn_fwd_sm90_kernel<RANGED>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((t + BQ - 1) / BQ, n * h);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o),
                                                lse, h, t, osn, osh, ost, band, valid_len, scale,
                                                bounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

// the body the last call took: "sm90" (bf16) or "wmma" (f32)
const char* last_body = "none";

template <typename T, bool RANGED>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int n, int h,
           int t, long long sn, long long sh, long long st, long long osn, long long osh,
           long long ost, int band, int valid_len, float scale, Bounds bounds,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      banded_attn_fwd_kernel<T, RANGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + BQ - 1) / BQ, n * h);
  banded_attn_fwd_kernel<T, RANGED><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, h, t, sn, sh, st, osn, osh, ost, band, valid_len, scale, bounds);
  return static_cast<int>(cudaGetLastError());
}

template <bool RANGED>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int n, int h,
             int t, long long sn, long long sh, long long st, long long osn, long long osh,
             long long ost, int band, int valid_len, float scale, Bounds bounds, int bf16,
             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  // the body by dtype: bf16 takes the Hopper body, f32 the PR 1 WMMA body
  if (bf16) {
    last_body = "sm90";
    return hopper::launch<RANGED>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh, ost, band,
                                  valid_len, scale, bounds, s);
  }
  last_body = "wmma";
  return launch<float, RANGED>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh, ost, band,
                               valid_len, scale, bounds, s);
}

}  // namespace

// q, k, v: (N, H, T, 64), f32 (bf16 = 0) or bf16 (bf16 = 1), with shared
// strides (sn, sh, st) and unit stride over the head dim; o: the same type
// with strides (osn, osh, ost). Launches on `stream` without synchronizing;
// returns cudaGetLastError().
extern "C" int banded_attention_fwd(const void* q, const void* k, const void* v, void* o, int n,
                                    int h, int t, long long sn, long long sh, long long st,
                                    long long osn, long long osh, long long ost, int band,
                                    int valid_len, float scale, int bf16, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, n, h, t, sn, sh, st, osn, osh, ost, band,
                         valid_len, scale, Bounds{}, bf16, stream);
}

// The same, also writing lse: f32 (N*H, T) contiguous, row n*H + h.
extern "C" int banded_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int n, int h, int t, long long sn,
                                        long long sh, long long st, long long osn, long long osh,
                                        long long ost, int band, int valid_len, float scale,
                                        int bf16, void* stream) {
  return dispatch<false>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh, ost, band, valid_len,
                         scale, Bounds{}, bf16, stream);
}

// Ranged: as banded_attention_fwd over all T (halo-extended) rows, with
// keys masked to [k_lo, k_hi) and only the query tiles that meet
// [q_lo, q_hi) computed (the others get 0).
extern "C" int banded_attention_fwd_ranged(const void* q, const void* k, const void* v, void* o,
                                           int n, int h, int t, long long sn, long long sh,
                                           long long st, long long osn, long long osh,
                                           long long ost, int band, int k_lo, int k_hi,
                                           int q_lo, int q_hi, float scale, int bf16,
                                           void* stream) {
  return dispatch<true>(q, k, v, o, nullptr, n, h, t, sn, sh, st, osn, osh, ost, band, t, scale,
                        Bounds{k_lo, k_hi, q_lo, q_hi}, bf16, stream);
}

// Ranged with lse (rows of uncomputed tiles get -1e30).
extern "C" int banded_attention_fwd_ranged_lse(const void* q, const void* k, const void* v,
                                               void* o, float* lse, int n, int h, int t,
                                               long long sn, long long sh, long long st,
                                               long long osn, long long osh, long long ost,
                                               int band, int k_lo, int k_hi, int q_lo, int q_hi,
                                               float scale, int bf16, void* stream) {
  return dispatch<true>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh, ost, band, t, scale,
                        Bounds{k_lo, k_hi, q_lo, q_hi}, bf16, stream);
}

extern "C" const char* banded_attention_error_string(int err) { return sm90::error_string(err); }

// "sm90" or "wmma": the body the last call of any entry took
extern "C" const char* banded_attention_last_body() { return last_body; }

// the Hopper body's dynamic shared memory per CTA, bytes
extern "C" int banded_attention_sm90_smem_bytes() { return hopper::SMEM_BYTES; }
