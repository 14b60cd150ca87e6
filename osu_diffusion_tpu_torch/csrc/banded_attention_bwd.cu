// Banded attention backward for Hopper, sm_90a: dq and dk/dv.
//
// Replaces: osu_diffusion_tpu/ops/pallas_attention.py,
//   _banded_attn_bwd_dq_kernel (entry banded_attention_bwd_dq) and
//   _banded_attn_bwd_dkv_kernel (entry banded_attention_bwd_dkv), both
//   called via _banded_flash_bwd_impl in the default slim-stats mode
//   (delta derived in-kernel from o and do); and the same two kernel bodies
//   with has_bounds, called via _ranged_bwd_impl for context parallelism
//   (entries banded_attention_bwd_dq_ranged and banded_attention_bwd_dkv_ranged).
//
// Ranged (the RANGED template flag; the unranged build is the same code):
// "allowed" also needs the key in [k_lo, k_hi) and the query in
// [q_lo, q_hi). The pad query rows of q (outside [q_lo, q_hi)) have an LSE
// of about -1e30 and an o the forward did not compute, so they must reach
// no gradient: dS is 0 wherever not allowed (not P * (dP - delta), whose
// delta is not trusted there); a query tile outside [q_lo, q_hi) writes 0
// to dq at once, a key tile outside [k_lo, k_hi) 0 to dk and dv, and the
// loops walk only the tiles inside the bounds.
//
// Math (scale = Dh^-1/2, every product bf16 operands with f32 accumulation):
//   P  = exp(bf16(q * scale) . bf16(k) - lse)  where allowed, else 0
//   dP = bf16(do) . bf16(v)^T,  delta = sum_d o * do  (f32, per query row)
//   dS = P * (dP - delta)
//   dq = bf16(dS) . bf16(k) * scale
//   dk = bf16(dS)^T . bf16(q * scale),  dv = bf16(P)^T . bf16(do)
// "allowed" is the forward's band q - L < k <= q + L with k < valid_len,
// and also q < valid_len: queries at or past valid_len get no gradient (a
// row with no valid key has LSE about -1e30, so exp is only taken where
// allowed). q/k/v/o/do and the gradients are f32 or bf16, one type per
// call; lse is the forward's (N*H, T) f32.
//
// What bounds it on the card: at the training shape (N*H = 3072,
// T = L = 128, Dh = 64, bf16) the dq kernel reads q, k, v, o, do (5 x 50 MB)
// and the LSE and writes dq (50 MB): 302 MB, 90 us at 3.35 TB/s, against
// 3 products of 2 x 128 x 128 x 64 per row block, 9.7 GFLOP (10 us at
// 989 TFLOP/s); dk/dv read the same and write two gradients: 352 MB,
// 105 us, against 4 products, 12.9 GFLOP. Both are bound by memory, and in
// practice by the latency of each CTA's short serial tile loop. At the
// context-parallel training shard (N*H = 384, T_ext = 512, half of it pad
// query rows, L = 128, bf16) the ranged dq reads q, k, v, o, do (5 x 25 MB)
// and the LSE and writes 25 MB (45 us), dk/dv writes two gradients (53 us);
// the pad tiles return at once, and a real tile walks up to 5 tiles of the
// other side.
//
// What the design does about it. On a GPU nothing carries over between
// CTAs, so every cross-tile sum stays inside one CTA (no atomics: the
// gradients are deterministic run to run):
// - dq: one CTA per (n*h, 64-row query tile); Q and dO are staged once,
//   the loop walks the 64-key tiles that meet the tile's band (as the
//   forward), and dQ accumulates in WMMA registers.
// - dk/dv: one CTA per (n*h, 64-key tile); K and V are staged once, the
//   loop walks the 64-query tiles that see the tile (a key k is seen by
//   q in [k - L, k + L)), and dK, dV accumulate in WMMA registers. Each
//   warp owns 16 keys and computes its S^T and dP^T directly (K.Q^T,
//   V.dO^T), so no transpose passes through shared memory.
// Per-row LSE and delta come in with each query tile (delta from o and do:
// two lanes per row, one shuffle). Inputs and outputs go through strides,
// like the forward. wgmma/TMA pipelining is left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tile_io.cuh"

using namespace nvcuda;

namespace {

constexpr int DH = 64;          // head dim the kernels take
constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int WARPS = 4;        // 16 rows (dq: queries, dk/dv: keys) per warp
constexpr int THREADS = WARPS * 32;
constexpr int LDB = DH + 8;     // bf16 row stride in shared memory (elements)
constexpr int LDS = 64 + 4;     // f32 row stride of the per-warp scratch

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using RowA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using RowB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using ColB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;

// runtime bounds of the ranged entries: keys in [k_lo, k_hi), query rows in
// [q_lo, q_hi); unused by the unranged entries
struct Bounds {
  int k_lo, k_hi, q_lo, q_hi;
};

// the forward's band and valid_len mask, both rows valid, and (ranged) the bounds
template <bool RANGED>
__device__ __forceinline__ bool pair_allowed(int kj, int qi, int band, int valid,
                                             const Bounds& b) {
  bool ok = kj > qi - band && kj <= qi + band && kj < valid && qi < valid;
  if constexpr (RANGED) ok = ok && kj >= b.k_lo && kj < b.k_hi && qi >= b.q_lo && qi < b.q_hi;
  return ok;
}

// dS of one pair: P * (dP - delta); ranged, exactly 0 where not allowed
template <bool RANGED>
__device__ __forceinline__ float pair_ds(bool ok, float p, float dp, float delta) {
  if constexpr (RANGED) return ok ? p * (dp - delta) : 0.f;
  return p * (dp - delta);
}

// zeros to this lane pair's row `row` of dst (row stride gt) if row < t
template <typename T>
__device__ __forceinline__ void zero_row(T* dst, int row, int t, long long gt) {
  const int c0 = ((threadIdx.x % 32) & 1) * 32;
  if (row < t) {
    T* drow = dst + (long long)row * gt + c0;
#pragma unroll
    for (int j = 0; j < 32; j += 4) tile_io::store4(drow + j, make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// out[16 x 64] = a[16 x 64] . b[64 x 64]^T for b staged row-major (rows are
// the output's columns), into this warp's f32 scratch
__device__ __forceinline__ void product_abt(float* out, const __nv_bfloat16* a,
                                            const __nv_bfloat16* b) {
  Acc f[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(f[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    RowA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDB);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      ColB fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LDB + kk * 16, LDB);
      wmma::mma_sync(f[n], fa, fb, f[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::store_matrix_sync(out + n * 16, f[n], LDS, wmma::mem_row_major);
}

// acc[16 x 64] += a[16 x 64] . b[64 x 64], both staged row-major
__device__ __forceinline__ void accumulate_ab(Acc (&acc)[4], const __nv_bfloat16* a,
                                              const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    RowA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDB);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      RowB fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LDB + n * 16, LDB);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// this warp's 16 x 64 accumulator, times `mul`, to rows row0 + r of dst
// (row stride gt) for rows < t, through the warp's f32 scratch
template <typename T>
__device__ __forceinline__ void store_rows(Acc (&acc)[4], float* scratch, T* dst, int row0,
                                           int t, long long gt, float mul) {
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::store_matrix_sync(scratch + n * 16, acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  if (row0 + r < t) {
    const float* srow = scratch + r * LDS + c0;
    T* drow = dst + (long long)(row0 + r) * gt + c0;
#pragma unroll
    for (int j = 0; j < 32; j += 4)
      tile_io::store4(drow + j, make_float4(srow[j] * mul, srow[j + 1] * mul, srow[j + 2] * mul,
                                            srow[j + 3] * mul));
  }
  __syncwarp();
}

// sum over the head dim of o * do for one row, 32 columns per lane of a pair
template <typename T>
__device__ __forceinline__ float half_row_dot(const T* o, const T* d) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 32; j += 4) {
    const float4 a = tile_io::load4(o + j);
    const float4 b = tile_io::load4(d + j);
    acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  return acc;
}

struct __align__(128) SmemDq {
  __nv_bfloat16 q[BQ * LDB];   // q * scale
  __nv_bfloat16 dout[BQ * LDB];
  __nv_bfloat16 k[BK * LDB];
  __nv_bfloat16 v[BK * LDB];
  __nv_bfloat16 ds[WARPS][16 * LDB];
  float s[WARPS][16 * LDS];    // scores, then the output staging
  float dp[WARPS][16 * LDS];
};

template <typename T, bool RANGED>
__global__ void __launch_bounds__(THREADS)
banded_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          T* __restrict__ dq, int h, int t, long long sn, long long sh,
                          long long st, long long gn, long long gh, long long gt, int band,
                          int valid, float scale, Bounds bounds) {
  extern __shared__ unsigned char smem_raw[];
  SmemDq& sm = *reinterpret_cast<SmemDq*>(smem_raw);

  const int q0 = blockIdx.x * BQ;
  const int nb = blockIdx.y / h;
  const int hb = blockIdx.y % h;
  const long long base = nb * sn + hb * sh;
  const long long gbase = nb * gn + hb * gh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  const int qi = q0 + warp * 16 + r;

  if constexpr (RANGED) {
    if (q0 + BQ <= bounds.q_lo || q0 >= bounds.q_hi) {  // pad query rows: no gradient
      zero_row(dq + gbase, qi, t, gt);
      return;
    }
  }

  tile_io::load_tile<BQ, DH, LDB, THREADS>(sm.q, q + base, q0, t, st, scale);
  tile_io::load_tile<BQ, DH, LDB, THREADS>(sm.dout, dout + gbase, q0, t, gt, 1.f);

  float delta = 0.f;
  float lse_q = 0.f;
  if (qi < t) {
    delta = half_row_dot(o + gbase + (long long)qi * gt + c0, dout + gbase + (long long)qi * gt + c0);
    lse_q = lse[(long long)blockIdx.y * t + qi];
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);

  Acc acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);

  // keys any valid row of this tile may see: (q0 - L, q0 + BQ - 1 + L], < valid
  // (ranged: and in [k_lo, k_hi))
  int k_lo = max(0, q0 - band + 1);
  int k_hi = q0 >= valid ? -1 : min(valid - 1, q0 + BQ - 1 + band);
  if constexpr (RANGED) {
    k_lo = max(k_lo, bounds.k_lo);
    k_hi = min(k_hi, bounds.k_hi - 1);
  }
  const float* srow = sm.s[warp] + r * LDS + c0;
  const float* dprow = sm.dp[warp] + r * LDS + c0;
  __nv_bfloat16* dsrow = sm.ds[warp] + r * LDB + c0;

  for (int kt = k_lo / BK; k_lo <= k_hi && kt <= k_hi / BK; ++kt) {
    const int kbase = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    tile_io::load_tile<BK, DH, LDB, THREADS>(sm.k, k + base, kbase, t, st, 1.f);
    tile_io::load_tile<BK, DH, LDB, THREADS>(sm.v, v + base, kbase, t, st, 1.f);
    __syncthreads();

    product_abt(sm.s[warp], sm.q + warp * 16 * LDB, sm.k);      // S = Q K^T
    product_abt(sm.dp[warp], sm.dout + warp * 16 * LDB, sm.v);  // dP = dO V^T
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool ok = pair_allowed<RANGED>(kbase + c0 + j, qi, band, valid, bounds);
      const float p = ok ? expf(srow[j] - lse_q) : 0.f;
      dsrow[j] = __float2bfloat16_rn(pair_ds<RANGED>(ok, p, dprow[j], delta));
    }
    __syncwarp();
    accumulate_ab(acc, sm.ds[warp], sm.k);  // dQ += dS K
  }
  store_rows(acc, sm.s[warp], dq + gbase, q0 + warp * 16, t, gt, scale);
}

struct __align__(128) SmemDkv {
  __nv_bfloat16 k[BK * LDB];
  __nv_bfloat16 v[BK * LDB];
  __nv_bfloat16 q[BQ * LDB];   // q * scale
  __nv_bfloat16 dout[BQ * LDB];
  __nv_bfloat16 pt[WARPS][16 * LDB];   // P^T rows of this warp's keys
  __nv_bfloat16 dst[WARPS][16 * LDB];  // dS^T rows
  float s[WARPS][16 * LDS];    // S^T, then the dK staging
  float dp[WARPS][16 * LDS];   // dP^T, then the dV staging
  float lse[BQ];
  float delta[BQ];
};

template <typename T, bool RANGED>
__global__ void __launch_bounds__(THREADS)
banded_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ o,
                           const T* __restrict__ dout, const float* __restrict__ lse,
                           T* __restrict__ dk, T* __restrict__ dv, int h, int t, long long sn,
                           long long sh, long long st, long long gn, long long gh,
                           long long gt, int band, int valid, float scale, Bounds bounds) {
  extern __shared__ unsigned char smem_raw[];
  SmemDkv& sm = *reinterpret_cast<SmemDkv*>(smem_raw);

  const int k0 = blockIdx.x * BK;
  const int nb = blockIdx.y / h;
  const int hb = blockIdx.y % h;
  const long long base = nb * sn + hb * sh;
  const long long gbase = nb * gn + hb * gh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  const int ki = k0 + warp * 16 + r;

  if constexpr (RANGED) {
    if (k0 + BK <= bounds.k_lo || k0 >= bounds.k_hi) {  // masked keys: no gradient
      zero_row(dk + gbase, ki, t, gt);
      zero_row(dv + gbase, ki, t, gt);
      return;
    }
  }

  tile_io::load_tile<BK, DH, LDB, THREADS>(sm.k, k + base, k0, t, st, 1.f);
  tile_io::load_tile<BK, DH, LDB, THREADS>(sm.v, v + base, k0, t, st, 1.f);

  Acc acc_k[4], acc_v[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(acc_k[n], 0.f);
    wmma::fill_fragment(acc_v[n], 0.f);
  }

  // valid queries that see any key of this tile: [k0 - L, k0 + BK - 1 + L)
  // (ranged: and in [q_lo, q_hi))
  int q_lo = max(0, k0 - band);
  int q_hi = k0 >= valid ? -1 : min(valid - 1, k0 + BK - 2 + band);
  if constexpr (RANGED) {
    q_lo = max(q_lo, bounds.q_lo);
    q_hi = min(q_hi, bounds.q_hi - 1);
  }
  const float* srow = sm.s[warp] + r * LDS + c0;
  const float* dprow = sm.dp[warp] + r * LDS + c0;
  __nv_bfloat16* ptrow = sm.pt[warp] + r * LDB + c0;
  __nv_bfloat16* dsrow = sm.dst[warp] + r * LDB + c0;

  for (int qt = q_lo / BQ; q_lo <= q_hi && qt <= q_hi / BQ; ++qt) {
    const int qbase = qt * BQ;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    tile_io::load_tile<BQ, DH, LDB, THREADS>(sm.q, q + base, qbase, t, st, scale);
    tile_io::load_tile<BQ, DH, LDB, THREADS>(sm.dout, dout + gbase, qbase, t, gt, 1.f);
    {  // per-row LSE and delta of the tile's 64 queries, two threads a row
      const int row = threadIdx.x >> 1;
      const int half = (threadIdx.x & 1) * 32;
      const int qr = qbase + row;
      float d = 0.f;
      if (qr < t)
        d = half_row_dot(o + gbase + (long long)qr * gt + half, dout + gbase + (long long)qr * gt + half);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (half == 0) {
        sm.delta[row] = d;
        sm.lse[row] = qr < t ? lse[(long long)blockIdx.y * t + qr] : 0.f;
      }
    }
    __syncthreads();

    product_abt(sm.s[warp], sm.k + warp * 16 * LDB, sm.q);      // S^T = K Q^T
    product_abt(sm.dp[warp], sm.v + warp * 16 * LDB, sm.dout);  // dP^T = V dO^T
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = c0 + j;
      const bool ok = pair_allowed<RANGED>(ki, qbase + col, band, valid, bounds);
      const float p = ok ? expf(srow[j] - sm.lse[col]) : 0.f;
      ptrow[j] = __float2bfloat16_rn(p);
      dsrow[j] = __float2bfloat16_rn(pair_ds<RANGED>(ok, p, dprow[j], sm.delta[col]));
    }
    __syncwarp();
    accumulate_ab(acc_v, sm.pt[warp], sm.dout);  // dV += P^T dO
    accumulate_ab(acc_k, sm.dst[warp], sm.q);    // dK += dS^T (Q * scale)
  }
  store_rows(acc_k, sm.s[warp], dk + gbase, k0 + warp * 16, t, gt, 1.f);
  store_rows(acc_v, sm.dp[warp], dv + gbase, k0 + warp * 16, t, gt, 1.f);
}

template <typename T, typename Smem, typename Kernel, typename... Args>
int launch(Kernel kernel, int n, int h, int t, cudaStream_t stream, Args... args) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + 63) / 64, n * h);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool RANGED>
int dq_entry(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, void* dq, int n, int h, int t, long long sn, long long sh,
             long long st, long long gn, long long gh, long long gt, int band, int valid_len,
             float scale, Bounds bounds, int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch<T, SmemDq>(banded_attn_bwd_dq_kernel<T, RANGED>, n, h, t, s,
                             static_cast<const T*>(q), static_cast<const T*>(k),
                             static_cast<const T*>(v), static_cast<const T*>(o),
                             static_cast<const T*>(dout), lse, static_cast<T*>(dq), h, t, sn, sh,
                             st, gn, gh, gt, band, valid_len, scale, bounds);
  }
  using T = float;
  return launch<T, SmemDq>(banded_attn_bwd_dq_kernel<T, RANGED>, n, h, t, s,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<const T*>(o),
                           static_cast<const T*>(dout), lse, static_cast<T*>(dq), h, t, sn, sh, st,
                           gn, gh, gt, band, valid_len, scale, bounds);
}

template <bool RANGED>
int dkv_entry(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dk, void* dv, int n, int h, int t, long long sn,
              long long sh, long long st, long long gn, long long gh, long long gt, int band,
              int valid_len, float scale, Bounds bounds, int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch<T, SmemDkv>(banded_attn_bwd_dkv_kernel<T, RANGED>, n, h, t, s,
                              static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), static_cast<const T*>(o),
                              static_cast<const T*>(dout), lse, static_cast<T*>(dk),
                              static_cast<T*>(dv), h, t, sn, sh, st, gn, gh, gt, band, valid_len,
                              scale, bounds);
  }
  using T = float;
  return launch<T, SmemDkv>(banded_attn_bwd_dkv_kernel<T, RANGED>, n, h, t, s,
                            static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<const T*>(o),
                            static_cast<const T*>(dout), lse, static_cast<T*>(dk),
                            static_cast<T*>(dv), h, t, sn, sh, st, gn, gh, gt, band, valid_len,
                            scale, bounds);
}

}  // namespace

// q, k, v: (N, H, T, 64) with shared strides (sn, sh, st); o, do and the
// gradients: the same shape and type with shared strides (gn, gh, gt); all
// f32 (bf16 = 0) or bf16 (bf16 = 1), unit stride over the head dim. lse:
// f32 (N*H, T) contiguous, from banded_attention_fwd_lse. Launch on
// `stream` without synchronizing; return cudaGetLastError().
extern "C" int banded_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       void* dq, int n, int h, int t, long long sn, long long sh,
                                       long long st, long long gn, long long gh, long long gt,
                                       int band, int valid_len, float scale, int bf16,
                                       void* stream) {
  return dq_entry<false>(q, k, v, o, dout, lse, dq, n, h, t, sn, sh, st, gn, gh, gt, band,
                         valid_len, scale, Bounds{}, bf16, stream);
}

extern "C" int banded_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
                                        void* dk, void* dv, int n, int h, int t, long long sn,
                                        long long sh, long long st, long long gn, long long gh,
                                        long long gt, int band, int valid_len, float scale,
                                        int bf16, void* stream) {
  return dkv_entry<false>(q, k, v, o, dout, lse, dk, dv, n, h, t, sn, sh, st, gn, gh, gt, band,
                          valid_len, scale, Bounds{}, bf16, stream);
}

// Ranged: as above over all T (halo-extended) rows with valid_len = T, keys
// in [k_lo, k_hi) and queries in [q_lo, q_hi); lse from
// banded_attention_fwd_ranged_lse.
extern "C" int banded_attention_bwd_dq_ranged(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const float* lse,
                                              void* dq, int n, int h, int t, long long sn,
                                              long long sh, long long st, long long gn,
                                              long long gh, long long gt, int band, int k_lo,
                                              int k_hi, int q_lo, int q_hi, float scale,
                                              int bf16, void* stream) {
  return dq_entry<true>(q, k, v, o, dout, lse, dq, n, h, t, sn, sh, st, gn, gh, gt, band, t,
                        scale, Bounds{k_lo, k_hi, q_lo, q_hi}, bf16, stream);
}

extern "C" int banded_attention_bwd_dkv_ranged(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const float* lse,
                                               void* dk, void* dv, int n, int h, int t,
                                               long long sn, long long sh, long long st,
                                               long long gn, long long gh, long long gt,
                                               int band, int k_lo, int k_hi, int q_lo, int q_hi,
                                               float scale, int bf16, void* stream) {
  return dkv_entry<true>(q, k, v, o, dout, lse, dk, dv, n, h, t, sn, sh, st, gn, gh, gt, band, t,
                         scale, Bounds{k_lo, k_hi, q_lo, q_hi}, bf16, stream);
}

extern "C" const char* banded_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
