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
// through strides too. wgmma/TMA pipelining is left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tile_io.cuh"

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
  if (bf16)
    return launch<__nv_bfloat16, RANGED>(q, k, v, o, lse, n, h, t, sn, sh, st, osn, osh, ost,
                                         band, valid_len, scale, bounds, s);
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

extern "C" const char* banded_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
