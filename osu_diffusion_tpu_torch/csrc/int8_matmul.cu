// The int8 weight-only adaLN projection for serving, for Hopper, sm_90a:
// act(x @ (w_q * s) + b), act none or GELU-tanh. (The other int8
// projections, the qkv projection with the LayerNorm and modulation folded
// in and the out projection with the gate and the residual folded in, run
// the adaLN-MLP's persistent Hopper GEMM over int8 codes: csrc/adaln_mlp.cu.)
//
// Replaces osu_diffusion_tpu/ops/pallas_quant.py, _kernel (int8_matmul,
// :221); the DiT block's adaLN projection.
//
// Weights are int8 codes in torch's Linear layout, w (M, K) row-major, with
// a float32 scale s (M) per output channel. Activations in and out are
// float32. Each CTA computes a (32 rows x 64 columns) output tile at a time:
// - prologue: the CTA's (32, K) activation tile, rounded to bf16, is
//   written to shared memory once;
// - loop: K is walked in 64-deep chunks. Each 64 x 64 int8 weight chunk is
//   read with 16-byte loads into registers one chunk ahead (the loads of
//   chunk i + 1 are in flight during the MMAs of chunk i), upcast to bf16
//   (exact, |q| <= 127) into a double-buffered shared tile, and multiplied
//   with WMMA bf16 16x16x16, f32 accumulation; four warps, each 16 rows x 32
//   columns;
// - epilogue: acc * s + b in f32, then GELU-tanh when asked; ragged rows
//   and columns are masked.
// A CTA walks `tiles_per_cta` column tiles with the same activation tile;
// the wrapper picks the count so the grid stays within about two CTAs per
// SM.
//
// What bounds it on the card: at DiT-B sampling (CFG batch 2, D = 768) it
// reads a 3.5 MB int8 weight for 2 rows: bytes (1.1 us at 3.35 TB/s). What
// stands in the way of that bound here: the upcast pass, WMMA instead of
// wgmma, and a 32-row tile that wastes 30 of them; its grid over M (4608 /
// 64 = 72 CTAs) under-fills the 132 SMs. (Measured on an H100 inside the
// sampling chain, int-to-float upcast: 0.015 ms; a 4-stage cp.async ring
// of int8 chunks three ahead, each thread upcasting its own pieces, took
// 0.012.) Those are a later change's levers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "tile_io.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 32;           // rows per CTA
constexpr int BN = 64;           // output columns per tile
constexpr int BK = 64;           // K depth of one staged weight chunk
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDW = BK + 8;      // bf16 row stride of a staged weight chunk
constexpr int LDC = BN + 4;      // f32 row stride of the accumulator spill
constexpr int MAX_K = 2048;      // the (32, K) bf16 activation tile fits shared memory
constexpr int PIECES = BK / 16;  // 16-byte pieces of one weight row's chunk
constexpr int W_LOADS = BN * PIECES / THREADS;  // 16-byte weight loads per thread per chunk
constexpr int W_BYTES = 2 * BN * LDW * 2;       // the double-buffered bf16 weight chunk
constexpr int C_BYTES = BM * LDC * 4;           // the f32 accumulator spill

struct Params {
  const float* x;       // (rows, k)
  const int8_t* w;      // (m, k) int8 codes
  const float* s;       // (m) per-output-channel scale
  const float* b;       // (m) bias
  float* out;           // (rows, m)
  int t, k, m, tiles_per_cta;  // t: the rows
  int gelu;
};

int smem_bytes(int k) { return W_BYTES + C_BYTES + BM * (k + 8) * 2; }

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c0 * (v + 0.044715f * v * v * v)));
}

// this thread's 16-byte pieces of weight chunk kc for columns col0 .. +BN;
// rows past m read as 0
__device__ __forceinline__ void load_w(int4 (&r)[W_LOADS], const int8_t* __restrict__ w, int col0,
                                       int kc, int k, int m) {
#pragma unroll
  for (int i = 0; i < W_LOADS; ++i) {
    const int j = threadIdx.x + i * THREADS;
    const int row = j / PIECES;
    r[i] = make_int4(0, 0, 0, 0);
    if (col0 + row < m)
      r[i] = *reinterpret_cast<const int4*>(w + (long long)(col0 + row) * k + kc * BK + (j % PIECES) * 16);
  }
}

// those pieces upcast to bf16 into the staged chunk (BN rows of BK)
__device__ __forceinline__ void store_w(__nv_bfloat16* dst, const int4 (&r)[W_LOADS]) {
#pragma unroll
  for (int i = 0; i < W_LOADS; ++i) {
    const int j = threadIdx.x + i * THREADS;
    uint4* d = reinterpret_cast<uint4*>(dst + (j / PIECES) * LDW + (j % PIECES) * 16);
    const uint2 a = tile_io::int8x4_to_bf16x4(static_cast<unsigned>(r[i].x));
    const uint2 b = tile_io::int8x4_to_bf16x4(static_cast<unsigned>(r[i].y));
    const uint2 c = tile_io::int8x4_to_bf16x4(static_cast<unsigned>(r[i].z));
    const uint2 e = tile_io::int8x4_to_bf16x4(static_cast<unsigned>(r[i].w));
    d[0] = make_uint4(a.x, a.y, b.x, b.y);
    d[1] = make_uint4(c.x, c.y, e.x, e.y);
  }
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float a, float b, float c, float d) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(dst);
  p[0] = __floats2bfloat162_rn(a, b);
  p[1] = __floats2bfloat162_rn(c, d);
}

__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* wbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);                     // [2][BN][LDW]
  auto* cbuf = reinterpret_cast<float*>(smem_raw + W_BYTES);                   // [BM][LDC]
  auto* abuf = reinterpret_cast<__nv_bfloat16*>(smem_raw + W_BYTES + C_BYTES);  // [BM][k + 8]
  const int lda = p.k + 8;
  const int t0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const long long row0 = t0;  // the tile's first row
  const int m_tiles = (p.m + BN - 1) / BN;
  const int tile0 = blockIdx.x * p.tiles_per_cta;
  const int tile1 = min(tile0 + p.tiles_per_cta, m_tiles);
  const int nk = p.k / BK;

  int4 wr[W_LOADS];  // the next weight chunk, in flight while the prologue runs
  load_w(wr, p.w, tile0 * BN, 0, p.k, p.m);

  // bf16(x); rows past t are 0
  const int k4 = p.k / 4;
  for (int idx = threadIdx.x; idx < BM * k4; idx += THREADS) {
    const int r = idx / k4;
    const int c = (idx % k4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < p.t) v = tile_io::load4(p.x + (row0 + r) * p.k + c);
    store_bf16x4(abuf + r * lda + c, v.x, v.y, v.z, v.w);
  }

  const int rt = warp & 1;   // the warp's 16-row half of the tile
  const int ch = warp >> 1;  // its 32-column half
  int buf = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int kc = 0; kc < nk; ++kc) {
      // chunk kc into buffer `buf`, whose last readers (the MMAs two chunks
      // back) passed the barrier of the previous chunk
      __nv_bfloat16* wb = wbuf + buf * BN * LDW;
      store_w(wb, wr);
      __syncthreads();  // the chunk (and, the first time, the activation tile) is written
      if (kc + 1 < nk)
        load_w(wr, p.w, tile * BN, kc + 1, p.k, p.m);
      else if (tile + 1 < tile1)
        load_w(wr, p.w, (tile + 1) * BN, 0, p.k, p.m);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, abuf + rt * 16 * lda + kc * BK + kk, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // B(k, col) = w[col][k]: the staged chunk read column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, wb + (ch * 32 + j * 16) * LDW + kk, LDW);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
      buf ^= 1;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cbuf + rt * 16 * LDC + ch * 32 + j * 16, acc[j], LDC, wmma::mem_row_major);
    __syncthreads();  // the tile's sums are spilled
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN;
      const int col = tile * BN + idx % BN;
      if (t0 + r >= p.t || col >= p.m) continue;
      float y = cbuf[r * LDC + idx % BN] * p.s[col] + p.b[col];
      if (p.gelu) y = gelu_tanh(y);
      p.out[(row0 + r) * p.m + col] = y;
    }
    // the spill is next written after the next tile's first barrier
  }
}

}  // namespace

// out (rows, m) = act(x (rows, k) @ (w * s)^T + b); gelu: 0 or 1. Every
// pointer 16-byte aligned and every array contiguous; K a multiple of 64,
// at most 2048. Launches on `stream` without synchronizing and returns
// cudaGetLastError().
extern "C" int int8_matmul_fwd(const float* x, const void* w, const float* s, const float* b,
                               float* out, int rows, int k, int m, int gelu, int tiles_per_cta,
                               void* stream) {
  const Params p{x, static_cast<const int8_t*>(w), s, b, out, rows, k, m, tiles_per_cta, gelu};
  if (p.k % BK || p.k < BK || p.k > MAX_K || p.m < 1 || p.t < 1 || p.tiles_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(p.k);
  cudaError_t err =
      cudaFuncSetAttribute(int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (p.m + BN - 1) / BN;
  const dim3 grid((m_tiles + p.tiles_per_cta - 1) / p.tiles_per_cta, (p.t + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
