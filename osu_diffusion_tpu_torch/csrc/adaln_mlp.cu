// Fused adaLN-modulated MLP forward for Hopper, sm_90a: inference, and
// training with the backward's residuals, with bf16 weights; and inference
// with int8 weight-only weights for serving.
//
// Replaces: osu_diffusion_tpu/ops/pallas_mlp.py, _adaln_mlp_kernel in
//   inference mode (a_ref = mlp_ref = None; called via _adaln_mlp_fwd_impl)
//   and in training mode (with_residuals=True, called via _fwd); and
//   _adaln_mlp_quant_kernel (:184), the int8 serving variant.
//
// Computes the MLP half of a DiT block:
//   out = x + gate * (fc2(gelu_tanh(fc1(LN(x) * (1 + scale) + shift))))
// with a non-affine two-pass LayerNorm (eps given), bf16 matmul operands,
// f32 accumulation, and f32 LN, bias, GELU, gate and residual. x and out
// are f32 or bf16 (the training stream), one type per call. In training it
// also writes the residuals of the backward: the pre-GELU activation
// a = fc1(...) + b1, (N, T, H) in x's type, written per 128-wide hidden
// chunk as each CTA computes it, and the pre-gate mlp = fc2(...) + b2,
// (N, T, D) f32, written by the epilogue kernel that sums the hidden-split
// partials (that sum plus b2 is mlp).
//
// Weights are bf16 in a packed layout (ops/adaln_mlp.py, pack_weights),
// made once by the model: w1 (D, H) cut into 128-column chunks, chunk-major,
// each row padded by 8 -> (H / 128, D, 136); w2 (H, D) with each row padded
// by 8 -> (H, D + 8). Every weight tile the kernel streams is then one
// contiguous block whose rows already carry the shared-memory padding.
//
// int8 weights (entry adaln_mlp_quant_fwd; f32 x only): the same packed
// layout with int8 codes, and per-output-channel f32 scales s1 (H) and s2
// (D). Each tile streams half the bytes; once it lands, the CTA upcasts it
// to bf16 (exact, |q| <= 127) into one more shared tile, which the MMAs
// read, and the ring stage is refilled at once. s1 scales the fc1
// accumulator before b1 and GELU; s2 scales the summed fc2 partials before
// b2 (a scale does not vary along the reduction, so this equals the TPU
// kernel's per-hidden-block application up to f32 rounding). Bound as
// below (the MMAs at sampling), with 4.7 MB of weights instead of 9.4; the
// upcast adds a pass over every tile and one barrier per tile, and its
// instructions take the MMA warps' issue slots. (Measured on an H100 at
// DiT-B sampling: with int-to-float conversions in the upcast, 0.372 ms,
// 1.7x the bf16-weight kernel, and the same 0.372 when tile i + 1 was
// upcast into a second buffer during tile i with one barrier per tile: the
// conversions' issue rate cost, not the barrier; the byte-permute upcast
// of tile_io.cuh took it to 0.312.)
//
// What bounds it on the card: at DiT-B sampling (x 2 x 768 x 768, H = 3072)
// one call is 14.5 GFLOP against 9.4 MB of bf16 weights and 9.4 MB of f32
// activations in and out, far above the H100's bf16 ridge, so in principle
// the matmuls bound it. At DiT-B training (x 256 x 128 x 768 bf16) it is
// 155 GFLOP (157 us at 989 TFLOP/s) against ~420 MB moved (x, out, a, mlp
// and the weights: 125 us at 3.35 TB/s): bound by the matmuls, with the
// 201 MB write of `a` close behind. Two things stand in the way: the (N, T, 4D) hidden
// activation, which must not round-trip through HBM (written and read back
// in f32 it would add ~38 MB per call), and the weights, which every
// 32-row tile of tokens has to stream through its SM (48 tiles x 9.4 MB =
// 453 MB of L2 reads per call). The (32, D) f32 output accumulator fills
// the registers, so the row tile cannot grow to cut that traffic.
//
// What the design does about it:
// - kernel 1, one CTA of 8 warps per (32-row token tile, n, hidden split):
//   LN + modulate once into shared memory as bf16; then for each 128-wide
//   chunk of the split's hidden range, fc1 (WMMA bf16 16x16x16, f32
//   accumulate), bias + GELU into a bf16 shared chunk, and fc2 of that chunk
//   accumulated into the (32, D) partial output held in registers. The
//   hidden activation never leaves the SM.
// - weight tiles (64 x 128 of w1, 16 x D of w2) stream through a four-stage
//   shared-memory ring, so the WMMA operand loads hit shared memory, not L2.
//   One thread issues each tile as a single bulk async copy
//   (cp.async.bulk) that completes on the stage's mbarrier; the other
//   threads only wait on it, so copying costs the MMA warps no issue slots
//   and four tiles are in flight. (Measured on an H100: per-thread 16-byte
//   cp.async copies spent the MMA warps' issue slots, 0.276 ms per call;
//   one bulk copy per padded row was slower still, 0.568 ms; one per
//   packed tile, 0.208 ms.)
// - the hidden dim is split over `split` CTAs (the wrapper picks it so the
//   grid fills the SMs: 48 token tiles alone would leave 84 of 132 idle).
//   Each writes its f32 partial to a workspace; kernel 2 sums the partials
//   in a fixed order (deterministic) and applies b2, gate and the residual.
// wgmma, and fewer L2 bytes (TMA multicast across a cluster), are left to
// a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "tile_io.cuh"

using namespace nvcuda;

namespace {

constexpr int BT = 32;    // rows (tokens) per CTA
constexpr int BH = 128;   // hidden chunk width
constexpr int K1 = 64;    // w1 rows per streamed tile
constexpr int K2 = 16;    // w2 rows per streamed tile
constexpr int STAGES = 4; // weight tiles in the shared-memory ring
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDG = BH + 8;   // bf16 row stride of the hidden chunk
constexpr int LDS = BH + 4;   // f32 row stride of the fc1 scratch
constexpr int LDW1 = BH + 8;  // bf16 row stride of a staged w1 tile

template <int D>
struct Cfg {
  static constexpr int LDH = D + 8;           // bf16 row stride of LN(x)
  static constexpr int LDW2 = D + 8;          // bf16 row stride of a staged w2 tile
  static constexpr int T1 = D / K1;           // w1 tiles per chunk
  static constexpr int T2 = BH / K2;          // w2 tiles per chunk
  static constexpr int STAGE = K1 * LDW1 > K2 * LDW2 ? K1 * LDW1 : K2 * LDW2;
  static constexpr int NT = D / 64;           // fc2 output column tiles per warp
};

// W: the weight type, __nv_bfloat16 or int8_t (int8 codes upcast on chip)
template <typename W>
constexpr bool kInt8 = sizeof(W) == 1;

template <int D, typename W>
struct __align__(128) Smem {
  __nv_bfloat16 h[BT * Cfg<D>::LDH];       // modulated LN(x), bf16
  __nv_bfloat16 g[BT * LDG];               // gelu(fc1) chunk, bf16
  float s[BT * LDS];                       // fc1 chunk accumulator spill
  W ring[STAGES][Cfg<D>::STAGE];           // streamed weight tiles
  // int8: the landed tile upcast to bf16, which the MMAs read
  __nv_bfloat16 wide[kInt8<W> ? Cfg<D>::STAGE : 16];
  unsigned long long full[STAGES];            // mbarrier: the stage's tile landed
};

using tile_io::issue_bulk;
using tile_io::mbar_init;
using tile_io::mbar_wait;
using tile_io::smem_addr;

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c0 * (v + 0.044715f * v * v * v)));
}

// Stage weight tile i of this CTA into ring[i % STAGES]; called by one
// thread. Per 128-wide hidden chunk the tiles are T1 slices of w1 (K1 rows
// of the chunk's block), then T2 slices of w2 (K2 of the chunk's rows).
template <int D, typename W>
__device__ __forceinline__ void issue_tile(Smem<D, W>& sm, int i, int chunk0,
                                           const W* __restrict__ w1p, const W* __restrict__ w2p) {
  using C = Cfg<D>;
  const int r = i % (C::T1 + C::T2);
  const int chunk = chunk0 + i / (C::T1 + C::T2);
  const unsigned mbar = smem_addr(&sm.full[i % STAGES]);
  const bool fc1 = r < C::T1;
  const unsigned bytes = (fc1 ? K1 * LDW1 : K2 * C::LDW2) * sizeof(W);
  const W* src = fc1 ? w1p + ((long long)chunk * D + r * K1) * LDW1
                                 : w2p + ((long long)chunk * BH + (r - C::T1) * K2) * C::LDW2;
  issue_bulk(sm.ring[i % STAGES], src, bytes, mbar);
}

// int8 -> bf16 upcast of one landed tile of `elems` codes (a multiple of 8)
__device__ __forceinline__ void upcast_tile(__nv_bfloat16* dst, const int8_t* src, int elems) {
  for (int e = threadIdx.x * 8; e < elems; e += THREADS * 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(src + e);
    const uint2 lo = tile_io::int8x4_to_bf16x4(q.x);
    const uint2 hi = tile_io::int8x4_to_bf16x4(q.y);
    *reinterpret_cast<uint4*>(dst + e) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// s1: null (bf16 weights) or the int8 fc1 weight's per-column scales
template <int D, typename TX, typename W>
__global__ void __launch_bounds__(THREADS)
adaln_mlp_partial_kernel(const TX* __restrict__ x, const float* __restrict__ shift,
                         const float* __restrict__ scale, long long mod_stride,
                         const W* __restrict__ w1p, const float* __restrict__ s1,
                         const float* __restrict__ b1, const W* __restrict__ w2p,
                         float* __restrict__ ws, TX* __restrict__ a_out, int n, int t, int t_pad,
                         int hdim, float eps) {
  using C = Cfg<D>;
  constexpr int V4 = D / 128;  // float4 per lane in one row
  extern __shared__ unsigned char smem_raw[];
  Smem<D, W>& sm = *reinterpret_cast<Smem<D, W>*>(smem_raw);

  const int t0 = blockIdx.x * BT;
  const int nb = blockIdx.y;
  const int chunks = hdim / BH / gridDim.z;  // chunks of this split
  const int chunk0 = blockIdx.z * chunks;
  const int ntiles = chunks * (C::T1 + C::T2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const TX* xb = x + (long long)nb * t * D;
  const float* sh = shift + nb * mod_stride;
  const float* sc = scale + nb * mod_stride;

  if (threadIdx.x == 0) mbar_init(sm.full, STAGES);
  __syncthreads();
  // the first tiles load while the LayerNorm runs
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES && i < ntiles; ++i) issue_tile<D, W>(sm, i, chunk0, w1p, w2p);
  }

  // LayerNorm (two-pass, f32) + modulate -> bf16, one warp per row
  for (int row = warp; row < BT; row += WARPS) {
    float4 xv[V4];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      xv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + row < t) xv[i] = tile_io::load4(xb + (long long)(t0 + row) * D + (i * 32 + lane) * 4);
      sum += xv[i].x + xv[i].y + xv[i].z + xv[i].w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      xv[i].x -= mean; xv[i].y -= mean; xv[i].z -= mean; xv[i].w -= mean;
      sq += xv[i].x * xv[i].x + xv[i].y * xv[i].y + xv[i].z * xv[i].z + xv[i].w * xv[i].w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float inv = rsqrtf(sq / D + eps);
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const int c = (i * 32 + lane) * 4;
      const float4 s4 = *reinterpret_cast<const float4*>(sh + c);
      const float4 k4 = *reinterpret_cast<const float4*>(sc + c);
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(sm.h + row * C::LDH + c);
      d[0] = __floats2bfloat162_rn(xv[i].x * inv * (1.f + k4.x) + s4.x,
                                   xv[i].y * inv * (1.f + k4.y) + s4.y);
      d[1] = __floats2bfloat162_rn(xv[i].z * inv * (1.f + k4.z) + s4.z,
                                   xv[i].w * inv * (1.f + k4.w) + s4.w);
    }
  }

  // warp w: row tile rt of the two; fc1 column tiles 2*(w/2), +1 of the
  // chunk's eight; fc2 output column tiles NT*(w/2) .. +NT of D/16
  const int rt = warp & 1;
  const int cg = warp >> 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::NT];
#pragma unroll
  for (int j = 0; j < C::NT; ++j) wmma::fill_fragment(acc[j], 0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f1[2];

  __syncthreads();  // LN(x) is written
  for (int i = 0; i < ntiles; ++i) {
    // tile i is the (i / STAGES)-th use of its stage
    mbar_wait(smem_addr(&sm.full[i % STAGES]), (i / STAGES) & 1);
    const int r = i % (C::T1 + C::T2);
    const __nv_bfloat16* buf;
    if constexpr (kInt8<W>) {
      upcast_tile(sm.wide, sm.ring[i % STAGES], r < C::T1 ? K1 * LDW1 : K2 * C::LDW2);
      __syncthreads();  // the tile is upcast: its stage takes tile i + STAGES now
      if (threadIdx.x == 0 && i + STAGES < ntiles)
        issue_tile<D, W>(sm, i + STAGES, chunk0, w1p, w2p);
      buf = sm.wide;
    } else {
      buf = sm.ring[i % STAGES];
    }
    if (r < C::T1) {
      // fc1: rows r*K1 .. +K1 of the reduction over D
      if (r == 0) {
        wmma::fill_fragment(f1[0], 0.f);
        wmma::fill_fragment(f1[1], 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < K1; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sm.h + rt * 16 * C::LDH + r * K1 + kk, C::LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, buf + kk * LDW1 + (cg * 2 + j) * 16, LDW1);
          wmma::mma_sync(f1[j], a, b, f1[j]);
        }
      }
      if (r == C::T1 - 1) {  // chunk's fc1 done: bias (+ the a residual) + GELU -> bf16 chunk
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(sm.s + rt * 16 * LDS + (cg * 2 + j) * 16, f1[j], LDS,
                                  wmma::mem_row_major);
        __syncthreads();
        const int c = (chunk0 + i / (C::T1 + C::T2)) * BH;
        for (int idx = threadIdx.x; idx < BT * BH; idx += THREADS) {
          const int row = idx / BH;
          const int col = idx % BH;
          const float sum = sm.s[row * LDS + col];
          const float pre = (s1 != nullptr ? sum * s1[c + col] : sum) + b1[c + col];
          if (a_out != nullptr && t0 + row < t)
            a_out[((long long)nb * t + t0 + row) * hdim + c + col] = tile_io::from_float<TX>(pre);
          sm.g[row * LDG + col] = __float2bfloat16_rn(gelu_tanh(pre));
        }
      }
    } else {
      // fc2: rows (r - T1)*K2 .. +K2 of the chunk, accumulated in registers
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sm.g + rt * 16 * LDG + (r - C::T1) * K2, LDG);
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, buf + (cg * C::NT + j) * 16, C::LDW2);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // every warp is done with tile i: its stage (bf16) takes tile i + STAGES
    if constexpr (!kInt8<W>) {
      if (threadIdx.x == 0 && i + STAGES < ntiles)
        issue_tile<D, W>(sm, i + STAGES, chunk0, w1p, w2p);
    }
  }

  // this split's f32 partial of fc2 (before b2), rows past t included: the
  // workspace has t_pad = 32 * ceil(t / 32) rows
  float* wp = ws + ((long long)blockIdx.z * n + nb) * t_pad * D + (long long)(t0 + rt * 16) * D;
#pragma unroll
  for (int j = 0; j < C::NT; ++j)
    wmma::store_matrix_sync(wp + (cg * C::NT + j) * 16, acc[j], D, wmma::mem_row_major);
}

// mlp = b2 + sum over splits of the partials (int8: b2 + s2 * that sum;
// written when mlp is given), out = x + gate * mlp; four elements per thread
template <typename TX>
__global__ void adaln_mlp_epilogue_kernel(const TX* __restrict__ x, const float* __restrict__ ws,
                                          const float* __restrict__ gate, long long mod_stride,
                                          const float* __restrict__ s2,
                                          const float* __restrict__ b2, TX* __restrict__ out,
                                          float* __restrict__ mlp, int n, int t, int t_pad, int d,
                                          int split) {
  const long long i4 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total4 = (long long)n * t * d / 4;
  if (i4 >= total4) return;
  const long long e = i4 * 4;
  const int col = static_cast<int>(e % d);
  const long long rowg = e / d;  // nb * t + row
  const int nb = static_cast<int>(rowg / t);
  const int row = static_cast<int>(rowg % t);
  const float4 bias = *reinterpret_cast<const float4*>(b2 + col);
  float4 acc = s2 != nullptr ? make_float4(0.f, 0.f, 0.f, 0.f) : bias;
  for (int s = 0; s < split; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(
        ws + (((long long)s * n + nb) * t_pad + row) * d + col);
    acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
  }
  if (s2 != nullptr) {
    const float4 sc = *reinterpret_cast<const float4*>(s2 + col);
    acc = make_float4(acc.x * sc.x + bias.x, acc.y * sc.y + bias.y, acc.z * sc.z + bias.z,
                      acc.w * sc.w + bias.w);
  }
  if (mlp != nullptr) tile_io::store4(mlp + e, acc);
  const float4 xv = tile_io::load4(x + e);
  const float4 g = *reinterpret_cast<const float4*>(gate + nb * mod_stride + col);
  tile_io::store4(out + e, make_float4(xv.x + g.x * acc.x, xv.y + g.y * acc.y,
                                       xv.z + g.z * acc.z, xv.w + g.w * acc.w));
}

template <int D, typename TX, typename W>
int launch(const void* xv, const float* shift, const float* scale, const float* gate,
           long long mod_stride, const W* w1, const float* s1, const float* b1, const W* w2,
           const float* s2, const float* b2, float* ws, void* outv, void* av, float* mlp, int n,
           int t, int hdim, int split, float eps, cudaStream_t stream) {
  const auto* x = static_cast<const TX*>(xv);
  auto* out = static_cast<TX*>(outv);
  const int smem = static_cast<int>(sizeof(Smem<D, W>));
  cudaError_t err = cudaFuncSetAttribute(
      adaln_mlp_partial_kernel<D, TX, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t_pad = (t + BT - 1) / BT * BT;
  const dim3 grid(t_pad / BT, n, split);
  adaln_mlp_partial_kernel<D, TX, W><<<grid, THREADS, smem, stream>>>(
      x, shift, scale, mod_stride, w1, s1, b1, w2, ws, static_cast<TX*>(av), n, t, t_pad, hdim, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total4 = (long long)n * t * D / 4;
  const int blocks = static_cast<int>((total4 + 255) / 256);
  adaln_mlp_epilogue_kernel<TX><<<blocks, 256, 0, stream>>>(x, ws, gate, mod_stride, s2, b2, out,
                                                           mlp, n, t, t_pad, D, split);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename W>
int dispatch(const void* x, const float* shift, const float* scale, const float* gate,
             long long mod_stride, const W* w1, const float* s1, const float* b1, const W* w2,
             const float* s2, const float* b2, float* ws, void* out, void* a, float* mlp, int n,
             int t, int d, int hdim, int split, float eps, cudaStream_t s) {
  switch (d) {
    case 384:
      return launch<384, TX, W>(x, shift, scale, gate, mod_stride, w1, s1, b1, w2, s2, b2, ws, out, a, mlp, n, t, hdim, split, eps, s);
    case 768:
      return launch<768, TX, W>(x, shift, scale, gate, mod_stride, w1, s1, b1, w2, s2, b2, ws, out, a, mlp, n, t, hdim, split, eps, s);
    case 1024:
      return launch<1024, TX, W>(x, shift, scale, gate, mod_stride, w1, s1, b1, w2, s2, b2, ws, out, a, mlp, n, t, hdim, split, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out: (N, T, D) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1);
// shift/scale/gate: f32 rows of D with row stride mod_stride; w1: bf16
// packed (H / 128, D, 136); b1: f32 (H); w2: bf16 packed (H, D + 8); b2: f32
// (D); ws: f32 workspace of split * N * (32 * ceil(T / 32)) * D; a: null
// (inference) or (N, T, H) contiguous in x's type; mlp: null or f32
// (N, T, D) contiguous. D in {384, 768, 1024}; H / 128 divisible by split.
// Launches on `stream` without synchronizing; returns cudaGetLastError().
extern "C" int adaln_mlp_fwd(const void* x, const float* shift, const float* scale,
                             const float* gate, long long mod_stride, const void* w1,
                             const float* b1, const void* w2, const float* b2, float* ws,
                             void* out, void* a, float* mlp, int n, int t, int d, int hdim,
                             int split, float eps, int bf16, void* stream) {
  const auto* w1b = static_cast<const __nv_bfloat16*>(w1);
  const auto* w2b = static_cast<const __nv_bfloat16*>(w2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, shift, scale, gate, mod_stride, w1b, nullptr, b1, w2b,
                                   nullptr, b2, ws, out, a, mlp, n, t, d, hdim, split, eps, s);
  return dispatch<float>(x, shift, scale, gate, mod_stride, w1b, nullptr, b1, w2b, nullptr, b2, ws,
                         out, a, mlp, n, t, d, hdim, split, eps, s);
}

// The int8 serving forward: x, out f32 (N, T, D) contiguous; w1, w2 int8
// codes in the packed layout above; s1 (H) and s2 (D) their f32
// per-output-channel scales; the other arguments as adaln_mlp_fwd's, without
// residuals. Launches on `stream` without synchronizing; returns
// cudaGetLastError().
extern "C" int adaln_mlp_quant_fwd(const float* x, const float* shift, const float* scale,
                                   const float* gate, long long mod_stride, const void* w1,
                                   const float* s1, const float* b1, const void* w2,
                                   const float* s2, const float* b2, float* ws, float* out, int n,
                                   int t, int d, int hdim, int split, float eps, void* stream) {
  return dispatch<float>(x, shift, scale, gate, mod_stride, static_cast<const int8_t*>(w1), s1, b1,
                         static_cast<const int8_t*>(w2), s2, b2, ws, out, nullptr, nullptr, n, t,
                         d, hdim, split, eps, static_cast<cudaStream_t>(stream));
}

extern "C" const char* adaln_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
