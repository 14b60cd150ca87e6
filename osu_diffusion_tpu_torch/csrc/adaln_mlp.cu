// The adaLN-modulated MLP forward for Hopper, sm_90a: inference, and
// training with the backward's residuals, with bf16 weights (the Hopper
// body: a modulate pass and two persistent wgmma GEMMs); and inference with
// int8 weight-only weights for serving (the WMMA body).
//
// Replaces: osu_diffusion_tpu/ops/pallas_mlp.py, _adaln_mlp_kernel (:53)
//   in inference mode (a_ref = mlp_ref = None; called via
//   _adaln_mlp_fwd_impl) and in training mode (with_residuals=True, called
//   via _fwd); and _adaln_mlp_quant_kernel (:184), the int8 serving variant.
//
// Computes the MLP half of a DiT block,
//   out = x + gate * (fc2(gelu_tanh(fc1(LN(x) * (1 + scale) + shift))))
// with a non-affine two-pass LayerNorm (eps given), at the plain version's
// rounding points (ops/adaln_mlp.py, adaln_mlp_train_reference):
//   h   = bf16(LN(x) * (1 + scale) + shift)         (f32 LN and modulation)
//   pre = h . W1 + b1 in f32;   a = pre in x's type (training only)
//   g   = bf16(gelu_tanh(pre))                      (GELU of the f32 pre)
//   mlp = g . W2 + b2 in f32 (written in training); out = x + gate * mlp
// x and out are f32 or bf16 (the training stream), one type per call;
// shift/scale/gate are f32 rows of the modulation tensor (row stride
// mod_stride); b1, b2 f32.
//
// ---- The Hopper body (bf16 weights: rows 7 and 8) ----
// Weights in torch's Linear layout, bf16: w1 = fc1.weight (H, D), w2 =
// fc2.weight (D, H). Each is then the K-major B operand of its product
// (the reduction dim contiguous), which TMA loads as it is: no packing, no
// transpose.
//
// What bounds it on the card: at DiT-B training (x 256 x 128 x 768 bf16,
// H = 3072) one call is two products of 2 x 32768 x 768 x 3072, 309 GFLOP
// (313 us at 989 TFLOP/s), against ~411 MB that must move (x, out, a, mlp
// and the weights: 123 us at 3.35 TB/s): bound by the products. At DiT-B
// sampling (x 2 x 768 x 768 f32) it is 14.5 GFLOP (14.7 us) against 18.9 MB
// (5.6 us): bound by the products too, but 1536 token rows make only 12
// row blocks of 128. What stood in the way of the first body (a CTA per
// 32-token tile that fused everything, with fc2's (32, D) f32 output in
// registers) was that every 32 tokens streamed all 9.4 MB of weights
// through their SM (~9.6 GB of L2 reads per training call), on WMMA
// 16x16x16 read from shared memory: 3.46 ms at training, 11x the bound.
//
// What the design does about it: it gives up keeping the hidden activation
// on chip, so that the row tile can grow to 128 and the products run on
// wgmma. Three kernels on the caller's stream:
// 1. modulate (adaln_mlp_modulate_kernel): one warp per token row, the
//    two-pass LayerNorm and the modulation in f32, h (N*T, D) bf16 written
//    once (50 MB at training) where every CTA of the first body recomputed
//    the LayerNorm of its rows.
// 2. up (adaln_mlp_gemm_kernel, UP): h . W1^T -> (N*T, H); 3. down (DOWN):
//    g . W2^T -> (N*T, D). Both the same persistent kernel, whose mainloop
//    the fused backward shares (csrc/gemm_sm90.cuh): one CTA an SM
//    walks the (128-row block, BN-column block) tiles c, c + grid, ...
//    (column blocks fastest, so the CTAs at work at one time share their
//    A rows in L2; the weights, 4.7 MB each, stay in L2). One producer
//    thread keeps the tiles' 64-wide reduction slabs of A and B in flight
//    by TMA (128-byte swizzle, rows past N*T read as 0) through a ring of
//    STAGES; two consumer warpgroups each multiply 64 rows by the BN
//    columns (wgmma m64nBNk16, f32 accumulators in registers: 128 a thread
//    at BN = 256, so the producer's warpgroup hands its registers over by
//    setmaxnreg, 232 a consumer thread, as the dk/dv body does), keep one
//    slab's products in flight while the next is issued, and release each
//    stage as its products retire. So the next tile's slabs load while a
//    tile's epilogue runs. W1 and W2 are read once per 128-row block, 4x
//    fewer L2 bytes than once per 32 rows (~2.4 GB at training).
//    Epilogues, from the registers: up adds b1, writes a (training) in x's
//    type and g = bf16(gelu(pre)), each bf16 64-column block through the
//    warp's swizzled staging tile in shared memory, so that every global
//    store covers whole 128-byte rows; down adds b2, writes mlp in f32
//    (training) and out = x + gate * mlp in x's type (gate indexed by the
//    row's batch, row / T) straight from the registers (8-byte f32 pairs
//    fill whole 32-byte sectors).
//    The hidden round trip (g, 201 MB at training, written once and read
//    once: ~0.12 ms of HBM time) was meant to hide under the products; at
//    sampling g is 9.4 MB and stays in L2.
// BN, the tile's width, and the grid come from the wrapper's tile plan
// (ops/adaln_mlp.py, gemm_plan): BN = 256 or 128, whichever leaves the card
// less idle in the last round of tiles; the grid is min(SMs, tiles). No
// split-K and no atomics: one CTA owns each output tile and sums its whole
// reduction in one order, so the result is the same bits run to run.
// Measured on an H100 (chip_smoke.py [mlp-train], [mlp]): 0.78 ms at
// training (modulate 0.045, up 0.38, down 0.36; cuBLAS's two products
// alone 0.43), 2.5x the bound; 0.074 ms at sampling, where 12 row blocks
// leave the up GEMM 3 rounds of 128-wide tiles and the down GEMM 72 tiles
// on 132 SMs. Each GEMM's epilogue runs while its CTA issues no products
// (the up epilogue writes a and g, 402 MB at training), and the down GEMM
// streams g back from device memory: not overlapping the two is left to a
// later change.
//
// ---- The WMMA body (int8 weights: row 10, entry adaln_mlp_quant_fwd) ----
// x and out f32. Weights: int8 codes in the packed layout of
// ops/adaln_mlp.py (pack_weights): w1 cut into 128-column chunks,
// chunk-major, each row padded by 8 -> (H / 128, D, 136); w2 (H, D) with
// each row padded by 8 -> (H, D + 8); every weight tile the kernel streams
// is one contiguous block whose rows already carry the shared-memory
// padding. Per-output-channel f32 scales s1 (H) and s2 (D).
// - kernel 1, one CTA of 8 warps per (32-row token tile, n, hidden split):
//   LN + modulate once into shared memory as bf16; then for each 128-wide
//   chunk of the split's hidden range, fc1 (WMMA bf16 16x16x16, f32
//   accumulate), s1 and bias + GELU into a bf16 shared chunk, and fc2 of
//   that chunk accumulated into the (32, D) partial output held in
//   registers. The hidden activation never leaves the SM.
// - weight tiles (64 x 128 of w1, 16 x D of w2) stream through a four-stage
//   shared-memory ring as single bulk async copies (cp.async.bulk, one
//   thread) that complete on the stage's mbarrier. Once a tile lands, the
//   CTA upcasts it to bf16 (exact, |q| <= 127; the byte-permute upcast of
//   tile_io.cuh) into one more shared tile, which the MMAs read, and the
//   ring stage is refilled at once. (Measured on an H100 at DiT-B sampling:
//   int-to-float conversions in the upcast 0.372 ms, the byte permutes
//   0.312.)
// - the hidden dim is split over `split` CTAs (the wrapper picks it so the
//   grid fills the SMs). Each writes its f32 partial to a workspace;
//   kernel 2 sums the partials in a fixed order (deterministic), applies s2
//   (a scale does not vary along the reduction, so this equals the TPU
//   kernel's per-hidden-block application up to f32 rounding), b2, gate
//   and the residual.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "gemm_sm90.cuh"
#include "tile_io.cuh"

using namespace nvcuda;

namespace {

// the body the last entry call launched: "sm90" (bf16 weights) or "wmma" (int8)
const char* last_body = "none";

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c0 * (v + 0.044715f * v * v * v)));
}

// two adjacent elements of x's type <-> f32
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// ---- 1. the modulate pass ------------------------------------------------

constexpr int MOD_WARPS = 8;  // token rows per CTA, one warp each

// h[row] = bf16(LN(x[row]) * (1 + scale[nb]) + shift[nb]), nb = row / t
template <int D, typename TX>
__global__ void __launch_bounds__(MOD_WARPS * 32)
adaln_mlp_modulate_kernel(const TX* __restrict__ x, const float* __restrict__ shift,
                          const float* __restrict__ scale, long long mod_stride,
                          __nv_bfloat16* __restrict__ h, int rows, int t, float eps) {
  constexpr int V4 = D / 128;  // float4 per lane in one row
  const int row = blockIdx.x * MOD_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const TX* xr = x + (long long)row * D;
  const float* sh = shift + (row / t) * mod_stride;
  const float* sc = scale + (row / t) * mod_stride;
  float4 xv[V4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < V4; ++i) {
    xv[i] = tile_io::load4(xr + (i * 32 + lane) * 4);
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
    tile_io::store4(h + (long long)row * D + c,
                    make_float4(xv[i].x * inv * (1.f + k4.x) + s4.x,
                                xv[i].y * inv * (1.f + k4.y) + s4.y,
                                xv[i].z * inv * (1.f + k4.z) + s4.z,
                                xv[i].w * inv * (1.f + k4.w) + s4.w));
  }
}

// ---- 2, 3. the persistent GEMMs (wgmma, TMA ring: csrc/gemm_sm90.cuh) -------
namespace gemm {

using gemm_sm90::THREADS;

template <int BN>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(gemm_sm90::Smem<BN>)) + 1024;  // + alignment slack
}

enum Epi { UP, DOWN };

// what the epilogues read and write besides the accumulator
struct EpiArgs {
  const float* bias;         // b1 (up) or b2 (down)
  void* a;                   // up: pre-GELU a in x's type, or null (inference)
  __nv_bfloat16* g;          // up: bf16(gelu(pre)), the down GEMM's A
  const void* x;             // down: the residual stream
  const float* gate;         // down: gate rows, row stride mod_stride
  long long mod_stride;
  int t;                     // tokens per batch row: a token row's batch is row / t
  void* out;                 // down: x + gate * mlp in x's type
  float* mlp;                // down: pre-gate mlp in f32, or null (inference)
};

// C[m, ncols] = A[m, kdim] . B[ncols, kdim]^T, both bf16 row-major (B
// K-major: torch's Linear weight), persistent, with the up or down epilogue.
template <int BN, int EPI, typename TX>
__global__ void __launch_bounds__(THREADS, 1)
adaln_mlp_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap b_map, int m, int ncols, int kdim,
                      EpiArgs ep) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = gemm_sm90::aligned_smem<gemm_sm90::Smem<BN>>(smem_raw);
  const auto epilogue = [&](float(&acc)[BN / 2], int r0, int c0) {
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    // epilogue: register 4n + 2i + j holds row rw + 8i, column cq + 8n + j
    const int rw = r0 + wg * 64 + warp * 16 + lane / 4;
    const int cq = c0 + 2 * (lane % 4);
    if constexpr (EPI == UP) {
      // per 64-column block: pre = acc + b1; a (bf16: staged; f32: stored
      // straight) and g = bf16(gelu(pre)) through the warp's staging tile
      TX* a_out = static_cast<TX*>(ep.a);
      unsigned char* st = sm.stage[threadIdx.x / 32];
      const int row0 = r0 + wg * 64 + warp * 16;
#pragma unroll
      for (int cb = 0; cb < BN / 64; ++cb) {
        unsigned av[8][2], gv[8][2];
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const int n = cb * 8 + nn;
          const int c = cq + 8 * n;
          const float2 bias = *reinterpret_cast<const float2*>(ep.bias + c);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float p0 = acc[4 * n + 2 * i] + bias.x;
            const float p1 = acc[4 * n + 2 * i + 1] + bias.y;
            av[nn][i] = sm90::pack_bf16(p0, p1);
            gv[nn][i] = sm90::pack_bf16(gelu_tanh(p0), gelu_tanh(p1));
            if constexpr (sizeof(TX) == 4) {
              const int row = rw + 8 * i;
              if (a_out != nullptr && row < m) store2(a_out + (long long)row * ncols + c, p0, p1);
            }
          }
        }
        if constexpr (sizeof(TX) == 2) {
          if (a_out != nullptr)
            gemm_sm90::stage_store(st, av, reinterpret_cast<__nv_bfloat16*>(a_out), row0,
                                   c0 + cb * 64, m, ncols, lane);
        }
        gemm_sm90::stage_store(st, gv, ep.g, row0, c0 + cb * 64, m, ncols, lane);
      }
    } else {
      const TX* x = static_cast<const TX*>(ep.x);
      TX* out = static_cast<TX*>(ep.out);
      const float* gate_row[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) gate_row[i] = ep.gate + min(rw + 8 * i, m - 1) / ep.t * ep.mod_stride;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int c = cq + 8 * n;
        const float2 bias = *reinterpret_cast<const float2*>(ep.bias + c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = rw + 8 * i;
          if (row >= m) continue;
          const float v0 = acc[4 * n + 2 * i] + bias.x;
          const float v1 = acc[4 * n + 2 * i + 1] + bias.y;
          const long long off = (long long)row * ncols + c;
          if (ep.mlp != nullptr) store2(ep.mlp + off, v0, v1);
          const float2 gt = *reinterpret_cast<const float2*>(gate_row[i] + c);
          const float2 xv = load2(x + off);
          store2(out + off, __fmaf_rn(gt.x, v0, xv.x), __fmaf_rn(gt.y, v1, xv.y));
        }
      }
    }
  };
  gemm_sm90::run<BN, gemm_sm90::B_K_MAJOR>(a_map, b_map, sm, m, ncols, kdim, [](int, int) {},
                                           epilogue);
}

// C = A . B^T for A (m, kdim) and B (ncols, kdim) bf16 row-major, on `grid`
// persistent CTAs
template <int BN, int EPI, typename TX>
int launch(const void* a, const void* b, int m, int ncols, int kdim, int grid, const EpiArgs& ep,
           cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  const int err = gemm_sm90::make_maps<BN, gemm_sm90::B_K_MAJOR>(&a_map, &b_map, a, b, m, ncols, kdim);
  if (err != 0) return err;
  const auto kernel = adaln_mlp_gemm_kernel<BN, EPI, TX>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BN>());
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem_bytes<BN>(), stream>>>(a_map, b_map, m, ncols, kdim, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI, typename TX>
int launch_width(int bn, const void* a, const void* b, int m, int ncols, int kdim, int grid,
                 const EpiArgs& ep, cudaStream_t stream) {
  if (grid < 1 || kdim % gemm_sm90::BK != 0 || ncols % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {
    case 256:
      return launch<256, EPI, TX>(a, b, m, ncols, kdim, grid, ep, stream);
    case 128:
      return launch<128, EPI, TX>(a, b, m, ncols, kdim, grid, ep, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gemm

// the three kernels of the Hopper body; `stages` a mask of the ones to run
// (1 modulate, 2 up, 4 down: all but a stage timing run pass 7)
template <int D, typename TX>
int sm90_forward(const void* x, const float* shift, const float* scale, const float* gate,
                 long long mod_stride, const void* w1, const float* b1, const void* w2,
                 const float* b2, void* h, void* g, void* out, void* a, float* mlp, int n, int t,
                 int hdim, int bn_up, int grid_up, int bn_down, int grid_down, float eps,
                 int stages, cudaStream_t stream) {
  const int rows = n * t;
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* gb = static_cast<__nv_bfloat16*>(g);
  if (stages & 1) {
    adaln_mlp_modulate_kernel<D, TX><<<(rows + MOD_WARPS - 1) / MOD_WARPS, MOD_WARPS * 32, 0,
                                       stream>>>(static_cast<const TX*>(x), shift, scale,
                                                 mod_stride, hb, rows, t, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (stages & 2) {
    const gemm::EpiArgs up{b1, a, gb, nullptr, nullptr, 0, t, nullptr, nullptr};
    const int err = gemm::launch_width<gemm::UP, TX>(bn_up, hb, w1, rows, hdim, D, grid_up, up,
                                                     stream);
    if (err != 0) return err;
  }
  if (stages & 4) {
    const gemm::EpiArgs down{b2, nullptr, nullptr, x, gate, mod_stride, t, out, mlp};
    return gemm::launch_width<gemm::DOWN, TX>(bn_down, gb, w2, rows, D, hdim, grid_down, down,
                                              stream);
  }
  return 0;
}

// ---- the int8 WMMA body (row 10) -------------------------------------------
namespace int8_body {

constexpr int BT = 32;    // rows (tokens) per CTA
constexpr int BH = 128;   // hidden chunk width
constexpr int K1 = 64;    // w1 rows per streamed tile
constexpr int K2 = 16;    // w2 rows per streamed tile
constexpr int STAGES = 4; // weight tiles in the shared-memory ring
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDG = BH + 8;   // bf16 row stride of the hidden chunk
constexpr int LDS = BH + 4;   // f32 row stride of the fc1 scratch
constexpr int LDW1 = BH + 8;  // row stride of a staged w1 tile

template <int D>
struct Cfg {
  static constexpr int LDH = D + 8;           // bf16 row stride of LN(x)
  static constexpr int LDW2 = D + 8;          // row stride of a staged w2 tile
  static constexpr int T1 = D / K1;           // w1 tiles per chunk
  static constexpr int T2 = BH / K2;          // w2 tiles per chunk
  static constexpr int STAGE = K1 * LDW1 > K2 * LDW2 ? K1 * LDW1 : K2 * LDW2;
  static constexpr int NT = D / 64;           // fc2 output column tiles per warp
};

template <int D>
struct __align__(128) Smem {
  __nv_bfloat16 h[BT * Cfg<D>::LDH];       // modulated LN(x), bf16
  __nv_bfloat16 g[BT * LDG];               // gelu(fc1) chunk, bf16
  float s[BT * LDS];                       // fc1 chunk accumulator spill
  int8_t ring[STAGES][Cfg<D>::STAGE];      // streamed int8 weight tiles
  __nv_bfloat16 wide[Cfg<D>::STAGE];       // the landed tile upcast to bf16, which the MMAs read
  unsigned long long full[STAGES];         // mbarrier: the stage's tile landed
};

using tile_io::issue_bulk;
using tile_io::mbar_init;
using tile_io::mbar_wait;
using tile_io::smem_addr;

// Stage weight tile i of this CTA into ring[i % STAGES]; called by one
// thread. Per 128-wide hidden chunk the tiles are T1 slices of w1 (K1 rows
// of the chunk's block), then T2 slices of w2 (K2 of the chunk's rows).
template <int D>
__device__ __forceinline__ void issue_tile(Smem<D>& sm, int i, int chunk0,
                                           const int8_t* __restrict__ w1p,
                                           const int8_t* __restrict__ w2p) {
  using C = Cfg<D>;
  const int r = i % (C::T1 + C::T2);
  const int chunk = chunk0 + i / (C::T1 + C::T2);
  const unsigned mbar = smem_addr(&sm.full[i % STAGES]);
  const bool fc1 = r < C::T1;
  const unsigned bytes = fc1 ? K1 * LDW1 : K2 * C::LDW2;
  const int8_t* src = fc1 ? w1p + ((long long)chunk * D + r * K1) * LDW1
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

template <int D>
__global__ void __launch_bounds__(THREADS)
adaln_mlp_partial_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                         const float* __restrict__ scale, long long mod_stride,
                         const int8_t* __restrict__ w1p, const float* __restrict__ s1,
                         const float* __restrict__ b1, const int8_t* __restrict__ w2p,
                         float* __restrict__ ws, int n, int t, int t_pad, int hdim, float eps) {
  using C = Cfg<D>;
  constexpr int V4 = D / 128;  // float4 per lane in one row
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int t0 = blockIdx.x * BT;
  const int nb = blockIdx.y;
  const int chunks = hdim / BH / gridDim.z;  // chunks of this split
  const int chunk0 = blockIdx.z * chunks;
  const int ntiles = chunks * (C::T1 + C::T2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* xb = x + (long long)nb * t * D;
  const float* sh = shift + nb * mod_stride;
  const float* sc = scale + nb * mod_stride;

  if (threadIdx.x == 0) mbar_init(sm.full, STAGES);
  __syncthreads();
  // the first tiles load while the LayerNorm runs
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES && i < ntiles; ++i) issue_tile<D>(sm, i, chunk0, w1p, w2p);
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
    upcast_tile(sm.wide, sm.ring[i % STAGES], r < C::T1 ? K1 * LDW1 : K2 * C::LDW2);
    __syncthreads();  // the tile is upcast: its stage takes tile i + STAGES now
    if (threadIdx.x == 0 && i + STAGES < ntiles) issue_tile<D>(sm, i + STAGES, chunk0, w1p, w2p);
    const __nv_bfloat16* buf = sm.wide;
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
      if (r == C::T1 - 1) {  // chunk's fc1 done: scale + bias + GELU -> bf16 chunk
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(sm.s + rt * 16 * LDS + (cg * 2 + j) * 16, f1[j], LDS,
                                  wmma::mem_row_major);
        __syncthreads();
        const int c = (chunk0 + i / (C::T1 + C::T2)) * BH;
        for (int idx = threadIdx.x; idx < BT * BH; idx += THREADS) {
          const int row = idx / BH;
          const int col = idx % BH;
          const float pre = sm.s[row * LDS + col] * s1[c + col] + b1[c + col];
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
    __syncthreads();  // every warp is done with tile i's upcast copy and chunk
  }

  // this split's f32 partial of fc2 (before s2 and b2), rows past t
  // included: the workspace has t_pad = 32 * ceil(t / 32) rows
  float* wp = ws + ((long long)blockIdx.z * n + nb) * t_pad * D + (long long)(t0 + rt * 16) * D;
#pragma unroll
  for (int j = 0; j < C::NT; ++j)
    wmma::store_matrix_sync(wp + (cg * C::NT + j) * 16, acc[j], D, wmma::mem_row_major);
}

// mlp = b2 + s2 * (the sum over splits of the partials), out = x + gate *
// mlp; four elements per thread
__global__ void adaln_mlp_epilogue_kernel(const float* __restrict__ x, const float* __restrict__ ws,
                                          const float* __restrict__ gate, long long mod_stride,
                                          const float* __restrict__ s2,
                                          const float* __restrict__ b2, float* __restrict__ out,
                                          int n, int t, int t_pad, int d, int split) {
  const long long i4 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total4 = (long long)n * t * d / 4;
  if (i4 >= total4) return;
  const long long e = i4 * 4;
  const int col = static_cast<int>(e % d);
  const long long rowg = e / d;  // nb * t + row
  const int nb = static_cast<int>(rowg / t);
  const int row = static_cast<int>(rowg % t);
  const float4 bias = *reinterpret_cast<const float4*>(b2 + col);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < split; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(
        ws + (((long long)s * n + nb) * t_pad + row) * d + col);
    acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
  }
  const float4 sc = *reinterpret_cast<const float4*>(s2 + col);
  acc = make_float4(acc.x * sc.x + bias.x, acc.y * sc.y + bias.y, acc.z * sc.z + bias.z,
                    acc.w * sc.w + bias.w);
  const float4 xv = *reinterpret_cast<const float4*>(x + e);
  const float4 g = *reinterpret_cast<const float4*>(gate + nb * mod_stride + col);
  *reinterpret_cast<float4*>(out + e) = make_float4(xv.x + g.x * acc.x, xv.y + g.y * acc.y,
                                                    xv.z + g.z * acc.z, xv.w + g.w * acc.w);
}

template <int D>
int launch(const float* x, const float* shift, const float* scale, const float* gate,
           long long mod_stride, const int8_t* w1, const float* s1, const float* b1,
           const int8_t* w2, const float* s2, const float* b2, float* ws, float* out, int n, int t,
           int hdim, int split, float eps, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<D>));
  cudaError_t err = cudaFuncSetAttribute(adaln_mlp_partial_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t_pad = (t + BT - 1) / BT * BT;
  const dim3 grid(t_pad / BT, n, split);
  adaln_mlp_partial_kernel<D><<<grid, THREADS, smem, stream>>>(
      x, shift, scale, mod_stride, w1, s1, b1, w2, ws, n, t, t_pad, hdim, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total4 = (long long)n * t * D / 4;
  const int blocks = static_cast<int>((total4 + 255) / 256);
  adaln_mlp_epilogue_kernel<<<blocks, 256, 0, stream>>>(x, ws, gate, mod_stride, s2, b2, out, n, t,
                                                        t_pad, D, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace int8_body

}  // namespace

// The Hopper body (bf16 weights). x, out: (N, T, D) contiguous, f32 (bf16 =
// 0) or bf16 (bf16 = 1); shift/scale/gate: f32 rows of D with row stride
// mod_stride; w1: fc1.weight (H, D) and w2: fc2.weight (D, H), bf16
// contiguous; b1: f32 (H); b2: f32 (D); h: bf16 workspace (N*T, D); g: bf16
// workspace (N*T, H); a: null (inference) or (N, T, H) contiguous in x's
// type; mlp: null or f32 (N, T, D) contiguous. D in {384, 768, 1024}, H a
// multiple of 128; bn_up / bn_down (256 or 128, dividing H / D) and
// grid_up / grid_down the tile plan's widths and CTA counts of the two
// GEMMs; stages: 7 (a mask: 1 modulate, 2 up, 4 down). Launches on
// `stream` without synchronizing; returns 0, a CUDA error code, or
// TMA_ENCODE_ERROR + a CUresult (adaln_mlp_error_string names either).
extern "C" int adaln_mlp_fwd(const void* x, const float* shift, const float* scale,
                             const float* gate, long long mod_stride, const void* w1,
                             const float* b1, const void* w2, const float* b2, void* h, void* g,
                             void* out, void* a, float* mlp, int n, int t, int d, int hdim,
                             int bn_up, int grid_up, int bn_down, int grid_down, float eps,
                             int bf16, int stages, void* stream) {
  last_body = "sm90";
  const auto s = static_cast<cudaStream_t>(stream);
#define ADALN_MLP_SM90(D, TX)                                                                   \
  sm90_forward<D, TX>(x, shift, scale, gate, mod_stride, w1, b1, w2, b2, h, g, out, a, mlp, n, \
                      t, hdim, bn_up, grid_up, bn_down, grid_down, eps, stages, s)
  switch (d) {
    case 384:
      return bf16 ? ADALN_MLP_SM90(384, __nv_bfloat16) : ADALN_MLP_SM90(384, float);
    case 768:
      return bf16 ? ADALN_MLP_SM90(768, __nv_bfloat16) : ADALN_MLP_SM90(768, float);
    case 1024:
      return bf16 ? ADALN_MLP_SM90(1024, __nv_bfloat16) : ADALN_MLP_SM90(1024, float);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ADALN_MLP_SM90
}

// The int8 serving forward (the WMMA body): x, out f32 (N, T, D)
// contiguous; w1, w2 int8 codes in the packed layout above; s1 (H) and s2
// (D) their f32 per-output-channel scales; ws: f32 workspace of split * N *
// (32 * ceil(T / 32)) * D; H / 128 divisible by split; the other arguments
// as adaln_mlp_fwd's, without residuals. Launches on `stream` without
// synchronizing; returns cudaGetLastError().
extern "C" int adaln_mlp_quant_fwd(const float* x, const float* shift, const float* scale,
                                   const float* gate, long long mod_stride, const void* w1,
                                   const float* s1, const float* b1, const void* w2,
                                   const float* s2, const float* b2, float* ws, float* out, int n,
                                   int t, int d, int hdim, int split, float eps, void* stream) {
  last_body = "wmma";
  const auto* w1q = static_cast<const int8_t*>(w1);
  const auto* w2q = static_cast<const int8_t*>(w2);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 384:
      return int8_body::launch<384>(x, shift, scale, gate, mod_stride, w1q, s1, b1, w2q, s2, b2,
                                    ws, out, n, t, hdim, split, eps, s);
    case 768:
      return int8_body::launch<768>(x, shift, scale, gate, mod_stride, w1q, s1, b1, w2q, s2, b2,
                                    ws, out, n, t, hdim, split, eps, s);
    case 1024:
      return int8_body::launch<1024>(x, shift, scale, gate, mod_stride, w1q, s1, b1, w2q, s2, b2,
                                     ws, out, n, t, hdim, split, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* adaln_mlp_last_body() { return last_body; }

// the Hopper GEMM's dynamic shared memory per CTA at tile width bn, bytes
extern "C" int adaln_mlp_sm90_smem_bytes(int bn) {
  return bn == 256 ? gemm::smem_bytes<256>() : gemm::smem_bytes<128>();
}

extern "C" const char* adaln_mlp_error_string(int err) { return sm90::error_string(err); }
