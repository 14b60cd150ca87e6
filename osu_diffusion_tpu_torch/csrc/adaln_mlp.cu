// The adaLN-modulated MLP forward for Hopper, sm_90a: inference, and
// training with the backward's residuals, with bf16 weights, and inference
// with int8 weight-only weights for serving; each a modulate pass and two
// persistent wgmma GEMMs (the Hopper body). Also the int8 qkv projection,
// which is the same modulate pass and one such GEMM, and the int8 out
// projection with the gate and the residual, which is one such GEMM; and the
// wide body of the int8 adaLN projection, a cast pass and one such GEMM.
//
// Replaces: osu_diffusion_tpu/ops/pallas_mlp.py, _adaln_mlp_kernel (:53)
//   in inference mode (a_ref = mlp_ref = None; called via
//   _adaln_mlp_fwd_impl) and in training mode (with_residuals=True, called
//   via _fwd); _adaln_mlp_quant_kernel (:184), the int8 serving variant;
//   and osu_diffusion_tpu/ops/pallas_quant.py, _modulated_kernel (:95),
//   the int8 qkv projection with the LayerNorm and modulation folded in,
//   _out_residual_kernel (:156), the int8 out projection with the
//   adaLN gate and the residual add folded in, and _kernel (:221,
//   int8_matmul) for batches wider than the skinny body of
//   csrc/int8_matmul.cu takes.
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
// (ops/gemm_plan.py, gemm_plan): BN = 256 or 128, whichever leaves the card
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
// ---- The int8 serving bodies (rows 10 and 11) ----
// The same three kernels over int8 weight codes for serving (x and out
// f32): fc1 (H, D) and fc2 (D, H) int8 in torch's Linear layout, as
// QuantLinear holds them, with f32 per-output-channel scales s1 (H) and s2
// (D). The GEMMs take csrc/gemm_sm90.cuh's int8 B operand: TMA loads each
// (BN, 64)-byte slab of codes into the stage, the consumers upcast it to
// bf16 in shared memory (exact: |q| <= 127) in the swizzled layout their
// wgmma reads, each slab while the products of the one before run, and
// each epilogue takes the f32 sum times the column's scale plus the bias
// (acc * s + b, the TPU kernels' order). No bf16 copy of a weight exists outside the
// ring. Row 10 (entry adaln_mlp_quant_fwd) is modulate, up and down as
// above; row 11 (int8_modulated_matmul_fwd, the qkv projection
// (LN(x) * (1 + scale) + shift) . (w * s)^T + b) is the modulate pass and
// one GEMM whose epilogue writes f32 (N*T, M) straight from the registers,
// M any even count (the last column block masked: TMA reads its codes past
// M as 0, the epilogue stores no column past M).
// What bounds them at DiT-B sampling (x 2 x 768 x 768 f32): row 10 as row
// 7, the products (14.5 GFLOP, 14.7 us); row 11 the bytes (x 4.7 MB, codes
// 1.8 MB, out 14.2 MB f32: 6.2 us, against 5.4 GFLOP, 5.5 us).
// At DiT-XL (D = 1152, H = 4608) the modulate pass holds nine float4 a lane
// and the GEMMs are the same builds: the down GEMM's and the out
// projection's 1152 columns take 128-wide tiles (256 does not divide
// them), the qkv projection's 3456 a ragged last 256-wide block where the
// plan picks 256. The training forward (row 8) takes 1152 too: its
// residuals a (N*T, 4608) and mlp (N*T, 1152) are the same epilogues' stores
// at XL's widths (at XL training, x 256 x 128 x 1152 bf16: 696 GFLOP, 0.70
// ms at 989 TFLOP/s, against 0.63 GB, 0.19 ms: the products). The fused
// backward (csrc/adaln_mlp_bwd.cu) stops at D = 1024.
// What replaced what: row 10's first body streamed all 4.7 MB of codes
// through each 32-token CTA and upcast each tile in shared memory before
// WMMA 16x16x16 products (0.30 ms at DiT-B sampling, 20x its bound); row
// 11's re-read its weight from L2 once per 32-row tile, also on WMMA (0.088
// ms). Here each weight slab is read once per 128-row block and multiplied
// on wgmma. At DiT-B sampling (1536 token rows) 12 row blocks under-fill
// the card as they do for row 7.
//
// ---- The int8 out projection (row 12) ----
// out = res + gate[n] * (o . (w * s)^T + b) in f32, o the attention's
// output (N*T, D) in bf16 (the TPU kernel rounds o to bf16 first; the
// banded-attention forward writes it so), w (D, D) int8 codes in torch's
// layout: one GEMM over int8 codes with o as its TMA-loaded A, no modulate
// pass. Its epilogue (OUT) is the down GEMM's: the column's scale and bias
// on the f32 sum, then res + gate * y (gate indexed by the row's batch,
// row / T: a 128-row block spans two batch rows when T is ragged), stored
// from the registers; a build of its own, so that a profile tells it from
// row 10's down GEMM. What bounds it at DiT-B sampling (o 2 x 768 x 768
// bf16): the bytes (o 2.4 MB, res and out 4.7 MB each f32, codes 0.6 MB:
// 3.7 us) against 1.8 GFLOP (1.8 us). What it replaced: a WMMA kernel
// (csrc/int8_matmul.cu, PR 3) that re-read the weight from L2 once per
// 32-row tile and upcast each chunk into shared memory before 16x16x16
// products (0.0359 ms at DiT-B sampling on an H100, 8.1x its bound).
//
// ---- The int8 adaLN projection's wide body (row 13 above SKINNY_ROWS) ----
// out = act(x . (w * s)^T + b), act none or GELU-tanh, x (rows, K) f32, w
// (M, K) int8 codes, for more activation rows than the skinny body
// (csrc/int8_matmul.cu) takes and an even M: a cast pass writes bf16(x)
// (rows, K) (adaln_mlp_cast_kernel, the contract's own rounding), then one
// GEMM over int8 codes whose epilogue (ADA) is the qkv one's, acc * s + b
// in f32 with a ragged last column block, plus GELU-tanh when asked; a
// build of its own, so that a profile tells it from row 11's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"
#include "tile_io.cuh"

namespace {

// the body the last entry call launched ("sm90": every entry's)
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

using gemm_sm90::B_INT8;
using gemm_sm90::B_K_MAJOR;
using gemm_sm90::THREADS;

template <int BN, int BL>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(gemm_sm90::SmemOf<BN, BL>)) + 1024;  // + alignment slack
}

// OUT: row 12, the down epilogue without mlp; ADA: row 13's wide body, the
// qkv epilogue with an optional GELU
enum Epi { UP, DOWN, QKV, OUT, ADA };

// what the epilogues read and write besides the accumulator
struct EpiArgs {
  const float* bias;         // b1 (up), b2 (down; null: a rank's partial) or b (qkv)
  void* a;                   // up: pre-GELU a in x's type, or null (inference)
  __nv_bfloat16* g;          // up: bf16(gelu(pre)), the down GEMM's A
  const void* x;             // down, out: the residual stream (down: null for a rank's partial)
  const float* gate;         // down: gate rows, row stride mod_stride
  long long mod_stride;
  int t;                     // tokens per batch row: a token row's batch is row / t
  void* out;                 // down, out: x + gate * mlp in x's type; qkv: f32 (m, ncols)
  float* mlp;                // down: pre-gate mlp in f32, or null (inference)
  const float* scale;        // int8 B: the codes' per-column scales s1, s2 or s
  int gelu;                  // ada: GELU-tanh after acc * s + b
};

// a column's f32 value from its sum: + bias; int8 codes' sums times the
// column's scale first
template <int BL>
__device__ __forceinline__ float biased(float acc, float s, float b) {
  if constexpr (BL == B_INT8) return acc * s + b;
  return acc + b;
}

// C[m, ncols] = A[m, kdim] . B[ncols, kdim]^T, A bf16 and B bf16 or int8
// codes (BL), both row-major (B K-major: torch's Linear weight),
// persistent, with the up, down or qkv epilogue.
template <int BN, int EPI, typename TX, int BL>
__global__ void __launch_bounds__(THREADS, 1)
adaln_mlp_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap b_map, int m, int ncols, int kdim,
                      EpiArgs ep) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = gemm_sm90::aligned_smem<gemm_sm90::SmemOf<BN, BL>>(smem_raw);
  const auto scales = [&](int c) {  // the codes' scales of columns c, c + 1
    if constexpr (BL == B_INT8) return *reinterpret_cast<const float2*>(ep.scale + c);
    return make_float2(1.f, 1.f);
  };
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
          const float2 sc = scales(c);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float p0 = biased<BL>(acc[4 * n + 2 * i], sc.x, bias.x);
            const float p1 = biased<BL>(acc[4 * n + 2 * i + 1], sc.y, bias.y);
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
    } else if constexpr (EPI == DOWN || EPI == OUT) {
      const TX* x = static_cast<const TX*>(ep.x);
      TX* out = static_cast<TX*>(ep.out);
      const float* gate_row[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) gate_row[i] = ep.gate + min(rw + 8 * i, m - 1) / ep.t * ep.mod_stride;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int c = cq + 8 * n;
        // a rank's partial (null bias and x) adds neither b2 nor the residual
        const float2 bias = ep.bias != nullptr ? *reinterpret_cast<const float2*>(ep.bias + c)
                                               : make_float2(0.f, 0.f);
        const float2 sc = scales(c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = rw + 8 * i;
          if (row >= m) continue;
          const float v0 = biased<BL>(acc[4 * n + 2 * i], sc.x, bias.x);
          const float v1 = biased<BL>(acc[4 * n + 2 * i + 1], sc.y, bias.y);
          const long long off = (long long)row * ncols + c;
          if (ep.mlp != nullptr) store2(ep.mlp + off, v0, v1);
          const float2 gt = *reinterpret_cast<const float2*>(gate_row[i] + c);
          const float2 xv = x != nullptr ? load2(x + off) : make_float2(0.f, 0.f);
          store2(out + off, __fmaf_rn(gt.x, v0, xv.x), __fmaf_rn(gt.y, v1, xv.y));
        }
      }
    } else {  // QKV, ADA: f32 (m, ncols), columns past ncols (a ragged block) not stored
      float* out = static_cast<float*>(ep.out);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int c = cq + 8 * n;
        if (c >= ncols) continue;  // ncols even: the pair's second column is in too
        const float2 bias = *reinterpret_cast<const float2*>(ep.bias + c);
        const float2 sc = scales(c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = rw + 8 * i;
          if (row >= m) continue;
          float v0 = biased<BL>(acc[4 * n + 2 * i], sc.x, bias.x);
          float v1 = biased<BL>(acc[4 * n + 2 * i + 1], sc.y, bias.y);
          if constexpr (EPI == ADA) {
            if (ep.gelu) {
              v0 = gelu_tanh(v0);
              v1 = gelu_tanh(v1);
            }
          }
          store2(out + (long long)row * ncols + c, v0, v1);
        }
      }
    }
  };
  gemm_sm90::run<BN, BL>(a_map, b_map, sm, m, ncols, kdim, [](int, int) {}, epilogue);
}

// C = A . B^T for A (m, kdim) bf16 and B (ncols, kdim) bf16 or int8
// codes, row-major, on `grid` persistent CTAs
template <int BN, int EPI, typename TX, int BL>
int launch(const void* a, const void* b, int m, int ncols, int kdim, int grid, const EpiArgs& ep,
           cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  const int err = gemm_sm90::make_maps<BN, BL>(&a_map, &b_map, a, b, m, ncols, kdim);
  if (err != 0) return err;
  const auto kernel = adaln_mlp_gemm_kernel<BN, EPI, TX, BL>;
  constexpr int smem = smem_bytes<BN, BL>();
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, stream>>>(a_map, b_map, m, ncols, kdim, ep);
  return static_cast<int>(cudaGetLastError());
}

// the up and down GEMMs take whole column blocks; qkv and ada an even
// ncols, the last block ragged
template <int EPI, typename TX, int BL>
int launch_width(int bn, const void* a, const void* b, int m, int ncols, int kdim, int grid,
                 const EpiArgs& ep, cudaStream_t stream) {
  const bool ragged = EPI == QKV || EPI == ADA;
  if (grid < 1 || kdim % gemm_sm90::BK != 0 || (ragged ? ncols % 2 : ncols % bn) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {
    case 256:
      return launch<256, EPI, TX, BL>(a, b, m, ncols, kdim, grid, ep, stream);
    case 128:
      return launch<128, EPI, TX, BL>(a, b, m, ncols, kdim, grid, ep, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gemm

// ---- the cast pass of row 13's wide body ----------------------------------

constexpr int CAST_THREADS = 256;

// y = bf16(x) over n4 groups of four values
__global__ void __launch_bounds__(CAST_THREADS)
adaln_mlp_cast_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y, long long n4) {
  for (long long i = blockIdx.x * (long long)CAST_THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * CAST_THREADS)
    tile_io::store4(y + 4 * i, tile_io::load4(x + 4 * i));
}

// the modulate pass of x (rows of D) into the bf16 workspace h
template <int D, typename TX>
int modulate(const void* x, const float* shift, const float* scale, long long mod_stride, void* h,
             int rows, int t, float eps, cudaStream_t stream) {
  adaln_mlp_modulate_kernel<D, TX><<<(rows + MOD_WARPS - 1) / MOD_WARPS, MOD_WARPS * 32, 0,
                                     stream>>>(static_cast<const TX*>(x), shift, scale,
                                               mod_stride, static_cast<__nv_bfloat16*>(h), rows,
                                               t, eps);
  return static_cast<int>(cudaGetLastError());
}

// the three kernels of the Hopper body, bf16 weights or int8 codes (BL,
// with their scales s1, s2); `stages` a mask of the ones to run (1
// modulate, 2 up, 4 down: all but a stage timing run pass 7)
template <int D, typename TX, int BL>
int sm90_forward(const void* x, const float* shift, const float* scale, const float* gate,
                 long long mod_stride, const void* w1, const float* s1, const float* b1,
                 const void* w2, const float* s2, const float* b2, void* h, void* g, void* out,
                 void* a, float* mlp, int n, int t, int hdim, int bn_up, int grid_up, int bn_down,
                 int grid_down, float eps, int stages, int partial, cudaStream_t stream) {
  const int rows = n * t;
  auto* gb = static_cast<__nv_bfloat16*>(g);
  if (stages & 1) {
    const int err = modulate<D, TX>(x, shift, scale, mod_stride, h, rows, t, eps, stream);
    if (err != 0) return err;
  }
  if (stages & 2) {
    const gemm::EpiArgs up{b1, a, gb, nullptr, nullptr, 0, t, nullptr, nullptr, s1};
    const int err = gemm::launch_width<gemm::UP, TX, BL>(bn_up, h, w1, rows, hdim, D, grid_up, up,
                                                         stream);
    if (err != 0) return err;
  }
  if (stages & 4) {
    const gemm::EpiArgs down{partial ? nullptr : b2, nullptr, nullptr, partial ? nullptr : x, gate,
                             mod_stride, t, out, mlp, s2};
    return gemm::launch_width<gemm::DOWN, TX, BL>(bn_down, gb, w2, rows, D, hdim, grid_down, down,
                                                  stream);
  }
  return 0;
}

}  // namespace

// The Hopper body (bf16 weights). x, out: (N, T, D) contiguous, f32 (bf16 =
// 0) or bf16 (bf16 = 1); shift/scale/gate: f32 rows of D with row stride
// mod_stride; w1: fc1.weight (H, D) and w2: fc2.weight (D, H), bf16
// contiguous; b1: f32 (H); b2: f32 (D); h: bf16 workspace (N*T, D); g: bf16
// workspace (N*T, H); a: null (inference) or (N, T, H) contiguous in x's
// type; mlp: null or f32 (N, T, D) contiguous. D in {384, 768, 1024, 1152}
// (1152: DiT-XL's, serving and training), H a multiple of 128; bn_up / bn_down (256 or 128, dividing H / D) and
// grid_up / grid_down the tile plan's widths and CTA counts of the two
// GEMMs; stages: 7 (a mask: 1 modulate, 2 up, 4 down); partial: 1 for one
// tensor-parallel rank's share (the down epilogue adds neither b2 nor x:
// out = gate * mlp, mlp = g . W2 over the rank's hidden units; the row's
// sum, with one rank passing 0, is the whole MLP half). Launches on
// `stream` without synchronizing; returns 0, a CUDA error code, or
// TMA_ENCODE_ERROR + a CUresult (adaln_mlp_error_string names either).
extern "C" int adaln_mlp_fwd(const void* x, const float* shift, const float* scale,
                             const float* gate, long long mod_stride, const void* w1,
                             const float* b1, const void* w2, const float* b2, void* h, void* g,
                             void* out, void* a, float* mlp, int n, int t, int d, int hdim,
                             int bn_up, int grid_up, int bn_down, int grid_down, float eps,
                             int bf16, int stages, int partial, void* stream) {
  last_body = "sm90";
  const auto s = static_cast<cudaStream_t>(stream);
#define ADALN_MLP_SM90(D, TX)                                                                   \
  sm90_forward<D, TX, gemm::B_K_MAJOR>(x, shift, scale, gate, mod_stride, w1, nullptr, b1, w2,  \
                                       nullptr, b2, h, g, out, a, mlp, n, t, hdim, bn_up,       \
                                       grid_up, bn_down, grid_down, eps, stages, partial, s)
  switch (d) {
    case 384:
      return bf16 ? ADALN_MLP_SM90(384, __nv_bfloat16) : ADALN_MLP_SM90(384, float);
    case 768:
      return bf16 ? ADALN_MLP_SM90(768, __nv_bfloat16) : ADALN_MLP_SM90(768, float);
    case 1024:
      return bf16 ? ADALN_MLP_SM90(1024, __nv_bfloat16) : ADALN_MLP_SM90(1024, float);
    case 1152:
      return bf16 ? ADALN_MLP_SM90(1152, __nv_bfloat16) : ADALN_MLP_SM90(1152, float);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ADALN_MLP_SM90
}

// The int8 serving forward (row 10): x, out f32 (N, T, D) contiguous; w1:
// fc1's int8 codes (H, D) and w2: fc2's (D, H), torch's layout,
// contiguous; s1 (H) and s2 (D) their f32 per-output-channel scales; the
// other arguments as adaln_mlp_fwd's, without residuals, D in {384, 768,
// 1024, 1152}. Returns as adaln_mlp_fwd.
extern "C" int adaln_mlp_quant_fwd(const float* x, const float* shift, const float* scale,
                                   const float* gate, long long mod_stride, const void* w1,
                                   const float* s1, const float* b1, const void* w2,
                                   const float* s2, const float* b2, void* h, void* g, float* out,
                                   int n, int t, int d, int hdim, int bn_up, int grid_up,
                                   int bn_down, int grid_down, float eps, int stages,
                                   void* stream) {
  last_body = "sm90";
  const auto s = static_cast<cudaStream_t>(stream);
#define ADALN_MLP_INT8(D)                                                                        \
  sm90_forward<D, float, gemm::B_INT8>(x, shift, scale, gate, mod_stride, w1, s1, b1, w2, s2, b2, \
                                       h, g, out, nullptr, nullptr, n, t, hdim, bn_up, grid_up,    \
                                       bn_down, grid_down, eps, stages, 0, s)
  switch (d) {
    case 384:
      return ADALN_MLP_INT8(384);
    case 768:
      return ADALN_MLP_INT8(768);
    case 1024:
      return ADALN_MLP_INT8(1024);
    case 1152:
      return ADALN_MLP_INT8(1152);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ADALN_MLP_INT8
}

// The int8 qkv projection (row 11): out (N, T, M) f32 = (LN(x) * (1 +
// scale) + shift) . (w * s)^T + b; x (N, T, D) f32; shift/scale as
// adaln_mlp_fwd's, D in {384, 768, 1024, 1152}; w (M, D) int8 codes,
// contiguous; s, b f32 (M); h: bf16 workspace (N*T, D); M even; bn (256 or 128) and grid the tile plan's;
// stages: 3 (1 modulate, 2 the GEMM). Returns as adaln_mlp_fwd.
extern "C" int int8_modulated_matmul_fwd(const float* x, const float* shift, const float* scale,
                                         long long mod_stride, const void* w, const float* s,
                                         const float* b, void* h, float* out, int n, int t, int d,
                                         int m, int bn, int grid, float eps, int stages,
                                         void* stream) {
  last_body = "sm90";
  const auto st = static_cast<cudaStream_t>(stream);
  const int rows = n * t;
  if (stages & 1) {
    int err;
    switch (d) {
      case 384:
        err = modulate<384, float>(x, shift, scale, mod_stride, h, rows, t, eps, st);
        break;
      case 768:
        err = modulate<768, float>(x, shift, scale, mod_stride, h, rows, t, eps, st);
        break;
      case 1024:
        err = modulate<1024, float>(x, shift, scale, mod_stride, h, rows, t, eps, st);
        break;
      case 1152:
        err = modulate<1152, float>(x, shift, scale, mod_stride, h, rows, t, eps, st);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
  }
  if (stages & 2) {
    const gemm::EpiArgs ep{b, nullptr, nullptr, nullptr, nullptr, 0, t, out, nullptr, s};
    return gemm::launch_width<gemm::QKV, float, gemm::B_INT8>(bn, h, w, rows, m, d, grid, ep, st);
  }
  return 0;
}

// The int8 out projection (row 12): out (N, T, D) f32 = res + gate * (o .
// (w * s)^T + b); o (N, T, D) bf16 and res (N, T, D) f32, contiguous; gate
// f32 rows of D with row stride gate_stride; w (D, D) int8 codes,
// contiguous; s, b f32 (D); bn (256 or 128, dividing D) and grid the tile
// plan's (quant.out_plan). Returns as adaln_mlp_fwd.
extern "C" int int8_out_residual_fwd(const void* o, const float* res, const float* gate,
                                     long long gate_stride, const void* w, const float* s,
                                     const float* b, float* out, int n, int t, int d, int bn,
                                     int grid, void* stream) {
  last_body = "sm90";
  const gemm::EpiArgs ep{b, nullptr, nullptr, res, gate, gate_stride, t, out, nullptr, s};
  return gemm::launch_width<gemm::OUT, float, gemm::B_INT8>(bn, o, w, n * t, d, d, grid, ep,
                                                           static_cast<cudaStream_t>(stream));
}

// The int8 adaLN projection's wide body (row 13): out (rows, M) f32 =
// act(x . (w * s)^T + b), act GELU-tanh when gelu = 1; x (rows, K) f32 and
// w (M, K) int8 codes, contiguous; s, b f32 (M); xb: bf16 workspace (rows,
// K); K a multiple of 64, M even; bn (256 or 128) and grid the tile plan's
// (quant.adaln_plan's GemmPlan). Returns as adaln_mlp_fwd.
extern "C" int int8_matmul_wide_fwd(const float* x, const void* w, const float* s, const float* b,
                                    void* xb, float* out, int rows, int k, int m, int gelu, int bn,
                                    int grid, void* stream) {
  last_body = "sm90";
  const auto st = static_cast<cudaStream_t>(stream);
  const long long n4 = (long long)rows * k / 4;
  const long long blocks = (n4 + CAST_THREADS - 1) / CAST_THREADS;
  adaln_mlp_cast_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), CAST_THREADS, 0, st>>>(
      x, static_cast<__nv_bfloat16*>(xb), n4);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const gemm::EpiArgs ep{b, nullptr, nullptr, nullptr, nullptr, 0, 1, out, nullptr, s, gelu};
  return gemm::launch_width<gemm::ADA, float, gemm::B_INT8>(bn, xb, w, rows, m, k, grid, ep, st);
}

extern "C" const char* adaln_mlp_last_body() { return last_body; }

// the Hopper GEMM's dynamic shared memory per CTA at tile width bn, bytes,
// over bf16 weights (int8 = 0) or int8 codes (int8 = 1)
extern "C" int adaln_mlp_sm90_smem_bytes(int bn, int int8) {
  if (int8) return bn == 256 ? gemm::smem_bytes<256, gemm::B_INT8>() : gemm::smem_bytes<128, gemm::B_INT8>();
  return bn == 256 ? gemm::smem_bytes<256, gemm::B_K_MAJOR>() : gemm::smem_bytes<128, gemm::B_K_MAJOR>();
}

extern "C" const char* adaln_mlp_error_string(int err) { return sm90::error_string(err); }
