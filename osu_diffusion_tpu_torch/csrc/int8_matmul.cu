// The int8 weight-only adaLN projection for serving, for Hopper, sm_90a: the
// skinny body, act(x @ (w * s)^T + b) for few activation rows, act none or
// GELU-tanh. (Wide batches run the adaLN-MLP's persistent Hopper GEMM over
// int8 codes instead, csrc/adaln_mlp.cu `int8_matmul_wide_fwd`; ops/quant.py's
// `adaln_plan` picks the body.)
//
// Replaces osu_diffusion_tpu/ops/pallas_quant.py, _kernel (int8_matmul,
// :221): one bf16 dot over an int8 block upcast in registers, f32 sums, the
// scale, bias and GELU in f32; the DiT block's adaLN projection.
//
// Weights are int8 codes in torch's Linear layout, w (M, K) row-major, with
// a float32 scale s (M) per output channel; x (rows, K) and out (rows, M)
// are float32. The contract: bf16(x) times the exact codes (|q| <= 127 is
// exact in bf16), f32 sums, then acc * s + b and GELU-tanh in f32.
//
// What bounds it on the card: at DiT-B sampling (CFG batch 2, D = 768) x is
// (2, 768) and w (4608, 768): a GEMV that reads 3.54 MB of codes for 14
// MFLOP, bound by bytes (1.1 us at 3.35 TB/s). What held the first body (a
// WMMA kernel) 9x above that bound was latency: 72 CTAs of 32-row
// tiles for 2 rows, each with one 4 KB chunk of codes in flight, upcast into
// shared memory and multiplied before the next was asked for: ~0.3 MB in
// flight across the card, where covering HBM's latency at full rate takes
// megabytes.
//
// What the design does about it: every byte of the weight is requested at
// the kernel's start.
// - Swap A and B: out^T (M, rows) = w (M, K) . x^T. Weight rows fill the
//   M side of mma.sync m16n8k16 (bf16 -> f32), activation rows its N side
//   (n8 tiles, a row block of 8, 16, 32 or 64 rows, rows past the real ones
//   read as 0 from registers).
// - Grid: CTA (c, r) owns output columns c * CW .. + CW (CW = 16, 32 or 64
//   weight rows) for the activation rows of row block r; at M = 4608 and
//   CW = 16 that is 288 CTAs, all resident at once on 132 SMs. Every CTA
//   reads all of x's rows, so the plan widens CTAs as rows grow (CW >= 8
//   rows: x's traffic within half the weight's), and past 16 rows takes the
//   smallest row block (16, 32, 64) whose grid the card holds at once, two
//   CTAs an SM at most.
// - At its start, warp 0's lanes issue the CTA's whole slab of codes (CW x
//   K bytes, 12 KB at CW = 16) as one TMA box per 64-deep K slab, each
//   completing on its own mbarrier; the CTA meanwhile rounds its rows of x
//   to bf16 into shared memory (rows x K x 2 bytes: an L2 hit for every CTA
//   but the first).
// - Warps: K_WARPS per 16-row m-tile, warp kg taking the CTA's slabs kg,
//   kg + K_WARPS, ...: it waits for a slab's barrier, loads each of its two
//   weight rows' 16 codes (one 16-byte load each), upcasts them to bf16 in
//   registers (tile_io.cuh's byte-permute upcast) and runs four k16 products
//   per n8 tile. The k16 step's 16 reduction indices are a permutation of
//   the slab's (thread t % 4 holds k = 16 (t % 4) + 4 s .. + 3 of step s),
//   the same for A and B, so a 16-byte code load and an 8-byte x load make
//   the fragments without any shuffle and without bank conflicts.
// - The sums meet in a fixed order, no atomics: once every warp is done
//   with the codes (a barrier), each warp stores its partial accumulators
//   over them in shared memory, so a CTA takes max(codes, partials) + x
//   (99 KB at 64 columns, 32 rows and K = 768: two an SM); the first warp
//   of each m-tile adds them warp by warp, so a call gives the same bits
//   every time. Its epilogue takes acc * s + b, then GELU-tanh when asked,
//   and stores the columns below M and the rows below `rows` (TMA reads
//   codes past M as 0).
//
// Measured on an H100 (tools/adaln_proj_variants.py; PERF.md): at DiT-B
// sampling 0.0052 ms back to back against the WMMA body's 0.0098, where one
// CTA of one slab takes 0.0029 (the launch and one CTA's chain of round
// trips). At 64 rows x's loads take ~6 us of 15 with one 212 KB CTA an SM
// on 72 SMs; 32-row blocks over all SMs take 0.0132 (the WMMA body 0.0153);
// 8 x loads in flight a thread or a walk over x from each CTA's own offset
// gained nothing. cp.async.bulk copies of a 64-byte row each are 2x slower
// than TMA, f32 FMAs 1.2x slower than mma.sync.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_io.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int SLAB = 64;       // K depth of one weight slab: one 64-byte row of codes per weight row
constexpr int MT_ROWS = 16;    // weight rows of one mma m-tile
constexpr int K_WARPS = 4;     // warps per m-tile, each a share of the CTA's slabs
constexpr int MAX_K = 2048;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a CTA may take on an H100

// the body the last entry call launched
const char* last_body = "none";

struct Params {
  const float* x;  // (rows, k)
  const float* s;  // (m) per-output-channel scale
  const float* b;  // (m) bias
  float* out;      // (rows, m)
  int rows, k, m;
  int cw;          // weight rows (output columns) a CTA owns: 16, 32 or 64
  int row_block;   // activation rows a CTA takes: 8 NT
  int gelu;
};

// where a CTA's shared memory holds what (byte offsets from a 128-byte
// aligned base): its codes and, over them once every warp is done with
// them, every warp's partial sums; x's rows in bf16; the slabs' barriers
struct Layout {
  int slabs;  // 64-deep slabs of K
  int ldx;    // bf16 row stride of x (K + 8: rows 16 bytes apart mod 128)
  int x_off, bar_off, bytes;

  __host__ __device__ Layout(int k, int cw, int row_block) {
    slabs = k / SLAB;
    ldx = k + 8;
    const int codes = slabs * cw * SLAB;
    const int partials = (cw / MT_ROWS) * K_WARPS * (row_block / 8) * 4 * 32 * 4;
    x_off = codes > partials ? codes : partials;
    bar_off = x_off + row_block * ldx * 2;
    bytes = bar_off + slabs * 8 + 128;  // + the base's alignment slack
  }
};

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c0 * (v + 0.044715f * v * v * v)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane `lane` of warp 0: slabs lane, lane + 32, ... of K into shared
// memory, each one TMA box of CW rows x 64 bytes completing on its own
// barrier (rows past M read as 0).
__device__ __forceinline__ void request_slabs(const CUtensorMap* w_map, int8_t* wsm,
                                              unsigned long long* bars, int nslab, int col0,
                                              int cw, int lane) {
  for (int j = lane; j < nslab; j += 32) sm90::bar_init(&bars[j], 1);
  sm90::bar_init_fence();
  for (int j = lane; j < nslab; j += 32) {
    sm90::bar_expect(&bars[j], cw * SLAB);
    sm90::tma_load_2d(wsm + j * cw * SLAB, w_map, &bars[j], j * SLAB, col0);
  }
}

// One warp's products of one 64-deep slab: lo and hi the 16 codes at k =
// 16 q .. + 15 (q = lane % 4) of weight rows g = lane / 4 and g + 8 of the
// warp's m-tile, `xs` x's row 0 at the slab's K offset (bf16, row stride
// ldx), rows from nrows on read as 0. Step s of the four k16 steps takes
// k = 16 q + 4 s .. + 3: the A registers {row g, row g + 8} x {k +0 +1,
// k +2 +3}, the B registers x's row n at k +0 +1 and +2 +3.
template <int NT>
__device__ __forceinline__ void slab_product(float (&acc)[NT][4], const uint4 lo, const uint4 hi,
                                             const __nv_bfloat16* xs, int ldx, int nrows,
                                             int lane) {
  const int g = lane / 4, q = lane % 4;
  const unsigned wl[4] = {lo.x, lo.y, lo.z, lo.w}, wh[4] = {hi.x, hi.y, hi.z, hi.w};
  unsigned a[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint2 el = tile_io::int8x4_to_bf16x4(wl[s]);
    const uint2 eh = tile_io::int8x4_to_bf16x4(wh[s]);
    a[s][0] = el.x;
    a[s][1] = eh.x;
    a[s][2] = el.y;
    a[s][3] = eh.y;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + g;
    uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
    if (n < nrows) {
      const __nv_bfloat16* row = xs + n * ldx + 16 * q;
      x0 = *reinterpret_cast<const uint4*>(row);
      x1 = *reinterpret_cast<const uint4*>(row + 8);
    }
    mma_bf16(acc[nt], a[0], x0.x, x0.y);
    mma_bf16(acc[nt], a[1], x0.z, x0.w);
    mma_bf16(acc[nt], a[2], x1.x, x1.y);
    mma_bf16(acc[nt], a[3], x1.z, x1.w);
  }
}

// grid (ceil(m / cw), ceil(rows / row_block)), 32 * K_WARPS * cw / 16
// threads; row_block = 8 NT
template <int NT>
__global__ void __launch_bounds__(512) int8_matmul_skinny_kernel(
    const __grid_constant__ CUtensorMap w_map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (-tile_io::smem_addr(smem_raw) & 127);
  const Layout lay(p.k, p.cw, p.row_block);
  auto* wsm = reinterpret_cast<int8_t*>(base);
  auto* xs = reinterpret_cast<__nv_bfloat16*>(base + lay.x_off);
  auto* red = reinterpret_cast<float*>(base);  // over the codes, after the products
  auto* bars = reinterpret_cast<unsigned long long*>(base + lay.bar_off);

  const int nslab = lay.slabs;
  const int col0 = blockIdx.x * p.cw;
  const int row0 = blockIdx.y * p.row_block;
  const int nrows = min(p.row_block, p.rows - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = warp / K_WARPS, kg = warp % K_WARPS;  // the warp's m-tile and share of the slabs
  const int g = lane / 4, q = lane % 4;

  // every code of the CTA requested before anything else
  if (warp == 0) request_slabs(&w_map, wsm, bars, nslab, col0, p.cw, lane);

  // x's rows of the block rounded to bf16 while the codes fly
  const int k4 = p.k / 4;
  for (int idx = threadIdx.x; idx < nrows * k4; idx += blockDim.x) {
    const int r = idx / k4, c = (idx % k4) * 4;
    tile_io::store4(xs + r * lay.ldx + c, tile_io::load4(p.x + (long long)(row0 + r) * p.k + c));
  }
  __syncthreads();  // x is in; the barriers are initialised

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  for (int j = kg; j < nslab; j += K_WARPS) {
    sm90::bar_wait(&bars[j], 0);
    const int8_t* codes = wsm + j * p.cw * SLAB + mt * MT_ROWS * SLAB + 16 * q;
    slab_product<NT>(acc, *reinterpret_cast<const uint4*>(codes + g * SLAB),
                     *reinterpret_cast<const uint4*>(codes + (g + 8) * SLAB), xs + j * SLAB,
                     lay.ldx, nrows, lane);
  }

  // the partial sums: register i of lane l of warp w at red[(w * 4 NT + i) * 32 + l]
  constexpr int REGS = NT * 4;
  __syncthreads();  // every warp is done with the codes
  if (kg != 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[(warp * REGS + nt * 4 + i) * 32 + lane] = acc[nt][i];
  }
  __syncthreads();
  if (kg != 0) return;

  // warp by warp: (0) (this warp's own), 1, .., K_WARPS - 1
  for (int w = 1; w < K_WARPS; ++w) {
    const float* src = red + ((mt * K_WARPS + w) * REGS) * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += src[(nt * 4 + i) * 32];
  }
  // acc[nt][i]: weight row g + 8 (i / 2) of the m-tile (output column
  // col[i / 2]), activation row nt * 8 + 2 q + i % 2 of the block
  int col[2];
  float sc[2] = {0.f, 0.f}, bi[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    col[h] = col0 + mt * MT_ROWS + g + 8 * h;
    if (col[h] < p.m) {
      sc[h] = p.s[col[h]];
      bi[h] = p.b[col[h]];
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = nt * 8 + 2 * q + (i & 1);
      const int h = i >> 1;
      if (n >= nrows || col[h] >= p.m) continue;
      float y = acc[nt][i] * sc[h] + bi[h];
      if (p.gelu) y = gelu_tanh(y);
      p.out[(long long)(row0 + n) * p.m + col[h]] = y;
    }
}

template <int NT>
int launch(const Params& p, const void* w, cudaStream_t stream) {
  const Layout lay(p.k, p.cw, p.row_block);
  CUtensorMap w_map;
  const int err = sm90::make_map_2d_int8(&w_map, w, p.m, p.k, p.cw);
  if (err != 0) return err;
  const auto kernel = int8_matmul_skinny_kernel<NT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.m + p.cw - 1) / p.cw, (p.rows + p.row_block - 1) / p.row_block);
  kernel<<<grid, 32 * K_WARPS * p.cw / MT_ROWS, lay.bytes, stream>>>(w_map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (rows, m) = act(x (rows, k) @ (w * s)^T + b) by the skinny body; gelu:
// 0 or 1. Every pointer 16-byte aligned and every array contiguous; K a
// multiple of 64 up to 2048; cw 16, 32 or 64; row_block 8, 16, 32 or 64
// (ops/quant.py's adaln_plan picks them).
// Launches on `stream` without synchronizing; returns 0, a CUDA error code,
// or TMA_ENCODE_ERROR + a CUresult (int8_matmul_error_string names either).
extern "C" int int8_matmul_skinny_fwd(const float* x, const void* w, const float* s,
                                      const float* b, float* out, int rows, int k, int m,
                                      int gelu, int cw, int row_block, void* stream) {
  last_body = "sm90_skinny";
  const Params p{x, s, b, out, rows, k, m, cw, row_block, gelu};
  const bool shape_ok = k % SLAB == 0 && k >= SLAB && k <= MAX_K && m >= 1 && rows >= 1 &&
                        (cw == 16 || cw == 32 || cw == 64) &&
                        (rows + row_block - 1) / row_block <= 65535;
  if (!shape_ok || Layout(k, cw, row_block).bytes > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (row_block) {
    case 8:
      return launch<1>(p, w, st);
    case 16:
      return launch<2>(p, w, st);
    case 32:
      return launch<4>(p, w, st);
    case 64:
      return launch<8>(p, w, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory a CTA of the skinny body takes, bytes
extern "C" int int8_matmul_skinny_smem_bytes(int k, int cw, int row_block) {
  return Layout(k, cw, row_block).bytes;
}

extern "C" const char* int8_matmul_last_body() { return last_body; }

extern "C" const char* int8_matmul_error_string(int err) { return sm90::error_string(err); }
