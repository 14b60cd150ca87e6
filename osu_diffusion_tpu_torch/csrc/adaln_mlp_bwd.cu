// The fused adaLN-MLP backward for Hopper, sm_90a: its two stages.
//
// Replaces: osu_diffusion_tpu/ops/pallas_mlp.py, _bwd_prologue_kernel (:315)
//   and _bwd_epilogue_kernel (:390), the two pl.pallas_call of
//   _bwd_fused_impl (:493, :519), the `bwd_impl="fused"` backward.
//
// With the forward's residuals a (pre-GELU, (N, T, H)) and mlp (pre-gate,
// (N, T, D) f32), the upstream gradient g (N, T, D) and the bf16 weights
// w1 = fc1.weight (H, D), w2 = fc2.weight (D, H):
//   prologue: dmlp = g * gate; dgate = sum_t g * mlp; db2 = sum dmlp;
//             dgelu = bf16(dmlp) . w2; da = dgelu * gelu'(a); db1 = sum da;
//             writes da, gelu(a) and dmlp in the stream's type.
//   epilogue: dh1 = bf16(da) . w1; h1 = LN(x) * (1 + scale) + shift;
//             dshift = sum_t dh1, dscale = sum_t dh1 * LN(x);
//             dx = g + LayerNorm backward of dh1 * (1 + scale);
//             writes dx and h1 in the stream's type. A null g (one
//             tensor-parallel rank's share over its hidden units) leaves
//             the residual term out: dx = the LayerNorm backward alone.
// The weight gradients dmlp^T . gelu(a) and da^T . h1 stay outside, as the
// JAX package leaves them to XLA. g, a, x and the emitted tensors are f32 or
// bf16 (the training stream), one type per call; every sum is f32, and
// every sum of partials runs in a fixed order (no atomics: the same bits
// run to run). The TPU grid runs in order and carries dgate/db1/db2/dshift/
// dscale in resident output blocks from program to program; here CTAs run
// in no order, so each writes its partial sums to a workspace and
// sum_partials_kernel adds them in a fixed order.
//
// What bounds them on the card, at DiT-B training (N*T = 32,768 tokens,
// D 768, H 3072, bf16 stream): each stage is 154.6 GFLOP (0.156 ms at
// 989 TFLOP/s). The prologue moves 805 MB (g, mlp, a in; da, gelu(a), dmlp
// out: 0.240 ms at 3.35 TB/s), so bytes bound it; the epilogue moves ~403 MB
// (0.120 ms), so its product bounds it. At DiT-XL training (D 1152, H 4608)
// each stage is 348 GFLOP (0.352 ms): the prologue moves 1.22 GB (0.365 ms,
// bytes), the epilogue's product bounds it.
//
// ---- The Hopper body (bf16 stream: rows 9a and 9b) ----
// The first body (the WMMA body below) gave each CTA a 32-token tile whose
// (32, D) f32 dh1 lived in registers, so the tile could not grow: every 32
// tokens streamed the whole 4.7 MB weight through their SM (~4.8 GB of L2
// reads per call and stage), on WMMA 16x16x16 from shared memory, 7-9x the
// bounds. As kernel B's forward did (csrc/adaln_mlp.cu), the Hopper body
// gives up fusing the rows' elementwise work into the product's CTA, so
// that the products run as the forward's persistent wgmma GEMM
// (csrc/gemm_sm90.cuh: 128 x BN tiles, TMA ring, two consumer warpgroups)
// and each 128-row block reads the weight once. torch's layout is the
// MN-major B operand of both products (the reduction index is the weight's
// row index), which the GEMM reads as it is: no packed or transposed copy.
// Five kernels on the caller's stream:
// 1. adaln_mlp_bwd_dmlp_kernel, one warp per token row (a CTA of 4 warps per
//    (n, 32-token tile)): dmlp = g * gate in f32, written in bf16 (the dgelu
//    GEMM's A: the same bits), and the tile's dgate / db2 partials.
// 2. the dgelu GEMM (adaln_mlp_bwd_gemm_kernel, DGELU): dmlp (N*T, D) . w2
//    -> (N*T, H), depth D, in 128-wide tiles (at 256 the epilogue's state
//    beside 128 accumulators a thread spilled, and ran slower; PERF.md).
//    Epilogue per warp and 64-column block: the block of `a` comes in as
//    whole-row 16-byte loads (the tile's first block while its products
//    run, the next one halfway through this one's math) through the warp's
//    staging tile into the accumulator's layout; gelu(a) and gelu'(a) in f32 (tanh-GELU,
//    accurate tanhf, as the forward); da = dgelu * gelu'(a); da and gelu(a)
//    go out through the staging tile as whole 128-byte rows; the f32 da's
//    column sums over the warp's 16 rows (a shuffle tree), then over the
//    CTA's 8 warps in order, are the db1 partial of the 128-row block
//    (workspace (row blocks, H)). Rows past N*T (A reads them as 0) are
//    masked. Per-batch sums stay in the row passes: a 128-row block
//    straddles batch rows whenever 128 does not divide T.
// 3. the dh1 GEMM (DH1): da (N*T, H) . w1 -> (N*T, D), depth H; dh1 is
//    written in f32 straight from the registers (8-byte pairs fill whole
//    32-byte sectors): never rounded (100 MB at training). A CTA cannot
//    hold whole 768-wide f32 rows, which the LayerNorm backward needs.
// 4. adaln_mlp_bwd_ln_kernel, one warp per token row: reads dh1, x and g,
//    recomputes the two-pass LayerNorm, writes h1 and dx, and the tile's
//    dshift / dscale partials.
// 5. sum_partials_kernel for each of the five sums.
// The tile plans (BN, grid) come from ops/adaln_mlp.py, mlp_bwd_plan: dgelu
// has the forward's up GEMM's shape, dh1 its down GEMM's.
//
// ---- The WMMA body (f32 stream) ----
// Weights in the packed bf16 layout of ops/adaln_mlp.py (pack_w1: (H / 128,
// D, 136); pack_w2: (H, D + 8)).
// - Prologue, one CTA of 8 warps per (32-token tile, n, hidden split): the
//   (32, D) g tile becomes bf16(dmlp) in shared memory once; the w2 rows of
//   each 128-wide hidden chunk stream as contiguous 16-row tiles (the tiles
//   kernel B's fc2 streams) through the bulk-copy ring of tile_io.cuh. A
//   16-row tile yields only a (32, 16) block of dgelu, so the 8 warps split
//   the reduction over D in quarters (WMMA bf16, f32 accumulate), each warp
//   holding the chunk's 8 column blocks; the quarters are summed in shared
//   memory, and one pass applies GELU' and writes da and gelu(a) (never an
//   f32 (N, T, H) tensor in device memory) and the db1 partial. That pass
//   reads the chunk's `a`, fetched into registers before the chunk's MMAs
//   so its latency hides behind them; it works on 4 columns a thread with
//   16-byte accesses.
// - Epilogue, one CTA per (32-token tile, n): dh1 (32, D) accumulates in
//   registers over every hidden chunk, like kernel B's fc2 phase; the w1p
//   tiles (64 rows of D by the chunk's 128, contiguous) stream through the
//   ring, and the next chunk's da is fetched into registers while this
//   chunk multiplies. Then dh1 goes to shared memory (over the ring), one
//   warp per row recomputes the two-pass LayerNorm and writes h1 and dx, and
//   one thread per column sums the dshift/dscale partials.
// - At the training shape both grids hold 1,024 CTAs (7.8 waves on 132
//   SMs), so no hidden split is needed there; small shapes split the
//   prologue's hidden range as kernel B does.
// - DiT-XL's D = 1152 keeps this design: the prologue's three ring stages,
//   bf16(dmlp) and the dgelu scratch take 223,616 of the 232,448 bytes a CTA
//   may hold; the epilogue's 18 dh1 fragments a warp hold 144 accumulator
//   registers a thread, under the 255 a thread that 256 threads a CTA allow.
//   With every k16 step unrolled, ptxas kept the A fragments of a whole
//   tile's reduction in registers across the streamed tiles (they do not
//   change from tile to tile) and spilled at 1152 (prologue 8, epilogue 16
//   bytes at 255 registers); unrolled two steps at a time (Cfg's P_UNROLL,
//   E_UNROLL) they are read again for each tile: the same products in the
//   same order (ptxas's registers and spills: chip_smoke.py [mlp-bwd-xl]).
//   The prologue at D 768 spilled the same way (40 bytes at 255 registers,
//   first checked by [mlp-tp], whose f32 case runs it) and takes the same
//   cure.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "gemm_sm90.cuh"
#include "tile_io.cuh"

using namespace nvcuda;

namespace {

using tile_io::issue_bulk;
using tile_io::mbar_init;
using tile_io::mbar_wait;
using tile_io::smem_addr;

constexpr int BT = 32;        // tokens per CTA
constexpr int BH = 128;       // hidden chunk width (the packing's chunk)
constexpr int KW = 16;        // w2 rows per streamed prologue tile
constexpr int K1 = 64;        // w1 rows (of D) per streamed epilogue tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDW1 = BH + 8;  // row stride of a packed w1 chunk
constexpr int LDS = BH + 4;   // f32 row stride of the dgelu scratch
constexpr int LDA = BH + 8;   // bf16 row stride of the staged da chunk
constexpr int E_STAGES = 4;   // epilogue ring stages
constexpr float GELU_C0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_C1 = 0.044715f;

template <int D>
struct Cfg {
  static constexpr int LDD = D + 8;                   // bf16 row stride of dmlp; w2p's row
  static constexpr int P_STAGES = D >= 1024 ? 3 : 4;  // prologue ring stages (shared memory)
  static constexpr int P_TILE = KW * LDD;             // elements of a prologue tile
  static constexpr int KQ = D / 4;                    // a prologue warp's share of the reduction
  static constexpr int E_TILES = D / K1;              // epilogue tiles per hidden chunk
  static constexpr int LDH = D + 4;                   // f32 row stride of dh1
  // k16 steps of a streamed tile's product unrolled together: every step
  // (so ptxas keeps the CTA's A fragments in registers from tile to tile)
  // where they fit; beside the accumulators they spilled out of 255
  // registers in the prologue at D 768 (40 bytes; not at 1024) and in both
  // stages at 1152, so two steps there, and A is read again for each tile
  static constexpr int P_UNROLL = D == 768 || D == 1152 ? 2 : KQ / 16;
  static constexpr int E_UNROLL = D == 1152 ? 2 : BH / 16;
};

template <int D>
struct __align__(128) PSmem {
  __nv_bfloat16 ring[Cfg<D>::P_STAGES][Cfg<D>::P_TILE];  // streamed w2 tiles
  __nv_bfloat16 dm[BT * Cfg<D>::LDD];                     // bf16(dmlp), the product's A
  float s[2][BT * LDS];                                   // dgelu: two K quarters' sums
  float red[WARPS][BH];                                   // db1: each row group's column sums
  unsigned long long full[Cfg<D>::P_STAGES];              // mbarrier: the stage's tile landed
};

static_assert(sizeof(PSmem<1152>) <= 232448, "the prologue's shared memory at D 1152 fits a CTA");

template <int D>
struct __align__(128) ESmem {
  union {
    __nv_bfloat16 ring[E_STAGES][K1 * LDW1];  // streamed w1 tiles
    float dh[BT * Cfg<D>::LDH];               // dh1, once every tile is used
  } u;
  __nv_bfloat16 da[2][BT * LDA];  // bf16(da) of a hidden chunk, double buffered
  float mean[BT];
  float inv[BT];
  unsigned long long full[E_STAGES];
};

// Prologue. Grid (token tiles, N, split); the split's CTAs share the hidden
// chunks evenly. Workspace rows are (n, token tile): dgate_ws and db2_ws
// (N, tiles, D), written by split 0; db1_ws (N, tiles, H).
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_prologue_kernel(const float* __restrict__ g, const float* __restrict__ mlp,
                    const float* __restrict__ a, const float* __restrict__ gate,
                    long long mod_stride, const __nv_bfloat16* __restrict__ w2p,
                    float* __restrict__ da, float* __restrict__ gelu_out,
                    float* __restrict__ dmlp, float* __restrict__ dgate_ws,
                    float* __restrict__ db2_ws, float* __restrict__ db1_ws, int t, int hdim) {
  using C = Cfg<D>;
  constexpr int STAGES = C::P_STAGES;
  constexpr int TPC = BH / KW;  // tiles per hidden chunk
  extern __shared__ unsigned char smem_raw[];
  PSmem<D>& sm = *reinterpret_cast<PSmem<D>*>(smem_raw);

  const int tile = blockIdx.x;
  const int t0 = tile * BT;
  const int nb = blockIdx.y;
  const int chunks = hdim / BH / gridDim.z;
  const int chunk0 = blockIdx.z * chunks;
  const int ntiles = chunks * TPC;
  const int warp = threadIdx.x / 32;
  const bool first = blockIdx.z == 0;
  const long long wrow = ((long long)nb * gridDim.x + tile);  // workspace row

  // tile i: w2 rows chunk0 * 128 + 16 i .. + 16, contiguous
  auto issue = [&](int i) {
    issue_bulk(sm.ring[i % STAGES], w2p + ((long long)chunk0 * BH + i * KW) * C::LDD,
               C::P_TILE * sizeof(__nv_bfloat16), smem_addr(&sm.full[i % STAGES]));
  };
  if (threadIdx.x == 0) mbar_init(sm.full, STAGES);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES && i < ntiles; ++i) issue(i);
  }

  // dmlp = g * gate, one thread per column; split 0 also writes dmlp and the
  // tile's dgate / db2 partials. Rows past t are 0.
  const float* gt = gate + nb * mod_stride;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float gc = gt[c];
    float sg = 0.f, sb = 0.f;
#pragma unroll 8
    for (int r = 0; r < BT; ++r) {
      const bool in = t0 + r < t;
      const long long e = ((long long)nb * t + t0 + r) * D + c;
      const float v = in ? tile_io::to_float(g[e]) : 0.f;
      const float m = first && in ? mlp[e] : 0.f;
      const float dm = v * gc;
      sm.dm[r * C::LDD + c] = __float2bfloat16_rn(dm);
      if (first && in) dmlp[e] = dm;
      sg += v * m;
      sb += dm;
    }
    if (first) {
      dgate_ws[wrow * D + c] = sg;
      db2_ws[wrow * D + c] = sb;
    }
  }
  __syncthreads();  // bf16(dmlp) is in shared memory

  // warp: row tile rt of the two, quarter q of the reduction over D
  const int rt = warp & 1;
  const int q = warp >> 1;
  // the elementwise pass: 4 columns from c4 * 4 of the chunk, rows rg + 8 j
  constexpr int ROWS = BT / WARPS;
  const int c4 = threadIdx.x % (BH / 4);
  const int rg = threadIdx.x / (BH / 4);
  for (int c = 0; c < chunks; ++c) {
    // this chunk's `a`, fetched now so that its latency hides behind the MMAs
    const int h = (chunk0 + c) * BH + c4 * 4;
    float4 av[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int row = rg + WARPS * j;
      av[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + row < t) av[j] = tile_io::load4(a + ((long long)nb * t + t0 + row) * hdim + h);
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TPC];
#pragma unroll
    for (int r = 0; r < TPC; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll
    for (int r = 0; r < TPC; ++r) {
      const int i = c * TPC + r;
      mbar_wait(smem_addr(&sm.full[i % STAGES]), (i / STAGES) & 1);
      const __nv_bfloat16* buf = sm.ring[i % STAGES];
      // dgelu[:, 16 r .. + 16] += dmlp[:, K quarter] @ w2[16 rows, K quarter]^T
#pragma unroll(C::P_UNROLL)
      for (int k = 0; k < C::KQ; k += 16) {
        const int kk = q * C::KQ + k;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, sm.dm + rt * 16 * C::LDD + kk, C::LDD);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, buf + kk, C::LDD);
        wmma::mma_sync(acc[r], af, bf, acc[r]);
      }
      __syncthreads();  // every warp is done with tile i: its stage takes tile i + STAGES
      if (threadIdx.x == 0 && i + STAGES < ntiles) issue(i + STAGES);
    }
    // the four quarters: 2 and 3 store, 0 and 1 add theirs
    if (q >= 2) {
#pragma unroll
      for (int r = 0; r < TPC; ++r)
        wmma::store_matrix_sync(sm.s[q - 2] + rt * 16 * LDS + r * 16, acc[r], LDS,
                                wmma::mem_row_major);
    }
    __syncthreads();
    if (q < 2) {
#pragma unroll
      for (int r = 0; r < TPC; ++r) {
        float* p = sm.s[q] + rt * 16 * LDS + r * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> other;
        wmma::load_matrix_sync(other, p, LDS, wmma::mem_row_major);
#pragma unroll
        for (int e = 0; e < other.num_elements; ++e) acc[r].x[e] += other.x[e];
        wmma::store_matrix_sync(p, acc[r], LDS, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // da = dgelu * gelu'(a), gelu(a), and the db1 partial of these columns
    float sdb1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int row = rg + WARPS * j;
      if (t0 + row >= t) break;  // rows ascend with j
      const float4 s0 = *reinterpret_cast<const float4*>(sm.s[0] + row * LDS + c4 * 4);
      const float4 s1 = *reinterpret_cast<const float4*>(sm.s[1] + row * LDS + c4 * 4);
      const float dg[4] = {s0.x + s1.x, s0.y + s1.y, s0.z + s1.z, s0.w + s1.w};
      const float x4[4] = {av[j].x, av[j].y, av[j].z, av[j].w};
      float d[4], gl[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = x4[k];
        const float th = tanhf(GELU_C0 * (v + GELU_C1 * v * v * v));
        d[k] = dg[k] * (0.5f * (1.f + th) + 0.5f * v * (1.f - th * th) * GELU_C0 * (1.f + 3.f * GELU_C1 * v * v));
        gl[k] = 0.5f * v * (1.f + th);
        sdb1[k] += d[k];
      }
      const long long e = ((long long)nb * t + t0 + row) * hdim + h;
      tile_io::store4(da + e, make_float4(d[0], d[1], d[2], d[3]));
      tile_io::store4(gelu_out + e, make_float4(gl[0], gl[1], gl[2], gl[3]));
    }
    *reinterpret_cast<float4*>(&sm.red[rg][c4 * 4]) = make_float4(sdb1[0], sdb1[1], sdb1[2], sdb1[3]);
    __syncthreads();
    if (threadIdx.x < BH) {
      float total = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) total += sm.red[k][threadIdx.x];
      db1_ws[wrow * hdim + (chunk0 + c) * BH + threadIdx.x] = total;
    }
    // sm.s and sm.red are written again only after the next chunk's tile
    // barriers, which every thread passes after this pass
  }
}

// Epilogue. Grid (token tiles, N). Workspace rows (n, token tile):
// dshift_ws, dscale_ws (N, tiles, D).
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_epilogue_kernel(const float* __restrict__ da, const float* __restrict__ x,
                    const float* __restrict__ g, const float* __restrict__ shift,
                    const float* __restrict__ scale,
                    long long mod_stride, const __nv_bfloat16* __restrict__ w1p,
                    float* __restrict__ dx, float* __restrict__ h1, float* __restrict__ dshift_ws,
                    float* __restrict__ dscale_ws, int t, int hdim, float eps) {
  using C = Cfg<D>;
  constexpr int NT = C::E_TILES;
  constexpr int V4 = D / 128;  // float4 per lane in one row
  constexpr int PRE = BT * BH / 4 / THREADS;  // float4 of da per thread and chunk
  extern __shared__ unsigned char smem_raw[];
  ESmem<D>& sm = *reinterpret_cast<ESmem<D>*>(smem_raw);

  const int tile = blockIdx.x;
  const int t0 = tile * BT;
  const int nb = blockIdx.y;
  const int chunks = hdim / BH;
  const int ntiles = chunks * NT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long wrow = ((long long)nb * gridDim.x + tile);

  // tile i: rows r * 64 .. + 64 of packed chunk i / NT, r = i % NT, contiguous
  auto issue = [&](int i) {
    issue_bulk(sm.u.ring[i % E_STAGES], w1p + ((long long)(i / NT) * D + (i % NT) * K1) * LDW1,
               K1 * LDW1 * sizeof(__nv_bfloat16), smem_addr(&sm.full[i % E_STAGES]));
  };
  if (threadIdx.x == 0) mbar_init(sm.full, E_STAGES);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < E_STAGES && i < ntiles; ++i) issue(i);
  }

  // da of one chunk: fetched into registers, then stored as bf16; rows past t are 0
  const float* dab = da + (long long)nb * t * hdim;
  float4 pre[PRE];
  auto fetch = [&](int chunk) {
#pragma unroll
    for (int j = 0; j < PRE; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      const int row = idx / (BH / 4);
      pre[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t0 + row < t)
        pre[j] = tile_io::load4(dab + (long long)(t0 + row) * hdim + chunk * BH + idx % (BH / 4) * 4);
    }
  };
  auto stash = [&](__nv_bfloat16* dst) {
#pragma unroll
    for (int j = 0; j < PRE; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + idx / (BH / 4) * LDA + idx % (BH / 4) * 4);
      d[0] = __floats2bfloat162_rn(pre[j].x, pre[j].y);
      d[1] = __floats2bfloat162_rn(pre[j].z, pre[j].w);
    }
  };
  fetch(0);
  stash(sm.da[0]);

  // warp: row tile rt of the two, 16 columns cw * 16 of every 64-row w1 tile
  const int rt = warp & 1;
  const int cw = warp >> 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int r = 0; r < NT; ++r) wmma::fill_fragment(acc[r], 0.f);
  __syncthreads();  // chunk 0's da is staged
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) fetch(c + 1);
    const __nv_bfloat16* abuf = sm.da[c & 1];
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      const int i = c * NT + r;
      mbar_wait(smem_addr(&sm.full[i % E_STAGES]), (i / E_STAGES) & 1);
      const __nv_bfloat16* buf = sm.u.ring[i % E_STAGES];
      // dh1[:, 64 r + 16 cw .. + 16] += da[:, chunk] @ w1[those rows, chunk]^T
#pragma unroll(C::E_UNROLL)
      for (int kk = 0; kk < BH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, abuf + rt * 16 * LDA + kk, LDA);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, buf + cw * 16 * LDW1 + kk, LDW1);
        wmma::mma_sync(acc[r], af, bf, acc[r]);
      }
      __syncthreads();  // every warp is done with tile i: its stage takes tile i + STAGES
      if (threadIdx.x == 0 && i + E_STAGES < ntiles) issue(i + E_STAGES);
    }
    if (c + 1 < chunks) {
      stash(sm.da[(c + 1) & 1]);  // its last reader, chunk c - 1, is past a barrier
      __syncthreads();
    }
  }

  // dh1 to shared memory, over the ring: every tile is used
#pragma unroll
  for (int r = 0; r < NT; ++r)
    wmma::store_matrix_sync(sm.u.dh + rt * 16 * C::LDH + r * K1 + cw * 16, acc[r], C::LDH,
                            wmma::mem_row_major);
  __syncthreads();

  // one warp per row: the two-pass LayerNorm, h1, and the LayerNorm backward
  const float* sh = shift + nb * mod_stride;
  const float* sc = scale + nb * mod_stride;
  for (int row = warp; row < BT; row += WARPS) {
    if (t0 + row >= t) continue;
    const long long base = ((long long)nb * t + t0 + row) * D;
    float4 xv[V4];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      xv[i] = tile_io::load4(x + base + (i * 32 + lane) * 4);
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
    if (lane == 0) {
      sm.mean[row] = mean;
      sm.inv[row] = inv;
    }
    // xv becomes LN(x); s1 = sum dxn, s2 = sum dxn * xn with dxn = dh1 * (1 + scale)
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const int c = (i * 32 + lane) * 4;
      const float4 s4 = *reinterpret_cast<const float4*>(sh + c);
      const float4 k4 = *reinterpret_cast<const float4*>(sc + c);
      const float4 d4 = *reinterpret_cast<const float4*>(sm.u.dh + row * C::LDH + c);
      xv[i] = make_float4(xv[i].x * inv, xv[i].y * inv, xv[i].z * inv, xv[i].w * inv);
      tile_io::store4(h1 + base + c,
                      make_float4(xv[i].x * (1.f + k4.x) + s4.x, xv[i].y * (1.f + k4.y) + s4.y,
                                  xv[i].z * (1.f + k4.z) + s4.z, xv[i].w * (1.f + k4.w) + s4.w));
      const float4 n4 = make_float4(d4.x * (1.f + k4.x), d4.y * (1.f + k4.y), d4.z * (1.f + k4.z),
                                    d4.w * (1.f + k4.w));
      s1 += n4.x + n4.y + n4.z + n4.w;
      s2 += n4.x * xv[i].x + n4.y * xv[i].y + n4.z * xv[i].z + n4.w * xv[i].w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / D;
    const float m2 = s2 / D;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const int c = (i * 32 + lane) * 4;
      const float4 k4 = *reinterpret_cast<const float4*>(sc + c);
      const float4 d4 = *reinterpret_cast<const float4*>(sm.u.dh + row * C::LDH + c);
      const float4 g4 = g != nullptr ? tile_io::load4(g + base + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      tile_io::store4(dx + base + c, make_float4(
          g4.x + inv * (d4.x * (1.f + k4.x) - m1 - xv[i].x * m2),
          g4.y + inv * (d4.y * (1.f + k4.y) - m1 - xv[i].y * m2),
          g4.z + inv * (d4.z * (1.f + k4.z) - m1 - xv[i].z * m2),
          g4.w + inv * (d4.w * (1.f + k4.w) - m1 - xv[i].w * m2)));
    }
  }
  __syncthreads();  // the rows' mean and 1/std are in shared memory

  // one thread per column: the tile's dshift / dscale partials
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float ss = 0.f, sk = 0.f;
    for (int row = 0; row < BT && t0 + row < t; ++row) {
      const float xn = (tile_io::to_float(x[((long long)nb * t + t0 + row) * D + c]) - sm.mean[row]) *
                       sm.inv[row];
      const float d = sm.u.dh[row * C::LDH + c];
      ss += d;
      sk += d * xn;
    }
    dshift_ws[wrow * D + c] = ss;
    dscale_ws[wrow * D + c] = sk;
  }
}

// out[o, c] = sum over p < P of ws[o, p, c] (ws (O, P, C), out (O, C)), in a
// fixed order: eight strided partial sums per column, then those eight in
// turn. Grid (ceil(C / 32), O), 256 threads.
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ ws, float* __restrict__ out, int p_count, int c_count) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x % 32;
  const int grp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const long long o = blockIdx.y;
  float s = 0.f;
  if (c < c_count) {
    for (int p = grp; p < p_count; p += 8) s += ws[(o * p_count + p) * c_count + c];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && c < c_count) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) total += red[k][lane];
    out[o * c_count + c] = total;
  }
}

int sum_partials(const float* ws, float* out, int o_count, int p_count, int c_count,
                 cudaStream_t stream) {
  const dim3 grid((c_count + 31) / 32, o_count);
  sum_partials_kernel<<<grid, 256, 0, stream>>>(ws, out, p_count, c_count);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_prologue(const void* g, const float* mlp, const void* a, const float* gate,
                    long long mod_stride, const __nv_bfloat16* w2p, void* da, void* gelu_out,
                    void* dmlp, float* dgate, float* db1, float* db2, float* ws, int n, int t,
                    int hdim, int split, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(PSmem<D>));
  cudaError_t err = cudaFuncSetAttribute(bwd_prologue_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (t + BT - 1) / BT;
  const long long rows = (long long)n * tiles;
  float* dgate_ws = ws;
  float* db2_ws = ws + rows * D;
  float* db1_ws = ws + 2 * rows * D;
  bwd_prologue_kernel<D><<<dim3(tiles, n, split), THREADS, smem, stream>>>(
      static_cast<const float*>(g), mlp, static_cast<const float*>(a), gate, mod_stride, w2p,
      static_cast<float*>(da), static_cast<float*>(gelu_out), static_cast<float*>(dmlp), dgate_ws,
      db2_ws, db1_ws, t, hdim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = sum_partials(dgate_ws, dgate, n, tiles, D, stream);
  if (e) return e;
  e = sum_partials(db2_ws, db2, 1, static_cast<int>(rows), D, stream);
  if (e) return e;
  return sum_partials(db1_ws, db1, 1, static_cast<int>(rows), hdim, stream);
}

template <int D>
int launch_epilogue(const void* da, const void* x, const void* g, const float* shift,
                    const float* scale, long long mod_stride, const __nv_bfloat16* w1p, void* dx,
                    void* h1, float* dshift, float* dscale, float* ws, int n, int t, int hdim,
                    float eps, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(ESmem<D>));
  cudaError_t err = cudaFuncSetAttribute(bwd_epilogue_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (t + BT - 1) / BT;
  float* dshift_ws = ws;
  float* dscale_ws = ws + (long long)n * tiles * D;
  bwd_epilogue_kernel<D><<<dim3(tiles, n), THREADS, smem, stream>>>(
      static_cast<const float*>(da), static_cast<const float*>(x), static_cast<const float*>(g),
      shift, scale, mod_stride, w1p, static_cast<float*>(dx), static_cast<float*>(h1), dshift_ws,
      dscale_ws, t, hdim, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = sum_partials(dshift_ws, dshift, n, tiles, D, stream);
  if (e) return e;
  return sum_partials(dscale_ws, dscale, n, tiles, D, stream);
}

// ---- the Hopper body (bf16 stream) -------------------------------------------
namespace sm90_body {

using bf16 = __nv_bfloat16;
using gemm_sm90::BM;
using gemm_sm90::CONSUMERS;
using gemm_sm90::THREADS;

// A row pass's CTA: one (n, BT-token tile), one warp per row, four warps
// (each its rows w, w + 4, ...). A warp adds its rows' column partials into
// its row of a shared-memory array, not registers, so that a thread holds
// little beyond one row (~100 registers at D = 768 with the partials in
// registers left 8-16 warps an SM: 2 TB/s).
constexpr int ROW_WARPS = 4;

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ void add4(float* s, float4 v) {
  float4& p = *reinterpret_cast<float4*>(s);
  p.x += v.x; p.y += v.y; p.z += v.z; p.w += v.w;
}

// the warp's rows of both partials to 0 (lane's columns (i * 32 + lane) * 4
// .. + 4)
template <int D>
__device__ __forceinline__ void zero_partials(float (*red)[ROW_WARPS][D], int warp, int lane) {
#pragma unroll
  for (int i = 0; i < D / 128; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      *reinterpret_cast<float4*>(&red[k][warp][(i * 32 + lane) * 4]) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The CTA's two column sums to their workspace rows: the ROW_WARPS warps'
// partials added in warp order.
template <int D>
__device__ __forceinline__ void warp_sums(float (*red)[ROW_WARPS][D], float* __restrict__ ws0,
                                          float* __restrict__ ws1) {
  __syncthreads();  // every warp's partials are in red
  for (int c = threadIdx.x; c < D; c += ROW_WARPS * 32) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) {
      s0 += red[0][w][c];
      s1 += red[1][w][c];
    }
    ws0[c] = s0;
    ws1[c] = s1;
  }
}

// 1. dmlp = g * gate (f32), written in bf16; the (n, token tile)'s dgate =
// sum g * mlp and db2 = sum dmlp partials (workspace rows n * tiles + tile).
// Grid (tiles, N).
template <int D>
__global__ void __launch_bounds__(ROW_WARPS * 32)
adaln_mlp_bwd_dmlp_kernel(const bf16* __restrict__ g, const float* __restrict__ mlp,
                          const float* __restrict__ gate, long long mod_stride,
                          bf16* __restrict__ dmlp, float* __restrict__ dgate_ws,
                          float* __restrict__ db2_ws, int t) {
  constexpr int V4 = D / 128;  // float4 per lane in one row
  __shared__ __align__(16) float red[2][ROW_WARPS][D];  // dgate, db2
  const int t0 = blockIdx.x * BT;
  const int nb = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long wrow = (long long)nb * gridDim.x + blockIdx.x;
  const float* gt = gate + nb * mod_stride;  // the CTA's gate row (L1 after the first row)
  zero_partials<D>(red, warp, lane);
  for (int r = warp; r < BT && t0 + r < t; r += ROW_WARPS) {
    const long long base = ((long long)nb * t + t0 + r) * D;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const int c = (i * 32 + lane) * 4;
      const float4 g4 = tile_io::load4(g + base + c);
      const float4 dm = mul4(g4, *reinterpret_cast<const float4*>(gt + c));
      tile_io::store4(dmlp + base + c, dm);
      add4(&red[0][warp][c], mul4(g4, *reinterpret_cast<const float4*>(mlp + base + c)));
      add4(&red[1][warp][c], dm);
    }
  }
  warp_sums<D>(red, dgate_ws + wrow * D, db2_ws + wrow * D);
}

// 4. The LayerNorm backward of the token rows of one (n, token tile): the
// two-pass LayerNorm of x, h1 = xn * (1 + scale) + shift, dx = g + inv *
// (dxn - mean(dxn) - xn * mean(dxn * xn)) with dxn = dh1 * (1 + scale); and
// the dshift = sum dh1, dscale = sum dh1 * xn partials. Grid (tiles, N).
template <int D>
__global__ void __launch_bounds__(ROW_WARPS * 32)
adaln_mlp_bwd_ln_kernel(const float* __restrict__ dh1, const bf16* __restrict__ x,
                        const bf16* __restrict__ g, const float* __restrict__ shift,
                        const float* __restrict__ scale, long long mod_stride,
                        bf16* __restrict__ dx, bf16* __restrict__ h1,
                        float* __restrict__ dshift_ws, float* __restrict__ dscale_ws, int t,
                        float eps) {
  constexpr int V4 = D / 128;
  __shared__ __align__(16) float red[2][ROW_WARPS][D];  // dshift, dscale
  const int t0 = blockIdx.x * BT;
  const int nb = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long wrow = (long long)nb * gridDim.x + blockIdx.x;
  const float* sh = shift + nb * mod_stride;
  const float* sc = scale + nb * mod_stride;
  zero_partials<D>(red, warp, lane);
  for (int r = warp; r < BT && t0 + r < t; r += ROW_WARPS) {
    const long long base = ((long long)nb * t + t0 + r) * D;
    float4 xv[V4], dv[V4];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const int c = (i * 32 + lane) * 4;
      xv[i] = tile_io::load4(x + base + c);
      dv[i] = *reinterpret_cast<const float4*>(dh1 + base + c);
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
    // xv becomes LN(x); s1 = sum dxn, s2 = sum dxn * xn
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const int c = (i * 32 + lane) * 4;
      const float4 s4 = *reinterpret_cast<const float4*>(sh + c);
      const float4 k4 = *reinterpret_cast<const float4*>(sc + c);
      xv[i] = make_float4(xv[i].x * inv, xv[i].y * inv, xv[i].z * inv, xv[i].w * inv);
      tile_io::store4(h1 + base + c,
                      make_float4(xv[i].x * (1.f + k4.x) + s4.x, xv[i].y * (1.f + k4.y) + s4.y,
                                  xv[i].z * (1.f + k4.z) + s4.z, xv[i].w * (1.f + k4.w) + s4.w));
      const float4 n4 = make_float4(dv[i].x * (1.f + k4.x), dv[i].y * (1.f + k4.y),
                                    dv[i].z * (1.f + k4.z), dv[i].w * (1.f + k4.w));
      s1 += n4.x + n4.y + n4.z + n4.w;
      s2 += n4.x * xv[i].x + n4.y * xv[i].y + n4.z * xv[i].z + n4.w * xv[i].w;
      add4(&red[0][warp][c], dv[i]);
      add4(&red[1][warp][c], mul4(dv[i], xv[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / D;
    const float m2 = s2 / D;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      const int c = (i * 32 + lane) * 4;
      const float4 k4 = *reinterpret_cast<const float4*>(sc + c);
      const float4 g4 = g != nullptr ? tile_io::load4(g + base + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      tile_io::store4(dx + base + c, make_float4(
          g4.x + inv * (dv[i].x * (1.f + k4.x) - m1 - xv[i].x * m2),
          g4.y + inv * (dv[i].y * (1.f + k4.y) - m1 - xv[i].y * m2),
          g4.z + inv * (dv[i].z * (1.f + k4.z) - m1 - xv[i].z * m2),
          g4.w + inv * (dv[i].w * (1.f + k4.w) - m1 - xv[i].w * m2)));
    }
  }
  warp_sums<D>(red, dshift_ws + wrow * D, dscale_ws + wrow * D);
}

// 2, 3. the persistent GEMMs: C[m, ncols] = A[m, kdim] . B[kdim, ncols], A
// bf16 row-major, B torch's Linear weight read MN-major
enum Epi { DGELU, DH1 };

struct EpiArgs {
  const bf16* a;   // dgelu: the pre-GELU residual a (m, ncols)
  bf16* da;        // dgelu: da = dgelu * gelu'(a) (m, ncols)
  bf16* gelu;      // dgelu: gelu(a) (m, ncols)
  float* db1_ws;   // dgelu: (row blocks, ncols) column sums of the f32 da
  float* dh1;      // dh1: the f32 product (m, ncols)
};

template <int BN>
struct Smem {
  gemm_sm90::Smem<BN> ring;
  float red[CONSUMERS / 32][BN];  // dgelu: each consumer warp's db1 sums of a tile
};

template <int BN>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem<BN>)) + 1024;  // + alignment slack
}

// gelu(v) and dgelu/dv of tanh-GELU, f32, accurate tanhf (the forward's)
__device__ __forceinline__ float gelu_and_grad(float v, float& grad) {
  const float th = tanhf(GELU_C0 * (v + GELU_C1 * v * v * v));
  grad = 0.5f * (1.f + th) + 0.5f * v * (1.f - th * th) * GELU_C0 * (1.f + 3.f * GELU_C1 * v * v);
  return 0.5f * v * (1.f + th);
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
adaln_mlp_bwd_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap b_map, int m, int ncols, int kdim,
                          EpiArgs ep) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = gemm_sm90::aligned_smem<Smem<BN>>(smem_raw);
  const int lane = threadIdx.x % 32;
  // dgelu: the warp's first block of `a` loads while the tile's products run
  gemm_sm90::StagedLoad a_blk;
  const auto begin = [&](int r0, int c0) {
    if constexpr (EPI == DGELU)
      a_blk.fetch(ep.a, r0 + (threadIdx.x / 32) * 16, c0, m, ncols, lane);
  };
  const auto epilogue = [&](float(&acc)[BN / 2], int r0, int c0) {
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    // register 4n + 2i + j holds row rw + 8i, column cq + 8n + j
    const int row0 = r0 + wg * 64 + warp * 16;  // the warp's first row
    const int rw = row0 + lane / 4;
    const int cq = c0 + 2 * (lane % 4);
    if constexpr (EPI == DH1) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = rw + 8 * i;
          if (row < m)
            *reinterpret_cast<float2*>(ep.dh1 + (long long)row * ncols + cq + 8 * n) =
                make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
        }
    } else {
      unsigned char* st = sm.ring.stage[threadIdx.x / 32];
      float* red = sm.red[threadIdx.x / 32];
#pragma unroll
      for (int cb = 0; cb < BN / 64; ++cb) {
        unsigned av[8][2];  // a's pairs, then gelu(a)'s
        a_blk.load(st, av, lane);
        __syncwarp();  // the warp has read a from the staging tile: da's pairs take it
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          // the next block of a loads from here on: half of this block's
          // accumulators are spent, which leaves it the registers (ptxas
          // holds the kernel to its 168-register launch cap)
          if (nn == 4 && cb + 1 < BN / 64)
            a_blk.fetch(ep.a, row0, c0 + (cb + 1) * 64, m, ncols, lane);
          const int n = cb * 8 + nn;
          float cs[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[nn][i]));
            float gp0, gp1;
            const float gl0 = gelu_and_grad(af.x, gp0);
            const float gl1 = gelu_and_grad(af.y, gp1);
            const bool in = rw + 8 * i < m;
            const float d0 = in ? acc[4 * n + 2 * i] * gp0 : 0.f;
            const float d1 = in ? acc[4 * n + 2 * i + 1] * gp1 : 0.f;
            *gemm_sm90::stage_slot(st, nn, i, lane) = sm90::pack_bf16(d0, d1);
            av[nn][i] = sm90::pack_bf16(gl0, gl1);
            cs[0] = i == 0 ? d0 : cs[0] + d0;
            cs[1] = i == 0 ? d1 : cs[1] + d1;
          }
          // the warp's 16-row sums of these two columns: lanes l ^ 4, l ^ 8,
          // l ^ 16 hold the same columns, rows 1, 2, 4 apart
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v = cs[j];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4) red[cb * 64 + 8 * nn + 2 * lane + j] = v;
          }
        }
        gemm_sm90::stage_flush(st, ep.da, row0, c0 + cb * 64, m, ncols, lane);
        gemm_sm90::stage_store(st, av, ep.gelu, row0, c0 + cb * 64, m, ncols, lane);
      }
      gemm_sm90::consumers_sync();  // every warp's sums are in red
      for (int c = threadIdx.x; c < BN; c += CONSUMERS) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < CONSUMERS / 32; ++w) s += sm.red[w][c];
        ep.db1_ws[(long long)(r0 / BM) * ncols + c0 + c] = s;
      }
      gemm_sm90::consumers_sync();  // red is read: the next tile may write it
    }
  };
  gemm_sm90::run<BN, gemm_sm90::B_MN_MAJOR>(a_map, b_map, sm.ring, m, ncols, kdim, begin, epilogue);
}

template <int BN, int EPI>
int launch_gemm(const void* a, const void* b, int m, int ncols, int kdim, int grid,
                const EpiArgs& ep, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  const int err = gemm_sm90::make_maps<BN, gemm_sm90::B_MN_MAJOR>(&a_map, &b_map, a, b, m, ncols,
                                                                 kdim);
  if (err != 0) return err;
  const auto kernel = adaln_mlp_bwd_gemm_kernel<BN, EPI>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BN>());
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem_bytes<BN>(), stream>>>(a_map, b_map, m, ncols, kdim, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI>
int launch_gemm_width(int bn, const void* a, const void* b, int m, int ncols, int kdim, int grid,
                      const EpiArgs& ep, cudaStream_t stream) {
  if (grid < 1 || kdim % gemm_sm90::BK != 0 || ncols % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 128) return launch_gemm<128, EPI>(a, b, m, ncols, kdim, grid, ep, stream);
  // dgelu: 128-wide tiles only (ops/adaln_mlp.py, BWD_DGELU_WIDTHS)
  if (bn == 256 && EPI == DH1) return launch_gemm<256, DH1>(a, b, m, ncols, kdim, grid, ep, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the prologue's kernels; `stages` a mask: 1 the dmlp pass (and the dgate,
// db2 sums), 2 the dgelu GEMM (and the db1 sum)
template <int D>
int prologue(const void* g, const float* mlp, const void* a, const float* gate,
             long long mod_stride, const void* w2, void* da, void* gelu_out, void* dmlp,
             float* dgate, float* db1, float* db2, float* ws, int n, int t, int hdim, int bn,
             int grid, int stages, cudaStream_t stream) {
  const int tiles = (t + BT - 1) / BT;
  const long long ws_rows = (long long)n * tiles;
  const int rows = n * t;
  float* dgate_ws = ws;
  float* db2_ws = ws + ws_rows * D;
  float* db1_ws = ws + 2 * ws_rows * D;
  if (stages & 1) {
    adaln_mlp_bwd_dmlp_kernel<D><<<dim3(tiles, n), ROW_WARPS * 32, 0, stream>>>(
        static_cast<const bf16*>(g), mlp, gate, mod_stride, static_cast<bf16*>(dmlp), dgate_ws,
        db2_ws, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    int err = sum_partials(dgate_ws, dgate, n, tiles, D, stream);
    if (err == 0) err = sum_partials(db2_ws, db2, 1, static_cast<int>(ws_rows), D, stream);
    if (err != 0) return err;
  }
  if (stages & 2) {
    const EpiArgs ep{static_cast<const bf16*>(a), static_cast<bf16*>(da),
                     static_cast<bf16*>(gelu_out), db1_ws, nullptr};
    int err = launch_gemm_width<DGELU>(bn, dmlp, w2, rows, hdim, D, grid, ep, stream);
    if (err == 0) err = sum_partials(db1_ws, db1, 1, (rows + BM - 1) / BM, hdim, stream);
    if (err != 0) return err;
  }
  return 0;
}

// the epilogue's kernels; `stages` a mask: 1 the dh1 GEMM, 2 the row pass
// (and the dshift, dscale sums)
template <int D>
int epilogue(const void* da, const void* x, const void* g, const float* shift,
             const float* scale, long long mod_stride, const void* w1, void* dx, void* h1,
             float* dshift, float* dscale, float* ws, int n, int t, int hdim, int bn, int grid,
             float eps, int stages, cudaStream_t stream) {
  const int tiles = (t + BT - 1) / BT;
  const long long ws_rows = (long long)n * tiles;
  float* dshift_ws = ws;
  float* dscale_ws = ws + ws_rows * D;
  float* dh1 = ws + 2 * ws_rows * D;
  if (stages & 1) {
    const EpiArgs ep{nullptr, nullptr, nullptr, nullptr, dh1};
    const int err = launch_gemm_width<DH1>(bn, da, w1, n * t, D, hdim, grid, ep, stream);
    if (err != 0) return err;
  }
  if (stages & 2) {
    adaln_mlp_bwd_ln_kernel<D><<<dim3(tiles, n), ROW_WARPS * 32, 0, stream>>>(
        dh1, static_cast<const bf16*>(x), static_cast<const bf16*>(g), shift, scale, mod_stride,
        static_cast<bf16*>(dx), static_cast<bf16*>(h1), dshift_ws, dscale_ws, t, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int err = sum_partials(dshift_ws, dshift, n, tiles, D, stream);
    if (err != 0) return err;
    return sum_partials(dscale_ws, dscale, n, tiles, D, stream);
  }
  return 0;
}

}  // namespace sm90_body

#define BWD_DISPATCH(CALL)                            \
  switch (d) {                                        \
    case 384:                                         \
      return CALL(384);                               \
    case 768:                                         \
      return CALL(768);                               \
    case 1024:                                        \
      return CALL(1024);                              \
    case 1152:                                        \
      return CALL(1152);                              \
    default:                                          \
      return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// ---- the Hopper body: the bf16 stream ----
// Stage 1. g, dmlp (N, T, D) and a, da, gelu_out (N, T, H) bf16 contiguous;
// mlp (N, T, D) f32 contiguous; gate: f32 rows of D with row stride
// mod_stride; w2: fc2.weight (D, H) bf16 contiguous. Writes da, gelu_out,
// dmlp, dgate (N, D), db1 (H) and db2 (D) f32. ws: f32 workspace of 2 N
// ceil(T / 32) D + ceil(N T / 128) H. D in {384, 768, 1024, 1152}; bn (256 or 128,
// dividing H) and grid the tile plan of the dgelu GEMM; stages: 3 (a mask:
// 1 the dmlp pass, 2 the GEMM). Launches on `stream` without
// synchronizing; returns 0, a CUDA error code, or TMA_ENCODE_ERROR + a
// CUresult (adaln_mlp_bwd_error_string names either).
extern "C" int adaln_mlp_bwd_prologue_sm90(const void* g, const float* mlp, const void* a,
                                           const float* gate, long long mod_stride, const void* w2,
                                           void* da, void* gelu_out, void* dmlp, float* dgate,
                                           float* db1, float* db2, float* ws, int n, int t, int d,
                                           int hdim, int bn, int grid, int stages, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define PROLOGUE(D)                                                                           \
  sm90_body::prologue<D>(g, mlp, a, gate, mod_stride, w2, da, gelu_out, dmlp, dgate, db1, db2, \
                         ws, n, t, hdim, bn, grid, stages, s)
  BWD_DISPATCH(PROLOGUE)
#undef PROLOGUE
}

// Stage 2. da (N, T, H), x, g (null: a rank's partial, no residual term),
// dx and h1 (N, T, D) bf16 contiguous;
// shift/scale: f32 rows of D with row stride mod_stride; w1: fc1.weight
// (H, D) bf16 contiguous. Writes dx, h1, dshift and dscale (N, D) f32. ws:
// f32 workspace of 2 N ceil(T / 32) D + N T D (the last N T D: the f32
// dh1). bn and grid the tile plan of the dh1 GEMM; stages: 3 (1 the GEMM, 2
// the row pass). Returns as stage 1.
extern "C" int adaln_mlp_bwd_epilogue_sm90(const void* da, const void* x, const void* g,
                                           const float* shift, const float* scale,
                                           long long mod_stride, const void* w1, void* dx,
                                           void* h1, float* dshift, float* dscale, float* ws,
                                           int n, int t, int d, int hdim, int bn, int grid,
                                           float eps, int stages, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define EPILOGUE(D)                                                                          \
  sm90_body::epilogue<D>(da, x, g, shift, scale, mod_stride, w1, dx, h1, dshift, dscale, ws, \
                         n, t, hdim, bn, grid, eps, stages, s)
  BWD_DISPATCH(EPILOGUE)
#undef EPILOGUE
}

// ---- the WMMA body: the f32 stream ----
// Stage 1. g (N, T, D), a (N, T, H) f32 contiguous; mlp (N, T, D) f32
// contiguous; gate: f32 rows of D with row stride mod_stride; w2p: bf16
// packed (H, D + 8). Writes da and gelu_out (N, T, H) and dmlp (N, T, D)
// f32, dgate (N, D), db1 (H) and db2 (D). ws: f32 workspace of N * ceil(T /
// 32) * (2 D + H). D in {384, 768, 1024, 1152}; H / 128 divisible by split.
// Launches on `stream` without synchronizing; returns cudaGetLastError().
extern "C" int adaln_mlp_bwd_prologue_wmma(const void* g, const float* mlp, const void* a,
                                           const float* gate, long long mod_stride,
                                           const void* w2p, void* da, void* gelu_out, void* dmlp,
                                           float* dgate, float* db1, float* db2, float* ws, int n,
                                           int t, int d, int hdim, int split, void* stream) {
  const auto* w2 = static_cast<const __nv_bfloat16*>(w2p);
  const auto s = static_cast<cudaStream_t>(stream);
#define PROLOGUE(D)                                                                          \
  launch_prologue<D>(g, mlp, a, gate, mod_stride, w2, da, gelu_out, dmlp, dgate, db1, \
                            db2, ws, n, t, hdim, split, s)
  BWD_DISPATCH(PROLOGUE)
#undef PROLOGUE
}

// Stage 2. da (N, T, H), x and g (N, T, D; g null: a rank's partial, no
// residual term) f32 contiguous; shift/scale: f32
// rows of D with row stride mod_stride; w1p: bf16 packed (H / 128, D, 136).
// Writes dx and h1 (N, T, D), dshift and dscale (N, D). ws: f32 workspace
// of 2 * N * ceil(T / 32) * D. Launches on `stream` without synchronizing;
// returns cudaGetLastError().
extern "C" int adaln_mlp_bwd_epilogue_wmma(const void* da, const void* x, const void* g,
                                           const float* shift, const float* scale,
                                           long long mod_stride, const void* w1p, void* dx,
                                           void* h1, float* dshift, float* dscale, float* ws,
                                           int n, int t, int d, int hdim, float eps, void* stream) {
  const auto* w1 = static_cast<const __nv_bfloat16*>(w1p);
  const auto s = static_cast<cudaStream_t>(stream);
#define EPILOGUE(D)                                                                            \
  launch_epilogue<D>(da, x, g, shift, scale, mod_stride, w1, dx, h1, dshift, dscale, ws, \
                            n, t, hdim, eps, s)
  BWD_DISPATCH(EPILOGUE)
#undef EPILOGUE
}

// the Hopper GEMM's dynamic shared memory per CTA at tile width bn, bytes
extern "C" int adaln_mlp_bwd_sm90_smem_bytes(int bn) {
  return bn == 256 ? sm90_body::smem_bytes<256>() : sm90_body::smem_bytes<128>();
}

// the WMMA body's dynamic shared memory per CTA, bytes: the prologue's
// (epilogue = 0) or the epilogue's (1) at width d (0 for another d)
extern "C" int adaln_mlp_bwd_wmma_smem_bytes(int epilogue, int d) {
#define SMEM(D) static_cast<int>(epilogue ? sizeof(ESmem<D>) : sizeof(PSmem<D>))
  switch (d) {
    case 384: return SMEM(384);
    case 768: return SMEM(768);
    case 1024: return SMEM(1024);
    case 1152: return SMEM(1152);
    default: return 0;
  }
#undef SMEM
}

extern "C" const char* adaln_mlp_bwd_error_string(int err) { return sm90::error_string(err); }
