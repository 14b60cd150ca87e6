// The fused adaLN-MLP backward for Hopper, sm_90a: its two stages.
//
// Replaces: osu_diffusion_tpu/ops/pallas_mlp.py, _bwd_prologue_kernel (:315)
//   and _bwd_epilogue_kernel (:390), the two pl.pallas_call of
//   _bwd_fused_impl (:493, :519), the `bwd_impl="fused"` backward.
//
// With the forward's residuals a (pre-GELU, (N, T, H)) and mlp (pre-gate,
// (N, T, D) f32), the upstream gradient g (N, T, D) and the packed bf16
// weights of ops/adaln_mlp.py (pack_weights: w1p (H / 128, D, 136), w2p
// (H, D + 8)):
//   prologue: dmlp = g * gate; dgate = sum_t g * mlp; db2 = sum dmlp;
//             dgelu = bf16(dmlp) @ w2^T; da = dgelu * gelu'(a); db1 = sum da;
//             writes da, gelu(a) and dmlp in the stream's type.
//   epilogue: dh1 = bf16(da) @ w1^T; h1 = LN(x) * (1 + scale) + shift;
//             dshift = sum_t dh1, dscale = sum_t dh1 * LN(x);
//             dx = g + LayerNorm backward of dh1 * (1 + scale);
//             writes dx and h1 in the stream's type.
// The weight gradients dmlp^T @ gelu(a) and da^T @ h1 stay outside, as the
// JAX package leaves them to XLA. g, a, x and the emitted tensors are f32 or
// bf16 (the training stream), one type per call; every sum is f32.
//
// What bounds them on the card, at DiT-B training (N*T = 32,768 tokens,
// D 768, H 3072, bf16 stream): each stage is 154.6 GFLOP (0.156 ms at
// 989 TFLOP/s). The prologue moves 805 MB (g, mlp, a in; da, gelu(a), dmlp
// out: 0.240 ms at 3.35 TB/s), so bytes bound it; the epilogue moves ~403 MB
// (0.120 ms), so its product bounds it. As in kernel B, every 32-token tile
// streams all of its weight (4.7 MB) through its SM: ~4.8 GB of L2 reads per
// call and stage.
//
// What the design does about it:
// - The TPU grid runs in order and carries dgate/db1/db2/dshift/dscale in
//   resident output blocks from program to program. Here CTAs run in no
//   order: each writes its partial sums (per token tile) to a workspace, and
//   a second pass (sum_partials_kernel) adds them in a fixed order. No
//   atomics: the result is deterministic, like the attention backward's.
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
//   16-byte (f32) or 8-byte (bf16) accesses.
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
// wgmma, TMA multicast of the weight tiles and persistent CTAs are left to
// a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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
};

template <int D>
struct __align__(128) PSmem {
  __nv_bfloat16 ring[Cfg<D>::P_STAGES][Cfg<D>::P_TILE];  // streamed w2 tiles
  __nv_bfloat16 dm[BT * Cfg<D>::LDD];                     // bf16(dmlp), the product's A
  float s[2][BT * LDS];                                   // dgelu: two K quarters' sums
  float red[WARPS][BH];                                   // db1: each row group's column sums
  unsigned long long full[Cfg<D>::P_STAGES];              // mbarrier: the stage's tile landed
};

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
template <int D, typename TX>
__global__ void __launch_bounds__(THREADS)
bwd_prologue_kernel(const TX* __restrict__ g, const float* __restrict__ mlp,
                    const TX* __restrict__ a, const float* __restrict__ gate, long long mod_stride,
                    const __nv_bfloat16* __restrict__ w2p, TX* __restrict__ da,
                    TX* __restrict__ gelu_out, TX* __restrict__ dmlp, float* __restrict__ dgate_ws,
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
      if (first && in) dmlp[e] = tile_io::from_float<TX>(dm);
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
#pragma unroll
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
template <int D, typename TX>
__global__ void __launch_bounds__(THREADS)
bwd_epilogue_kernel(const TX* __restrict__ da, const TX* __restrict__ x, const TX* __restrict__ g,
                    const float* __restrict__ shift, const float* __restrict__ scale,
                    long long mod_stride, const __nv_bfloat16* __restrict__ w1p,
                    TX* __restrict__ dx, TX* __restrict__ h1, float* __restrict__ dshift_ws,
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
  const TX* dab = da + (long long)nb * t * hdim;
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
#pragma unroll
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
      const float4 g4 = tile_io::load4(g + base + c);
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

template <int D, typename TX>
int launch_prologue(const void* g, const float* mlp, const void* a, const float* gate,
                    long long mod_stride, const __nv_bfloat16* w2p, void* da, void* gelu_out,
                    void* dmlp, float* dgate, float* db1, float* db2, float* ws, int n, int t,
                    int hdim, int split, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(PSmem<D>));
  cudaError_t err = cudaFuncSetAttribute(bwd_prologue_kernel<D, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (t + BT - 1) / BT;
  const long long rows = (long long)n * tiles;
  float* dgate_ws = ws;
  float* db2_ws = ws + rows * D;
  float* db1_ws = ws + 2 * rows * D;
  bwd_prologue_kernel<D, TX><<<dim3(tiles, n, split), THREADS, smem, stream>>>(
      static_cast<const TX*>(g), mlp, static_cast<const TX*>(a), gate, mod_stride, w2p,
      static_cast<TX*>(da), static_cast<TX*>(gelu_out), static_cast<TX*>(dmlp), dgate_ws, db2_ws,
      db1_ws, t, hdim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = sum_partials(dgate_ws, dgate, n, tiles, D, stream);
  if (e) return e;
  e = sum_partials(db2_ws, db2, 1, static_cast<int>(rows), D, stream);
  if (e) return e;
  return sum_partials(db1_ws, db1, 1, static_cast<int>(rows), hdim, stream);
}

template <int D, typename TX>
int launch_epilogue(const void* da, const void* x, const void* g, const float* shift,
                    const float* scale, long long mod_stride, const __nv_bfloat16* w1p, void* dx,
                    void* h1, float* dshift, float* dscale, float* ws, int n, int t, int hdim,
                    float eps, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(ESmem<D>));
  cudaError_t err = cudaFuncSetAttribute(bwd_epilogue_kernel<D, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (t + BT - 1) / BT;
  float* dshift_ws = ws;
  float* dscale_ws = ws + (long long)n * tiles * D;
  bwd_epilogue_kernel<D, TX><<<dim3(tiles, n), THREADS, smem, stream>>>(
      static_cast<const TX*>(da), static_cast<const TX*>(x), static_cast<const TX*>(g), shift,
      scale, mod_stride, w1p, static_cast<TX*>(dx), static_cast<TX*>(h1), dshift_ws, dscale_ws, t,
      hdim, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = sum_partials(dshift_ws, dshift, n, tiles, D, stream);
  if (e) return e;
  return sum_partials(dscale_ws, dscale, n, tiles, D, stream);
}

#define BWD_DISPATCH(LAUNCH, ...)                                                 \
  switch (d) {                                                                    \
    case 384:                                                                     \
      return bf16 ? LAUNCH<384, __nv_bfloat16>(__VA_ARGS__) : LAUNCH<384, float>(__VA_ARGS__);  \
    case 768:                                                                     \
      return bf16 ? LAUNCH<768, __nv_bfloat16>(__VA_ARGS__) : LAUNCH<768, float>(__VA_ARGS__);  \
    case 1024:                                                                    \
      return bf16 ? LAUNCH<1024, __nv_bfloat16>(__VA_ARGS__) : LAUNCH<1024, float>(__VA_ARGS__); \
    default:                                                                      \
      return static_cast<int>(cudaErrorInvalidValue);                             \
  }

}  // namespace

// Stage 1. g (N, T, D), a (N, T, H) contiguous in the stream's type (f32:
// bf16 = 0, bf16: bf16 = 1); mlp (N, T, D) f32 contiguous; gate: f32 rows of
// D with row stride mod_stride; w2p: bf16 packed (H, D + 8). Writes da and
// gelu_out (N, T, H) and dmlp (N, T, D) in the stream's type, dgate (N, D),
// db1 (H) and db2 (D) f32. ws: f32 workspace of N * ceil(T / 32) * (2 D + H).
// D in {384, 768, 1024}; H / 128 divisible by split. Launches on `stream`
// without synchronizing; returns cudaGetLastError().
extern "C" int adaln_mlp_bwd_prologue(const void* g, const float* mlp, const void* a,
                                      const float* gate, long long mod_stride, const void* w2p,
                                      void* da, void* gelu_out, void* dmlp, float* dgate,
                                      float* db1, float* db2, float* ws, int n, int t, int d,
                                      int hdim, int split, int bf16, void* stream) {
  const auto* w2 = static_cast<const __nv_bfloat16*>(w2p);
  const auto s = static_cast<cudaStream_t>(stream);
  BWD_DISPATCH(launch_prologue, g, mlp, a, gate, mod_stride, w2, da, gelu_out, dmlp, dgate, db1,
               db2, ws, n, t, hdim, split, s)
}

// Stage 2. da (N, T, H), x and g (N, T, D) contiguous in the stream's type;
// shift/scale: f32 rows of D with row stride mod_stride; w1p: bf16 packed
// (H / 128, D, 136). Writes dx and h1 (N, T, D) in the stream's type, dshift
// and dscale (N, D) f32. ws: f32 workspace of 2 * N * ceil(T / 32) * D.
// Launches on `stream` without synchronizing; returns cudaGetLastError().
extern "C" int adaln_mlp_bwd_epilogue(const void* da, const void* x, const void* g,
                                      const float* shift, const float* scale, long long mod_stride,
                                      const void* w1p, void* dx, void* h1, float* dshift,
                                      float* dscale, float* ws, int n, int t, int d, int hdim,
                                      float eps, int bf16, void* stream) {
  const auto* w1 = static_cast<const __nv_bfloat16*>(w1p);
  const auto s = static_cast<cudaStream_t>(stream);
  BWD_DISPATCH(launch_epilogue, da, x, g, shift, scale, mod_stride, w1, dx, h1, dshift, dscale, ws,
               n, t, hdim, eps, s)
}

extern "C" const char* adaln_mlp_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
