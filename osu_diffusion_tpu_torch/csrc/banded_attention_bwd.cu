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
// Head dims: 64 (DiT-S/B/L) and 72 (DiT-XL) in every entry, ranged or not
// (XL training, under context parallelism too). The DH template parameter
// picks the build.
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
// 105 us, against 4 products, 12.9 GFLOP. Both are bound by memory. At the
// context-parallel training shard (N*H = 384, T_ext = 512, half of it pad
// query rows, L = 128, bf16) the ranged dq reads q, k, v, o, do and the LSE
// on the rows it needs and writes dq there (26 us), dk/dv writes two
// gradients (34 us); the pad blocks return at once, and a real block walks
// up to 6 key tiles. At DiT-XL training (N*H = 4096, T = L = 128, Dh = 72,
// bf16) dq moves 455 MB (136 us) against 29.0 GFLOP (29 us), dk/dv 530 MB
// (158 us) against 38.7 GFLOP (39 us): bytes again; on DiT-XL's CP shard
// (N*H = 512, Dh = 72) the ranged dq's bound is 40 us and dk/dv's 51 us,
// bytes.
//
// Two bodies of each kernel; the C entries choose by dtype (`dq_entry`,
// `dkv_entry`): bf16 (the training stream) takes the Hopper bodies below,
// f32 the WMMA bodies. On a GPU nothing carries over between CTAs,
// so in both every cross-tile sum stays inside one CTA (no atomics: the
// gradients are the same bits run to run).
//
// The WMMA bodies (f32 stream):
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
// like the forward. WMMA steps are 16 wide: at Dh = 72 every staged tile is
// 80 columns, 72..79 zero (written once; the loads fill 0..71), so the
// products over the padded head dim add nothing there, and the stores
// write 72 columns.
//
// The Hopper bodies (bf16 stream: rows 3 and 4, and row 6's dq and dk/dv),
// wgmma and TMA from wgmma_tma.cuh. Both:
// - Persistent: as many CTAs as fit at once (1 per SM) walk the items,
//   numbered block-major, while a producer runs ahead of two consumer
//   warpgroups, loading tiles by TMA (tensor maps built on the host from
//   the wrapper's strides; rows past T read as 0) and the LSE by 4-byte
//   cp.async copies that arrive on the same mbarrier. So the next item's
//   loads are in flight while the current one is multiplied and stored (a
//   CTA per item left each SM idle between items: 26% slower for dq, 18%
//   for dk/dv on an H100).
// - Scale folding: for Dh = 64 the scale 1/8 is a power of two, so raw q
//   goes through TMA and the scores are scaled in f32, bit-identical to
//   bf16(q * scale); dq and dk take the scale at their store.
// - Dh = 72: the scale is no power of two, so q is scaled in f32 and
//   rounded to bf16 on chip after its TMA load lands (dq: each warpgroup
//   its own 64-row half; dk/dv: the 256 consumer threads a share of the
//   shared query tile), then a proxy fence and a named barrier before any
//   wgmma reads it. That rounded q feeds S (not scaled again) and is the
//   B operand of dK += dS^T.q (no trailing scale); dq keeps its scale.
//   A row of 72 is a 64-column slab in the 128-byte swizzle and a
//   16-column slab in the 32-byte swizzle (a second TMA map over columns
//   64..79; 72..79 read as 0, past the map's extent), as in the forward:
//   S and dP take a fifth k16 step on the second slabs, and dQ, dK and dV
//   an m64n16 product beside the m64n64 one, whose columns 72..79 are
//   never stored.
// - delta = rowsum(o * do) comes from the o and do tiles in shared memory.
// - No atomics: one CTA owns each query block (dq) or key block (dk/dv).
//   A warpgroup skips the tiles outside its rows' band; a block that gets
//   no gradient (past valid_len, or ranged pad query rows or masked keys)
//   loads nothing and writes 0.
// dq: an item is (n*h, 128-row query block), two consumer warpgroups of 64
// rows sharing every K/V tile, so at T = L = 128 one item holds the whole
// (n, h) and reads each byte of q, k, v, o and do once. One producer warp
// loads the block's q, do and o (one 128-row box each) and its 128 LSE
// values into one of QBUF buffers, and walks the key tiles of its band
// through a ring of STAGES K/V tiles. S = Q.K^T and dP = dO.V^T run as wgmma
// into registers; the mask, P and dS = P * (dP - delta) are formed there,
// packed to bf16 and fed as the register A operand of dQ += dS.K (K the
// MN-major B operand, through a second descriptor on the same tile); dQ
// accumulates in registers for the whole walk and is stored once, times
// the scale. delta: the four lanes that share a row sum 16 columns each.
// dk/dv: an item is (n*h, 128-key block), two consumer warpgroups of 64
// keys sharing every query tile. A producer warpgroup (setmaxnreg hands its
// registers to the consumers: 232 a consumer thread, where 9 warps a CTA
// capped all at 168 and spilled) loads each item's K and V into one of two
// buffers and its query tiles into a ring of STAGES: q, do and o by TMA and
// 64 LSE values. S^T = K.Q^T and dP^T = V.dO^T run as wgmma into registers,
// P^T and dS^T are packed to bf16 there as the register A operands of
// dV += P^T.dO and dK += dS^T.Q (dO and Q the MN-major B operands); dK and
// dV are stored from registers, dK times the scale. delta: two threads a
// row, once per warpgroup.
// Resources (ptxas, printed by chip_smoke.py [attn-train] and [attn-cp]):
// dq 151 registers (152 ranged), 0 spill bytes, 165984 bytes of dynamic
// shared memory a CTA, 1 CTA an SM (9 warps: ptxas caps them at 168, and S,
// dP and dQ hold 96 f32 a thread; 2 CTAs an SM would cap at 96). dk/dv 168
// registers at launch, 232 in the consumers after setmaxnreg (40 in the
// producer warpgroup), 0 spill bytes, 142672 bytes a CTA, 1 CTA an SM. At
// Dh = 72 (printed by [attn-train-xl]): dq 160 registers, 206944 bytes (the
// second slabs add 40 KB), dk/dv 168 at launch, 177488 bytes, both 0 spill
// bytes; the WMMA bodies at 72: dq 128 registers, 99328 bytes, dk/dv 184,
// 111104 bytes, 0 spill bytes. The ranged builds at Dh = 72 (XL under
// context parallelism, printed by [attn-cp-xl]): dq 162 registers, dk/dv
// 168 at launch, the shared memory of the unranged ones, 0 spill bytes; the
// bounds' checks fold into the per-row key or query interval (lo, hi) as
// at 64, so they cost 2 registers in dq and none at dk/dv's cap; WMMA dq
// 134, dk/dv 183, 0 spill bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tile_io.cuh"
#include "wgmma_tma.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int WARPS = 4;        // 16 rows (dq: queries, dk/dv: keys) per warp
constexpr int THREADS = WARPS * 32;

// the head dims the kernels take: 64 (DiT-S/B/L) and 72 (DiT-XL)
template <int DH>
__host__ __device__ constexpr int padded() {  // the head dim in whole k16 steps: 64, or 80
  static_assert(DH == 64 || DH == 72, "the head dims the kernels take");
  return (DH + 15) / 16 * 16;
}
// bf16 row stride of the WMMA bodies' tiles in shared memory (elements):
// the padded head dim (columns DH.. zero) plus 8
template <int DH>
__host__ __device__ constexpr int ldb() {
  return padded<DH>() + 8;
}
// f32 row stride of the per-warp scratch: 64 keys, or the padded head dim
// where that is wider (the output staging)
template <int DH>
__host__ __device__ constexpr int lds() {
  return (padded<DH>() > 64 ? padded<DH>() : 64) + 4;
}

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
template <int DH, typename T>
__device__ __forceinline__ void zero_row(T* dst, int row, int t, long long gt) {
  const int c0 = ((threadIdx.x % 32) & 1) * (DH / 2);
  if (row < t) {
    T* drow = dst + (long long)row * gt + c0;
#pragma unroll
    for (int j = 0; j < DH / 2; j += 4) tile_io::store4(drow + j, make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// Dh = 72: columns 72..79 of `rows` rows of a tile to 0, once (load_tile
// writes columns 0..71 only), so the 80-deep padded products add nothing
template <int DH>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* tile, int rows) {
  if constexpr (padded<DH>() != DH) {
    static_assert(padded<DH>() - DH == 8, "one 16-byte chunk of padding a row");
    for (int r = threadIdx.x; r < rows; r += THREADS)
      *reinterpret_cast<uint4*>(tile + r * ldb<DH>() + DH) = make_uint4(0, 0, 0, 0);
  }
}

// out[16 x 64] = a[16 x Dh] . b[64 x Dh]^T for b staged row-major (rows are
// the output's columns), into this warp's f32 scratch
template <int DH>
__device__ __forceinline__ void product_abt(float* out, const __nv_bfloat16* a,
                                            const __nv_bfloat16* b) {
  constexpr int LDB = ldb<DH>();
  Acc f[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(f[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < padded<DH>() / 16; ++kk) {
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
  for (int n = 0; n < 4; ++n) wmma::store_matrix_sync(out + n * 16, f[n], lds<DH>(), wmma::mem_row_major);
}

// acc[16 x Dh] += a[16 x 64] . b[64 x Dh], both staged row-major
template <int DH>
__device__ __forceinline__ void accumulate_ab(Acc (&acc)[padded<DH>() / 16], const __nv_bfloat16* a,
                                              const __nv_bfloat16* b) {
  constexpr int LDB = ldb<DH>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    RowA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDB);
#pragma unroll
    for (int n = 0; n < padded<DH>() / 16; ++n) {
      RowB fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LDB + n * 16, LDB);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// this warp's 16 x Dh accumulator, times `mul`, to rows row0 + r of dst
// (row stride gt) for rows < t, through the warp's f32 scratch
template <int DH, typename T>
__device__ __forceinline__ void store_rows(Acc (&acc)[padded<DH>() / 16], float* scratch, T* dst,
                                           int row0, int t, long long gt, float mul) {
  constexpr int LDS = lds<DH>();
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int c0 = (lane & 1) * (DH / 2);
#pragma unroll
  for (int n = 0; n < padded<DH>() / 16; ++n)
    wmma::store_matrix_sync(scratch + n * 16, acc[n], LDS, wmma::mem_row_major);
  __syncwarp();
  if (row0 + r < t) {
    const float* srow = scratch + r * LDS + c0;
    T* drow = dst + (long long)(row0 + r) * gt + c0;
#pragma unroll
    for (int j = 0; j < DH / 2; j += 4)
      tile_io::store4(drow + j, make_float4(srow[j] * mul, srow[j + 1] * mul, srow[j + 2] * mul,
                                            srow[j + 3] * mul));
  }
  __syncwarp();
}

// sum over the head dim of o * do for one row, Dh / 2 columns per lane of a pair
template <int DH, typename T>
__device__ __forceinline__ float half_row_dot(const T* o, const T* d) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < DH / 2; j += 4) {
    const float4 a = tile_io::load4(o + j);
    const float4 b = tile_io::load4(d + j);
    acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  return acc;
}

template <int DH>
struct __align__(128) SmemDq {
  __nv_bfloat16 q[BQ * ldb<DH>()];   // q * scale
  __nv_bfloat16 dout[BQ * ldb<DH>()];
  __nv_bfloat16 k[BK * ldb<DH>()];
  __nv_bfloat16 v[BK * ldb<DH>()];
  __nv_bfloat16 ds[WARPS][16 * ldb<DH>()];
  float s[WARPS][16 * lds<DH>()];    // scores, then the output staging
  float dp[WARPS][16 * lds<DH>()];
};

template <typename T, bool RANGED, int DH>
__global__ void __launch_bounds__(THREADS)
banded_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          T* __restrict__ dq, int h, int t, long long sn, long long sh,
                          long long st, long long gn, long long gh, long long gt, int band,
                          int valid, float scale, Bounds bounds) {
  constexpr int LDB = ldb<DH>();
  constexpr int LDS = lds<DH>();
  extern __shared__ unsigned char smem_raw[];
  SmemDq<DH>& sm = *reinterpret_cast<SmemDq<DH>*>(smem_raw);

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
      zero_row<DH>(dq + gbase, qi, t, gt);
      return;
    }
  }

  zero_pad<DH>(sm.q, BQ);
  zero_pad<DH>(sm.dout, BQ);
  zero_pad<DH>(sm.k, BK);
  zero_pad<DH>(sm.v, BK);
  tile_io::load_tile<BQ, DH, LDB, THREADS>(sm.q, q + base, q0, t, st, scale);
  tile_io::load_tile<BQ, DH, LDB, THREADS>(sm.dout, dout + gbase, q0, t, gt, 1.f);

  float delta = 0.f;
  float lse_q = 0.f;
  if (qi < t) {
    const int half = (lane & 1) * (DH / 2);
    delta = half_row_dot<DH>(o + gbase + (long long)qi * gt + half, dout + gbase + (long long)qi * gt + half);
    lse_q = lse[(long long)blockIdx.y * t + qi];
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);

  Acc acc[padded<DH>() / 16];
#pragma unroll
  for (int n = 0; n < padded<DH>() / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

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

    product_abt<DH>(sm.s[warp], sm.q + warp * 16 * LDB, sm.k);      // S = Q K^T
    product_abt<DH>(sm.dp[warp], sm.dout + warp * 16 * LDB, sm.v);  // dP = dO V^T
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool ok = pair_allowed<RANGED>(kbase + c0 + j, qi, band, valid, bounds);
      const float p = ok ? expf(srow[j] - lse_q) : 0.f;
      dsrow[j] = __float2bfloat16_rn(pair_ds<RANGED>(ok, p, dprow[j], delta));
    }
    __syncwarp();
    accumulate_ab<DH>(acc, sm.ds[warp], sm.k);  // dQ += dS K
  }
  store_rows<DH>(acc, sm.s[warp], dq + gbase, q0 + warp * 16, t, gt, scale);
}

template <int DH>
struct __align__(128) SmemDkv {
  __nv_bfloat16 k[BK * ldb<DH>()];
  __nv_bfloat16 v[BK * ldb<DH>()];
  __nv_bfloat16 q[BQ * ldb<DH>()];   // q * scale
  __nv_bfloat16 dout[BQ * ldb<DH>()];
  __nv_bfloat16 pt[WARPS][16 * ldb<DH>()];   // P^T rows of this warp's keys
  __nv_bfloat16 dst[WARPS][16 * ldb<DH>()];  // dS^T rows
  float s[WARPS][16 * lds<DH>()];    // S^T, then the dK staging
  float dp[WARPS][16 * lds<DH>()];   // dP^T, then the dV staging
  float lse[BQ];
  float delta[BQ];
};

template <typename T, bool RANGED, int DH>
__global__ void __launch_bounds__(THREADS)
banded_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ o,
                           const T* __restrict__ dout, const float* __restrict__ lse,
                           T* __restrict__ dk, T* __restrict__ dv, int h, int t, long long sn,
                           long long sh, long long st, long long gn, long long gh,
                           long long gt, int band, int valid, float scale, Bounds bounds) {
  constexpr int LDB = ldb<DH>();
  constexpr int LDS = lds<DH>();
  extern __shared__ unsigned char smem_raw[];
  SmemDkv<DH>& sm = *reinterpret_cast<SmemDkv<DH>*>(smem_raw);

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
      zero_row<DH>(dk + gbase, ki, t, gt);
      zero_row<DH>(dv + gbase, ki, t, gt);
      return;
    }
  }

  zero_pad<DH>(sm.k, BK);
  zero_pad<DH>(sm.v, BK);
  zero_pad<DH>(sm.q, BQ);
  zero_pad<DH>(sm.dout, BQ);
  tile_io::load_tile<BK, DH, LDB, THREADS>(sm.k, k + base, k0, t, st, 1.f);
  tile_io::load_tile<BK, DH, LDB, THREADS>(sm.v, v + base, k0, t, st, 1.f);

  Acc acc_k[padded<DH>() / 16], acc_v[padded<DH>() / 16];
#pragma unroll
  for (int n = 0; n < padded<DH>() / 16; ++n) {
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
      const int half = (threadIdx.x & 1) * (DH / 2);
      const int qr = qbase + row;
      float d = 0.f;
      if (qr < t)
        d = half_row_dot<DH>(o + gbase + (long long)qr * gt + half, dout + gbase + (long long)qr * gt + half);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (half == 0) {
        sm.delta[row] = d;
        sm.lse[row] = qr < t ? lse[(long long)blockIdx.y * t + qr] : 0.f;
      }
    }
    __syncthreads();

    product_abt<DH>(sm.s[warp], sm.k + warp * 16 * LDB, sm.q);      // S^T = K Q^T
    product_abt<DH>(sm.dp[warp], sm.v + warp * 16 * LDB, sm.dout);  // dP^T = V dO^T
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
    accumulate_ab<DH>(acc_v, sm.pt[warp], sm.dout);  // dV += P^T dO
    accumulate_ab<DH>(acc_k, sm.dst[warp], sm.q);    // dK += dS^T (Q * scale)
  }
  store_rows<DH>(acc_k, sm.s[warp], dk + gbase, k0 + warp * 16, t, gt, 1.f);
  store_rows<DH>(acc_v, sm.dp[warp], dv + gbase, k0 + warp * 16, t, gt, 1.f);
}

// ---- dk/dv in bf16 for Hopper (sm_90a): wgmma, TMA ring, P^T and dS^T in registers
namespace hopper {

using sm90::bar_arrive;
using sm90::bar_expect;
using sm90::bar_init;
using sm90::bar_wait;
using sm90::desc;
using sm90::desc32;
using sm90::tma_load;

constexpr int SLAB = 64;                  // head-dim columns of the first slab (128-byte swizzle)
constexpr int BKV = 128;                  // keys per CTA: two consumer warpgroups
constexpr int STAGES = 3;                 // query tiles in flight
constexpr int CONSUMERS = 256;            // two warpgroups of 64 keys
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (one warp loads)
// setmaxnreg: the producer warpgroup gives its registers to the consumers
// (168 a thread at launch: 384 x 168 fits the SM's 64K)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(CONSUMERS * CONSUMER_REGS + 128 * PRODUCER_REGS <= THREADS * 168, "register pool");
constexpr float LOG2E = 1.4426950408889634f;

// head-dim columns of the second slab (32-byte swizzle): 16 for Dh = 72
// (72..79 zero: TMA's fill past the map's extent), none for Dh = 64
template <int DH>
__host__ __device__ constexpr int x_cols() {
  static_assert(DH == 64 || DH == 72, "the head dims the Hopper bodies take");
  return DH == 64 ? 0 : 16;
}
// bytes TMA lands for 64 rows of one head: both slabs
template <int DH>
__host__ __device__ constexpr unsigned tile_bytes() {
  return 64 * (SLAB + x_cols<DH>()) * 2;
}

// the TMA maps of q, k, v, o and do: the first slab's, and at Dh = 72 the
// second slab's (unused at Dh = 64)
struct Maps {
  CUtensorMap q, k, v, o, dout, q1, k1, v1, o1, dout1;
};

// the maps over bf16 q/k/v (strides sn, sh, st; boxes of q_rows and kv_rows
// rows) and o/do (strides gn, gh, gt; q_rows); returns 0 or TMA_ENCODE_ERROR + a CUresult
template <int DH>
int make_maps(Maps& m, const void* q, const void* k, const void* v, const void* o, const void* dout,
              int n, int h, int t, long long sn, long long sh, long long st, long long gn,
              long long gh, long long gt, int q_rows, int kv_rows) {
  const void* bases[5] = {q, k, v, o, dout};
  CUtensorMap* firsts[5] = {&m.q, &m.k, &m.v, &m.o, &m.dout};
  CUtensorMap* seconds[5] = {&m.q1, &m.k1, &m.v1, &m.o1, &m.dout1};
  int err = 0;
  for (int i = 0; i < 5 && err == 0; ++i) {
    const bool qkv = i < 3;
    const long long a = qkv ? sn : gn, b = qkv ? sh : gh, c = qkv ? st : gt;
    const int rows = i == 1 || i == 2 ? kv_rows : q_rows;
    err = sm90::make_map(firsts[i], bases[i], n, h, t, a, b, c, rows, DH);
    if (err == 0 && x_cols<DH>() != 0)
      err = sm90::make_map(seconds[i], bases[i], n, h, t, a, b, c, rows, DH, x_cols<DH>(),
                           CU_TENSOR_MAP_SWIZZLE_32B);
  }
  return err;
}

// d += o . do over the 8 columns of one 16-byte chunk of each (bf16), pair
// by pair in column order
__device__ __forceinline__ void chunk_dot(float& d, const unsigned char* ob, const unsigned char* db,
                                          int off) {
  const uint4 a = *reinterpret_cast<const uint4*>(ob + off);
  const uint4 e = *reinterpret_cast<const uint4*>(db + off);
  const unsigned aw[4] = {a.x, a.y, a.z, a.w};
  const unsigned ew[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[x]));
    const float2 fe = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ew[x]));
    d += fa.x * fe.x + fa.y * fe.y;
  }
}

// Dh = 72: the 16-byte chunks c0, c0 + stride, ... < CHUNKS of a q tile (a
// 64-wide slab of `rows` rows, then its 16-wide second slab) scaled by
// Dh^-1/2 in f32 and rounded back to bf16 in place: the TPU kernel's
// rounding of the scaled query, which then feeds S (not scaled again) and
// dK (no trailing scale)
template <int ROWS>
__device__ __forceinline__ void scale_q(__nv_bfloat16* slab, __nv_bfloat16* slab1, int c0, int stride,
                                        float scale) {
  constexpr int CHUNKS0 = ROWS * SLAB * 2 / 16, CHUNKS = ROWS * (SLAB + 16) * 2 / 16;
  for (int c = c0; c < CHUNKS; c += stride) {
    uint4* p = c < CHUNKS0 ? reinterpret_cast<uint4*>(slab) + c
                           : reinterpret_cast<uint4*>(slab1) + (c - CHUNKS0);
    uint4 v = *p;
    unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      w[e] = sm90::pack_bf16(f.x * scale, f.y * scale);
    }
    *p = v;
  }
}

// the second slabs (columns 64..79), every 64-row block 2048 bytes (256-byte
// aligned: the 32-byte swizzle's period); 34 KB, so the first slabs after it
// stay 1024-byte aligned
template <int X>
struct SlabsDkv {
  __nv_bfloat16 k1[2][2][64 * X];
  __nv_bfloat16 v1[2][2][64 * X];
  __nv_bfloat16 q1[STAGES][BQ * X];
  __nv_bfloat16 dout1[STAGES][BQ * X];
  __nv_bfloat16 o1[STAGES][BQ * X];
};
template <>
struct SlabsDkv<0> {};
static_assert(sizeof(SlabsDkv<16>) % 1024 == 0, "the first slabs after it stay 1024-byte aligned");

template <int DH>
struct Smem : SlabsDkv<x_cols<DH>()> {  // every first-slab tile 1024-byte aligned (the 128-byte swizzle's period)
  __nv_bfloat16 k[2][2][64 * SLAB];  // two key blocks in flight, a 64-key half per warpgroup
  __nv_bfloat16 v[2][2][64 * SLAB];
  __nv_bfloat16 q[STAGES][BQ * SLAB];  // Dh = 64: raw q, the scale goes on S^T and dK
  __nv_bfloat16 dout[STAGES][BQ * SLAB];
  __nv_bfloat16 o[STAGES][BQ * SLAB];
  float lse[STAGES][BQ];
  float delta[2][STAGES][BQ];  // each warpgroup's copy
  unsigned long long kv_full[2], kv_empty[2], full[STAGES], empty[STAGES];
};
template <int DH>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem<DH>)) + 1024;  // + alignment slack
}

// the query tiles [qt0, qt0 + ntiles) that a key block at k0 walks, and the
// valid queries [q_lo, q_hi] that see any of its keys: [k0 - L, k0 + BKV - 2 + L]
// (ranged: in [q_lo, q_hi), and none for a block of masked keys)
struct Walk {
  int qt0, ntiles, q_lo, q_hi;
};

template <bool RANGED>
__device__ __forceinline__ Walk walk(int k0, int band, int valid, const Bounds& bounds) {
  int q_lo = max(0, k0 - band);
  int q_hi = k0 >= valid ? -1 : min(valid - 1, k0 + BKV - 2 + band);
  if constexpr (RANGED) {
    q_lo = max(q_lo, bounds.q_lo);
    q_hi = min(q_hi, bounds.q_hi - 1);
    if (k0 + BKV <= bounds.k_lo || k0 >= bounds.k_hi) q_hi = -1;
  }
  const int qt0 = q_lo / BQ;
  return {qt0, q_lo <= q_hi ? q_hi / BQ - qt0 + 1 : 0, q_lo, q_hi};
}

// Persistent: CTA c walks the items c, c + gridDim.x, ... of the
// (key block, n*h) grid (item = block * N*H + bh; numbered by bh first, a
// grid that is a multiple of the block count would hand each CTA one kind
// of block, pad or inner, and idle the SMs with the pad ones), so the producer
// loads the next item's K/V and query tiles while the consumers finish the
// current one. The ring position g and the key-block count jj run on over
// items, the same on both sides.
template <bool RANGED, int DH>
__global__ void __launch_bounds__(THREADS, 1)
banded_attn_bwd_dkv_sm90_kernel(const __grid_constant__ Maps maps,
                                const float* __restrict__ lse, __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int nbh, int h, int t, long long gn,
                                long long gh, long long gt, int band, int valid, float scale,
                                Bounds bounds) {
  constexpr int X = x_cols<DH>();  // second-slab columns
  constexpr unsigned TILE_BYTES = tile_bytes<DH>();
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<DH>*>(smem_raw + (-sm90::smem_addr(smem_raw) & 1023));  // 1024-aligned
  const int nkb = (t + BKV - 1) / BKV;  // key blocks per (n, h)
  const int items = nkb * nbh;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      bar_init(&sm.kv_full[b], 1);
      bar_init(&sm.kv_empty[b], CONSUMERS / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&sm.full[s], 1 + 32);  // the TMA arrival and the 32 LSE copiers
      bar_init(&sm.empty[s], CONSUMERS / 32);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: its first warp issues every load
    sm90::registers_dec<PRODUCER_REGS>();
    if (threadIdx.x < CONSUMERS + 32) {
      const int lane = threadIdx.x % 32;
      int g = 0, jj = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int bh = item % nbh;
        const int k0 = item / nbh * BKV;
        const Walk w = walk<RANGED>(k0, band, valid, bounds);
        if (w.ntiles == 0) continue;
        const int nb = bh / h;
        const int hb = bh % h;
        const int b = jj & 1;
        if (jj >= 2) bar_wait(&sm.kv_empty[b], ((jj >> 1) - 1) & 1);
        if (lane == 0) {
          bar_expect(&sm.kv_full[b], 4 * TILE_BYTES);
          tma_load(sm.k[b][0], &maps.k, &sm.kv_full[b], k0, hb, nb);
          tma_load(sm.v[b][0], &maps.v, &sm.kv_full[b], k0, hb, nb);
          if constexpr (X != 0) {
            tma_load(sm.k1[b][0], &maps.k1, &sm.kv_full[b], k0, hb, nb, SLAB);
            tma_load(sm.v1[b][0], &maps.v1, &sm.kv_full[b], k0, hb, nb, SLAB);
          }
        }
        const float* lse_bh = lse + (long long)bh * t;
        for (int i = 0; i < w.ntiles; ++i, ++g) {
          const int s = g % STAGES;
          const int qbase = (w.qt0 + i) * BQ;
          if (g >= STAGES) bar_wait(&sm.empty[s], (g / STAGES - 1) & 1);
          if (lane == 0) {
            bar_expect(&sm.full[s], 3 * TILE_BYTES);
            tma_load(sm.q[s], &maps.q, &sm.full[s], qbase, hb, nb);
            tma_load(sm.dout[s], &maps.dout, &sm.full[s], qbase, hb, nb);
            tma_load(sm.o[s], &maps.o, &sm.full[s], qbase, hb, nb);
            if constexpr (X != 0) {
              tma_load(sm.q1[s], &maps.q1, &sm.full[s], qbase, hb, nb, SLAB);
              tma_load(sm.dout1[s], &maps.dout1, &sm.full[s], qbase, hb, nb, SLAB);
              tma_load(sm.o1[s], &maps.o1, &sm.full[s], qbase, hb, nb, SLAB);
            }
          }
#pragma unroll
          for (int half = 0; half < BQ; half += 32) {
            const int row = qbase + half + lane;
            sm90::cp_async4(&sm.lse[s][half + lane], row < t ? lse_bh + row : lse, row < t);
          }
          sm90::cp_async_arrive(&sm.full[s]);
        }
        ++jj;
      }
    }
  } else {  // the two consumer warpgroups
    sm90::registers_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int cq = 2 * (lane % 4);  // this thread's first column in each 8-column chunk
    // Dh = 64: exact, scale is a power of two (scale folding); Dh = 72: q
    // arrives scaled, S^T is not scaled again
    const float c = X == 0 ? scale * LOG2E : LOG2E;
    int g = 0, jj = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int bh = item % nbh;
      const int k0 = item / nbh * BKV;
      const Walk w = walk<RANGED>(k0, band, valid, bounds);
      const int kw = k0 + wg * 64;                 // this warpgroup's first key
      const int key0 = kw + warp * 16 + lane / 4;  // its keys: key0 and key0 + 8
      // the queries that see this warpgroup's keys; none for keys past
      // valid_len or (ranged) a half of masked keys
      const int w_lo = max(w.q_lo, kw - band);
      int w_hi = min(w.q_hi, kw + 62 + band);
      if (kw >= valid) w_hi = -1;
      if constexpr (RANGED) {
        if (kw + 64 <= bounds.k_lo || kw >= bounds.k_hi) w_hi = -1;
      }
      // the queries that see key key0 + 8r, [lo[r], hi[r]]: pair_allowed as one
      // interval (empty for a key past valid_len or, ranged, outside [k_lo, k_hi))
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        lo[r] = max(key - band, RANGED ? bounds.q_lo : 0);
        hi[r] = min(key + band - 1, RANGED ? min(valid, bounds.q_hi) - 1 : valid - 1);
        bool key_ok = key < valid;
        if constexpr (RANGED) key_ok = key_ok && key >= bounds.k_lo && key < bounds.k_hi;
        if (!key_ok) hi[r] = -1;
      }

      float acc_k[32], acc_v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc_k[j] = acc_v[j] = 0.f;
      // Dh = 72: dK's and dV's columns 64..79 (72..79 never stored)
      [[maybe_unused]] float acc_k1[8], acc_v1[8];
      if constexpr (X != 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_k1[j] = acc_v1[j] = 0.f;
      }

      if (w.ntiles > 0) {
        const int b = jj & 1;
        bar_wait(&sm.kv_full[b], (jj >> 1) & 1);
        for (int i = 0; i < w.ntiles; ++i, ++g) {
          const int s = g % STAGES;
          const int qbase = (w.qt0 + i) * BQ;
          bar_wait(&sm.full[s], (g / STAGES) & 1);
          {  // delta of the tile's 64 queries into this warpgroup's copy, two threads a row
            const int row = (threadIdx.x % 128) >> 1;
            const int half = threadIdx.x & 1;
            const unsigned char* ob = reinterpret_cast<const unsigned char*>(sm.o[s]);
            const unsigned char* db = reinterpret_cast<const unsigned char*>(sm.dout[s]);
            float d = 0.f;
#pragma unroll
            for (int c8 = 0; c8 < 4; ++c8) chunk_dot(d, ob, db, sm90::swizzled(row, (half * 4 + c8) * 8));
            if constexpr (X != 0) {  // columns 64..71 (72..79 are zero in both)
              if (half == 0)
                chunk_dot(d, reinterpret_cast<const unsigned char*>(sm.o1[s]),
                          reinterpret_cast<const unsigned char*>(sm.dout1[s]), sm90::swizzled32(row, 0));
            }
            d += __shfl_xor_sync(0xffffffffu, d, 1);
            // the slot's last reader passed this barrier STAGES tiles ago
            if (half == 0) sm.delta[wg][s][row] = d;
            if constexpr (X == 0) {
              sm90::warpgroup_sync(1 + wg);
            } else {
              // Dh = 72: the consumers scale the shared q tile in place, a
              // share each, then a proxy fence and a barrier over both
              // warpgroups before either's wgmma reads it
              scale_q<BQ>(sm.q[s], sm.q1[s], threadIdx.x, CONSUMERS, scale);
              sm90::fence_proxy_async();
              sm90::named_sync(3, CONSUMERS);
            }
          }
          if (qbase <= w_hi && qbase + BQ - 1 >= w_lo) {  // uniform over the warpgroup
            float st[32], dpt[32];
            sm90::fence();
#pragma unroll
            for (int kk = 0; kk < SLAB / 16; ++kk)  // S^T = K Q^T
              sm90::mma_ss(st, desc(sm.k[b][wg], 32 * kk), desc(sm.q[s], 32 * kk), kk);
            if constexpr (X != 0) sm90::mma_ss(st, desc32(sm.k1[b][wg], 0), desc32(sm.q1[s], 0), 1);
#pragma unroll
            for (int kk = 0; kk < SLAB / 16; ++kk)  // dP^T = V dO^T
              sm90::mma_ss(dpt, desc(sm.v[b][wg], 32 * kk), desc(sm.dout[s], 32 * kk), kk);
            if constexpr (X != 0) sm90::mma_ss(dpt, desc32(sm.v1[b][wg], 0), desc32(sm.dout1[s], 0), 1);
            sm90::commit();
            sm90::wait_all();
            sm90::pin(st);
            sm90::pin(dpt);

            // P^T and dS^T, packed to bf16 as they are formed: register
            // 4n + 2r + j is key key0 + 8r, query qbase + 8n + cq + j, and the
            // A fragment of k-step kk is registers 8kk .. 8kk+7 in pairs
            unsigned pa[4][4], da[4][4];
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n) {
              const float2 ls = *reinterpret_cast<const float2*>(&sm.lse[s][8 * n + cq]);
              const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[wg][s][8 * n + cq]);
              const int query = qbase + 8 * n + cq;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int idx = 4 * n + 2 * r;
                const bool ok0 = query >= lo[r] && query <= hi[r];
                const bool ok1 = query + 1 >= lo[r] && query + 1 <= hi[r];
                const float p0 = ok0 ? exp2f(fmaf(st[idx], c, -ls.x * LOG2E)) : 0.f;
                const float p1 = ok1 ? exp2f(fmaf(st[idx + 1], c, -ls.y * LOG2E)) : 0.f;
                pa[n >> 1][2 * (n & 1) + r] = sm90::pack_bf16(p0, p1);
                const float ds0 = ok0 ? p0 * (dpt[idx] - dl.x) : 0.f;
                const float ds1 = ok1 ? p1 * (dpt[idx + 1] - dl.y) : 0.f;
                da[n >> 1][2 * (n & 1) + r] = sm90::pack_bf16(ds0, ds1);
              }
            }
            sm90::fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)  // dV += P^T dO
              sm90::mma_rs(acc_v, pa[kk], desc(sm.dout[s], 2048 * kk));
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk)  // dK += dS^T Q
              sm90::mma_rs(acc_k, da[kk], desc(sm.q[s], 2048 * kk));
            if constexpr (X != 0) {  // the second slab: m64n16 products
#pragma unroll
              for (int kk = 0; kk < BQ / 16; ++kk)
                sm90::mma_rs16(acc_v1, pa[kk], desc32(sm.dout1[s], 512 * kk));
#pragma unroll
              for (int kk = 0; kk < BQ / 16; ++kk)
                sm90::mma_rs16(acc_k1, da[kk], desc32(sm.q1[s], 512 * kk));
            }
            sm90::commit();
            sm90::wait_all();
            sm90::pin(acc_v);
            sm90::pin(acc_k);
            if constexpr (X != 0) {
              sm90::pin(acc_v1);
              sm90::pin(acc_k1);
            }
          }
          __syncwarp();
          if (lane == 0) bar_arrive(&sm.empty[s]);  // this warp is done with stage s
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&sm.kv_empty[b]);  // and with this key block's K/V
        ++jj;
      }

      // dk times the scale at Dh = 64 (raw q); at 72 q was scaled
      const float dk_mul = X == 0 ? scale : 1.f;
      const long long gbase = (bh / h) * gn + (bh % h) * gh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= t) continue;
        __nv_bfloat16* dkrow = dk + gbase + key * gt + cq;
        __nv_bfloat16* dvrow = dv + gbase + key * gt + cq;
#pragma unroll
        for (int n = 0; n < SLAB / 8; ++n) {
          const int idx = 4 * n + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * n) =
              __floats2bfloat162_rn(acc_k[idx] * dk_mul, acc_k[idx + 1] * dk_mul);
          *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * n) =
              __floats2bfloat162_rn(acc_v[idx], acc_v[idx + 1]);
        }
        if constexpr (X != 0) {  // columns 64..71
          *reinterpret_cast<__nv_bfloat162*>(dkrow + SLAB) =
              __floats2bfloat162_rn(acc_k1[2 * r], acc_k1[2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvrow + SLAB) =
              __floats2bfloat162_rn(acc_v1[2 * r], acc_v1[2 * r + 1]);
        }
      }
    }
  }
}

// persistent: as many CTAs as fit at once (the occupancy times the SMs), at
// most `items`; launches `kernel` with `args`
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int threads, int smem, int items, cudaStream_t stream,
                      Args... args) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);  // the CTA does not fit
  kernel<<<min(per_sm * sms, items), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool RANGED, int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dk, void* dv, int n, int h, int t, long long sn,
               long long sh, long long st, long long gn, long long gh, long long gt, int band,
               int valid_len, float scale, Bounds bounds, cudaStream_t stream) {
  Maps maps{};
  const int err = make_maps<DH>(maps, q, k, v, o, dout, n, h, t, sn, sh, st, gn, gh, gt, BQ, BKV);
  if (err != 0) return err;
  return launch_persistent(banded_attn_bwd_dkv_sm90_kernel<RANGED, DH>, THREADS, smem_bytes<DH>(),
                           (t + BKV - 1) / BKV * n * h, stream, maps, lse,
                           static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n * h,
                           h, t, gn, gh, gt, band, valid_len, scale, bounds);
}

}  // namespace hopper

// ---- dq in bf16 for Hopper (sm_90a): wgmma, K/V through a TMA ring, dS in registers
namespace hopper_dq {

using hopper::chunk_dot;
using hopper::LOG2E;
using hopper::Maps;
using hopper::SLAB;
using hopper::tile_bytes;
using hopper::x_cols;
using sm90::bar_arrive;
using sm90::bar_expect;
using sm90::bar_init;
using sm90::bar_wait;
using sm90::desc;
using sm90::desc32;
using sm90::tma_load;

constexpr int BQB = 128;                  // query rows per item: two consumer warpgroups
constexpr int QBUF = 2;                   // query blocks in flight (q, do, o and the LSE)
constexpr int STAGES = 4;                 // K/V tiles in flight
constexpr int CONSUMERS = 256;            // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp

// the second slabs (columns 64..79): 40 KB, so the first slabs after it stay
// 1024-byte aligned
template <int X>
struct SlabsDq {
  __nv_bfloat16 q1[QBUF][2][64 * X];
  __nv_bfloat16 dout1[QBUF][2][64 * X];
  __nv_bfloat16 o1[QBUF][2][64 * X];
  __nv_bfloat16 k1[STAGES][BK * X];
  __nv_bfloat16 v1[STAGES][BK * X];
};
template <>
struct SlabsDq<0> {};
static_assert(sizeof(SlabsDq<16>) % 1024 == 0, "the first slabs after it stay 1024-byte aligned");

template <int DH>
struct Smem : SlabsDq<x_cols<DH>()> {  // every first-slab tile 1024-byte aligned (the 128-byte swizzle's period)
  __nv_bfloat16 q[QBUF][2][64 * SLAB];  // Dh = 64: raw q, the scale goes on S and dQ; a 64-row half per warpgroup
  __nv_bfloat16 dout[QBUF][2][64 * SLAB];
  __nv_bfloat16 o[QBUF][2][64 * SLAB];
  __nv_bfloat16 k[STAGES][BK * SLAB];
  __nv_bfloat16 v[STAGES][BK * SLAB];
  float lse[QBUF][BQB];
  unsigned long long q_full[QBUF], q_empty[QBUF], full[STAGES], empty[STAGES];
};
template <int DH>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem<DH>)) + 1024;  // + alignment slack
}

// the key tiles [kt0, kt0 + ntiles) that a query block at q0 walks, and the
// keys [k_lo, k_hi] any valid row of it may see: (q0 - L, q0 + BQB - 1 + L],
// < valid (ranged: in [k_lo, k_hi), and none for a block of pad query rows)
struct Walk {
  int kt0, ntiles, k_lo, k_hi;
};

template <bool RANGED>
__device__ __forceinline__ Walk walk(int q0, int band, int valid, const Bounds& bounds) {
  int k_lo = max(0, q0 - band + 1);
  int k_hi = q0 >= valid ? -1 : min(valid - 1, q0 + BQB - 1 + band);
  if constexpr (RANGED) {
    k_lo = max(k_lo, bounds.k_lo);
    k_hi = min(k_hi, bounds.k_hi - 1);
    if (q0 + BQB <= bounds.q_lo || q0 >= bounds.q_hi) k_hi = -1;
  }
  const int kt0 = k_lo / BK;
  return {kt0, k_lo <= k_hi ? k_hi / BK - kt0 + 1 : 0, k_lo, k_hi};
}

// Persistent: CTA c walks the items c, c + gridDim.x, ... of the (query
// block, n*h) grid, numbered block-major (item = block * N*H + bh), so the
// producer loads the next item's q, do, o and K/V tiles while the consumers
// finish the current one. The ring position g and the query-block count jj
// run on over items, the same on both sides.
template <bool RANGED, int DH>
__global__ void __launch_bounds__(THREADS, 1)
banded_attn_bwd_dq_sm90_kernel(const __grid_constant__ Maps maps,
                               const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                               int nbh, int h, int t, long long gn, long long gh, long long gt,
                               int band, int valid, float scale, Bounds bounds) {
  constexpr int X = x_cols<DH>();  // second-slab columns
  constexpr unsigned TILE_BYTES = tile_bytes<DH>();
  extern __shared__ unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<DH>*>(smem_raw + (-sm90::smem_addr(smem_raw) & 1023));  // 1024-aligned
  const int items = (t + BQB - 1) / BQB * nbh;

  if (threadIdx.x == 0) {
    for (int b = 0; b < QBUF; ++b) {
      bar_init(&sm.q_full[b], 1 + 32);  // the TMA arrival and the 32 LSE copiers
      bar_init(&sm.q_empty[b], CONSUMERS / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], CONSUMERS / 32);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: lane 0 issues the TMA loads
    const int lane = threadIdx.x % 32;
    int g = 0, jj = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int bh = item % nbh;
      const int q0 = item / nbh * BQB;
      const Walk w = walk<RANGED>(q0, band, valid, bounds);
      if (w.ntiles == 0) continue;
      const int nb = bh / h;
      const int hb = bh % h;
      const int b = jj % QBUF;
      if (jj >= QBUF) bar_wait(&sm.q_empty[b], (jj / QBUF - 1) & 1);
      if (lane == 0) {
        bar_expect(&sm.q_full[b], 6 * TILE_BYTES);
        tma_load(sm.q[b][0], &maps.q, &sm.q_full[b], q0, hb, nb);
        tma_load(sm.dout[b][0], &maps.dout, &sm.q_full[b], q0, hb, nb);
        tma_load(sm.o[b][0], &maps.o, &sm.q_full[b], q0, hb, nb);
        if constexpr (X != 0) {
          tma_load(sm.q1[b][0], &maps.q1, &sm.q_full[b], q0, hb, nb, SLAB);
          tma_load(sm.dout1[b][0], &maps.dout1, &sm.q_full[b], q0, hb, nb, SLAB);
          tma_load(sm.o1[b][0], &maps.o1, &sm.q_full[b], q0, hb, nb, SLAB);
        }
      }
      const float* lse_bh = lse + (long long)bh * t;
#pragma unroll
      for (int r = 0; r < BQB; r += 32) {
        const int row = q0 + r + lane;
        sm90::cp_async4(&sm.lse[b][r + lane], row < t ? lse_bh + row : lse, row < t);
      }
      sm90::cp_async_arrive(&sm.q_full[b]);
      for (int i = 0; i < w.ntiles; ++i, ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) bar_wait(&sm.empty[s], (g / STAGES - 1) & 1);
        if (lane == 0) {
          bar_expect(&sm.full[s], 2 * TILE_BYTES);
          tma_load(sm.k[s], &maps.k, &sm.full[s], (w.kt0 + i) * BK, hb, nb);
          tma_load(sm.v[s], &maps.v, &sm.full[s], (w.kt0 + i) * BK, hb, nb);
          if constexpr (X != 0) {
            tma_load(sm.k1[s], &maps.k1, &sm.full[s], (w.kt0 + i) * BK, hb, nb, SLAB);
            tma_load(sm.v1[s], &maps.v1, &sm.full[s], (w.kt0 + i) * BK, hb, nb, SLAB);
          }
        }
      }
      ++jj;
    }
    return;
  }

  // the two consumer warpgroups
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int cq = 2 * (lane % 4);          // this thread's first column in each 8-column chunk
  const int rloc = warp * 16 + lane / 4;  // its rows in the warpgroup's 64: rloc and rloc + 8
  // Dh = 64: exact, scale is a power of two (scale folding); Dh = 72: q
  // is scaled on chip, S is not scaled again
  const float c = X == 0 ? scale * LOG2E : LOG2E;
  int g = 0, jj = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bh = item % nbh;
    const int q0 = item / nbh * BQB;
    const Walk w = walk<RANGED>(q0, band, valid, bounds);
    const int qw = q0 + wg * 64;  // this warpgroup's first row
    // the keys this warpgroup's rows may see; none for rows past valid_len
    // or (ranged) a half of pad query rows
    const int w_lo = max(w.k_lo, qw - band + 1);
    int w_hi = min(w.k_hi, qw + 63 + band);
    if (qw >= valid) w_hi = -1;
    if constexpr (RANGED) {
      if (qw + 64 <= bounds.q_lo || qw >= bounds.q_hi) w_hi = -1;
    }
    // the keys row qw + rloc + 8r sees, [lo[r], hi[r]]: pair_allowed as one
    // interval (empty for a row past valid_len or, ranged, outside [q_lo, q_hi))
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw + rloc + 8 * r;
      lo[r] = max(row - band + 1, RANGED ? bounds.k_lo : 0);
      hi[r] = min(row + band, RANGED ? min(valid, bounds.k_hi) - 1 : valid - 1);
      bool row_ok = row < valid;
      if constexpr (RANGED) row_ok = row_ok && row >= bounds.q_lo && row < bounds.q_hi;
      if (!row_ok) hi[r] = -1;
    }

    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    // Dh = 72: dQ's columns 64..79 (72..79 never stored)
    [[maybe_unused]] float acc1[8];
    if constexpr (X != 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc1[j] = 0.f;
    }

    if (w.ntiles > 0) {
      const int b = jj % QBUF;
      bar_wait(&sm.q_full[b], (jj / QBUF) & 1);
      if constexpr (X != 0) {
        // Dh = 72: this warpgroup's half of q scaled on chip (f32 multiply,
        // bf16 round), then a proxy fence and a barrier over the warpgroup
        // before its wgmma reads it
        hopper::scale_q<64>(sm.q[b][wg], sm.q1[b][wg], threadIdx.x % 128, 128, scale);
        sm90::fence_proxy_async();
        sm90::warpgroup_sync(1 + wg);
      }
      // delta = rowsum(o * do) and the LSE (times log2 e) of this thread's
      // two rows: the four lanes that share them sum 16 columns each (Dh =
      // 72: the first of them also columns 64..71)
      float delta[2], ml[2];
      const unsigned char* ob = reinterpret_cast<const unsigned char*>(sm.o[b][wg]);
      const unsigned char* db = reinterpret_cast<const unsigned char*>(sm.dout[b][wg]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rloc + 8 * r;
        float d = 0.f;
#pragma unroll
        for (int c8 = 0; c8 < 2; ++c8) chunk_dot(d, ob, db, sm90::swizzled(row, (cq + c8) * 8));
        if constexpr (X != 0) {
          if (cq == 0)
            chunk_dot(d, reinterpret_cast<const unsigned char*>(sm.o1[b][wg]),
                      reinterpret_cast<const unsigned char*>(sm.dout1[b][wg]), sm90::swizzled32(row, 0));
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        delta[r] = d;
        ml[r] = sm.lse[b][wg * 64 + row] * LOG2E;
      }

      for (int i = 0; i < w.ntiles; ++i, ++g) {
        const int s = g % STAGES;
        const int kbase = (w.kt0 + i) * BK;
        bar_wait(&sm.full[s], (g / STAGES) & 1);
        if (kbase <= w_hi && kbase + BK - 1 >= w_lo) {  // uniform over the warpgroup
          float sc[32], dp[32];
          sm90::fence();
#pragma unroll
          for (int kk = 0; kk < SLAB / 16; ++kk)  // S = Q K^T
            sm90::mma_ss(sc, desc(sm.q[b][wg], 32 * kk), desc(sm.k[s], 32 * kk), kk);
          if constexpr (X != 0) sm90::mma_ss(sc, desc32(sm.q1[b][wg], 0), desc32(sm.k1[s], 0), 1);
#pragma unroll
          for (int kk = 0; kk < SLAB / 16; ++kk)  // dP = dO V^T
            sm90::mma_ss(dp, desc(sm.dout[b][wg], 32 * kk), desc(sm.v[s], 32 * kk), kk);
          if constexpr (X != 0) sm90::mma_ss(dp, desc32(sm.dout1[b][wg], 0), desc32(sm.v1[s], 0), 1);
          sm90::commit();
          sm90::wait_all();
          sm90::pin(sc);
          sm90::pin(dp);

          // dS = P * (dP - delta), packed to bf16 as it is formed: register
          // 4n + 2r + j is row qw + rloc + 8r, key kbase + 8n + cq + j, and
          // the A fragment of k-step kk is registers 8kk .. 8kk+7 in pairs
          unsigned da[4][4];
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            const int key = kbase + 8 * n + cq;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int idx = 4 * n + 2 * r;
              const bool ok0 = key >= lo[r] && key <= hi[r];
              const bool ok1 = key + 1 >= lo[r] && key + 1 <= hi[r];
              const float p0 = ok0 ? exp2f(fmaf(sc[idx], c, -ml[r])) : 0.f;
              const float p1 = ok1 ? exp2f(fmaf(sc[idx + 1], c, -ml[r])) : 0.f;
              const float ds0 = ok0 ? p0 * (dp[idx] - delta[r]) : 0.f;
              const float ds1 = ok1 ? p1 * (dp[idx + 1] - delta[r]) : 0.f;
              da[n >> 1][2 * (n & 1) + r] = sm90::pack_bf16(ds0, ds1);
            }
          }
          sm90::fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)  // dQ += dS K, K the MN-major B operand
            sm90::mma_rs(acc, da[kk], desc(sm.k[s], 2048 * kk));
          if constexpr (X != 0) {  // the second slab: an m64n16 product
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) sm90::mma_rs16(acc1, da[kk], desc32(sm.k1[s], 512 * kk));
          }
          sm90::commit();
          sm90::wait_all();
          sm90::pin(acc);
          if constexpr (X != 0) sm90::pin(acc1);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&sm.empty[s]);  // this warp is done with stage s
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.q_empty[b]);  // and with this block's q, do, o
      ++jj;
    }

    // dq = dQ * scale from registers; 0 for rows that get no gradient
    const long long gbase = (bh / h) * gn + (bh % h) * gh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qw + rloc + 8 * r;
      if (row >= t) continue;
      __nv_bfloat16* dqrow = dq + gbase + row * gt + cq;
#pragma unroll
      for (int n = 0; n < SLAB / 8; ++n) {
        const int idx = 4 * n + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(dqrow + 8 * n) =
            __floats2bfloat162_rn(acc[idx] * scale, acc[idx + 1] * scale);
      }
      if constexpr (X != 0)  // columns 64..71
        *reinterpret_cast<__nv_bfloat162*>(dqrow + SLAB) =
            __floats2bfloat162_rn(acc1[2 * r] * scale, acc1[2 * r + 1] * scale);
    }
  }
}

template <bool RANGED, int DH>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dq, int n, int h, int t, long long sn, long long sh,
           long long st, long long gn, long long gh, long long gt, int band, int valid_len,
           float scale, Bounds bounds, cudaStream_t stream) {
  Maps maps{};
  const int err = hopper::make_maps<DH>(maps, q, k, v, o, dout, n, h, t, sn, sh, st, gn, gh, gt, BQB, BK);
  if (err != 0) return err;
  return hopper::launch_persistent(banded_attn_bwd_dq_sm90_kernel<RANGED, DH>, THREADS,
                                   smem_bytes<DH>(), (t + BQB - 1) / BQB * n * h, stream, maps, lse,
                                   static_cast<__nv_bfloat16*>(dq), n * h, h, t, gn, gh, gt, band,
                                   valid_len, scale, bounds);
}

}  // namespace hopper_dq

// the body the last dq and dk/dv calls took: "sm90" (bf16) or "wmma" (f32)
const char* last_dq_body = "none";
const char* last_dkv_body = "none";

template <typename Smem, typename Kernel, typename... Args>
int launch(Kernel kernel, int n, int h, int t, cudaStream_t stream, Args... args) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + 63) / 64, n * h);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool RANGED, int DH>
int dq_dh(const void* q, const void* k, const void* v, const void* o, const void* dout,
          const float* lse, void* dq, int n, int h, int t, long long sn, long long sh,
          long long st, long long gn, long long gh, long long gt, int band, int valid_len,
          float scale, Bounds bounds, int bf16, cudaStream_t s) {
  // the body by dtype: bf16 takes the Hopper body, f32 the WMMA body
  if (bf16) {
    last_dq_body = "sm90";
    return hopper_dq::launch<RANGED, DH>(q, k, v, o, dout, lse, dq, n, h, t, sn, sh, st, gn, gh,
                                         gt, band, valid_len, scale, bounds, s);
  }
  last_dq_body = "wmma";
  using T = float;
  return launch<SmemDq<DH>>(banded_attn_bwd_dq_kernel<T, RANGED, DH>, n, h, t, s,
                            static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<const T*>(o),
                            static_cast<const T*>(dout), lse, static_cast<T*>(dq), h, t, sn, sh,
                            st, gn, gh, gt, band, valid_len, scale, bounds);
}

template <bool RANGED, int DH>
int dkv_dh(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, void* dk, void* dv, int n, int h, int t, long long sn,
           long long sh, long long st, long long gn, long long gh, long long gt, int band,
           int valid_len, float scale, Bounds bounds, int bf16, cudaStream_t s) {
  // the body by dtype: bf16 takes the Hopper body, f32 the WMMA body
  if (bf16) {
    last_dkv_body = "sm90";
    return hopper::launch_dkv<RANGED, DH>(q, k, v, o, dout, lse, dk, dv, n, h, t, sn, sh, st, gn,
                                          gh, gt, band, valid_len, scale, bounds, s);
  }
  last_dkv_body = "wmma";
  using T = float;
  return launch<SmemDkv<DH>>(banded_attn_bwd_dkv_kernel<T, RANGED, DH>, n, h, t, s,
                             static_cast<const T*>(q), static_cast<const T*>(k),
                             static_cast<const T*>(v), static_cast<const T*>(o),
                             static_cast<const T*>(dout), lse, static_cast<T*>(dk),
                             static_cast<T*>(dv), h, t, sn, sh, st, gn, gh, gt, band, valid_len,
                             scale, bounds);
}

// head dim dh: 64 or 72 (DiT-XL training, ranged under context parallelism)
template <bool RANGED>
int dq_entry(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, void* dq, int n, int h, int t, int dh, long long sn, long long sh,
             long long st, long long gn, long long gh, long long gt, int band, int valid_len,
             float scale, Bounds bounds, int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return dq_dh<RANGED, 64>(q, k, v, o, dout, lse, dq, n, h, t, sn, sh, st, gn, gh, gt, band,
                             valid_len, scale, bounds, bf16, s);
  if (dh == 72)
    return dq_dh<RANGED, 72>(q, k, v, o, dout, lse, dq, n, h, t, sn, sh, st, gn, gh, gt, band,
                             valid_len, scale, bounds, bf16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool RANGED>
int dkv_entry(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dk, void* dv, int n, int h, int t, int dh, long long sn,
              long long sh, long long st, long long gn, long long gh, long long gt, int band,
              int valid_len, float scale, Bounds bounds, int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return dkv_dh<RANGED, 64>(q, k, v, o, dout, lse, dk, dv, n, h, t, sn, sh, st, gn, gh, gt,
                              band, valid_len, scale, bounds, bf16, s);
  if (dh == 72)
    return dkv_dh<RANGED, 72>(q, k, v, o, dout, lse, dk, dv, n, h, t, sn, sh, st, gn, gh, gt,
                              band, valid_len, scale, bounds, bf16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v: (N, H, T, dh), dh 64 or 72, with shared strides (sn, sh, st); o,
// do and the gradients: the same shape and type with shared strides (gn,
// gh, gt); all f32 (bf16 = 0) or bf16 (bf16 = 1), unit stride over the head
// dim. lse: f32 (N*H, T) contiguous, from banded_attention_fwd_lse. Launch
// on `stream` without synchronizing; return cudaGetLastError().
extern "C" int banded_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       void* dq, int n, int h, int t, int dh, long long sn,
                                       long long sh, long long st, long long gn, long long gh,
                                       long long gt, int band, int valid_len, float scale, int bf16,
                                       void* stream) {
  return dq_entry<false>(q, k, v, o, dout, lse, dq, n, h, t, dh, sn, sh, st, gn, gh, gt, band,
                         valid_len, scale, Bounds{}, bf16, stream);
}

extern "C" int banded_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
                                        void* dk, void* dv, int n, int h, int t, int dh,
                                        long long sn, long long sh, long long st, long long gn,
                                        long long gh, long long gt, int band, int valid_len,
                                        float scale, int bf16, void* stream) {
  return dkv_entry<false>(q, k, v, o, dout, lse, dk, dv, n, h, t, dh, sn, sh, st, gn, gh, gt,
                          band, valid_len, scale, Bounds{}, bf16, stream);
}

// Ranged: as above over all T (halo-extended) rows with valid_len = T, keys
// in [k_lo, k_hi) and queries in [q_lo, q_hi), dh 64 or 72; lse from
// banded_attention_fwd_ranged_lse.
extern "C" int banded_attention_bwd_dq_ranged(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const float* lse,
                                              void* dq, int n, int h, int t, int dh, long long sn,
                                              long long sh, long long st, long long gn,
                                              long long gh, long long gt, int band, int k_lo,
                                              int k_hi, int q_lo, int q_hi, float scale,
                                              int bf16, void* stream) {
  return dq_entry<true>(q, k, v, o, dout, lse, dq, n, h, t, dh, sn, sh, st, gn, gh, gt, band, t,
                        scale, Bounds{k_lo, k_hi, q_lo, q_hi}, bf16, stream);
}

extern "C" int banded_attention_bwd_dkv_ranged(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const float* lse,
                                               void* dk, void* dv, int n, int h, int t, int dh,
                                               long long sn, long long sh, long long st,
                                               long long gn, long long gh, long long gt,
                                               int band, int k_lo, int k_hi, int q_lo, int q_hi,
                                               float scale, int bf16, void* stream) {
  return dkv_entry<true>(q, k, v, o, dout, lse, dk, dv, n, h, t, dh, sn, sh, st, gn, gh, gt, band,
                         t, scale, Bounds{k_lo, k_hi, q_lo, q_hi}, bf16, stream);
}

extern "C" const char* banded_attention_bwd_error_string(int err) {
  return sm90::error_string(err);
}

// "sm90" or "wmma": the body the last dq (dk/dv) call took
extern "C" const char* banded_attention_bwd_last_dq_body() { return last_dq_body; }
extern "C" const char* banded_attention_bwd_last_dkv_body() { return last_dkv_body; }

// the Hopper dq (dk/dv) body's dynamic shared memory per CTA at head dim
// dh (64 or 72; else 0), bytes
extern "C" int banded_attention_bwd_sm90_dq_smem_bytes(int dh) {
  return dh == 64 ? hopper_dq::smem_bytes<64>() : dh == 72 ? hopper_dq::smem_bytes<72>() : 0;
}
extern "C" int banded_attention_bwd_sm90_dkv_smem_bytes(int dh) {
  return dh == 64 ? hopper::smem_bytes<64>() : dh == 72 ? hopper::smem_bytes<72>() : 0;
}

// the WMMA dq (dkv = 0) or dk/dv (dkv = 1) body's dynamic shared memory per
// CTA at head dim dh (64 or 72; else 0), bytes
extern "C" int banded_attention_bwd_wmma_smem_bytes(int dkv, int dh) {
  if (dh == 64) return static_cast<int>(dkv ? sizeof(SmemDkv<64>) : sizeof(SmemDq<64>));
  if (dh == 72) return static_cast<int>(dkv ? sizeof(SmemDkv<72>) : sizeof(SmemDq<72>));
  return 0;
}
