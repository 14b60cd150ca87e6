// Hopper building blocks of the banded-attention bodies and of the
// adaLN-MLP GEMMs: TMA tensor maps over an (N, H, T, Dh) bf16 tensor read
// through its strides, or over a row-major (rows, cols) bf16 or int8
// matrix read 64 columns at a time; the mbarrier ring that the loads complete on; and
// warpgroup MMAs (wgmma m64nNk16 with N = 16, 64, 128 or 256, bf16 operands,
// f32 accumulators in registers) on tiles in the 128-byte swizzle, which
// TMA writes (or threads, at `swizzled` offsets, where an operand is
// converted on chip), or in the 32-byte swizzle (`swizzled32`, `desc32`):
// the 16-column second slab of a head dim of 72.
//
// Tile layout: every operand tile is R rows x 64 bf16 (one 128-byte row per
// row of the tensor), loaded by one TMA box {64, R} with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned buffer: 16-byte chunk
// c of row r sits at chunk c ^ (r % 8). wgmma reads such a tile as
// - K-major (the operand's reduction dim is the 64 contiguous elements:
//   Q, K in S = Q.K^T; K, V, Q, dO in the dk/dv kernel's K.Q^T and V.dO^T):
//   8-row groups 1024 bytes apart (SBO), a k16 step 32 bytes further along
//   the row;
// - MN-major (tnspB = 1: the reduction dim runs over the rows, as V in P.V
//   and dO, Q in P^T.dO, dS^T.Q, and torch's Linear weights in the adaLN-MLP
//   backward's products): a k16 step is 16 rows, 2048 bytes; an operand
//   wider than 64 is several such tiles, a leading byte offset apart.
// A 16-wide tile (R rows x 32 bytes, a TMA box {16, R} with
// CU_TENSOR_MAP_SWIZZLE_32B into a 256-byte aligned buffer) holds 16-byte
// chunk c of row r at chunk c ^ ((r / 4) % 2); wgmma reads it K-major (one
// k16 step: the whole row; 8-row groups 256 bytes apart) or MN-major (a
// 16-wide operand; a k16 step is 16 rows, 512 bytes).
//
// Register fragments of m64nNk16 (per warp w of the warpgroup, lane l):
// accumulator register 4n + 2i + j holds row 16w + l/4 + 8i, column
// 8n + 2(l%4) + j; the bf16 A operand of k-step kk is the accumulator's
// registers 8kk .. 8kk+7 packed in pairs (the same fragment as mma.sync's
// m16n8k16), so a softmax computed in the accumulator feeds the next
// product without touching shared memory.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdio>

#include "tile_io.cuh"

namespace sm90 {

using tile_io::smem_addr;

// ---- host: tensor maps -------------------------------------------------

// an entry's error code when the tensor map cannot be encoded: this base
// plus the driver's CUresult (error_string below names it)
constexpr int TMA_ENCODE_ERROR = 100000;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime so the
// library needs no -lcuda; nullptr if the driver does not offer it
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A map of the (N, H, T, dh) bf16 tensor at `base` with element strides
// (sn, sh, st) (unit stride over the dh), loading boxes of `rows` x `cols`
// with `swizzle` (by default 64 columns in the 128-byte swizzle; 16 in the
// 32-byte one for the second slab of dh 72); rows past T (and before 0) and
// columns past dh read as 0. Strides and base must be multiples of 16 bytes
// (the wrappers see to it). Returns 0 or TMA_ENCODE_ERROR + the CUresult.
inline int make_map(CUtensorMap* map, const void* base, int n, int h, int t, long long sn,
                    long long sh, long long st, int rows, int dh = 64, int cols = 64,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TMA_ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sn) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ENCODE_ERROR + static_cast<int>(r);
}

// A map of a row-major (rows, cols) matrix of `type` (elements of
// `elem_bytes`) at `base`, loading boxes of `box_rows` rows x 64 elements
// with `swizzle`; rows past `rows` read as 0. Returns 0 or
// TMA_ENCODE_ERROR + the CUresult.
inline int make_map_rows(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                         CUtensorMapSwizzle swizzle, const void* base, long long rows,
                         long long cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TMA_ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ENCODE_ERROR + static_cast<int>(r);
}

// A map of the row-major (rows, cols) bf16 matrix at `base` (cols a
// multiple of 8, base 16-byte aligned), loading boxes of `box_rows` x 64
// with the 128-byte swizzle; rows past `rows` read as 0.
inline int make_map_2d(CUtensorMap* map, const void* base, long long rows, long long cols,
                       int box_rows) {
  return make_map_rows(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, CU_TENSOR_MAP_SWIZZLE_128B, base,
                       rows, cols, box_rows);
}

// A map of the row-major (rows, cols) int8 matrix at `base` (cols a
// multiple of 16, base 16-byte aligned), loading boxes of `box_rows` rows x
// 64 bytes unswizzled (row r of a box at byte 64 r); rows past `rows` read
// as 0.
inline int make_map_2d_int8(CUtensorMap* map, const void* base, long long rows, long long cols,
                            int box_rows) {
  return make_map_rows(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, CU_TENSOR_MAP_SWIZZLE_NONE, base,
                       rows, cols, box_rows);
}

inline const char* error_string(int err) {
  static thread_local char buf[96];
  if (err >= TMA_ENCODE_ERROR) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed, CUresult %d", err - TMA_ENCODE_ERROR);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ---- device: the mbarrier ring ------------------------------------------

// one thread: mbarrier at `bar` completed by `count` arrivals a phase
__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also arms the barrier for `bytes` of TMA traffic
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  tile_io::mbar_wait(smem_addr(bar), parity);
}

// TMA: the box at coordinates (col, row, head, batch) of `map` into dst,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, unsigned long long* bar,
                                         int row, int head, int batch, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_addr(bar)),
        "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// TMA: the box at (column col, row row) of a make_map_2d map into dst,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            unsigned long long* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_addr(bar)),
        "r"(col), "r"(row)
      : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes when !valid; a later
// cp_async_arrive makes the calling thread's copies one arrival on a barrier
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies landed
// (counted in the barrier's init count: .noinc)
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// move registers between warpgroups: the calling warpgroup's count drops
// (dec) or rises (inc, waiting for what others released) to REGS a thread
template <int REGS>
__device__ __forceinline__ void registers_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void registers_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// a barrier over one warpgroup's 128 threads (ids 1.. : 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// a barrier over `threads` threads (a multiple of 32; ids 1.. : 0 is
// __syncthreads), e.g. the two consumer warpgroups of a CTA
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- device: wgmma ----------------------------------------------------

// descriptor of a 128-byte swizzled tile at `tile` (1024-byte aligned),
// advanced by `offset` bytes (a k16 step); SBO 1024 bytes, LBO unused by
// these 64-wide tiles
__device__ __forceinline__ unsigned long long desc(const void* tile, unsigned offset) {
  const unsigned long long addr = smem_addr(tile) + offset;
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// descriptor of a 32-byte swizzled 16-wide tile at `tile` (256-byte
// aligned), advanced by `offset` bytes (MN-major: a k16 step of 512 bytes);
// SBO 256 bytes (8 rows of 32), LBO unused by a 16-wide operand
__device__ __forceinline__ unsigned long long desc32(const void* tile, unsigned offset) {
  const unsigned long long addr = smem_addr(tile) + offset;
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) | (3ull << 62);
}

// descriptor of an MN-major operand wider than 64: `boxes` 128-byte swizzled
// 64-wide tiles (rows: the reduction dim) `box_bytes` apart (the leading
// byte offset), the first at `tile` (1024-byte aligned) advanced by `offset`
// bytes (a k16 step: 16 rows, 2048 bytes); SBO 1024 bytes (8 rows)
__device__ __forceinline__ unsigned long long desc_mn(const void* tile, unsigned offset,
                                                      unsigned box_bytes) {
  const unsigned long long addr = smem_addr(tile) + offset;
  return ((addr & 0x3FFFF) >> 4) | (static_cast<unsigned long long>(box_bytes >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
// orders this thread's shared-memory stores before later reads of them by
// the async proxy (wgmma operands written by threads, not by TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most PENDING committed groups of products are in flight
template <int PENDING>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void wait_all() { wait<0>(); }

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_ACC32                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major tiles in shared
// memory (descriptors), d zeroed first when !accumulate
__device__ __forceinline__ void mma_ss(float (&d)[32], unsigned long long da,
                                       unsigned long long db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (four packed bf16
// pairs, the fragment above), B an MN-major tile (tnspB = 1)
__device__ __forceinline__ void mma_rs(float (&d)[32], const unsigned (&a)[4],
                                       unsigned long long db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] += A[64 x 16] . B[16 x 16], A in registers as mma_rs's, B an
// MN-major 16-wide tile (desc32)
__device__ __forceinline__ void mma_rs16(float (&d)[8], const unsigned (&a)[4],
                                         unsigned long long db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SM90_ACC32
#undef SM90_D32

// d[64 x N] (+)= A[64 x 16] . B[16 x N], A a K-major tile in shared memory,
// B K-major (TRANS_B = 0: N rows of the swizzled 64-wide tile, 8-row groups
// 1024 bytes apart, which the same descriptor covers) or MN-major (TRANS_B =
// 1: 16 rows of N / 64 swizzled 64-wide boxes, desc_mn), d zeroed first when
// !accumulate; the accumulator layout above with n running to N / 8
template <int N, int TRANS_B = 0>
__device__ __forceinline__ void mma_ss_n(float (&d)[N / 2], unsigned long long da,
                                         unsigned long long db, int accumulate) {
  static_assert(N == 128 || N == 256, "wgmma widths of the GEMMs");
  if constexpr (N == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// the A fragment of k-step kk from accumulator-layout values
__device__ __forceinline__ void a_fragment(unsigned (&a)[4], const float (&x)[32], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// byte offset of element (r, c) of a 128-byte swizzled 64-wide bf16 tile
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// byte offset of element (r, c) of a 32-byte swizzled 16-wide bf16 tile
__device__ __forceinline__ int swizzled32(int r, int c) {
  return r * 32 + ((((c >> 3) ^ (r >> 2)) & 1) << 4) + (c & 7) * 2;
}

}  // namespace sm90
