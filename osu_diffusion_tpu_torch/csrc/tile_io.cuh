// Typed 4-element loads and stores shared by the kernels: activations are
// float32 or bfloat16 (the training stream), and the kernels compute in f32
// with bf16 matmul operands (int8 weight codes are upcast to bf16 first).
// Also the mbarrier-completed bulk copies of the MLP kernels' weight rings.
// Every pointer passed here is aligned to four elements (16 bytes for f32,
// 8 for bf16); the wrappers check it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile_io {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four int8 weight codes (one 32-bit word, lowest byte first) -> four bf16
// values, exact, with full-rate byte permutes and adds instead of int-to-
// float conversions (those issue at a quarter of the rate and bound the
// upcast): byte q + 128 placed in the mantissa of 2^23 is the float
// 2^23 + 128 + q, minus 2^23 + 128 is q, and a float that small an integer
// (|q| <= 127, 8 significant bits) is exactly its high 16 bits as bf16.
__device__ __forceinline__ uint2 int8x4_to_bf16x4(unsigned v) {
  const unsigned u = v ^ 0x80808080u;  // each byte q + 128
  const float magic = 8388736.f;       // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - magic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - magic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - magic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - magic;
  uint2 r;
  r.x = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  r.y = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  return r;
}

// The bulk-copy ring of the MLP kernels: one thread issues each weight tile
// as a single cp.async.bulk that completes on its stage's mbarrier.
constexpr long long SPIN_LIMIT = 1ll << 24;  // mbarrier polls before trapping

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared bulk copy of `bytes` (multiple of 16, both ends 16-byte
// aligned) that reports its bytes to the mbarrier at `mbar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(mbar) : "memory");
}

// arm the mbarrier at `mbar` for `bytes`, then copy them into `dst`
__device__ __forceinline__ void issue_bulk(void* dst, const void* src, unsigned bytes, unsigned mbar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(mbar), "r"(bytes) : "memory");
  bulk_copy(dst, src, bytes, mbar);
}

// one thread: `count` mbarriers, each completed by one arrival
__device__ __forceinline__ void mbar_init(unsigned long long* bars, int count) {
  for (int st = 0; st < count; ++st)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[st])));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// block until the mbarrier at `mbar` completes the phase of `parity`; a
// tile that never lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
    if (done) return;
    if (spin > SPIN_LIMIT) asm volatile("trap;");
  }
}

// rows [r0, r0 + ROWS) of a (t, COLS) slab with row stride `st` -> bf16
// shared tile with row stride LD, times `mul`; rows past t read as 0.
template <int ROWS, int COLS, int LD, int THREADS, typename T>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const T* src, int r0, int t,
                                          long long st, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * (COLS / 4); idx += THREADS) {
    const int row = idx / (COLS / 4);
    const int c4 = idx % (COLS / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < t) val = load4(src + (long long)(r0 + row) * st + c4 * 4);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + row * LD + c4 * 4);
    d[0] = __floats2bfloat162_rn(val.x * mul, val.y * mul);
    d[1] = __floats2bfloat162_rn(val.z * mul, val.w * mul);
  }
}

}  // namespace tile_io
