// Typed 4-element loads and stores shared by the kernels: activations are
// float32 or bfloat16 (the training stream), and the kernels compute in f32
// with bf16 matmul operands. Every pointer passed here is aligned to four
// elements (16 bytes for f32, 8 for bf16); the wrappers check it.
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
