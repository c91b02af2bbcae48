// Element access shared by the CUDA-core flash kernels
// (flash_attention.cu, flash_attention_bwd.cu): f32, bf16 and f16 rows
// read and written as f32, four elements at a time or a thread's few
// columns of a narrow row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// two 16-bit elements in one 32-bit word, as f32
__device__ __forceinline__ float2 unpack2(uint32_t u, const __nv_bfloat16*) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = u;
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u, const __half*) {
  __half2 v;
  *reinterpret_cast<uint32_t*>(&v) = u;
  return __half22float2(v);
}

__device__ __forceinline__ uint32_t pack2(float a, float b, const __nv_bfloat16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float a, float b, const __half*) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four consecutive elements (a 16-byte f32 or an 8-byte 16-bit access)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack2(u.x, p), b = unpack2(u.y, p);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 x) {
  uint2 u;
  u.x = pack2(x.x, x.y, p);
  u.y = pack2(x.z, x.w, p);
  *reinterpret_cast<uint2*>(p) = u;
}

// W = 1, 2 or 4 consecutive elements as f32
template <int W, typename T>
__device__ __forceinline__ void load_n(const T* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 v = load4(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) x[e] = to_f32(p[e]);
  }
}

template <int W, typename T>
__device__ __forceinline__ void store_n(T* p, const float (&x)[W]) {
  if constexpr (W == 4) {
    store4(p, make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) p[e] = from_f32<T>(x[e]);
  }
}

// The columns a thread of a row of 16 threads (tx = 0..15) owns in a row
// of D: D / 16 of them, in groups of W consecutive ones, group g at
// g * 16 W + tx W. At D >= 64 that is 4-wide groups 64 apart (16-byte
// f32 accesses); a narrow row (D = 16, 32) gives each thread one group of
// D / 16, so no column is padded.
template <int D>
struct RowCols {
  static constexpr int kPer = D / 16;
  static constexpr int kW = kPer < 4 ? kPer : 4;
  static constexpr int kGroups = kPer / kW;
  static __device__ __forceinline__ int col(int g, int tx) { return g * 16 * kW + tx * kW; }
};

}  // namespace
