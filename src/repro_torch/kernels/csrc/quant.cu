// Symmetric per-row int8 quantization (the int8 wire codec) for Hopper.
//
// Replaces the Pallas TPU kernel quantize_rows
// (src/repro/kernels/quant/kernel.py, _quant_kernel). For each row of 256
// elements of a flat bf16, f16 or f32 input:
//   scale = max(absmax / 127, 1e-12)
//   q     = clip(rint(x / scale), -127, 127)   (round half to even)
// A ragged last row reads zeros past n, exactly like the codec's zero
// padding. The result must equal the NumPy reference
// (Int8Codec._quant_rows, numpy branch) bit for bit, in q and in scales:
// replicas seeded over int8 chain raw pulls off each other and verify
// checksums, so one scale rounded differently breaks a mixed cluster.
// Hence true IEEE division (no --use_fast_math, no __fdividef, no
// reciprocal multiply) and rintf.
//
// Bound: bytes. Per element it reads 2 or 4 bytes and writes 1 (plus 4
// per 256 for the scale), with a few float ops, far below the card's
// compute rate. Design: one warp per row, 8 elements per lane, so a
// lane's elements arrive in one or two 16-byte loads and its q in one
// 8-byte store; the absmax is a warp shuffle reduction and never touches
// shared memory. Narrow inputs are upcast in registers, so no f32 copy of
// a 1 GiB chunk is ever materialized.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowLen = 256;
constexpr int kPerLane = kRowLen / 32;  // 8
constexpr int kThreads = 256;           // 8 rows per block
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, uint64_t n, int8_t* __restrict__ q,
             float* __restrict__ scales, uint64_t rows, bool vec_ok) {
  const int lane = threadIdx.x & 31;
  const uint64_t row = static_cast<uint64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const uint64_t base = row * kRowLen + static_cast<uint64_t>(lane) * kPerLane;

  float v[kPerLane];
  if (vec_ok && base + kPerLane <= n) {
    alignas(16) T buf[kPerLane];
    constexpr int kLoads = kPerLane * sizeof(T) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) reinterpret_cast<uint4*>(buf)[j] = __ldg(src + j);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) v[k] = to_f32(buf[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) v[k] = (base + k < n) ? to_f32(x[base + k]) : 0.0f;
  }

  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) amax = fmaxf(amax, fabsf(v[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, off));

  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  alignas(8) int8_t out[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const float r = rintf(__fdiv_rn(v[k], scale));
    out[k] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
  *reinterpret_cast<uint2*>(q + base) = *reinterpret_cast<const uint2*>(out);
  if (lane == 0) scales[row] = scale;
}

template <typename T>
void launch(const void* x, uint64_t n, void* q, void* scales, uint64_t rows, cudaStream_t s) {
  const bool vec_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const uint64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quant_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), n, static_cast<int8_t*>(q), static_cast<float*>(scales), rows,
      vec_ok);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q holds rows * 256 int8 (the
// padded tail included), scales rows floats, rows == ceil(n / 256) > 0.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unknown dtype code).
extern "C" int th_quantize_rows(const void* x, int dtype, uint64_t n, void* q, void* scales,
                                uint64_t rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, n, q, scales, rows, s); break;
    case 1: launch<__nv_bfloat16>(x, n, q, scales, rows, s); break;
    case 2: launch<__half>(x, n, q, scales, rows, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
