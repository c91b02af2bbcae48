// Fused int8 dequantize + gather (the resharded int8 pull) for Hopper.
//
// Replaces the Pallas TPU kernel dequant_gather
// (src/repro/kernels/quant/fused.py, its inner _kernel). A resharded
// int8 pull receives one undecoded wire frame per interval; each frame's
// rows that cover the interval are dequantized straight into the
// interval's place in the destination unit payload:
//   out element = (float(q[k]) * scales[k / row_len]) rounded once in f32,
//                 then converted to the frame's dtype (RNE; f64 widens
//                 exactly)
// bit for bit as the NumPy reference (fused_repack_np / _dequant_span).
// Row-grid widening (lead/tail) is never decoded, gaps read 0 (the
// wrapper zero-fills the output first only when the placements do not
// tile it) and passthrough frames are copied over afterwards.
//
// Bound: bytes. Per output element it reads 1 byte of q, 4 bytes of
// scale per row of 256, and writes 2-8 bytes, with one multiply. The TPU
// kernel concatenated every frame's q and scales on the host, built two
// int32 maps per output element (8 bytes of index per element) and held
// q and scales whole in VMEM. Here the kernel reads one descriptor per
// placement (q and scales pointers into the wire frames, frame byte lead,
// byte count, row length, output offset, dtype) from a small device
// table, so the only traffic is q, scales and the output. Design:
// blockIdx.y picks a placement and the blocks along x stride over its
// elements. Where the placement is element-aligned, a thread takes 8
// elements of one row: q in two 4-byte loads, one scale, the output in
// 16-byte stores (one element a thread where q or the output is not
// aligned for that, and for the ragged end); elsewhere it stores the
// bytes of an element that fall in the placement one by one. Every dtype
// the codec quantizes (f32, bf16, f16, f64) and mixed dtypes in one unit
// run here.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDescWords = 8;

// descriptor words (int64): q pointer, scales pointer, lead (frame bytes
// skipped before the placement), nbytes, row_len, out byte offset, dtype
// code (0 f32, 1 bf16, 2 f16, 3 f64), unused
enum { kQ = 0, kS, kLead, kBytes, kRowLen, kOut, kDtype };

__device__ __forceinline__ int itemsize(int code) {
  return code == 0 ? 4 : (code == 3 ? 8 : 2);
}

// row of element k: 32-bit division where it fits (a 64-bit division
// costs tens of instructions)
__device__ __forceinline__ uint64_t row_of(uint64_t k, uint64_t row_len) {
  if ((k >> 32) == 0 && (row_len >> 32) == 0)
    return static_cast<uint32_t>(k) / static_cast<uint32_t>(row_len);
  return k / row_len;
}

__device__ __forceinline__ float dequant(const int8_t* q, const float* s, uint64_t k, uint64_t row_len) {
  return __fmul_rn(static_cast<float>(q[k]), s[row_of(k, row_len)]);
}

template <typename T>
__device__ __forceinline__ T convert(float v);
template <>
__device__ __forceinline__ float convert<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half convert<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ double convert<double>(float v) { return static_cast<double>(v); }

// the element's bytes in its output dtype, little-endian in a u64
__device__ __forceinline__ uint64_t encode(float v, int code) {
  switch (code) {
    case 0: return __float_as_uint(v);
    case 1: return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    case 2: return __half_as_ushort(__float2half_rn(v));
    default: return static_cast<uint64_t>(__double_as_longlong(static_cast<double>(v)));
  }
}

// elements [e0, e0 + cnt) of the frame to dst. Groups of 8 elements that
// share a row load their q as two 4-byte words and one scale, and store
// 16-byte vectors, where q, dst and the row length allow; the rest (or
// all, where they do not) one element a thread.
template <typename T>
__device__ __forceinline__ void dequant_span(const int8_t* __restrict__ q, const float* __restrict__ s,
                                             uint64_t e0, uint64_t cnt, uint64_t row_len,
                                             T* __restrict__ dst, uint64_t tid, uint64_t nthreads) {
  uint64_t done = 0;
  if (row_len % 8 == 0 && e0 % 8 == 0 && reinterpret_cast<uintptr_t>(q + e0) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    const uint64_t groups = cnt / 8;
    for (uint64_t i = tid; i < groups; i += nthreads) {
      const uint64_t k = e0 + 8 * i;
      const uint32_t w[2] = {*reinterpret_cast<const uint32_t*>(q + k),
                             *reinterpret_cast<const uint32_t*>(q + k + 4)};
      const float sc = s[row_of(k, row_len)];
      alignas(16) T v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qj = static_cast<int32_t>(w[j / 4] << (24 - 8 * (j % 4))) >> 24;  // sign-extended byte
        v[j] = convert<T>(__fmul_rn(static_cast<float>(qj), sc));
      }
#pragma unroll
      for (int b = 0; b < static_cast<int>(8 * sizeof(T) / 16); ++b)
        reinterpret_cast<uint4*>(dst + 8 * i)[b] = reinterpret_cast<const uint4*>(v)[b];
    }
    done = groups * 8;
  }
  for (uint64_t i = done + tid; i < cnt; i += nthreads) dst[i] = convert<T>(dequant(q, s, e0 + i, row_len));
}

__global__ void __launch_bounds__(kThreads)
dequant_gather_kernel(const int64_t* __restrict__ desc, int num_placements, uint8_t* __restrict__ out) {
  const uint64_t tid = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint64_t nthreads = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (int p = blockIdx.y; p < num_placements; p += gridDim.y) {
    const int64_t* d = desc + kDescWords * p;
    const int8_t* q = reinterpret_cast<const int8_t*>(d[kQ]);
    const float* s = reinterpret_cast<const float*>(d[kS]);
    const uint64_t lead = static_cast<uint64_t>(d[kLead]);
    const uint64_t nbytes = static_cast<uint64_t>(d[kBytes]);
    const uint64_t row_len = static_cast<uint64_t>(d[kRowLen]);
    const uint64_t uo = static_cast<uint64_t>(d[kOut]);
    const int code = static_cast<int>(d[kDtype]);
    const int isz = itemsize(code);
    uint8_t* dst = out + uo;
    const bool aligned = lead % isz == 0 && nbytes % isz == 0 &&
                         reinterpret_cast<uintptr_t>(dst) % isz == 0;
    if (aligned) {
      const uint64_t e0 = lead / isz;
      const uint64_t cnt = nbytes / isz;
      switch (code) {
        case 0: dequant_span(q, s, e0, cnt, row_len, reinterpret_cast<float*>(dst), tid, nthreads); break;
        case 1: dequant_span(q, s, e0, cnt, row_len, reinterpret_cast<__nv_bfloat16*>(dst), tid, nthreads); break;
        case 2: dequant_span(q, s, e0, cnt, row_len, reinterpret_cast<__half*>(dst), tid, nthreads); break;
        default: dequant_span(q, s, e0, cnt, row_len, reinterpret_cast<double*>(dst), tid, nthreads); break;
      }
    } else {
      for (uint64_t b = tid; b < nbytes; b += nthreads) {
        const uint64_t fb = lead + b;  // byte of the decoded frame
        const uint64_t bits = encode(dequant(q, s, fb / isz, row_len), code);
        dst[b] = static_cast<uint8_t>(bits >> (8 * (fb % isz)));
      }
    }
  }
}

}  // namespace

// desc: device int64 [num_placements, 8] (see the enum above), each
// placement inside its frame and the output (the wrapper checks).
// blocks_x blocks stride over each placement, blocks_y (<= 65535)
// placements are taken at once. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a bad grid).
extern "C" int th_dequant_gather(const void* desc, int num_placements, void* out, int blocks_x,
                                 int blocks_y, void* stream) {
  if (num_placements <= 0 || blocks_x <= 0 || blocks_y <= 0 || blocks_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
  dequant_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), num_placements, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
