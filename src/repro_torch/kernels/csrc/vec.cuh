// Element access and tile machinery shared by the CUDA-core flash kernels
// (flash_attention.cu, flash_attention_bwd.cu): f32, bf16 and f16 rows
// read and written as f32, four elements at a time or a thread's few
// columns of a narrow row; 16-byte asynchronous copies (cp.async) of
// tiles into shared memory in the 16-byte-chunk XOR swizzle; the packed
// query rows of a GQA group; and the two register micro-tile products.

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

// -- asynchronous tile copies ---------------------------------------------------

// 16 bytes from global into shared memory, or 16 zero bytes when `valid`
// is false (src-size 0: nothing is read, so a dead slot's NaN never lands)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// A row-major tile of rows of D elements of T in shared memory, unpadded,
// in 16-byte chunks whose index is XORed with a function of the row: any 8
// consecutive rows put a given chunk on 8 different bank groups, so a
// warp's 16-byte reads of 8 (or 16) rows at one column are conflict-free,
// and so are its reads of 16 consecutive chunks of one row. f(r) depends
// on r mod 8 only, so a thread whose rows lie 8 apart has one swizzle.
template <typename T, int D>
struct Swz {
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  static constexpr int kCh = D / kChunk;                            // chunks a row
  static constexpr int kRowsPerLine = kCh >= 8 ? 1 : 8 / kCh;      // rows a 128-byte line
  static constexpr int kMask = (kCh >= 8 ? 8 : kCh) - 1;
  static __device__ __forceinline__ int f(int r) { return (r / kRowsPerLine) & kMask; }
  // the element offset within a row of element e under the swizzle f
  static __device__ __forceinline__ int col(int e, int fr) { return ((e / kChunk) ^ fr) * kChunk + e % kChunk; }
  static __device__ __forceinline__ int at(int r, int e) { return r * D + col(e, f(r)); }
};

// Copy R rows into a swizzled tile: row r from `src(r)` (a row pointer, or
// null for a row of zeros); every thread of the block (NT) issues its chunks.
// A source row holds DL <= D elements (a whole number of chunks): the
// tile's columns from DL on are zeros, and nothing past DL is read (a row
// of the reduced deepseek-v3's q/k, 24 wide, in a tile of 32).
template <typename T, int D, int R, int NT, int DL = D, typename RowPtr>
__device__ __forceinline__ void copy_tile(T* dst, RowPtr src, const T* any) {
  using S = Swz<T, D>;
  static_assert(NT % S::kCh == 0, "a row's chunks within one pass");
  static_assert(DL <= D && DL % S::kChunk == 0, "whole chunks of a row");
  const int c = threadIdx.x % S::kCh;
  const bool col_ok = DL == D || c * S::kChunk < DL;
  for (int r = threadIdx.x / S::kCh; r < R; r += NT / S::kCh) {
    const T* row = src(r);
    const bool ok = row != nullptr && col_ok;
    cp_async16(dst + S::at(r, c * S::kChunk), ok ? row + c * S::kChunk : any, ok);
  }
}

// Copy rows [0, R) of a swizzled tile from rows row0 + r of a source whose
// rows are `stride` elements apart, issued by every thread of the block
// (NT); rows at or past n are zeros, and so are the columns from DL on (as
// copy_tile's). A thread's rows lie NT / kCh apart, so where that is a
// multiple of 8 its chunk keeps one swizzle and its addresses advance by
// constants.
template <typename T, int D, int R, int NT, int DL = D>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long stride, int row0, int n) {
  using S = Swz<T, D>;
  static_assert(DL <= D && DL % S::kChunk == 0, "whole chunks of a row");
  constexpr int kStep = NT / S::kCh;
  const int c = threadIdx.x % S::kCh;
  const bool col_ok = DL == D || c * S::kChunk < DL;
  int r = threadIdx.x / S::kCh;
  if constexpr (kStep % 8 == 0) {
    const T* s = src + (row0 + r) * stride + c * S::kChunk;
    T* d = dst + S::at(r, c * S::kChunk);
    for (; r < R; r += kStep, s += kStep * stride, d += kStep * D) {
      const bool ok = row0 + r < n && col_ok;
      cp_async16(d, ok ? s : src, ok);
    }
  } else {
    for (; r < R; r += kStep) {
      const bool ok = row0 + r < n && col_ok;
      cp_async16(dst + S::at(r, c * S::kChunk), ok ? src + (row0 + r) * stride + c * S::kChunk : src, ok);
    }
  }
}

// -- packed query rows -----------------------------------------------------------

// The G query heads of a KV head share its K and V, so a tile of query rows
// packs them: a sub-tile of 64 rows holds qpt = 64 / G positions x G heads
// (row r is head r % G at position sub * qpt + r / G; rows from qpt * G on,
// and positions past Sq, are padding). Every (head, position) of the group
// lies in exactly one row of one sub-tile. r / G is taken as (r + 1/2) / G
// in f32 (inv_group = 1 / G): exact for r < 64 and G <= 64, where the
// fraction stays at least 1 / 128 away from the next integer, and a few
// instructions where an integer division takes dozens.
constexpr int kSub = 64;

__device__ __forceinline__ bool packed_row(int group, float inv_group, int qpt, int sq, int sub, int r, int& g,
                                           int& pos) {
  const int q = __float2int_rz((static_cast<float>(r) + 0.5f) * inv_group);
  g = r - q * group;
  pos = sub * qpt + q;
  return r < qpt * group && pos < sq;
}

// -- the two register micro-tile products ----------------------------------------

__device__ __forceinline__ float fma4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

// acc[a][c] += A[x0 + XS a] . B[y0 + YS c] over the DN columns from d0: A
// and B row-major swizzled tiles (scores S = Q K^T, dP = dO V^T and their
// transposes, or a part of one over half of D). Each 16-byte (f32) load of
// a thread's RA + RC rows feeds 4 RC or 4 RA FMAs: 8 x 8 gives 4 FMAs a
// float loaded, what the 128 bytes a clock an SM's shared memory delivers
// to its 128 FMA lanes need. XS is a multiple of 8 and YS 4 or a multiple
// of 8, so a thread's A rows share one swizzle and its B rows at most two,
// and every read is at an immediate offset from one of them.
template <typename T, int D, int DN, int RA, int RC, int XS, int YS>
__device__ __forceinline__ void nt_product(float (&acc)[RA][RC], const T* A, int x0, const T* B, int y0, int d0) {
  using S = Swz<T, D>;
  static_assert(XS % 8 == 0 && (YS % 8 == 0 || YS == 4), "one or two swizzles a thread");
  constexpr int NB = YS % 8 == 0 ? 1 : 2;  // swizzles among B's rows, alternating with c
  const T* ar = A + x0 * D;
  const T* br = B + y0 * D;
  const int fa = S::f(x0);
  int fb[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) fb[n] = S::f(y0 + YS * n);
#pragma unroll 8
  for (int d = d0; d < d0 + DN; d += 4) {
    const int ea = S::col(d, fa);
    int eb[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) eb[n] = S::col(d, fb[n]);
    float4 av[RA], bv[RC];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = load4(ar + a * XS * D + ea);
#pragma unroll
    for (int c = 0; c < RC; ++c) bv[c] = load4(br + c * YS * D + eb[c % NB]);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[a][c] = fma4(av[a], bv[c], acc[a][c]);
  }
}

// acc[a][g W + e] += sum_j P[j][slot0 + a] X[j][RowCols::col(g, tx) + e] for
// j < N: P an f32 tile of pitch PP (P, P^T, dS or dS^T, its rows the
// reduction), X a row-major swizzled tile (V, dO, Q or K); slot0 is a
// multiple of 4, so a thread's RA values of P are RA / 4 16-byte loads
template <typename T, int D, int RA, int PP, int N>
__device__ __forceinline__ void nn_product(float (&acc)[RA][D / 16], const float* P, int slot0, const T* X, int tx) {
  using C = RowCols<D>;
  using S = Swz<T, D>;
#pragma unroll 8
  for (int j = 0; j < N; ++j) {
    float pv[RA];
#pragma unroll
    for (int a = 0; a < RA; a += 4) {
      const float4 t = *reinterpret_cast<const float4*>(P + j * PP + slot0 + a);
      pv[a] = t.x, pv[a + 1] = t.y, pv[a + 2] = t.z, pv[a + 3] = t.w;
    }
    const int fj = S::f(j);
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      float xv[C::kW];
      load_n<C::kW>(X + j * D + S::col(C::col(g, tx), fj), xv);
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int e = 0; e < C::kW; ++e) acc[a][g * C::kW + e] = fmaf(pv[a], xv[e], acc[a][g * C::kW + e]);
    }
  }
}

}  // namespace
