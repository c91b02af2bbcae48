// Flash attention (online softmax) for Hopper, f32 arithmetic on the CUDA
// cores.
//
// Replaces the Pallas TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention/kernel.py, _flash_kernel). For query
// head row b*Hq + h against KV row b*Hkv + h / G (G = Hq / Hkv, GQA):
//   s   = (q . k) * (1 / sqrt(D))          f32 dot, scale after it
//   s   = c * tanh(s / c)                  when softcap c > 0
//   s   = -1e30 where key j >= kv_len, or (causal) j > q_offset + i
//   out = softmax(s) v                     online: m, l, acc in f32
// with the TPU kernel's numerics: -1e30 (not -inf) for masked scores,
// alpha = exp(m_prev - m_cur), l = l * alpha + sum(p), and the final
// acc / max(l, 1e-30), rounded once to the input dtype. With q_offset = 0
// and kv_len = Sk it computes what the TPU kernel computes; the two
// runtime arguments are what the model's decode step needs (one query at
// position cache_len against a cache of which cache_len + 1 slots hold
// keys).
//
// Bound: at the serving path's prefill shape (16 x 32 heads x 512 x 128,
// bf16, causal) the work is 34.4 GFLOP of live q.k pairs against 168 MB of
// q, k, v and o: operations, 0.035 ms at the tensor cores' 989 TFLOP/s
// against 0.050 ms for the bytes at 3.35 TB/s, so the bytes bound it by a
// hair; the decode step (one query a head, 37.7 MB of cache at kv_len 576)
// is bound by bytes alone. This first version does not chase either bound:
// it computes in f32 FMAs on the CUDA cores (67 TFLOP/s at most), so it is
// bound by operations and by shared-memory reads, far from both bounds.
// `wgmma` and TMA are the next version's work.
//
// Design. The TPU kernel carries m, l and acc in VMEM across a sequential
// grid axis over key tiles; Hopper blocks run in no order, so here one
// block of 256 threads owns a tile of 64 query rows and loops over the key
// tiles itself, with m and l in registers and each K/V tile staged through
// shared memory as f32. The G query heads that share a KV head are packed
// into the same tile (row r is query i0 + r / G of head hk * G + r % G), so
// each K/V tile loaded serves all of them, and a decode step (Sq = 1) fills
// G of the 64 rows rather than 1. A block loops only over the key tiles
// that hold a live key: tiles at or past kv_len, and (causal) past the
// tile's last query position, are skipped, not masked, so a decode step's
// cost follows cache_len, not the cache's length. Within a tile a 16 x 16
// thread grid computes the 64 x BK scores (4 x BK/16 a thread, from Q and
// K stored transposed so both operands are vector loads), reduces row max
// and row sum over the 16 threads that share a row by shuffles, writes
// P transposed to shared memory and accumulates P V into 4 x D/16 outputs
// a thread. Causal blocks with the most key tiles are launched first.
// f32, bf16 and f16 at head_dim 16, 32, 64, 128 and 256: the outputs'
// columns follow RowCols (vec.cuh), 4-wide groups 64 apart from head_dim
// 64 up and one group of D/16 columns a thread below it (the training
// entry point's reduced config has head_dim 16), so D is never padded.
//
// Inputs are strided in batch, head and sequence (unit stride in D), so
// the wrapper hands over views without copies; each row must be aligned
// for the 4-element vector loads. Keys past the live range load as zeros.
//
// For the backward (flash_attention_bwd.cu) the kernel also writes each
// row's log-sum-exp, m + log(max(l, 1e-30)) in f32, to lse [B, Hq, Sq]
// when the pointer is not null (the serving path passes null).

#include <cmath>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kBQ = 64;        // packed query rows a block
constexpr int kPad = 4;        // floats of padding on transposed rows
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Hq, Sq] or null
  long long qs[3], ks[3], vs[3], os[3];  // element strides: batch, head, sequence
  int hkv, group, sq, q_per_tile, num_q_tiles, causal, q_offset, kv_len;
  float scale, softcap;
};

template <int D, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(D) * (kBQ + kPad) + size_t(D) * (BK + kPad) + size_t(BK) * D + size_t(BK) * (kBQ + kPad));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr int RN = BK / 16;   // score columns a thread
  using C = RowCols<D>;         // output columns a thread
  constexpr int QP = kBQ + kPad;
  constexpr int KP = BK + kPad;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][QP]  Q transposed
  float* kt = qt + D * QP;                      // [D][KP]  K tile transposed
  float* vs = kt + D * KP;                      // [BK][D]  V tile
  float* pt = vs + BK * D;                      // [BK][QP] P transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nbkv = gridDim.x / p.num_q_tiles;
  const int bkv = blockIdx.x % nbkv;
  const int qtile = p.num_q_tiles - 1 - blockIdx.x / nbkv;  // longest causal tiles first
  const int b = bkv / p.hkv, hk = bkv % p.hkv;
  const int i0 = qtile * p.q_per_tile;
  const int rows = p.q_per_tile * p.group;

  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];

  // Q tile, transposed into qt[d][r]; rows past the queries load zeros
  for (int idx = tid; idx < kBQ * (D / 4); idx += kThreads) {
    const int r = idx % kBQ, d = (idx / kBQ) * 4;
    const int i = i0 + r / p.group;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && i < p.sq) {
      const int h = hk * p.group + r % p.group;
      x = load4(qg + b * p.qs[0] + h * p.qs[1] + i * p.qs[2] + d);
    }
    qt[(d + 0) * QP + r] = x.x;
    qt[(d + 1) * QP + r] = x.y;
    qt[(d + 2) * QP + r] = x.z;
    qt[(d + 3) * QP + r] = x.w;
  }

  int qpos[4];  // positions of this thread's four rows
#pragma unroll
  for (int a = 0; a < 4; ++a) qpos[a] = p.q_offset + i0 + (ty * 4 + a) / p.group;

  // live keys: [0, kv_end); tiles past it are skipped (the TPU kernel's `live`)
  const int i_last = min(p.sq, i0 + p.q_per_tile) - 1;
  const int kv_end = p.causal ? min(p.kv_len, p.q_offset + i_last + 1) : p.kv_len;
  const int ntiles = (kv_end + BK - 1) / BK;

  float m[4], l[4], acc[4][C::kPer];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) acc[a][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's reads are done (and qt is visible)
    for (int idx = tid; idx < BK * (D / 4); idx += kThreads) {
      const int j = idx % BK, d = (idx / BK) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < kv_end) x = load4(kg + (k0 + j) * p.ks[2] + d);
      kt[(d + 0) * KP + j] = x.x;
      kt[(d + 1) * KP + j] = x.y;
      kt[(d + 2) * KP + j] = x.z;
      kt[(d + 3) * KP + j] = x.w;
    }
    for (int idx = tid; idx < BK * (D / 4); idx += kThreads) {
      const int j = idx / (D / 4), d = (idx % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < kv_end) x = load4(vg + (k0 + j) * p.vs[2] + d);
      *reinterpret_cast<float4*>(vs + j * D + d) = x;
    }
    __syncthreads();

    // scores of rows ty*4 + a, columns tx*RN + c
    float s[4][RN];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < RN; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * QP + ty * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kv[RN];
      if constexpr (RN == 4) {
        const float4 kb = *reinterpret_cast<const float4*>(kt + d * KP + tx * 4);
        kv[0] = kb.x; kv[1] = kb.y; kv[2] = kb.z; kv[3] = kb.w;
      } else {
        const float2 kb = *reinterpret_cast<const float2*>(kt + d * KP + tx * 2);
        kv[0] = kb.x; kv[1] = kb.y;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < RN; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        float x = s[a][c] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const int kpos = k0 + tx * RN + c;
        const bool ok = kpos < p.kv_len && (!p.causal || kpos <= qpos[a]);
        s[a][c] = ok ? x : kNegInf;
        rmax = fmaxf(rmax, s[a][c]);
      }
      // the 16 threads of a row are one half warp (lanes differ in tx only)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xFFFFFFFFu, rmax, off));
      const float m_cur = fmaxf(m[a], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        s[a][c] = expf(s[a][c] - m_cur);
        rsum += s[a][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xFFFFFFFFu, rsum, off);
      const float alpha = expf(m[a] - m_cur);
      l[a] = l[a] * alpha + rsum;
      m[a] = m_cur;
#pragma unroll
      for (int c = 0; c < C::kPer; ++c) acc[a][c] *= alpha;
#pragma unroll
      for (int c = 0; c < RN; ++c) pt[(tx * RN + c) * QP + ty * 4 + a] = s[a][c];
    }
    __syncthreads();

    // acc[a][g*W + e] += sum_j P[row a][j] * V[j][C::col(g, tx) + e]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(pt + j * QP + ty * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < C::kGroups; ++g) {
        float vv[C::kW];
        load_n<C::kW>(vs + j * D + C::col(g, tx), vv);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < C::kW; ++e) acc[a][g * C::kW + e] = fmaf(pv[a], vv[e], acc[a][g * C::kW + e]);
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    const int i = i0 + r / p.group;
    if (r >= rows || i >= p.sq) continue;
    const int h = hk * p.group + r % p.group;
    const float den = fmaxf(l[a], 1e-30f);
    // m and l are the same in the 16 threads of the row
    if (p.lse != nullptr && tx == 0) p.lse[(static_cast<long long>(b) * p.hkv * p.group + h) * p.sq + i] = m[a] + logf(den);
    T* orow = og + b * p.os[0] + h * p.os[1] + i * p.os[2];
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      float x[C::kW];
#pragma unroll
      for (int e = 0; e < C::kW; ++e) x[e] = acc[a][g * C::kW + e] / den;
      store_n<C::kW>(orow + C::col(g, tx), x);
    }
  }
}

template <typename T, int D, int BK>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, BK>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_kernel<T, D, BK><<<blocks, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int d, int blocks, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, 64>(p, blocks, stream);
    case 32: return launch<T, 32, 64>(p, blocks, stream);
    case 64: return launch<T, 64, 64>(p, blocks, stream);
    case 128: return launch<T, 128, 64>(p, blocks, stream);
    case 256: return launch<T, 256, 32>(p, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], o [B, Hq, Sq, D], each given by
// its pointer and its (batch, head, sequence) element strides in
// `strides` (a host array of 12: q, k, v, o); dtype 0 = float32,
// 1 = bfloat16, 2 = float16; D in {16, 32, 64, 128, 256}; Hq / Hkv <= 64;
// 1 <= kv_len <= Sk;
// lse f32 [B, Hq, Sq] or null. Returns cudaGetLastError() after the launch.
extern "C" int th_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  const long long* strides, int dtype, int batch, int hq,
                                  int hkv, int sq, int d, int causal, float softcap,
                                  int q_offset, int kv_len, float* lse, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.hkv = hkv;
  p.group = hq / hkv;
  p.sq = sq;
  p.q_per_tile = kBQ / p.group;
  p.num_q_tiles = (sq + p.q_per_tile - 1) / p.q_per_tile;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));  // as the TPU kernel's Python scalar
  p.softcap = softcap;
  const int blocks = p.num_q_tiles * batch * hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(p, d, blocks, s);
    case 1: return dispatch<__nv_bfloat16>(p, d, blocks, s);
    case 2: return dispatch<__half>(p, d, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
