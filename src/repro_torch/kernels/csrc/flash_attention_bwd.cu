// The flash-attention backward for Hopper, f32 arithmetic on the CUDA
// cores: dQ, dK and dV of the forward kernels (flash_attention.cu,
// flash_attention_tc.cu), which is what the training step needs from
// every layer. This is the `cuda_core` backward route: f32, f16 and bf16
// at head_dim 16, 32, 64 and 128, every call the tensor-core backward
// (flash_attention_bwd_tc.cu, bf16 at head_dim 64/128) does not take.
//
// The JAX package has no Pallas backward: it differentiates its jnp
// chunked_attention (src/repro/models/layers.py) with jax.grad, so this
// is the backward of the TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention/kernel.py) that the port's forward
// replaces. For query head h of batch b against KV head h / G (GQA):
//   s   = (q . k) * (1 / sqrt(D));  s_c = c tanh(s / c) under a softcap c
//   P   = exp(s_c - lse)            lse written by the forward, per row
//   dV  = P^T dO                    summed over the G heads of the group
//   dP  = dO V^T,   D_i = rowsum(dO * O)
//   dS  = P * (dP - D_i) * (1 - (s_c / c)^2)   (the last factor only
//                                               under a softcap)
//   dQ  = dS K * scale,   dK = dS^T Q * scale   (dK summed over the group)
// with the forward's masks: key j is live for row i when j < kv_len and
// (causal) j <= q_offset + i; a masked pair contributes nothing (its P is
// 0). Keys past kv_len get zero gradients. What attention_backward_plain
// (kernels/flash_attention/__init__.py) computes in plain PyTorch.
//
// Bound: at the training step's shape (q [16, 32, 576, 128], k/v
// [16, 8, 576, 128], bf16, causal) five products of 2 D FLOPs a live
// (query, key) pair over 85 M live pairs are 0.109 TFLOP, 0.110 ms at the
// tensor cores' 989 TFLOP/s; q, o, dO, dQ, k, v, dK, dV and the lse once
// each are 379 MB, 0.113 ms at 3.35 TB/s. This first version does not
// chase either bound: its products run as f32 FMAs on the CUDA cores
// (67 TFLOP/s at most) and it recomputes S and dP in both kernels (seven
// products, not five), so it is bound by operations and shared-memory
// reads, far from both bounds. wgmma and TMA are a later version's work.
//
// Design. No atomics, so the result is deterministic: two kernels, each
// owning its outputs.
//  * dK/dV: one block of 256 threads a (batch, KV head, 64-key tile). It
//    holds its K and V tiles in shared memory and dK, dV in registers,
//    and walks the 64-row query tiles of the group's G heads that can
//    see its keys (causal: from the first tile whose last row reaches
//    the tile's first key). Per query tile it loads Q and dO, computes
//    D_i of its rows on the fly from dO and the forward's output O, then
//    the score tile S and dP, P and dS into shared memory, and
//    accumulates dV += P^T dO and dK += dS^T Q.
//  * dQ: one block a (batch, query head, 64-row query tile). It holds Q
//    and dO (and lse, D_i) in shared memory and dQ in registers, and
//    walks the key tiles up to the causal / kv_len edge (tiles past it
//    are skipped, as in the forward), accumulating dQ += dS K.
// Tiles are row-major in shared memory with 4 floats of padding a row, so
// a 16-byte load of 8 consecutive rows hits 8 different bank groups. A
// thread of the 16 x 16 grid scores rows ty*4 + a against keys tx + 16c
// (a, c < 4), and accumulates rows ty*4 + a against its columns of
// RowCols (vec.cuh): tx*4 + 64g from head_dim 64 up, one group of D/16
// below it, so head_dim 16 and 32 are not padded.
// The longest blocks are launched first (small key tiles for dK/dV, late
// query tiles for dQ).
//
// Inputs are strided in batch, head and sequence (unit stride in D, rows
// aligned for 4-element vector loads); outputs likewise.

#include <cmath>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kT = 64;         // rows of a query tile and keys of a key tile
constexpr int kTP = kT + 4;    // padded row of a P / dS tile

struct BwdParams {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;  // [B, Hq, Sq]
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];  // batch, head, sequence
  int batch, hq, hkv, group, sq, sk, causal, q_offset, kv_len;
  float scale, softcap;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// rows [row0, row0 + 64) of a [S, D] slab (sequence stride `stride`) into
// a padded f32 tile; rows at or past `n` load as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride, int row0, int n) {
  constexpr int DP = D + 4;
  for (int idx = threadIdx.x; idx < kT * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) x = load4(src + static_cast<long long>(row0 + r) * stride + d);
    store4(dst + r * DP + d, x);
  }
}

// lse and D_i = rowsum(dO * O) of the query tile's 64 rows: four threads
// a row (needs the dO tile in shared memory)
template <typename T, int D>
__device__ __forceinline__ void row_stats(const BwdParams& p, int b, int h, int i0, const float* dos,
                                          float* lse_s, float* di_s) {
  constexpr int DP = D + 4;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const int i = i0 + r;
  float acc = 0.f;
  if (i < p.sq) {
    const T* orow = static_cast<const T*>(p.o) + b * p.os[0] + h * p.os[1] + static_cast<long long>(i) * p.os[2];
    for (int d = part * 4; d < D; d += 16) acc += dot4(load4(orow + d), load4(dos + r * DP + d));
  }
  acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 1);
  acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 2);
  if (part == 0) {
    di_s[r] = acc;
    lse_s[r] = i < p.sq ? p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + i] : 0.f;
  }
}

// P and dS of a 64 x 64 (query rows i0.., keys k0..) tile from the Q, dO,
// K, V tiles in shared memory: this thread's rows ty*4 + a, keys tx + 16c
template <int D>
__device__ __forceinline__ void score_tile(const BwdParams& p, int i0, int k0, const float* qs, const float* dos,
                                           const float* ks, const float* vs, const float* lse_s,
                                           const float* di_s, float (&pr)[4][4], float (&ds)[4][4]) {
  constexpr int DP = D + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qa[4], ga[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = load4(qs + (ty * 4 + a) * DP + d);
      ga[a] = load4(dos + (ty * 4 + a) * DP + d);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 kc = load4(ks + (tx + 16 * c) * DP + d);
      const float4 vc = load4(vs + (tx + 16 * c) * DP + d);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        s[a][c] += dot4(qa[a], kc);
        dp[a][c] += dot4(ga[a], vc);
      }
    }
  }
  const bool capped = p.softcap > 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    const int i = i0 + r;
    const float lse = lse_s[r], di = di_s[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      const bool live = i < p.sq && j < p.kv_len && (!p.causal || j <= p.q_offset + i);
      float x = s[a][c] * p.scale;
      float t = 0.f;
      if (capped) {
        t = tanhf(x / p.softcap);
        x = p.softcap * t;
      }
      const float pv = live ? expf(x - lse) : 0.f;
      float g = pv * (dp[a][c] - di);
      if (capped) g *= 1.f - t * t;
      pr[a][c] = pv;
      ds[a][c] = g;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * size_t(kT) * (D + 4) + 2 * size_t(kT) * kTP + 2 * kT);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int DP = D + 4;
  using C = RowCols<D>;  // accumulator columns a thread
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [64][DP]
  float* vs = ks + kT * DP;
  float* qs = vs + kT * DP;
  float* dos = qs + kT * DP;
  float* ps = dos + kT * DP;  // [64 rows][kTP]
  float* dss = ps + kT * kTP;
  float* lse_s = dss + kT * kTP;
  float* di_s = lse_s + kT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nbkv = p.batch * p.hkv;
  const int bkv = blockIdx.x % nbkv;
  const int k0 = (blockIdx.x / nbkv) * kT;  // the first key tiles (the most query rows) first
  const int b = bkv / p.hkv, hk = bkv % p.hkv;

  float dk[4][C::kPer], dv[4][C::kPer];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) dk[a][c] = dv[a][c] = 0.f;

  const int nq = (p.sq + kT - 1) / kT;
  // query tiles whose rows can see a key of this tile (none if it starts
  // at or past kv_len)
  const int first = p.causal ? max(0, k0 - p.q_offset) / kT : 0;
  const int qt_begin = k0 < p.kv_len ? first : nq;

  if (qt_begin < nq) {
    load_tile<T, D>(ks, static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1], p.ks[2], k0, p.kv_len);
    load_tile<T, D>(vs, static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1], p.vs[2], k0, p.kv_len);
  }
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
    const T* dog = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[1];
    for (int qt = qt_begin; qt < nq; ++qt) {
      const int i0 = qt * kT;
      __syncthreads();  // the last tile's reads of qs, dos, ps, dss are done
      load_tile<T, D>(qs, qg, p.qs[2], i0, p.sq);
      load_tile<T, D>(dos, dog, p.dos[2], i0, p.sq);
      __syncthreads();
      row_stats<T, D>(p, b, h, i0, dos, lse_s, di_s);
      __syncthreads();
      float pr[4][4], ds[4][4];
      score_tile<D>(p, i0, k0, qs, dos, ks, vs, lse_s, di_s, pr, ds);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(ty * 4 + a) * kTP + tx + 16 * c] = pr[a][c];
          dss[(ty * 4 + a) * kTP + tx + 16 * c] = ds[a][c];
        }
      __syncthreads();
      // dV[j] += sum_r P[r][j] dO[r], dK[j] += sum_r dS[r][j] Q[r] for this
      // thread's keys j = ty*4 + a and columns C::col(g, tx) + e
#pragma unroll 4
      for (int r = 0; r < kT; ++r) {
        const float4 pp = load4(ps + r * kTP + ty * 4);
        const float4 dd = load4(dss + r * kTP + ty * 4);
        const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
        const float da[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int g = 0; g < C::kGroups; ++g) {
          float o[C::kW], q[C::kW];
          load_n<C::kW>(dos + r * DP + C::col(g, tx), o);
          load_n<C::kW>(qs + r * DP + C::col(g, tx), q);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < C::kW; ++e) {
              dv[a][g * C::kW + e] = fmaf(pa[a], o[e], dv[a][g * C::kW + e]);
              dk[a][g * C::kW + e] = fmaf(da[a], q[e], dk[a][g * C::kW + e]);
            }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dks[0] + hk * p.dks[1];
  T* dvg = static_cast<T*>(p.dv) + b * p.dvs[0] + hk * p.dvs[1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty * 4 + a;
    if (j >= p.sk) continue;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      float xk[C::kW], xv[C::kW];
#pragma unroll
      for (int e = 0; e < C::kW; ++e) {
        xk[e] = dk[a][g * C::kW + e] * p.scale;
        xv[e] = dv[a][g * C::kW + e];
      }
      store_n<C::kW>(dkg + static_cast<long long>(j) * p.dks[2] + C::col(g, tx), xk);
      store_n<C::kW>(dvg + static_cast<long long>(j) * p.dvs[2] + C::col(g, tx), xv);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return dkdv_smem<D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int DP = D + 4;
  using C = RowCols<D>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kT * DP;
  float* qs = vs + kT * DP;
  float* dos = qs + kT * DP;
  float* dss = dos + kT * DP + kT * kTP;  // the P tile's slot stays unused here
  float* lse_s = dss + kT * kTP;
  float* di_s = lse_s + kT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (p.sq + kT - 1) / kT;
  const int nbh = p.batch * p.hq;
  const int bh = blockIdx.x % nbh;
  const int qt = nq - 1 - blockIdx.x / nbh;  // the last query tiles (the most keys) first
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int i0 = qt * kT;

  load_tile<T, D>(qs, static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1], p.qs[2], i0, p.sq);
  load_tile<T, D>(dos, static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[1], p.dos[2], i0, p.sq);
  __syncthreads();
  row_stats<T, D>(p, b, h, i0, dos, lse_s, di_s);

  // live keys [0, kv_end); tiles past it are skipped
  const int i_last = min(p.sq, i0 + kT) - 1;
  const int kv_end = p.causal ? min(p.kv_len, p.q_offset + i_last + 1) : p.kv_len;
  const int ntiles = (kv_end + kT - 1) / kT;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];

  float dq[4][C::kPer];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) dq[a][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kT;
    __syncthreads();  // the last tile's reads of ks and dss are done (and lse_s, di_s visible)
    load_tile<T, D>(ks, kg, p.ks[2], k0, kv_end);
    load_tile<T, D>(vs, vg, p.vs[2], k0, kv_end);
    __syncthreads();
    float pr[4][4], ds[4][4];
    score_tile<D>(p, i0, k0, qs, dos, ks, vs, lse_s, di_s, pr, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dss[(ty * 4 + a) * kTP + tx + 16 * c] = ds[a][c];
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j] for this thread's rows i = ty*4 + a and
    // columns C::col(g, tx) + e
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float da[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = dss[(ty * 4 + a) * kTP + j];
#pragma unroll
      for (int g = 0; g < C::kGroups; ++g) {
        float kv[C::kW];
        load_n<C::kW>(ks + j * DP + C::col(g, tx), kv);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < C::kW; ++e) dq[a][g * C::kW + e] = fmaf(da[a], kv[e], dq[a][g * C::kW + e]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= p.sq) continue;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      float x[C::kW];
#pragma unroll
      for (int e = 0; e < C::kW; ++e) x[e] = dq[a][g * C::kW + e] * p.scale;
      store_n<C::kW>(dqg + static_cast<long long>(i) * p.dqs[2] + C::col(g, tx), x);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t bytes, int blocks, const BwdParams& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                      void* dk, void* dv, const float* lse, const long long* strides, int batch, int hq, int hkv,
                      int sq, int sk, int d, int causal, float softcap, int q_offset, int kv_len) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  long long* dst[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.batch = batch;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));  // as the forward's
  p.softcap = softcap;
  return p;
}

template <typename T>
int dispatch_dkdv(const BwdParams& p, int d, cudaStream_t s) {
  const int blocks = p.batch * p.hkv * ((p.sk + kT - 1) / kT);
  switch (d) {
    case 16: return launch(flash_bwd_dkdv_kernel<T, 16>, dkdv_smem<16>(), blocks, p, s);
    case 32: return launch(flash_bwd_dkdv_kernel<T, 32>, dkdv_smem<32>(), blocks, p, s);
    case 64: return launch(flash_bwd_dkdv_kernel<T, 64>, dkdv_smem<64>(), blocks, p, s);
    case 128: return launch(flash_bwd_dkdv_kernel<T, 128>, dkdv_smem<128>(), blocks, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dq(const BwdParams& p, int d, cudaStream_t s) {
  const int blocks = p.batch * p.hq * ((p.sq + kT - 1) / kT);
  switch (d) {
    case 16: return launch(flash_bwd_dq_kernel<T, 16>, dq_smem<16>(), blocks, p, s);
    case 32: return launch(flash_bwd_dq_kernel<T, 32>, dq_smem<32>(), blocks, p, s);
    case 64: return launch(flash_bwd_dq_kernel<T, 64>, dq_smem<64>(), blocks, p, s);
    case 128: return launch(flash_bwd_dq_kernel<T, 128>, dq_smem<128>(), blocks, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq [B, Hq, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D]: pointers,
// and their (batch, head, sequence) element strides in `strides` (a host
// array of 24 in the order q, k, v, o, dout, dq, dk, dv); lse f32
// [B, Hq, Sq] contiguous, from the forward; dtype 0 = float32,
// 1 = bfloat16, 2 = float16 (every tensor but lse); D in {16, 32, 64,
// 128}; 1 <= kv_len <= Sk.
// th_flash_bwd_dkdv writes dk and dv (zeros past kv_len),
// th_flash_bwd_dq writes dq. Each returns cudaGetLastError() after its
// launch.
extern "C" int th_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 void* dq, void* dk, void* dv, const float* lse, const long long* strides,
                                 int dtype, int batch, int hq, int hkv, int sq, int sk, int d, int causal,
                                 float softcap, int q_offset, int kv_len, void* stream) {
  const BwdParams p = make_params(q, k, v, o, dout, dq, dk, dv, lse, strides, batch, hq, hkv, sq, sk, d, causal,
                                  softcap, q_offset, kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dkdv<float>(p, d, s);
    case 1: return dispatch_dkdv<__nv_bfloat16>(p, d, s);
    case 2: return dispatch_dkdv<__half>(p, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int th_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               void* dq, void* dk, void* dv, const float* lse, const long long* strides, int dtype,
                               int batch, int hq, int hkv, int sq, int sk, int d, int causal, float softcap,
                               int q_offset, int kv_len, void* stream) {
  const BwdParams p = make_params(q, k, v, o, dout, dq, dk, dv, lse, strides, batch, hq, hkv, sq, sk, d, causal,
                                  softcap, q_offset, kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dq<float>(p, d, s);
    case 1: return dispatch_dq<__nv_bfloat16>(p, d, s);
    case 2: return dispatch_dq<__half>(p, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
