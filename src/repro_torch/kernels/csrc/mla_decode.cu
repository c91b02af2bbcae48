// Absorbed multi-head latent attention for decode (deepseek-v3's MLA), on
// the CUDA cores, split-KV.
//
// The JAX package has no Pallas kernel for it: its absorbed decode
// (src/repro/models/blocks.py, mla_apply with a cache) computes these
// einsums in f32 under XLA. For batch b and query head h, against the
// latent cache ckv [B, Smax, R] and the decoupled rope keys krope [B, Smax,
// rd] (one shared "KV head" of width R + rd for all H query heads):
//   s   = ((q_abs . ckv_t) + (q_rope . krope_t)) * scale    f32
//   s   = -1e30 where slot t >= kv_len                        (no causal term)
//   out = softmax(s) . ckv                                     f32 [B, H, R]
// with R = 512, rd = 64 (deepseek-v3), Sq = 1, and the scale the caller's
// (1 / sqrt(qk_nope + qk_rope) = 1 / sqrt(192), not 1 / sqrt(R + rd)).
//
// Bound: one step reads the live latent rows once (kv_len x 576 bf16 a
// batch, 2.4 MB at the served shape of 4 x 528 slots), the queries (0.6
// MB) and writes the f32 output (1 MB): 1.2 us at 3.35 TB/s, and does 2 x
// H x kv_len x (576 + 512) operations a batch (0.59 GFLOP, 0.6 us at the
// bf16 peak). So it is bound by bytes; the products run as f32 FMAs of
// the bf16 inputs because the reference computes them in f32 (P, too,
// stays f32), which at the CUDA cores' 67 TFLOP/s takes ~9 us for the
// FLOPs alone: this kernel is right and simple first, not at its bound.
//
// Design. The 128 heads share each latent row, so a block takes 64 query
// heads of one batch (half of them) against a split of the keys, and reads
// each 32-key tile of [ckv | krope] rows once into shared memory, where it
// serves as K (all 576 columns) and as V (the first 512): a two-stage ring
// of 16-byte cp.async copies (zeros past the split, so a cache's dead
// slots never reach the math; rows padded by 16 bytes so that threads
// reading different rows hit different banks). The block's queries sit
// beside it in shared memory, [q_abs | q_rope] rows of 576 bf16. A group
// of 16 threads (half a warp) owns 4 heads: for the scores each thread
// takes 2 keys of the tile against the 4 heads, 16-byte chunks of 8
// columns at a time, the latent and rope parts summed apart and then
// added, as the reference's two einsums; the group's online softmax joins
// its 16 threads by shuffles (row max, row sum), so every thread of the
// group holds its heads' m and l; for P V each thread owns 32 of the 512
// columns (4 chunks of 8, 128 apart) of its 4 heads, and takes each key's
// P from the thread that scored it by a shuffle within the group. Each
// split writes its partial (acc [64][512], m, l) in f32 to the scratch the
// wrapper allocated and counts itself done on a per-(batch, head half)
// counter; the block that counts the last split merges the partials in
// split order (M = max m_i, out = sum exp(m_i - M) acc_i / max(sum exp(m_i
// - M) l_i, 1e-30)) and resets the counter, so one launch does the step
// and a rerun gives the same bits. With one split the block writes acc /
// max(l, 1e-30) itself (the merge's value for one split).
//
// Numerics against the reference (f32 einsums, softmax over all slots at
// once): the same f32 operations summed in another order (a thread's
// chunks in order, an online softmax over tiles, then the merge):
// relative differences of order 1e-7 of the output's magnitude.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 64;      // query heads a block: 16 groups of 16 threads, 4 heads a group
constexpr int kTile = 32;       // keys a tile: 2 a thread of a group
constexpr int kR = 512;         // the latent width
constexpr int kRope = 64;       // the rope keys' width
constexpr int kW = kR + kRope;  // a score row: 576
constexpr int kRow = kW + 8;    // a shared row, padded by 16 bytes
constexpr int kChunks = kW / 8;  // 16-byte chunks a row
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;

struct MlaParams {
  const __nv_bfloat16* qa;  // q_abs [B, H, R]
  const __nv_bfloat16* qr;  // q_rope [B, H, rd]
  const __nv_bfloat16* ckv;
  const __nv_bfloat16* kr;
  float* out;       // [B, H, R]
  float* part;      // acc [B * HG][nsplit][kHeads][R], then (m, l) [B * HG][nsplit][kHeads][2]
  int* counters;    // [B * HG] splits done, 0 between calls (the merging block resets its own)
  long long cb, cs, rb, rs;  // element strides of ckv and krope: batch, slot
  int heads, kv_len, keys_per_split, nsplit;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int nbytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(nbytes) : "memory");
}

// 8 bf16 (one 16-byte chunk of shared memory) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// a group's (16 threads, half a warp) max and sum
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
  return x;
}

constexpr size_t kSmemBytes = size_t(kHeads + 2 * kTile) * kRow * 2;

__global__ void __launch_bounds__(kThreads, 1) mla_decode_kernel(const MlaParams p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kHeads][kRow]
  __nv_bfloat16* tiles = qs + kHeads * kRow;                         // [2][kTile][kRow]

  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int nhg = gridDim.y;
  const int h0 = hg * kHeads;
  const int tid = threadIdx.x;
  const int grp = tid / 16, j = tid % 16;  // heads 4 grp .. 4 grp + 3 (local); keys j, j + 16; columns 8 j + 128 c
  const int k_begin = split * p.keys_per_split;
  const int k_end = min(k_begin + p.keys_per_split, p.kv_len);
  const int ntiles = (k_end - k_begin + kTile - 1) / kTile;

  // the queries: [q_abs | q_rope] rows, zeros past the last head
  for (int idx = tid; idx < kHeads * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int h = min(h0 + r, p.heads - 1);
    const __nv_bfloat16* src = c < kR / 8 ? p.qa + (size_t(b) * p.heads + h) * kR + c * 8
                                          : p.qr + (size_t(b) * p.heads + h) * kRope + (c - kR / 8) * 8;
    cp_async16(qs + r * kRow + c * 8, src, h0 + r < p.heads ? 16 : 0);
  }
  auto load_tile = [&](int t, int buf) {
    __nv_bfloat16* dst = tiles + buf * kTile * kRow;
    for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const int key = k_begin + t * kTile + r;
      const int kk = min(key, p.kv_len - 1);
      const __nv_bfloat16* src = c < kR / 8 ? p.ckv + b * p.cb + kk * p.cs + c * 8
                                            : p.kr + b * p.rb + kk * p.rs + (c - kR / 8) * 8;
      cp_async16(dst + r * kRow + c * 8, src, key < k_end ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_tile(0, 0);  // the queries' copies join the first tile's group

  float o[4][32];
#pragma unroll
  for (int hh = 0; hh < 4; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int hh = 0; hh < 4; ++hh) m[hh] = kNegInf, l[hh] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1, (t + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* tile = tiles + (t & 1) * kTile * kRow;

    // scores of keys j and j + 16 against the group's 4 heads: the latent
    // and the rope parts apart, then added, as the reference's two einsums
    float sl[4][2], sr[4][2];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) sl[hh][0] = sl[hh][1] = sr[hh][0] = sr[hh][1] = 0.f;
    const __nv_bfloat16* q0 = qs + 4 * grp * kRow;
    const __nv_bfloat16* k0 = tile + j * kRow;
    const __nv_bfloat16* k1 = tile + (j + 16) * kRow;
#pragma unroll 2
    for (int c = 0; c < kR / 8; ++c) {
      float ka[8], kb[8];
      load8(k0 + c * 8, ka);
      load8(k1 + c * 8, kb);
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        float q[8];
        load8(q0 + hh * kRow + c * 8, q);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sl[hh][0] = fmaf(q[e], ka[e], sl[hh][0]);
          sl[hh][1] = fmaf(q[e], kb[e], sl[hh][1]);
        }
      }
    }
#pragma unroll
    for (int c = kR / 8; c < kChunks; ++c) {
      float ka[8], kb[8];
      load8(k0 + c * 8, ka);
      load8(k1 + c * 8, kb);
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        float q[8];
        load8(q0 + hh * kRow + c * 8, q);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sr[hh][0] = fmaf(q[e], ka[e], sr[hh][0]);
          sr[hh][1] = fmaf(q[e], kb[e], sr[hh][1]);
        }
      }
    }

    // the group's online softmax over the tile; P stays f32 in registers
    const int key0 = k_begin + t * kTile + j;
    float pv[4][2];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      float s0 = (sl[hh][0] + sr[hh][0]) * p.scale;
      float s1 = (sl[hh][1] + sr[hh][1]) * p.scale;
      if (key0 >= k_end) s0 = kNegInf;
      if (key0 + 16 >= k_end) s1 = kNegInf;
      const float mc = fmaxf(m[hh], group_max(fmaxf(s0, s1)));
      const float alpha = expf(m[hh] - mc);
      pv[hh][0] = expf(s0 - mc);
      pv[hh][1] = expf(s1 - mc);
      l[hh] = l[hh] * alpha + group_sum(pv[hh][0] + pv[hh][1]);
      m[hh] = mc;
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hh][i] *= alpha;
    }

    // O += P V: V is the tile's latent part; key kk's P sits in thread kk %
    // 16 of the group (slot kk / 16)
    const int lane0 = (tid % 32) & 16;  // the group's first lane in its warp
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pk[4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
        pk[hh] = __shfl_sync(0xFFFFFFFFu, kk < 16 ? pv[hh][0] : pv[hh][1], lane0 + kk % 16);
      const __nv_bfloat16* vrow = tile + kk * kRow + 8 * j;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[8];
        load8(vrow + 128 * c, v);
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
#pragma unroll
          for (int e = 0; e < 8; ++e) o[hh][8 * c + e] = fmaf(pk[hh], v[e], o[hh][8 * c + e]);
      }
    }
    __syncthreads();  // the tile's buffer is free for the load two tiles on
  }

  const int bh = b * nhg + hg;
  if (p.nsplit == 1) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int h = h0 + 4 * grp + hh;
      if (h >= p.heads) continue;
      const float den = fmaxf(l[hh], 1e-30f);
      float* out = p.out + (size_t(b) * p.heads + h) * kR + 8 * j;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 8; e += 4)
          *reinterpret_cast<float4*>(out + 128 * c + e) =
              make_float4(o[hh][8 * c + e] / den, o[hh][8 * c + e + 1] / den, o[hh][8 * c + e + 2] / den,
                          o[hh][8 * c + e + 3] / den);
    }
    return;
  }

  // this split's partial out; the block that finishes the last split of its
  // (batch, head half) merges them
  float* pacc = p.part + (size_t(bh) * p.nsplit + split) * kHeads * kR;
  float* ml = p.part + size_t(gridDim.z) * nhg * p.nsplit * kHeads * kR + size_t(bh) * p.nsplit * kHeads * 2;
#pragma unroll
  for (int hh = 0; hh < 4; ++hh) {
    const int r = 4 * grp + hh;
    float* acc = pacc + r * kR + 8 * j;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 8; e += 4)
        *reinterpret_cast<float4*>(acc + 128 * c + e) =
            make_float4(o[hh][8 * c + e], o[hh][8 * c + e + 1], o[hh][8 * c + e + 2], o[hh][8 * c + e + 3]);
    if (j == 0) {
      ml[(split * kHeads + r) * 2] = m[hh];
      ml[(split * kHeads + r) * 2 + 1] = l[hh];
    }
  }
  __threadfence();  // the partial is visible to the merging block before the count says so
  __syncthreads();
  __shared__ int merging;
  if (tid == 0) {
    merging = atomicAdd(p.counters + bh, 1) == p.nsplit - 1;
    if (merging) p.counters[bh] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!merging) return;
  __threadfence();

  // out = sum_i exp(m_i - M) acc_i / max(sum_i exp(m_i - M) l_i, 1e-30), in
  // split order: the weights of every (split, head) first, into the (free)
  // shared memory, then each thread sums four columns of a head over the
  // splits
  const int ns = p.nsplit;
  float* w = reinterpret_cast<float*>(smem_raw);  // [ns][kHeads]
  float* den = w + kMaxSplits * kHeads;           // [kHeads]
  for (int r = tid; r < kHeads; r += kThreads) {
    float mx = kNegInf;
    for (int i = 0; i < ns; ++i) mx = fmaxf(mx, __ldcg(ml + (i * kHeads + r) * 2));
    float lsum = 0.f;
    for (int i = 0; i < ns; ++i) {
      const float wi = expf(__ldcg(ml + (i * kHeads + r) * 2) - mx);
      w[i * kHeads + r] = wi;
      lsum = fmaf(wi, __ldcg(ml + (i * kHeads + r) * 2 + 1), lsum);
    }
    den[r] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  const float* accs = p.part + size_t(bh) * ns * kHeads * kR;
  for (int idx = tid; idx < kHeads * (kR / 4); idx += kThreads) {
    const int r = idx / (kR / 4), d = (idx % (kR / 4)) * 4;
    if (h0 + r >= p.heads) continue;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int i = 0; i < ns; ++i) {
      const float wi = w[i * kHeads + r];
      const float4 a = __ldcg(reinterpret_cast<const float4*>(accs + (size_t(i) * kHeads + r) * kR + d));
      x[0] = fmaf(wi, a.x, x[0]);
      x[1] = fmaf(wi, a.y, x[1]);
      x[2] = fmaf(wi, a.z, x[2]);
      x[3] = fmaf(wi, a.w, x[3]);
    }
    const float dn = den[r];
    *reinterpret_cast<float4*>(p.out + (size_t(b) * p.heads + h0 + r) * kR + d) =
        make_float4(x[0] / dn, x[1] / dn, x[2] / dn, x[3] / dn);
  }
}

}  // namespace

// q_abs [B, H, 512] and q_rope [B, H, 64] bf16 (contiguous), the caches
// ckv [B, Smax, 512] and krope [B, Smax, 64] bf16 (unit stride in the last
// dimension; batch and slot element strides given, each a multiple of 8;
// 16-byte aligned), out f32 [B, H, 512] (contiguous). The slots [0, kv_len)
// are cut into nsplit splits of keys_per_split keys (a multiple of 32;
// nsplit = ceil(kv_len / keys_per_split) <= 64); `part` is f32 scratch of
// B * ceil(H / 64) * nsplit * 64 * (512 + 2) floats, `counters` B * ceil(H /
// 64) int32 zeros, left zero (the merging blocks reset them; calls that
// share them must not overlap). One launch; returns cudaGetLastError()
// after it.
extern "C" int th_mla_decode(const void* q_abs, const void* q_rope, const void* ckv, const void* krope, void* out,
                             int batch, int heads, long long ckv_b, long long ckv_s, long long kr_b, long long kr_s,
                             int kv_len, int keys_per_split, int nsplit, float scale, void* part, void* counters,
                             void* stream) {
  if (batch < 1 || heads < 1 || kv_len < 1 || keys_per_split <= 0 || keys_per_split % kTile || nsplit < 1 ||
      nsplit > kMaxSplits || nsplit != (kv_len + keys_per_split - 1) / keys_per_split)
    return static_cast<int>(cudaErrorInvalidValue);
  MlaParams p;
  p.qa = static_cast<const __nv_bfloat16*>(q_abs);
  p.qr = static_cast<const __nv_bfloat16*>(q_rope);
  p.ckv = static_cast<const __nv_bfloat16*>(ckv);
  p.kr = static_cast<const __nv_bfloat16*>(krope);
  p.out = static_cast<float*>(out);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.cb = ckv_b;
  p.cs = ckv_s;
  p.rb = kr_b;
  p.rs = kr_s;
  p.heads = heads;
  p.kv_len = kv_len;
  p.keys_per_split = keys_per_split;
  p.nsplit = nsplit;
  p.scale = scale;
  static bool sized = false;  // the attribute is set once
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(nsplit, (heads + kHeads - 1) / kHeads, batch);
  mla_decode_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
