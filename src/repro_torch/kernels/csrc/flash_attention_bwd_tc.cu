// The flash-attention backward for Hopper on the tensor cores: dQ, dK and
// dV in bf16 at head_dim 64, 128 or 256, with or without a sliding window,
// the training step's path (the `tensor_core` backward route). The
// CUDA-core kernels of flash_attention_bwd.cu take the rest (f32, f16,
// head_dim 16/32).
//
// The JAX package has no Pallas backward: it differentiates its jnp
// chunked_attention (src/repro/models/layers.py) with jax.grad, so this
// is the backward of the TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention/kernel.py) that the port's forward
// replaces. For query head h of batch b against KV head h / G (GQA):
//   s   = (q . k) * (1 / sqrt(D));  s_c = c tanh(s / c) under a softcap c
//   P   = exp(s_c - lse)            lse written by the forward, per row
//   D_i = rowsum(dO * O)
//   dV  = P^T dO,  dP = dO V^T,  dS = P * (dP - D_i) * (1 - (s_c / c)^2)
//   dQ  = dS K * scale,  dK = dS^T Q * scale   (dK, dV summed over the group)
// with the forward's masks (key j is live for row i when j < kv_len,
// causal, j <= q_offset + i, and under a sliding window W, j > q_offset + i
// - W); keys past kv_len, and keys no row's window reaches, get zero dK and
// dV. What
// attention_backward_plain (kernels/flash_attention/__init__.py) computes
// in plain PyTorch. Sources of error the plain version lacks: P and dS
// are rounded to bf16 before their products (the tensor cores' operand
// type, relative error 2^-9 a term, as the forward's P); exp is ex2.approx
// of a prescaled argument (~2^-22); sums run in the tensor cores' order.
//
// Bound: at the training step's shape (q [16, 32, 576, 128], k/v
// [16, 8, 576, 128], bf16, causal) five products (S, dP, dV, dK, dQ) of
// 2 D FLOPs a live (query, key) pair over 85 M live pairs are 0.109 TFLOP,
// 0.110 ms at the tensor cores' 989 TFLOP/s; q, o, dO, dQ, k, v, dK, dV
// and the lse once each are 379 MB, 0.113 ms at 3.35 TB/s: 0.113 ms
// (bytes). This design computes seven products (S and dP in both the
// dK/dV and the dQ kernel): 0.152 TFLOP over the live pairs, a floor of
// ~0.155 ms at peak (0.169 TFLOP, 0.171 ms over the whole 64 x 64 tiles
// it runs, diagonal ones included). Why seven and not five, at this
// shape:
//  * the two recomputed products cost 0.044 TFLOP, ~0.045 ms a layer;
//  * computing S and dP once means handing dQ between key tiles: a 64 x
//    128 f32 partial in and out for each of the 16 x 32 x 45 live tile
//    pairs, ~1.5 GB, ~0.45 ms (the 151 MB accumulator does not fit the
//    50 MB L2), or atomics, which would make the result depend on the
//    order the blocks run in;
//  * writing dS out for a second pass costs 190-340 MB of scratch, written
//    and read, ~0.11-0.2 ms.
// So the result is deterministic (no atomics: each kernel owns its
// outputs, and two runs give the same bits), and the two extra products
// cost less than either way of avoiding them.
//
// Design, three kernels in stream order:
//  1. pre: D_i = rowsum(dO * O), one warp a row, one pass over O and dO
//     (151 MB at the training shape, ~0.045 ms), so no later block
//     recomputes it (the CUDA-core dK/dV kernel does, up to nine times a
//     row at the training shape). It writes each 64-row query tile's lse
//     (times log2 e) and D_i side by side, zeros past Sq, so one 512-byte
//     bulk copy brings a tile's row statistics.
//  2. dK/dV: one block a (batch, KV head, 128 keys): two consumer
//     warpgroups of 64 keys and a producer warpgroup, whose one thread
//     issues every copy. The producer TMA-loads K and V once, then streams
//     the Q and dO tiles (64 rows) of the group's G heads and their
//     statistics through a ring of kStages stages, only the tiles whose
//     rows can see the block's keys (causal). A consumer warpgroup runs
//     S^T = K Q^T and dP^T = V dO^T as SS wgmma (both operands K-major in
//     the 128-byte swizzle: the layout of the forward's Q K^T), forms P^T
//     and dS^T in registers on the accumulator's layout, rounds them to
//     bf16 there (the layout of the A fragment), and accumulates
//     dV += P^T dO and dK += dS^T Q as RS wgmma with dO and Q as the
//     MN-major B operand (as the forward reads V). P and dS never touch
//     shared memory. A warpgroup whose keys no row of a tile sees skips
//     the tile's math; only edge tiles are masked.
//  3. dQ: one block a (batch, query head, 128 query rows): two consumer
//     warpgroups of 64 rows and a producer warpgroup. Q and dO are loaded
//     once, K and V tiles of 64 keys stream through the ring up to the
//     causal / kv_len edge; S = Q K^T and dP = dO V^T (SS), dS in
//     registers, dQ += dS K (RS, K as the MN-major B operand).
// Registers: a consumer thread of dK/dV holds 64 + 64 f32 of dK and dV
// (head_dim 128) beside 32 + 32 of S^T and dP^T. The producer warpgroup
// gives its registers back (setmaxnreg: 24 a thread) so each consumer
// thread has 240, and nothing spills; the warpgroup index comes from a
// warp shuffle, so the compiler sees branches on it as uniform and keeps
// the wgmma asynchronous under them.
// The window (gemma2's local layers): the kernels are instantiated with
// and without one (template W), so a call without a window runs the code
// it ran before. dK/dV streams the query tiles up to the one holding the
// last row whose window reaches the block's last live key (row k_last + W
// - 1 - q_offset); dQ starts at the key tile holding its first row's first
// key (q_offset + i0 - W + 1); a warpgroup skips a tile whose keys all lie
// before its first row's window; the window's edge tiles are masked per
// element as the causal ones. A masked pair's P is 0 whatever its score
// (the lse of every row is finite: the wrapper refuses a window that
// leaves a row no key), so a row with no live key in a tile adds nothing.
// Head_dim 256 has a kernel of its own, one launch after pre (section 4 below).
// Epilogues scale dK and dQ by 1/sqrt(D) and store bf16 pairs from the
// registers into the [B, S, H, D] layout under the [B, H, S, D] views,
// clipped at Sq and Sk. The tensor maps' sequence extents are Sq and
// kv_len, so TMA fills rows past them with zeros. Blocks with the most
// work go first (key tiles from the front, query tiles from the back).

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;                      // query rows a tile; keys and rows a consumer warpgroup
constexpr int kKeys = 128;                  // keys a dK/dV block
constexpr int kRows = 128;                  // query rows a dQ block
constexpr int kStages = 3;                  // depth of both rings
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kConsumerRegs = 240;          // 2 x 128 x 240 + 128 x 24 <= 65536
constexpr int kProducerRegs = 24;
constexpr int kPreRows = 8;                 // rows (warps) a block of the pre kernel
constexpr int kStatsTile = 2 * kT;          // floats of a query tile's stats: lse log2 e [64], then D_i [64]

struct BwdParams {
  const __nv_bfloat16 *o, *dout;
  __nv_bfloat16 *dq, *dk, *dv;
  const float* lse;  // [B, Hq, Sq] from the forward
  float* stats;      // [B * Hq][nq][2][64]: lse log2 e and D_i a query tile, zeros past Sq
  long long os[3], dos[3], dqs[3], dks[3], dvs[3];  // element strides: batch, head, sequence
  int batch, hq, hkv, group, sq, sk, nq, causal, q_offset, kv_len;
  int window;  // the sliding window, or 2^30 for none
  float scale, softcap;
};

// where the sequence, head and batch coordinates go among a map's
// dimensions 1..3 (the host sorts those dimensions by stride)
struct BwdDims {
  int q[3], k[3], v[3], dout[3];
};

// P (or P^T) and dS of one accumulator element: the raw dot `s`, dP, the
// row's lse times log2 e and D_i; `live` false masks it to zero
__device__ __forceinline__ void p_ds(const BwdParams& p, float& s, float& dp, float lse2, float di, bool live) {
  float x = s * p.scale;
  float t = 0.f;
  if (p.softcap > 0.f) {
    t = tanhf(x / p.softcap);
    x = p.softcap * t;
  }
  const float pr = live ? ex2(fmaf(x, kLog2e, -lse2)) : 0.f;
  float ds = pr * (dp - di);
  if (p.softcap > 0.f) ds *= 1.f - t * t;
  s = pr;
  dp = ds;
}

// two f32 accumulators as a bf16 pair into columns d, d + 1 of a row
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int d, float a, float b) {
  *reinterpret_cast<uint32_t*>(row + d) = pack_bf16(a, b);
}

// whether `key` is live for the query at position `qpos` (a row below Sq):
// below kv_len, causal up to itself, within the window where W. The
// kernels are instantiated with and without a window, so a call without
// one runs the code it ran before the window came
template <bool W>
__device__ __forceinline__ bool live(const BwdParams& p, int key, int qpos) {
  return key < p.kv_len && (!p.causal || key <= qpos) && (!W || key > qpos - p.window);
}

// one past the last query tile with a row whose window reaches `k_last`
// (all nq tiles without a window)
template <bool W>
__device__ __forceinline__ int q_tiles_end(const BwdParams& p, int k_last) {
  if (!W) return p.nq;
  const int i_end = k_last + p.window - 1 - p.q_offset;  // the last such row
  return i_end < 0 ? 0 : min(p.nq, i_end / kT + 1);
}

// S = A.B^T over D (A: 64 rows of a tile, B: 64 rows of another; both
// bf16 K-major in the 128-byte swizzle, in boxes of 64 columns `a_box` and
// `b_box` bytes apart), into a 64 x 64 f32 accumulator
template <int D>
__device__ __forceinline__ void gemm_ss(float (&acc)[kT / 2], uint32_t a, uint32_t a_box, uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns: 32 bytes into a swizzled row
    wgmma_ss_n64(acc, sw128_desc(a + (kk / 4) * a_box + off, 16, 1024), sw128_desc(b + (kk / 4) * b_box + off, 16, 1024));
  }
}

// -- 1. D_i = rowsum(dO * O), and the stats tiles ----------------------------------

template <int D>
__global__ void __launch_bounds__(32 * kPreRows) flash_bwd_tc_pre_kernel(const BwdParams p) {
  constexpr int V = D / 32;  // elements a lane: 2, 4 or 8
  const int padded = p.nq * kT;
  const int row = blockIdx.x * kPreRows + threadIdx.x / 32;  // of B * Hq * padded rows
  const int lane = threadIdx.x % 32;
  if (row >= p.batch * p.hq * padded) return;
  const int i = row % padded, bh = row / padded;
  float acc = 0.f, lse2 = 0.f;
  if (i < p.sq) {  // the same for the whole warp
    const int b = bh / p.hq, h = bh % p.hq;
    const long long ro = b * p.os[0] + h * p.os[1] + static_cast<long long>(i) * p.os[2] + lane * V;
    const long long rg = b * p.dos[0] + h * p.dos[1] + static_cast<long long>(i) * p.dos[2] + lane * V;
    if constexpr (V == 8) {  // head_dim 256: one 16-byte load of each a lane
      const uint4 a4 = *reinterpret_cast<const uint4*>(p.o + ro), g4 = *reinterpret_cast<const uint4*>(p.dout + rg);
      const uint32_t aw[4] = {a4.x, a4.y, a4.z, a4.w}, gw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[e]));
        const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[e]));
        acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.o + ro + e));
        const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.dout + rg + e));
        acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
      }
    }
    lse2 = p.lse[static_cast<long long>(bh) * p.sq + i] * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if (lane == 0) {
    float* st = p.stats + (static_cast<long long>(bh) * p.nq + i / kT) * kStatsTile;
    st[i % kT] = lse2;
    st[kT + i % kT] = acc;
  }
}

// -- 2. dK and dV ----------------------------------------------------------------

template <int D>
struct DkdvLayout {
  static constexpr uint32_t kKVBytes = kKeys * D * 2;  // the block's K (and V)
  static constexpr uint32_t kTileBytes = kT * D * 2;   // a Q or dO tile
  static constexpr uint32_t kStatsBytes = kStatsTile * 4;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kKVBytes;
  static constexpr uint32_t kQ = kV + kKVBytes;
  static constexpr uint32_t kDO = kQ + kStages * kTileBytes;
  static constexpr uint32_t kStats = kDO + kStages * kTileBytes;
  static constexpr uint32_t kBar = kStats + kStages * kStatsBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int D, bool W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tc_dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                             const BwdParams p, const BwdDims dims) {
  using L = DkdvLayout<D>;
  constexpr int NB = D / kBox;  // 64-element boxes a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const float* stats = reinterpret_cast<const float*>(smem + L::kStats);
  auto bar = [&](int i) { return base + L::kBar + 8 * i; };
  auto kv_full = [&]() { return bar(0); };
  auto full = [&](int s) { return bar(1 + s); };
  auto empty = [&](int s) { return bar(1 + kStages + s); };
  auto q_tile = [&](int s) { return base + L::kQ + s * L::kTileBytes; };
  auto do_tile = [&](int s) { return base + L::kDO + s * L::kTileBytes; };

  const int tid = threadIdx.x;
  const int nbkv = p.batch * p.hkv;
  const int bkv = blockIdx.x % nbkv;
  const int k0 = (blockIdx.x / nbkv) * kKeys;  // the first keys (the most query tiles) first
  const int b = bkv / p.hkv, hk = bkv % p.hkv;
  // the query tiles of each head whose rows can see a key of the block
  // (none if the block starts at or past kv_len): from the one holding
  // position k0 - q_offset, up to the one holding the last row whose window
  // reaches the block's last live key
  const int first = p.causal ? max(0, k0 - p.q_offset) / kT : 0;
  const int q_end = q_tiles_end<W>(p, min(k0 + kKeys, p.kv_len) - 1);
  const int ntiles = k0 < p.kv_len ? max(q_end - first, 0) : 0;
  const int nitems = p.group * ntiles;  // (head, query tile) pairs, head-major

  if (tid == 0) {
    mbar_init(kv_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = warpgroup_idx();

  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      if (nitems > 0) {
        mbar_expect_tx(kv_full(), 2 * L::kKVBytes);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(base + L::kK + nb * kKeys * kRowBytes, &kmap, kv_full(), dims.k, nb * kBox, k0, hk, b);
          tma_load(base + L::kV + nb * kKeys * kRowBytes, &vmap, kv_full(), dims.v, nb * kBox, k0, hk, b);
        }
      }
      for (int it = 0; it < nitems; ++it) {
        const int h = hk * p.group + it / ntiles;
        const int qt = first + it % ntiles;
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // passes at once on a fresh stage
        mbar_expect_tx(full(s), 2 * L::kTileBytes + L::kStatsBytes);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(q_tile(s) + nb * kT * kRowBytes, &qmap, full(s), dims.q, nb * kBox, qt * kT, h, b);
          tma_load(do_tile(s) + nb * kT * kRowBytes, &domap, full(s), dims.dout, nb * kBox, qt * kT, h, b);
        }
        bulk_load(base + L::kStats + s * L::kStatsBytes,
                  p.stats + (static_cast<long long>(b * p.hq + h) * p.nq + qt) * kStatsTile, L::kStatsBytes, full(s));
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  // consumers: warpgroup wg owns keys [kw0, kw0 + 64); this thread holds
  // key rows ra and ra + 8 of them, query columns 8j + col + {0, 1}
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int kw0 = k0 + wg * kT;
  const int key_a = kw0 + ra, key_b = key_a + 8;
  const uint32_t k_base = base + L::kK + wg * kT * kRowBytes;
  const uint32_t v_base = base + L::kV + wg * kT * kRowBytes;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (nitems > 0) mbar_wait(kv_full(), 0);

  for (int it = 0; it < nitems; ++it) {
    const int i0 = (first + it % ntiles) * kT;
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    const int i_last = min(p.sq, i0 + kT) - 1;
    // a row sees a key of ours (under a window: our last key is inside the
    // tile's first row's window)
    if (kw0 < p.kv_len && (!p.causal || kw0 <= p.q_offset + i_last) &&
        (!W || kw0 + kT - 1 > p.q_offset + i0 - p.window)) {
      float st[kT / 2], dpt[kT / 2];
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
      gemm_ss<D>(st, k_base, kKeys * kRowBytes, q_tile(s), kT * kRowBytes);    // S^T = K Q^T
      gemm_ss<D>(dpt, v_base, kKeys * kRowBytes, do_tile(s), kT * kRowBytes);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const float* lse2 = stats + s * kStatsTile;
      const float* di = lse2 + kT;
      const bool edge = kw0 + kT > p.kv_len || i0 + kT > p.sq || (p.causal && kw0 + kT - 1 > p.q_offset + i0) ||
                        (W && kw0 <= p.q_offset + i0 + kT - 1 - p.window);
      // P^T and dS^T, rounded to bf16 as A fragments (rows keys, depth
      // queries) 16 queries at a time
      uint32_t pa[kT / 16][4], da[kT / 16][4];
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qc = 8 * j + col + c;
            const bool row_ok = i0 + qc < p.sq;
            const int qpos = p.q_offset + i0 + qc;
            p_ds(p, st[4 * j + c], dpt[4 * j + c], lse2[qc], di[qc], !edge || (row_ok && live<W>(p, key_a, qpos)));
            p_ds(p, st[4 * j + 2 + c], dpt[4 * j + 2 + c], lse2[qc], di[qc], !edge || (row_ok && live<W>(p, key_b, qpos)));
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)  // dO [queries][D] as the MN-major B operand, 16 queries a step
        wgmma_rs<D>(dv, pa[kk], sw128_desc(do_tile(s) + kk * 16 * kRowBytes, kT * kRowBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_rs<D>(dk, da[kk], sw128_desc(q_tile(s) + kk * 16 * kRowBytes, kT * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk);
      fence_regs(dv);
    }
    mbar_arrive(empty(s));
  }

  // zeros for keys no row sees, past kv_len included
  __nv_bfloat16* dkg = p.dk + b * p.dks[0] + hk * p.dks[1];
  __nv_bfloat16* dvg = p.dv + b * p.dvs[0] + hk * p.dvs[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + col;
    if (key_a < p.sk) {
      store_pair(dkg + static_cast<long long>(key_a) * p.dks[2], d, dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
      store_pair(dvg + static_cast<long long>(key_a) * p.dvs[2], d, dv[4 * j], dv[4 * j + 1]);
    }
    if (key_b < p.sk) {
      store_pair(dkg + static_cast<long long>(key_b) * p.dks[2], d, dk[4 * j + 2] * p.scale,
                 dk[4 * j + 3] * p.scale);
      store_pair(dvg + static_cast<long long>(key_b) * p.dvs[2], d, dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// -- 3. dQ ---------------------------------------------------------------------------

template <int D>
struct DqLayout {
  static constexpr uint32_t kQBytes = kRows * D * 2;  // the block's Q (and dO)
  static constexpr uint32_t kTileBytes = kT * D * 2;  // a K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kQBytes;
  static constexpr uint32_t kK = kDO + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, bool W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                           const BwdParams p, const BwdDims dims) {
  using L = DqLayout<D>;
  constexpr int NB = D / kBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  auto bar = [&](int i) { return base + L::kBar + 8 * i; };
  auto q_full = [&]() { return bar(0); };
  auto full = [&](int s) { return bar(1 + s); };
  auto empty = [&](int s) { return bar(1 + kStages + s); };
  auto k_tile = [&](int s) { return base + L::kK + s * L::kTileBytes; };
  auto v_tile = [&](int s) { return base + L::kV + s * L::kTileBytes; };

  const int tid = threadIdx.x;
  const int nbh = p.batch * p.hq;
  const int bh = blockIdx.x % nbh;
  const int nblocks = (p.sq + kRows - 1) / kRows;
  const int i0 = (nblocks - 1 - blockIdx.x / nbh) * kRows;  // the last query rows (the most keys) first
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int i_last = min(p.sq, i0 + kRows) - 1;
  // live keys [kv_start, kv_end): key tiles wholly outside are not loaded
  const int kv_end = p.causal ? min(p.kv_len, p.q_offset + i_last + 1) : p.kv_len;
  const int t0 = W ? max(0, p.q_offset + i0 - p.window + 1) / kT : 0;
  const int ntiles = (kv_end + kT - 1) / kT - t0;

  if (tid == 0) {
    mbar_init(q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = warpgroup_idx();

  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_expect_tx(q_full(), 2 * L::kQBytes);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load(base + L::kQ + nb * kRows * kRowBytes, &qmap, q_full(), dims.q, nb * kBox, i0, h, b);
        tma_load(base + L::kDO + nb * kRows * kRowBytes, &domap, q_full(), dims.dout, nb * kBox, i0, h, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTileBytes);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(k_tile(s) + nb * kT * kRowBytes, &kmap, full(s), dims.k, nb * kBox, (t0 + t) * kT, hk, b);
          tma_load(v_tile(s) + nb * kT * kRowBytes, &vmap, full(s), dims.v, nb * kBox, (t0 + t) * kT, hk, b);
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  // consumers: warpgroup wg owns query rows [row0, row0 + 64); this
  // thread holds rows ra and ra + 8 of them, key columns 8j + col + {0, 1}
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int row0 = i0 + wg * kT;
  const int i_a = row0 + ra, i_b = i_a + 8;
  // the warpgroup's live keys end earlier than the block's (causal); a
  // warpgroup past Sq does no math
  const int wg_end = p.causal ? min(p.kv_len, p.q_offset + min(p.sq, row0 + kT)) : p.kv_len;
  const int wg_kv_end = row0 < p.sq ? wg_end : 0;
  const int wg_kv_start = p.q_offset + row0 - p.window + 1;  // its first row's first key (may be < 0)
  float lse_a = 0.f, lse_b = 0.f, di_a = 0.f, di_b = 0.f;
  if (row0 < p.sq) {
    const float* st = p.stats + (static_cast<long long>(bh) * p.nq + row0 / kT) * kStatsTile;
    lse_a = st[ra];
    lse_b = st[ra + 8];
    di_a = st[kT + ra];
    di_b = st[kT + ra + 8];
  }
  const uint32_t q_base = base + L::kQ + wg * kT * kRowBytes, do_base = base + L::kDO + wg * kT * kRowBytes;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_full(), 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const int k0 = (t0 + t) * kT;
    mbar_wait(full(s), (t / kStages) & 1);
    if (k0 < wg_kv_end && (!W || k0 + kT > wg_kv_start)) {
      float sc[kT / 2], dp[kT / 2];
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      gemm_ss<D>(sc, q_base, kRows * kRowBytes, k_tile(s), kT * kRowBytes);   // S = Q K^T
      gemm_ss<D>(dp, do_base, kRows * kRowBytes, v_tile(s), kT * kRowBytes);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = k0 + kT > p.kv_len || row0 + kT > p.sq || (p.causal && k0 + kT - 1 > p.q_offset + row0) ||
                        (W && k0 <= p.q_offset + row0 + kT - 1 - p.window);
      const bool ok_a = i_a < p.sq, ok_b = i_b < p.sq;
      uint32_t da[kT / 16][4];
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + col + c;
            p_ds(p, sc[4 * j + c], dp[4 * j + c], lse_a, di_a, !edge || (ok_a && live<W>(p, key, p.q_offset + i_a)));
            p_ds(p, sc[4 * j + 2 + c], dp[4 * j + 2 + c], lse_b, di_b,
                 !edge || (ok_b && live<W>(p, key, p.q_offset + i_b)));
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)  // K [keys][D] as the MN-major B operand, 16 keys a step
        wgmma_rs<D>(dq, da[kk], sw128_desc(k_tile(s) + kk * 16 * kRowBytes, kT * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
    }
    mbar_arrive(empty(s));
  }

  __nv_bfloat16* dqg = p.dq + b * p.dqs[0] + h * p.dqs[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + col;
    if (i_a < p.sq)
      store_pair(dqg + static_cast<long long>(i_a) * p.dqs[2], d, dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
    if (i_b < p.sq)
      store_pair(dqg + static_cast<long long>(i_b) * p.dqs[2], d, dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
  }
}

// -- 4. head_dim 256: one persistent launch of the dK/dV and dQ items ----------------

// At D = 256 a warpgroup holding dK and dV of 64 keys over all of D would
// need 256 f32 registers a thread, and 128 rows of Q and dO (128 KB) beside
// a ring of 64 KB stages overflow the shared memory. So D = 256 has a kernel
// of its own, flash_bwd_tc256_kernel: after pre, one persistent launch for
// the whole call.
//
// * Items. A dK/dV item is 64 keys of a KV head: its K and V stay in shared
//   memory, and the Q and dO tiles (64 rows) of the group's G heads whose
//   rows see them stream through the ring, head by head. A dQ item is 64
//   query rows of a head: Q, dO and the rows' stats stay, and the K and V
//   tiles (64 keys) its rows see stream through. One code serves both: the
//   item's fixed pair (K, V or Q, dO) is the A operand of both score
//   products and the streamed pair (Q, dO or K, V) their B operand, so S^T
//   = K Q^T and dP^T = V dO^T (dK/dV) and S = Q K^T and dP = dO V^T (dQ) are
//   the same two products; the softmax reads its columns' (dK/dV) or its
//   rows' (dQ) stats; dK/dV accumulates dV += P^T dO and dK += dS^T Q, dQ
//   accumulates dQ += dS K. dQ needs only pre's stats, not dK/dV, so the
//   items of both kinds share one grid. Each item owns its outputs: no
//   atomics, and two runs give the same bits.
// * The work list. The host lists the items with their work (four 64 x 64
//   x 256 products a live tile of a dK/dV item, three of a dQ item), sorts
//   them heaviest first and gives each to the block with the least work so
//   far (flash_attention's bwd256_order, kept on the device by shape): each
//   of min(items, SMs) blocks walks its own items, heaviest first, and no
//   block ends more than one item's work after the mean. At phase 10's
//   shape (4 x 8/4 heads x 576) that is 144 dK/dV items (up to 72
//   products) and 288 dQ items (up to 27) on 132 blocks, where two launches
//   left a tail of 12 dK/dV blocks behind a wave of 132 and a third dQ wave.
// * The softmax split between the two consumer warpgroups. Each computes
//   both score products for half of the tile's other axis (S^T and dP^T for
//   32 of the tile's queries, S and dP for 32 of its keys) over all 256
//   columns as m64n32k16 products, forms P and dS of its half in registers
//   and writes them as bf16 into 64 x 64 exchange tiles in the 128-byte
//   swizzle (stmatrix); then each accumulates its half of D's columns (128)
//   over the whole tile as m64n128k16 products, the exchange tile the
//   K-major A operand and the streamed tile the MN-major B operand. Neither
//   warpgroup waits for the other's softmax, and only bf16 P and dS cross
//   between them (the two before handed 16 KB of f32 dP over and one of
//   them formed all 4096 scores of a tile while the other waited). Two named
//   barriers a tile: the exchange tiles are free (both warpgroups'
//   accumulation of the last tile is done), and they are full.
// * Overlap. Each tile's score products are issued behind the previous
//   tile's accumulation, as three commit groups: accumulate(i), S(i+1),
//   dP(i+1). The accumulation's completion frees tile i's ring stage, so
//   tile i+2's loads run under S and dP; P is formed from S while dP is in
//   flight, then dS. The issue is straight-line code (a prologue, a steady
//   loop, a drain: a wgmma issued under a condition serialises the
//   pipeline), and no register a product in flight reads is written before
//   its wait.
// * The softcap as the wide forward forms it (flash_attention_tc.cu): in
//   log2 units, s2 = c2 - 2 c2 r with r = 1 / (2^(dot k) + 1), c2 = c log2 e
//   and k = 2 log2 e scale / c, by ex2.approx and rcp.approx, within 4.5e-7
//   c of c tanh(x / c); and 1 - t^2 from the same r (t = 1 - 2 r): 4 r (1 -
//   r). No IEEE division and no tanhf a score; the forward's lse was made
//   with the same form.
// * A producer warpgroup (setmaxnreg 24; the consumers 240) issues every
//   load from one thread: an item's fixed pair (and a dQ item's stats) as
//   soon as the last item's score products are done, and the streamed tiles
//   (with a dK/dV tile's stats) through a ring of two stages that runs on
//   across items.
// Shared memory: the fixed pair 2 x 32 KB, two stages of 2 x 32 KB, the
// exchange tiles 2 x 8 KB and the stats 3 x 512 B: 214,528 bytes, 215,600
// with the barriers and the alignment slack. A consumer thread holds 64 +
// 64 f32 of dV and dK (dQ: 64) of its 128 columns, 16 + 16 of the score
// halves and 16 of the softcap's factor.
constexpr int kD256 = 256;
constexpr int kStages256 = 2;
constexpr uint32_t kTile256 = kT * kD256 * 2;  // 64 rows of 256 bf16: 32 KB
constexpr uint32_t kXBytes = kT * kT * 2;      // a 64 x 64 bf16 exchange tile: 8 KB
constexpr int kBarFree = 1, kBarFull = 2;      // the consumers' named barriers (0 is __syncthreads)

struct Bwd256Layout {
  static constexpr uint32_t kA = 0;                          // the fixed pair: K then V, or Q then dO
  static constexpr uint32_t kB = 2 * kTile256;               // the ring: stage s holds Q then dO, or K then V
  static constexpr uint32_t kStage = 2 * kTile256;
  static constexpr uint32_t kX = kB + kStages256 * kStage;   // P (P^T), then dS (dS^T)
  static constexpr uint32_t kStats = kX + 2 * kXBytes;       // a dQ item's rows, then each stage's query tile
  static constexpr uint32_t kBar = kStats + (1 + kStages256) * kStatsTile * 4;
  static constexpr uint32_t kBytes = kBar + 8 * (2 + 2 * kStages256) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// the head_dim-256 kernel's parameters: the call's, the work list and the
// softcap's constants (folded in double, rounded once)
struct Bwd256Params : BwdParams {
  const int* work;  // [grid + 1] each block's first item, then an item's kind, batch, head, tile
  float kcap;       // 2 log2 e scale / c (0 without a softcap)
  float c2;         // c log2 e
  float k2;         // scale log2 e
};

// the two consumer warpgroups' named barrier `id`
__device__ __forceinline__ void consumers_sync(int id) { named_sync(id, kConsumers); }

// an item: kind 0 dK/dV (h the KV head, keys from 64 t), kind 1 dQ (h the
// query head, rows from 64 t); its first streamed tile (a query tile, or a
// key tile), a head's tiles (dK/dV: ntq of each of the G heads) and its
// live tiles n
struct Item256 {
  int kind, b, h, t, first, ntq, n;
};

template <bool W>
__device__ __forceinline__ Item256 item256(const BwdParams& p, int kind, int b, int h, int t) {
  Item256 x;
  x.kind = kind;
  x.b = b;
  x.h = h;
  x.t = t;
  if (kind == 0) {  // the query tiles whose rows see a key of the item, as the dK/dV kernel above
    const int k0 = t * kT;
    x.first = p.causal ? max(0, k0 - p.q_offset) / kT : 0;
    x.ntq = k0 < p.kv_len ? max(q_tiles_end<W>(p, min(k0 + kT, p.kv_len) - 1) - x.first, 0) : 0;
    x.n = p.group * x.ntq;
  } else {  // the key tiles its rows see, as the dQ kernel above
    const int i0 = t * kT, i_last = min(p.sq, i0 + kT) - 1;
    const int kv_end = p.causal ? min(p.kv_len, p.q_offset + i_last + 1) : p.kv_len;
    x.first = W ? max(0, p.q_offset + i0 - p.window + 1) / kT : 0;
    x.ntq = 0;
    x.n = (kv_end + kT - 1) / kT - x.first;
  }
  return x;
}

// P of a raw dot `s` (in place) against its row's lse log2 e, 0 where the
// pair is masked, and the factor dS carries under a softcap, 1 - t^2
// (1 without one)
__device__ __forceinline__ void p_of(const Bwd256Params& p, bool capped, float& s, float& f, float lse2, bool live) {
  float x2 = s * p.k2;
  f = 1.f;
  if (capped) {
    const float r = rcp(ex2(s * p.kcap) + 1.f);
    x2 = fmaf(-2.f * p.c2, r, p.c2);
    f = 4.f * r * (1.f - r);
  }
  s = live ? ex2(x2 - lse2) : 0.f;
}

// 128 columns of one row of a 64 x 128 f32 accumulator (this thread's
// pairs: `off` 0 for its row ra, 2 for ra + 8) times `f`, as bf16 at `row`,
// by 16-byte stores (where `ok`): the four threads of a quad (`quad`, the
// lane's place in it) trade their pairs, a 4 x 4 transpose of words by two
// xor shuffles, so that each holds the 8 columns of four of the row's
// sixteen 8-column chunks (a thread's own pairs would be 4-byte stores, 8
// rows a warp)
__device__ __forceinline__ void store_row128(__nv_bfloat16* row, const float (&acc)[64], int off, float f, bool ok,
                                             int quad) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {  // chunks 4m .. 4m + 3
    uint32_t w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = pack_bf16(acc[16 * m + 4 * c + off] * f, acc[16 * m + 4 * c + off + 1] * f);
    uint32_t x0 = (quad & 1) ? w[0] : w[1], x1 = (quad & 1) ? w[2] : w[3];
    x0 = __shfl_xor_sync(0xFFFFFFFFu, x0, 1);
    x1 = __shfl_xor_sync(0xFFFFFFFFu, x1, 1);
    if (quad & 1) {
      w[0] = x0;
      w[2] = x1;
    } else {
      w[1] = x0;
      w[3] = x1;
    }
    x0 = (quad & 2) ? w[0] : w[2];
    x1 = (quad & 2) ? w[1] : w[3];
    x0 = __shfl_xor_sync(0xFFFFFFFFu, x0, 2);
    x1 = __shfl_xor_sync(0xFFFFFFFFu, x1, 2);
    if (quad & 2) {
      w[0] = x0;
      w[1] = x1;
    } else {
      w[2] = x0;
      w[3] = x1;
    }
    if (ok) *reinterpret_cast<uint4*>(row + 8 * (4 * m + quad)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int K>
struct Kind {
  static constexpr int value = K;
};

template <bool W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tc256_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                           const Bwd256Params p, const BwdDims dims) {
  using L = Bwd256Layout;
  constexpr int NB = kD256 / kBox;
  constexpr int kS = kStages256;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const float* stats = reinterpret_cast<const float*>(smem + L::kStats);  // [1 + kS][kStatsTile]
  auto bar = [&](int i) { return base + L::kBar + 8 * i; };
  const uint32_t fixed_full = bar(0), fixed_empty = bar(1);
  auto full = [&](int s) { return bar(2 + s); };
  auto empty = [&](int s) { return bar(2 + kS + s); };
  const uint32_t a0 = base + L::kA, a1 = a0 + kTile256;
  auto b0 = [&](int s) { return base + L::kB + s * L::kStage; };
  auto b1 = [&](int s) { return base + L::kB + s * L::kStage + kTile256; };
  const uint32_t xp = base + L::kX, xd = xp + kXBytes;
  const int* items = p.work + gridDim.x + 1;
  const int u0 = p.work[blockIdx.x], u1 = p.work[blockIdx.x + 1];

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(fixed_full, 1);
    mbar_init(fixed_empty, kConsumers);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = warpgroup_idx();

  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      int kt = 0;  // tiles streamed so far: the ring's position
      for (int u = u0, n = 0; u < u1; ++u, ++n) {
        const int* w = items + 4 * u;
        const Item256 x = item256<W>(p, w[0], w[1], w[2], w[3]);
        mbar_wait(fixed_empty, (n & 1) ^ 1);  // the last item's score products are done
        if (x.n == 0) {
          mbar_arrive(fixed_full);  // nothing to load: the item writes zeros
        } else if (x.kind == 0) {
          mbar_expect_tx(fixed_full, 2 * kTile256);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            tma_load(a0 + nb * kT * kRowBytes, &kmap, fixed_full, dims.k, nb * kBox, x.t * kT, x.h, x.b);
            tma_load(a1 + nb * kT * kRowBytes, &vmap, fixed_full, dims.v, nb * kBox, x.t * kT, x.h, x.b);
          }
        } else {
          mbar_expect_tx(fixed_full, 2 * kTile256 + kStatsTile * 4);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            tma_load(a0 + nb * kT * kRowBytes, &qmap, fixed_full, dims.q, nb * kBox, x.t * kT, x.h, x.b);
            tma_load(a1 + nb * kT * kRowBytes, &domap, fixed_full, dims.dout, nb * kBox, x.t * kT, x.h, x.b);
          }
          bulk_load(base + L::kStats, p.stats + (static_cast<long long>(x.b * p.hq + x.h) * p.nq + x.t) * kStatsTile,
                    kStatsTile * 4, fixed_full);
        }
        for (int i = 0; i < x.n; ++i, ++kt) {
          const int s = kt % kS;
          mbar_wait(empty(s), ((kt / kS) & 1) ^ 1);  // passes at once on a fresh stage
          if (x.kind == 0) {
            const int h = x.h * p.group + i / x.ntq, qt = x.first + i % x.ntq;
            mbar_expect_tx(full(s), 2 * kTile256 + kStatsTile * 4);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              tma_load(b0(s) + nb * kT * kRowBytes, &qmap, full(s), dims.q, nb * kBox, qt * kT, h, x.b);
              tma_load(b1(s) + nb * kT * kRowBytes, &domap, full(s), dims.dout, nb * kBox, qt * kT, h, x.b);
            }
            bulk_load(base + L::kStats + (1 + s) * kStatsTile * 4,
                      p.stats + (static_cast<long long>(x.b * p.hq + h) * p.nq + qt) * kStatsTile, kStatsTile * 4,
                      full(s));
          } else {
            const int hk = x.h / p.group, key0 = (x.first + i) * kT;
            mbar_expect_tx(full(s), 2 * kTile256);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              tma_load(b0(s) + nb * kT * kRowBytes, &kmap, full(s), dims.k, nb * kBox, key0, hk, x.b);
              tma_load(b1(s) + nb * kT * kRowBytes, &vmap, full(s), dims.v, nb * kBox, key0, hk, x.b);
            }
          }
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  // consumers: this thread holds rows ra and ra + 8 of a tile (keys of a
  // dK/dV item, query rows of a dQ item), columns 32 wg + 8j + col + {0, 1}
  // of the score halves (j < 4) and 128 wg + 8j + col + {0, 1} of the
  // gradients (j < 16)
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  // the exchange tile's row this lane addresses in stmatrix
  const int xr = warp * 16 + (lane / 8 % 2) * 8 + lane % 8;
  auto xaddr = [&](uint32_t x, int j) {  // chunks j, j + 1 of this warpgroup's half of row xr
    const int chunk = 4 * wg + j + lane / 16;
    return x + xr * kRowBytes + ((chunk ^ (xr & 7)) << 4);
  };
  const bool capped = p.softcap > 0.f;
  const uint32_t half = wg * 2 * kT * kRowBytes;  // this warpgroup's two 64-column boxes of a tile
  float acc0[kD256 / 4], acc1[kD256 / 4];  // dV and dK of a dK/dV item; dQ (acc1) of a dQ item
  float sc[kT / 4], dp[kT / 4], fac[kT / 4];  // S then P, dP then dS, 1 - t^2: this warpgroup's half

  // S and dP of the streamed tile in stage s (this warpgroup's 32 of its
  // rows), two commit groups; the caller zeroes sc and dp and fences
  auto scores = [&](int s) {
    const uint32_t rows = wg * 32 * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < kD256 / 16; ++kk) {
      const uint32_t off = (kk / 4) * kT * kRowBytes + (kk % 4) * 32;  // box kk / 4, 16 columns
      wgmma_ss_n32(sc, sw128_desc(a0 + off, 16, 1024), sw128_desc(b0(s) + rows + off, 16, 1024));
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD256 / 16; ++kk) {
      const uint32_t off = (kk / 4) * kT * kRowBytes + (kk % 4) * 32;
      wgmma_ss_n32(dp, sw128_desc(a1 + off, 16, 1024), sw128_desc(b1(s) + rows + off, 16, 1024));
    }
    wgmma_commit();
  };
  auto zero_scores = [&] {
#pragma unroll
    for (int i = 0; i < kT / 4; ++i) sc[i] = dp[i] = 0.f;
  };

  int kt = 0;  // tiles streamed so far
  for (int u = u0, n = 0; u < u1; ++u, ++n) {
    const int* w = items + 4 * u;
    // the same for every thread: through lane 0, so branches on it are uniform
    const Item256 x = item256<W>(p, __shfl_sync(0xFFFFFFFFu, w[0], 0), __shfl_sync(0xFFFFFFFFu, w[1], 0),
                                 __shfl_sync(0xFFFFFFFFu, w[2], 0), __shfl_sync(0xFFFFFFFFu, w[3], 0));
#pragma unroll
    for (int i = 0; i < kD256 / 4; ++i) acc0[i] = acc1[i] = 0.f;
    mbar_wait(fixed_full, n & 1);

    auto run = [&](auto kind) {
      constexpr int K = decltype(kind)::value;
      float lse_a = 0.f, lse_b = 0.f, di_a = 0.f, di_b = 0.f;  // a dQ item's rows' stats
      if (K == 1) {
        lse_a = stats[ra];
        lse_b = stats[ra + 8];
        di_a = stats[kT + ra];
        di_b = stats[kT + ra + 8];
      }
      // tile i's rows and keys: i0 its first query row, c0 its first key
      auto tile_pos = [&](int i, int& i0, int& c0) {
        if (K == 0) {
          i0 = (x.first + i % x.ntq) * kT;
          c0 = x.t * kT;
        } else {
          i0 = x.t * kT;
          c0 = (x.first + i) * kT;
        }
      };
      // P of tile i from S, and the softcap's factor, masked per element on
      // the tile's causal, window and kv_len edges and past Sq
      auto softmax_p = [&](int i, int s) {
        int i0, c0;
        tile_pos(i, i0, c0);
        const float* st = stats + (1 + s) * kStatsTile;  // a dK/dV tile's query rows' stats
        const bool edge = c0 + kT > p.kv_len || i0 + kT > p.sq || (p.causal && c0 + kT - 1 > p.q_offset + i0) ||
                          (W && c0 <= p.q_offset + i0 + kT - 1 - p.window);
#pragma unroll
        for (int j = 0; j < kT / 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int m = 32 * wg + 8 * j + col + c;  // the column: a query (dK/dV) or a key (dQ)
            const int ea = 4 * j + c, eb = 4 * j + 2 + c;  // this thread's elements in rows ra, ra + 8
            if (K == 0) {
              const bool row_ok = i0 + m < p.sq;
              const int qpos = p.q_offset + i0 + m;
              const float lse = st[m];
              p_of(p, capped, sc[ea], fac[ea], lse, !edge || (row_ok && live<W>(p, c0 + ra, qpos)));
              p_of(p, capped, sc[eb], fac[eb], lse, !edge || (row_ok && live<W>(p, c0 + ra + 8, qpos)));
            } else {
              const int key = c0 + m, ia = i0 + ra;
              p_of(p, capped, sc[ea], fac[ea], lse_a, !edge || (ia < p.sq && live<W>(p, key, p.q_offset + ia)));
              p_of(p, capped, sc[eb], fac[eb], lse_b,
                   !edge || (ia + 8 < p.sq && live<W>(p, key, p.q_offset + ia + 8)));
            }
          }
        }
      };
      // dS = P (dP - D_i) (1 - t^2) of tile i, into dp
      auto softmax_ds = [&](int s) {
        const float* st = stats + (1 + s) * kStatsTile + kT;
#pragma unroll
        for (int j = 0; j < kT / 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int ea = 4 * j + c, eb = 4 * j + 2 + c;
            const float da = K == 0 ? st[32 * wg + 8 * j + col + c] : di_a;
            const float db = K == 0 ? da : di_b;
            dp[ea] = sc[ea] * (dp[ea] - da) * fac[ea];
            dp[eb] = sc[eb] * (dp[eb] - db) * fac[eb];
          }
        }
      };
      // this warpgroup's half of P (dK/dV) and dS into the exchange tiles,
      // once both warpgroups' last accumulation is done, then wait for the
      // other half
      auto exchange = [&] {
        consumers_sync(kBarFree);
#pragma unroll
        for (int j = 0; j < kT / 16; j += 2) {
          if (K == 0)
            stmatrix_x4(xaddr(xp, j), pack_bf16(sc[4 * j], sc[4 * j + 1]), pack_bf16(sc[4 * j + 2], sc[4 * j + 3]),
                        pack_bf16(sc[4 * j + 4], sc[4 * j + 5]), pack_bf16(sc[4 * j + 6], sc[4 * j + 7]));
          stmatrix_x4(xaddr(xd, j), pack_bf16(dp[4 * j], dp[4 * j + 1]), pack_bf16(dp[4 * j + 2], dp[4 * j + 3]),
                      pack_bf16(dp[4 * j + 4], dp[4 * j + 5]), pack_bf16(dp[4 * j + 6], dp[4 * j + 7]));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmma that read them
        consumers_sync(kBarFull);
      };
      // dV += P^T dO and dK += dS^T Q (dQ += dS K) over this warpgroup's 128
      // columns, the streamed tile in stage s the MN-major B operand, 16 of
      // its rows a step; one commit group
      auto accumulate = [&](int s) {
        if (K == 0) {
#pragma unroll
          for (int kk = 0; kk < kT / 16; ++kk)
            wgmma_ss_tb_n128(acc0, sw128_desc(xp + kk * 32, 16, 1024),
                             sw128_desc(b1(s) + half + kk * 16 * kRowBytes, kT * kRowBytes, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk)
          wgmma_ss_tb_n128(acc1, sw128_desc(xd + kk * 32, 16, 1024),
                           sw128_desc(b0(s) + half + kk * 16 * kRowBytes, kT * kRowBytes, 1024));
        wgmma_commit();
      };

      // the prologue: tile 0's products alone
      int s = kt % kS;
      mbar_wait(full(s), (kt / kS) & 1);
      zero_scores();
      wgmma_fence();
      scores(s);
      wgmma_wait_one();  // S done, dP in flight
      fence_regs(sc);
      softmax_p(0, s);
      wgmma_wait_all();
      fence_regs(dp);
      softmax_ds(s);
      exchange();
      // the steady loop: tile i's accumulation, then tile i + 1's products
      for (int i = 0; i + 1 < x.n; ++i) {
        const int s0 = (kt + i) % kS, s1 = (kt + i + 1) % kS;
        mbar_wait(full(s1), ((kt + i + 1) / kS) & 1);
        zero_scores();
        wgmma_fence();
        accumulate(s0);
        scores(s1);
        wgmma_wait_two();  // tile i's accumulation done: its stage is free
        fence_regs(acc0);
        fence_regs(acc1);
        mbar_arrive(empty(s0));
        wgmma_wait_one();  // S done, dP in flight
        fence_regs(sc);
        softmax_p(i + 1, s1);
        wgmma_wait_all();
        fence_regs(dp);
        softmax_ds(s1);
        exchange();
      }
      mbar_arrive(fixed_empty);  // every score product of the item is done
      // the drain: the last tile's accumulation
      s = (kt + x.n - 1) % kS;
      wgmma_fence();
      accumulate(s);
      wgmma_wait_all();
      fence_regs(acc0);
      fence_regs(acc1);
      mbar_arrive(empty(s));
    };
    if (x.n == 0)
      mbar_arrive(fixed_empty);
    else if (x.kind == 0)
      run(Kind<0>{});
    else
      run(Kind<1>{});
    kt += x.n;

    // the item's gradients, dK and dQ scaled by 1 / sqrt(D); zeros for the
    // keys of a dK/dV item that no row sees, past kv_len included
    const int quad = lane % 4;
    if (x.kind == 0) {
      const long long key_a = x.t * kT + ra, key_b = key_a + 8;
      __nv_bfloat16* dkg = p.dk + x.b * p.dks[0] + x.h * p.dks[1] + 128 * wg;
      __nv_bfloat16* dvg = p.dv + x.b * p.dvs[0] + x.h * p.dvs[1] + 128 * wg;
      store_row128(dkg + key_a * p.dks[2], acc1, 0, p.scale, key_a < p.sk, quad);
      store_row128(dvg + key_a * p.dvs[2], acc0, 0, 1.f, key_a < p.sk, quad);
      store_row128(dkg + key_b * p.dks[2], acc1, 2, p.scale, key_b < p.sk, quad);
      store_row128(dvg + key_b * p.dvs[2], acc0, 2, 1.f, key_b < p.sk, quad);
    } else {
      const long long i_a = x.t * kT + ra, i_b = i_a + 8;
      __nv_bfloat16* dqg = p.dq + x.b * p.dqs[0] + x.h * p.dqs[1] + 128 * wg;
      store_row128(dqg + i_a * p.dqs[2], acc1, 0, p.scale, i_a < p.sq, quad);
      store_row128(dqg + i_b * p.dqs[2], acc1, 2, p.scale, i_b < p.sq, quad);
    }
  }
}

// -- host side -----------------------------------------------------------------------

struct Call {
  CUtensorMap qm, km, vm, dom;
  BwdParams p;
  BwdDims dims;
};

// the parameters and tensor maps of a call (Q and dO in boxes of
// `q_rows`, K and V of `key_rows`; no maps when both are 0); 0 or an error
// as the entry points return it
int prepare(Call& c, const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
            void* dk, void* dv, const float* lse, float* stats, const long long* strides, int batch, int hq,
            int hkv, int sq, int sk, int d, int causal, float softcap, int q_offset, int kv_len, int window,
            int q_rows, int key_rows) {
  if (d != 64 && d != 128 && d != kD256) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams& p = c.p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = lse;
  p.stats = stats;
  long long* dst[5] = {p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * (3 + t) + i];  // o, dout, dq, dk, dv
  p.batch = batch;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.sq = sq;
  p.sk = sk;
  p.nq = (sq + kT - 1) / kT;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.window = window > 0 ? window : 1 << 30;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));  // as the forward's
  p.softcap = softcap;
  if (key_rows == 0) return 0;
  int err = make_map(&c.qm, q, d, sq, hq, batch, strides + 0, q_rows, c.dims.q);
  if (err == 0) err = make_map(&c.km, k, d, kv_len, hkv, batch, strides + 3, key_rows, c.dims.k);
  if (err == 0) err = make_map(&c.vm, v, d, kv_len, hkv, batch, strides + 6, key_rows, c.dims.v);
  if (err == 0) err = make_map(&c.dom, dout, d, sq, hq, batch, strides + 12, q_rows, c.dims.dout);
  return err;
}

template <typename Kernel>
int launch(Kernel kernel, int bytes, int blocks, const Call& c, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, bytes, stream>>>(c.qm, c.km, c.vm, c.dom, c.p, c.dims);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, o, dout, dq [B, Hq, Sq, D] and k, v, dk, dv [B, Hkv, Sk, D], each
// by its pointer and its (batch, head, sequence) element strides in
// `strides` (a host array of 24 in the order q, k, v, o, dout, dq, dk,
// dv; pointers and strides of q, k, v and dout 16-byte aligned); lse f32
// [B, Hq, Sq] contiguous, from the forward; stats f32 scratch of
// B * Hq * ceil(Sq / 64) * 128 floats, 16-byte aligned; D in {64, 128,
// 256}; 1 <= kv_len <= Sk; window > 0 a sliding window, 0 none. Entry
// points with the same arguments, launched in this order on one stream:
// th_flash_bwd_tc_pre writes stats (each query tile's lse log2 e and D_i),
// th_flash_bwd_tc_dkdv writes dk and dv (zeros past kv_len) and
// th_flash_bwd_tc_dq writes dq at D 64 and 128; at D 256
// th_flash_bwd_tc_dkdv_dq (below; a work list beside the arguments) writes
// all three. Each returns cudaGetLastError() after its launch, or a
// tensor-map encoding failure negated.
#define TH_BWD_TC_ARGS                                                                                         \
  const void *q, const void *k, const void *v, const void *o, const void *dout, void *dq, void *dk, void *dv, \
      const float *lse, float *stats, const long long *strides, int batch, int hq, int hkv, int sq, int sk,   \
      int d, int causal, float softcap, int q_offset, int kv_len, int window, void *stream
#define TH_BWD_TC_PASS                                                                                        \
  q, k, v, o, dout, dq, dk, dv, lse, stats, strides, batch, hq, hkv, sq, sk, d, causal, softcap, q_offset, kv_len, \
      window

extern "C" int th_flash_bwd_tc_pre(TH_BWD_TC_ARGS) {
  Call c;
  const int err = prepare(c, TH_BWD_TC_PASS, 0, 0);
  if (err != 0) return err;
  const int blocks = (batch * hq * c.p.nq * kT + kPreRows - 1) / kPreRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    flash_bwd_tc_pre_kernel<64><<<blocks, 32 * kPreRows, 0, s>>>(c.p);
  else if (d == 128)
    flash_bwd_tc_pre_kernel<128><<<blocks, 32 * kPreRows, 0, s>>>(c.p);
  else
    flash_bwd_tc_pre_kernel<kD256><<<blocks, 32 * kPreRows, 0, s>>>(c.p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int th_flash_bwd_tc_dkdv(TH_BWD_TC_ARGS) {
  if (d == kD256) return static_cast<int>(cudaErrorInvalidValue);  // th_flash_bwd_tc_dkdv_dq's
  Call c;
  const int err = prepare(c, TH_BWD_TC_PASS, kT, kKeys);
  if (err != 0) return err;
  const int blocks = batch * hkv * ((sk + kKeys - 1) / kKeys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = window > 0;
  if (d == 64)
    return w ? launch(flash_bwd_tc_dkdv_kernel<64, true>, DkdvLayout<64>::kBytes, blocks, c, s)
             : launch(flash_bwd_tc_dkdv_kernel<64, false>, DkdvLayout<64>::kBytes, blocks, c, s);
  return w ? launch(flash_bwd_tc_dkdv_kernel<128, true>, DkdvLayout<128>::kBytes, blocks, c, s)
           : launch(flash_bwd_tc_dkdv_kernel<128, false>, DkdvLayout<128>::kBytes, blocks, c, s);
}

extern "C" int th_flash_bwd_tc_dq(TH_BWD_TC_ARGS) {
  if (d == kD256) return static_cast<int>(cudaErrorInvalidValue);  // th_flash_bwd_tc_dkdv_dq's
  Call c;
  const int err = prepare(c, TH_BWD_TC_PASS, kRows, kT);
  if (err != 0) return err;
  const int blocks = batch * hq * ((sq + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = window > 0;
  if (d == 64)
    return w ? launch(flash_bwd_tc_dq_kernel<64, true>, DqLayout<64>::kBytes, blocks, c, s)
             : launch(flash_bwd_tc_dq_kernel<64, false>, DqLayout<64>::kBytes, blocks, c, s);
  return w ? launch(flash_bwd_tc_dq_kernel<128, true>, DqLayout<128>::kBytes, blocks, c, s)
           : launch(flash_bwd_tc_dq_kernel<128, false>, DqLayout<128>::kBytes, blocks, c, s);
}

// D = 256 only, after th_flash_bwd_tc_pre: dk, dv and dq in one launch of
// `grid` persistent blocks walking the work list `work` (int32 on the
// device: grid + 1 offsets, then four ints an item; flash_attention's
// bwd256_order)
extern "C" int th_flash_bwd_tc_dkdv_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                       void* dq, void* dk, void* dv, const float* lse, float* stats,
                                       const long long* strides, int batch, int hq, int hkv, int sq, int sk, int d,
                                       int causal, float softcap, int q_offset, int kv_len, int window,
                                       const int* work, int grid, void* stream) {
  if (d != kD256 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  Call c;
  const int err = prepare(c, TH_BWD_TC_PASS, kT, kT);
  if (err != 0) return err;
  Bwd256Params bp;
  static_cast<BwdParams&>(bp) = c.p;
  bp.work = work;
  const double log2e = 1.4426950408889634, scale = 1.0 / sqrt(static_cast<double>(d));
  bp.kcap = softcap > 0.f ? static_cast<float>(2.0 * log2e * scale / softcap) : 0.f;
  bp.c2 = static_cast<float>(softcap * log2e);
  bp.k2 = static_cast<float>(scale * log2e);
  auto kernel = window > 0 ? flash_bwd_tc256_kernel<true> : flash_bwd_tc256_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd256Layout::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, Bwd256Layout::kBytes, static_cast<cudaStream_t>(stream)>>>(c.qm, c.km, c.vm, c.dom, bp,
                                                                                        c.dims);
  return static_cast<int>(cudaGetLastError());
}
