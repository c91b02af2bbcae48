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
// Head_dim 256 has kernels of its own (section 4 below).
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
  constexpr int V = D / 32;  // elements a lane: 2 or 4
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
#pragma unroll
    for (int e = 0; e < V; e += 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.o + ro + e));
      const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.dout + rg + e));
      acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
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

// -- 4. head_dim 256: dK/dV and dQ with D split between the warpgroups ---------------

// At D = 256 a warpgroup holding dK and dV of 64 keys over all of D would
// need 256 f32 registers a thread, and the dQ block's 128 rows of Q and dO
// (128 KB) beside a ring of 32 KB tiles overflow the shared memory. So a
// block owns 64 keys (dK/dV) or 64 query rows (dQ), and its two consumer
// warpgroups split the work of a tile: warpgroup 0 computes S^T = K Q^T
// (dQ: S = Q K^T) and warpgroup 1 dP^T = V dO^T (dP = dO V^T), each over
// all of D (16 wgmma steps); warpgroup 1 hands dP^T to warpgroup 0 through
// shared memory (f32, in its accumulator layout: thread t's i-th value at
// [i][t], so a warp's accesses are consecutive); warpgroup 0 forms P^T and
// dS^T, rounds them to bf16 A fragments and hands them back the same way;
// then each warpgroup accumulates its half of D's columns (128) of dV += P^T
// dO and dK += dS^T Q (dQ += dS K) as m64n128k16 products with the B
// operand read from the tile's boxes 2 wg and 2 wg + 1. Two named barriers
// a tile order the hand-overs (the second also tells warpgroup 1 that
// warpgroup 0 has read dP^T, the first the converse for the fragments).
// Registers: 64 + 64 f32 of dK and dV (dQ: 64) beside 32 of S or dP and
// the 32 fragment words. Shared memory, dK/dV: K and V of the block 2 x 32
// KB, two stages of Q, dO (2 x 32 KB) and stats (512 B), and the hand-over
// 2 x 16 KB: 230,400 bytes, 231,464 with the barriers and the alignment
// slack, of the 232,448 a block may use. dQ: Q and dO 2 x 32 KB, two stages
// of K and V 2 x 2 x 32 KB, the hand-over 16 + 8 KB: 221,184 bytes (222,248).
constexpr int kD256 = 256;
constexpr int kStages256 = 2;
constexpr uint32_t kTile256 = kT * kD256 * 2;  // 64 rows of 256 bf16: 32 KB
constexpr uint32_t kHand = 32 * 128 * 4;       // 32 words of each thread of a warpgroup: 16 KB

struct Dkdv256Layout {
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kTile256;
  static constexpr uint32_t kQ = kV + kTile256;
  static constexpr uint32_t kDO = kQ + kStages256 * kTile256;
  static constexpr uint32_t kStats = kDO + kStages256 * kTile256;
  static constexpr uint32_t kDP = kStats + kStages256 * kStatsTile * 4;
  static constexpr uint32_t kPD = kDP + kHand;  // P^T fragments (words 0-15), dS^T (16-31)
  static constexpr uint32_t kBar = kPD + kHand;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages256) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

struct Dq256Layout {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kTile256;
  static constexpr uint32_t kK = kDO + kTile256;
  static constexpr uint32_t kV = kK + kStages256 * kTile256;
  static constexpr uint32_t kDP = kV + kStages256 * kTile256;
  static constexpr uint32_t kDS = kDP + kHand;  // dS fragments (16 words)
  static constexpr uint32_t kBar = kDS + kHand / 2;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages256) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// the two consumer warpgroups' named barrier `id` (0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kConsumers) : "memory");
}

template <bool W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tc_dkdv256_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                                const BwdParams p, const BwdDims dims) {
  using L = Dkdv256Layout;
  constexpr int NB = kD256 / kBox;
  constexpr int kS = kStages256;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const float* stats = reinterpret_cast<const float*>(smem + L::kStats);
  float* dps = reinterpret_cast<float*>(smem + L::kDP);
  uint32_t* pds = reinterpret_cast<uint32_t*>(smem + L::kPD);
  auto bar = [&](int i) { return base + L::kBar + 8 * i; };
  auto kv_full = [&]() { return bar(0); };
  auto full = [&](int s) { return bar(1 + s); };
  auto empty = [&](int s) { return bar(1 + kS + s); };
  auto q_tile = [&](int s) { return base + L::kQ + s * kTile256; };
  auto do_tile = [&](int s) { return base + L::kDO + s * kTile256; };

  const int tid = threadIdx.x;
  const int nbkv = p.batch * p.hkv;
  const int bkv = blockIdx.x % nbkv;
  const int k0 = (blockIdx.x / nbkv) * kT;  // the block's 64 keys; the first keys (the most query tiles) first
  const int b = bkv / p.hkv, hk = bkv % p.hkv;
  const int k_last = min(k0 + kT, p.kv_len) - 1;
  const int first = p.causal ? max(0, k0 - p.q_offset) / kT : 0;
  const int ntiles = k0 < p.kv_len ? max(q_tiles_end<W>(p, k_last) - first, 0) : 0;
  const int nitems = p.group * ntiles;

  if (tid == 0) {
    mbar_init(kv_full(), 1);
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
      if (nitems > 0) {
        mbar_expect_tx(kv_full(), 2 * kTile256);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(base + L::kK + nb * kT * kRowBytes, &kmap, kv_full(), dims.k, nb * kBox, k0, hk, b);
          tma_load(base + L::kV + nb * kT * kRowBytes, &vmap, kv_full(), dims.v, nb * kBox, k0, hk, b);
        }
      }
      for (int it = 0; it < nitems; ++it) {
        const int h = hk * p.group + it / ntiles;
        const int qt = first + it % ntiles;
        const int s = it % kS;
        mbar_wait(empty(s), ((it / kS) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile256 + kStatsTile * 4);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load(q_tile(s) + nb * kT * kRowBytes, &qmap, full(s), dims.q, nb * kBox, qt * kT, h, b);
          tma_load(do_tile(s) + nb * kT * kRowBytes, &domap, full(s), dims.dout, nb * kBox, qt * kT, h, b);
        }
        bulk_load(base + L::kStats + s * kStatsTile * 4,
                  p.stats + (static_cast<long long>(b * p.hq + h) * p.nq + qt) * kStatsTile, kStatsTile * 4, full(s));
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  // consumers: both warpgroups hold the block's keys; this thread holds
  // key rows ra and ra + 8, query columns 8j + col + {0, 1} of S^T / dP^T,
  // and columns 128 wg + 8j + col + {0, 1} of dK and dV
  const int t = tid % 128, warp = t / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int key_a = k0 + ra, key_b = key_a + 8;
  float dk[kD256 / 4], dv[kD256 / 4];
#pragma unroll
  for (int i = 0; i < kD256 / 4; ++i) dk[i] = dv[i] = 0.f;
  if (nitems > 0) mbar_wait(kv_full(), 0);

  for (int it = 0; it < nitems; ++it) {
    const int i0 = (first + it % ntiles) * kT;
    const int s = it % kS;
    mbar_wait(full(s), (it / kS) & 1);
    const int i_last = min(p.sq, i0 + kT) - 1;
    // the same for both warpgroups, so both pass the named barriers or neither
    if ((!p.causal || k0 <= p.q_offset + i_last) && (!W || k_last > p.q_offset + i0 - p.window)) {
      float acc[kT / 2];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) acc[i] = 0.f;
      wgmma_fence();
      if (wg == 0)
        gemm_ss<kD256>(acc, base + L::kK, kT * kRowBytes, q_tile(s), kT * kRowBytes);
      else
        gemm_ss<kD256>(acc, base + L::kV, kT * kRowBytes, do_tile(s), kT * kRowBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < kT / 2; ++i) dps[i * 128 + t] = acc[i];
      }
      consumers_sync(1);  // dP^T is in; warpgroup 1 has read the last tile's fragments
      if (wg == 0) {
        const float* lse2 = stats + s * kStatsTile;
        const float* di = lse2 + kT;
        const bool edge = k0 + kT > p.kv_len || i0 + kT > p.sq || (p.causal && k0 + kT - 1 > p.q_offset + i0) ||
                          (W && k0 <= p.q_offset + i0 + kT - 1 - p.window);
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          float pr[8], ds[8];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kk + jj;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int qc = 8 * j + col + c;
              const bool row_ok = i0 + qc < p.sq;
              const int qpos = p.q_offset + i0 + qc;
              const int ea = 4 * j + c, eb = 4 * j + 2 + c;  // this thread's elements (keys a, b)
              float sa = acc[ea], da = dps[ea * 128 + t], sb = acc[eb], db = dps[eb * 128 + t];
              p_ds(p, sa, da, lse2[qc], di[qc], !edge || (row_ok && live<W>(p, key_a, qpos)));
              p_ds(p, sb, db, lse2[qc], di[qc], !edge || (row_ok && live<W>(p, key_b, qpos)));
              pr[ea - 8 * kk] = sa, ds[ea - 8 * kk] = da;
              pr[eb - 8 * kk] = sb, ds[eb - 8 * kk] = db;
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pds[(4 * kk + r) * 128 + t] = pack_bf16(pr[2 * r], pr[2 * r + 1]);
            pds[(16 + 4 * kk + r) * 128 + t] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
          }
        }
      }
      consumers_sync(2);  // the fragments are in; warpgroup 0 has read dP^T
      uint32_t pa[kT / 16][4], da[kT / 16][4];
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pds[(4 * kk + r) * 128 + t];
          da[kk][r] = pds[(16 + 4 * kk + r) * 128 + t];
        }
      const uint32_t half = 2 * wg * kT * kRowBytes;  // this warpgroup's two 64-column boxes
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)  // dO [queries][D] as the MN-major B operand, 16 queries a step
        wgmma_rs<128>(dv, pa[kk], sw128_desc(do_tile(s) + half + kk * 16 * kRowBytes, kT * kRowBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_rs<128>(dk, da[kk], sw128_desc(q_tile(s) + half + kk * 16 * kRowBytes, kT * kRowBytes, 1024));
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
  for (int j = 0; j < kD256 / 16; ++j) {
    const int d = 128 * wg + 8 * j + col;
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

template <bool W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tc_dq256_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                              const BwdParams p, const BwdDims dims) {
  using L = Dq256Layout;
  constexpr int NB = kD256 / kBox;
  constexpr int kS = kStages256;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  float* dps = reinterpret_cast<float*>(smem + L::kDP);
  uint32_t* dss = reinterpret_cast<uint32_t*>(smem + L::kDS);
  auto bar = [&](int i) { return base + L::kBar + 8 * i; };
  auto q_full = [&]() { return bar(0); };
  auto full = [&](int s) { return bar(1 + s); };
  auto empty = [&](int s) { return bar(1 + kS + s); };
  auto k_tile = [&](int s) { return base + L::kK + s * kTile256; };
  auto v_tile = [&](int s) { return base + L::kV + s * kTile256; };

  const int tid = threadIdx.x;
  const int nbh = p.batch * p.hq;
  const int bh = blockIdx.x % nbh;
  const int i0 = (p.nq - 1 - blockIdx.x / nbh) * kT;  // the block's 64 rows; the last (the most keys) first
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int i_last = min(p.sq, i0 + kT) - 1;
  // live keys [kv_start, kv_end): every tile between holds a key some row sees
  const int kv_end = p.causal ? min(p.kv_len, p.q_offset + i_last + 1) : p.kv_len;
  const int t0 = W ? max(0, p.q_offset + i0 - p.window + 1) / kT : 0;
  const int ntiles = (kv_end + kT - 1) / kT - t0;

  if (tid == 0) {
    mbar_init(q_full(), 1);
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
      mbar_expect_tx(q_full(), 2 * kTile256);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load(base + L::kQ + nb * kT * kRowBytes, &qmap, q_full(), dims.q, nb * kBox, i0, h, b);
        tma_load(base + L::kDO + nb * kT * kRowBytes, &domap, q_full(), dims.dout, nb * kBox, i0, h, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kS;
        mbar_wait(empty(s), ((t / kS) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile256);
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

  // consumers: both warpgroups hold the block's rows; this thread holds
  // rows ra and ra + 8, key columns 8j + col + {0, 1} of S / dP, and
  // columns 128 wg + 8j + col + {0, 1} of dQ
  const int t = tid % 128, warp = t / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int i_a = i0 + ra, i_b = i_a + 8;
  float lse_a = 0.f, lse_b = 0.f, di_a = 0.f, di_b = 0.f;
  if (wg == 0) {
    const float* st = p.stats + (static_cast<long long>(bh) * p.nq + i0 / kT) * kStatsTile;
    lse_a = st[ra];
    lse_b = st[ra + 8];
    di_a = st[kT + ra];
    di_b = st[kT + ra + 8];
  }
  float dq[kD256 / 4];
#pragma unroll
  for (int i = 0; i < kD256 / 4; ++i) dq[i] = 0.f;
  mbar_wait(q_full(), 0);

  for (int tt = 0; tt < ntiles; ++tt) {
    const int s = tt % kS;
    const int k0 = (t0 + tt) * kT;
    mbar_wait(full(s), (tt / kS) & 1);
    float acc[kT / 2];  // S (warpgroup 0) or dP (warpgroup 1)
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
    if (wg == 0)
      gemm_ss<kD256>(acc, base + L::kQ, kT * kRowBytes, k_tile(s), kT * kRowBytes);
    else
      gemm_ss<kD256>(acc, base + L::kDO, kT * kRowBytes, v_tile(s), kT * kRowBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) dps[i * 128 + t] = acc[i];
    }
    consumers_sync(1);  // dP is in; warpgroup 1 has read the last tile's fragments
    if (wg == 0) {
      const bool edge = k0 + kT > p.kv_len || i0 + kT > p.sq || (p.causal && k0 + kT - 1 > p.q_offset + i0) ||
                        (W && k0 <= p.q_offset + i0 + kT - 1 - p.window);
      const bool ok_a = i_a < p.sq, ok_b = i_b < p.sq;
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        float ds[8];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 8 * j + col + c;
            const int ea = 4 * j + c, eb = 4 * j + 2 + c;
            float sa = acc[ea], da = dps[ea * 128 + t], sb = acc[eb], db = dps[eb * 128 + t];
            p_ds(p, sa, da, lse_a, di_a, !edge || (ok_a && live<W>(p, key, p.q_offset + i_a)));
            p_ds(p, sb, db, lse_b, di_b, !edge || (ok_b && live<W>(p, key, p.q_offset + i_b)));
            ds[ea - 8 * kk] = da;
            ds[eb - 8 * kk] = db;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) dss[(4 * kk + r) * 128 + t] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
    }
    consumers_sync(2);  // the fragments are in; warpgroup 0 has read dP
    uint32_t da[kT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[kk][r] = dss[(4 * kk + r) * 128 + t];
    const uint32_t half = 2 * wg * kT * kRowBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)  // K [keys][D] as the MN-major B operand, 16 keys a step
      wgmma_rs<128>(dq, da[kk], sw128_desc(k_tile(s) + half + kk * 16 * kRowBytes, kT * kRowBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    mbar_arrive(empty(s));
  }

  __nv_bfloat16* dqg = p.dq + b * p.dqs[0] + h * p.dqs[1];
#pragma unroll
  for (int j = 0; j < kD256 / 16; ++j) {
    const int d = 128 * wg + 8 * j + col;
    if (i_a < p.sq)
      store_pair(dqg + static_cast<long long>(i_a) * p.dqs[2], d, dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
    if (i_b < p.sq)
      store_pair(dqg + static_cast<long long>(i_b) * p.dqs[2], d, dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
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
// 256}; 1 <= kv_len <= Sk; window > 0 a sliding window, 0 none. Three
// entry points with the same arguments, launched in this order on one
// stream: th_flash_bwd_tc_pre writes stats (each query tile's lse log2 e
// and D_i), th_flash_bwd_tc_dkdv writes dk and dv (zeros past kv_len),
// th_flash_bwd_tc_dq writes dq. Each returns cudaGetLastError() after its
// launch, or a tensor-map encoding failure negated.
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
  Call c;
  const int keys = d == kD256 ? kT : kKeys;  // keys a block
  const int err = prepare(c, TH_BWD_TC_PASS, kT, keys);
  if (err != 0) return err;
  const int blocks = batch * hkv * ((sk + keys - 1) / keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = window > 0;
  switch (d) {
    case 64:
      return w ? launch(flash_bwd_tc_dkdv_kernel<64, true>, DkdvLayout<64>::kBytes, blocks, c, s)
               : launch(flash_bwd_tc_dkdv_kernel<64, false>, DkdvLayout<64>::kBytes, blocks, c, s);
    case 128:
      return w ? launch(flash_bwd_tc_dkdv_kernel<128, true>, DkdvLayout<128>::kBytes, blocks, c, s)
               : launch(flash_bwd_tc_dkdv_kernel<128, false>, DkdvLayout<128>::kBytes, blocks, c, s);
    default:
      return w ? launch(flash_bwd_tc_dkdv256_kernel<true>, Dkdv256Layout::kBytes, blocks, c, s)
               : launch(flash_bwd_tc_dkdv256_kernel<false>, Dkdv256Layout::kBytes, blocks, c, s);
  }
}

extern "C" int th_flash_bwd_tc_dq(TH_BWD_TC_ARGS) {
  Call c;
  const int rows = d == kD256 ? kT : kRows;  // query rows a block
  const int err = prepare(c, TH_BWD_TC_PASS, rows, kT);
  if (err != 0) return err;
  const int blocks = batch * hq * ((sq + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = window > 0;
  switch (d) {
    case 64:
      return w ? launch(flash_bwd_tc_dq_kernel<64, true>, DqLayout<64>::kBytes, blocks, c, s)
               : launch(flash_bwd_tc_dq_kernel<64, false>, DqLayout<64>::kBytes, blocks, c, s);
    case 128:
      return w ? launch(flash_bwd_tc_dq_kernel<128, true>, DqLayout<128>::kBytes, blocks, c, s)
               : launch(flash_bwd_tc_dq_kernel<128, false>, DqLayout<128>::kBytes, blocks, c, s);
    default:
      return w ? launch(flash_bwd_tc_dq256_kernel<true>, Dq256Layout::kBytes, blocks, c, s)
               : launch(flash_bwd_tc_dq256_kernel<false>, Dq256Layout::kBytes, blocks, c, s);
  }
}
