// Absorbed multi-head latent attention for decode (deepseek-v3's MLA), on
// Hopper's tensor cores, split-KV.
//
// The JAX package has no Pallas kernel for it: its absorbed decode
// (src/repro/models/blocks.py:184-208, mla_apply with a cache) computes
// these einsums in f32 under XLA. For batch b and query head h, against
// the latent cache ckv [B, Smax, R] and the decoupled rope keys krope [B,
// Smax, rd] (one shared "KV head" of width R + rd for all H query heads):
//   s   = ((q_abs . ckv_t) + (q_rope . krope_t)) * scale    f32
//   s   = -1e30 where slot t >= kv_len                        (no causal term)
//   out = softmax(s) . ckv                                     f32 [B, H, R]
// with R = 512, rd = 64 (deepseek-v3), Sq = 1, and the scale the caller's
// (1 / sqrt(qk_nope + qk_rope) = 1 / sqrt(192), not 1 / sqrt(R + rd)).
//
// Bound: one step reads the live latent rows once (kv_len x 576 bf16 a
// batch: 2.4 MB at the served shape of 4 x 528 slots, 37.7 MB at 4 x
// 8192), the queries (0.6 MB) and writes the f32 output (1 MB): 1.2 us
// and 11.8 us at 3.35 TB/s; it does 2 x H x kv_len x (576 + 512)
// operations a batch (0.59 GFLOP served, 0.6 us at the bf16 peak). So it
// is bound by bytes, and both products run on the tensor cores (wgmma) so
// that the CUDA cores keep only the softmax.
//
// Numerics. Every operand of the reference's einsums is bf16 here (q_abs,
// q_rope, ckv, krope), so each product of S = Q.K^T is exact in the f32
// accumulator and only the order of the sums differs from the f32 einsum
// (the 576 columns of [q_abs | q_rope] . [ckv | krope] are summed in two
// halves of 288, one a warpgroup, and the halves added). The softmax
// weights P in f32 would lose 2^-9 of each weight as one bf16 operand,
// ~100x the f32 gate (2e-5 of the output's max); so P = P_hi + P_lo with
// P_hi = bf16(p)
// and P_lo = bf16(p - P_hi) (p - P_hi is exact in f32), both issued as
// register-A products into the same f32 O against the same V tile: each
// weight keeps ~2^-16 of itself at worst. The row sum l adds the f32 p.
// exp is ex2.approx of a prescaled argument (relative error ~2^-22).
// mla_decode_split_plain (kernels/mla_decode/__init__.py) is this
// algorithm in plain PyTorch.
//
// Design (one kernel for the splits, one for the merge; both launched by
// th_mla_decode, one "launch" of the wrapper):
// * A block takes 64 query heads of one batch (M = 64 of every wgmma)
//   against one split of the slots: grid (split, head group, batch).
//   split_plan (the wrapper) decides the splits, in whole 32-key tiles.
// * A producer warpgroup's first thread loads by TMA: the block's queries
//   once ([q_abs | q_rope], nine 64-column boxes of 64 rows: 72 KB; heads
//   past H arrive as zeros and are never stored), then each 32-key tile of
//   [ckv | krope] rows (nine boxes of 32 rows: 36 KB) into a ring of three
//   stages on full/empty mbarriers, all in the 128-byte swizzle. The
//   cache's tensor maps are built per call from the caller's batch and
//   slot strides (a layer's slice of the stacked cache is read in place)
//   with the slot extent set to kv_len, not Smax: TMA fills the slots past
//   kv_len with zeros, so a dead slot's NaN never meets a product (0 x NaN
//   would be NaN in P.V); the zero slots' scores are masked to -1e30.
// * The tile in shared memory is K^T for S (K-major, 576 columns) and its
//   first 512 columns are V for P.V (MN-major), as the flash kernels use
//   their tiles.
// * Two consumer warpgroups each own 256 of O's 512 columns (64 x 256 f32:
//   128 registers a thread). Each computes half of S's columns
//   (wgmma.m64n32k16, 18 k-steps, both operands in shared memory), hands
//   its f32 half to the other through shared memory (8 KB, a named
//   barrier a tile) and adds the other's: both hold the same S bits and
//   run the same online softmax, so no P is handed over. Then O += P_hi.V
//   + P_lo.V as m64n128k16 products with A from registers. S at N = 32
//   reads 3 KB of shared memory a 16-cycle product, more than its 128
//   bytes a cycle: a whole S in each warpgroup (the simplest form) took
//   ~1730 of a tile's ~2750 tensor-core cycles at peak, its halves ~860.
// * Tile t's S is issued together with tile t-1's P.V, and t's softmax
//   runs while that P.V is in flight (wgmma.wait_group 1); O is rescaled
//   by t's factors once it is done. The loop is straight-line prologue,
//   steady state and drain: a wgmma issued under a condition makes ptxas
//   serialise them.
// * Shared memory: Q 72 KB + 3 stages x 36 KB + the exchange's two tiles
//   of 2 x 8 KB = 212 KB of the 227 KB (64-key stages would leave no room
//   for the exchange; 32-key tiles also let a served step's short splits
//   fill more SMs). Registers: the producer warpgroup gives its own back
//   (setmaxnreg 40) and the consumers take 232 (2 x 128 x 232 + 128 x 40 <=
//   65536): O, S, P_hi/P_lo and the softmax need ~180; without setmaxnreg
//   ptxas holds 384 threads to 168 a thread, spills and serialises the
//   wgmma.
// * Each split writes its partial (O, m, l) in f32 to the scratch the
//   wrapper allocated, [B * H][nsplit][512] then [B * H][nsplit][2]. A
//   second small kernel merges them, one block of 128 threads a (batch,
//   head) row, four columns a thread, in split order: M = max m_i, out =
//   sum exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i, 1e-30); the two
//   kernels run in stream order, so the merge spreads over the card, needs
//   no counter and no memset, and a rerun gives the same bits. With one
//   split the block writes acc / max(l, 1e-30) itself (the merge's value
//   for one split) and the merge is not launched.
// * Measured and not kept (tools/mla_decode_ab.py, PERF.md): 17 one-tile
//   splits at the served step (136 blocks, two waves) against split_plan's
//   9; a cluster of the two head groups of a split loading each tile once
//   for both by TMA multicast; the merge launched early as a programmatic
//   dependent launch. Each was slower. By copies of the kernel with one
//   piece removed (tools/mla_decode_pieces.py) the loads, the ring and
//   the partials' writes alone take ~2/3 of the split kernel's time at
//   8192 slots.

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kHeads = 64;                   // query heads a block: the M of every wgmma
constexpr int kTile = 32;                    // keys a tile, the unit of a split
constexpr int kStages = 3;                   // the tile ring
constexpr int kR = 512;                      // the latent width
constexpr int kRope = 64;                    // the rope keys' width
constexpr int kBoxes = (kR + kRope) / kBox;  // 64-column boxes of a score row: 9
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int kSteps = kBoxes * 4 / 2;       // k-steps of 16 columns a warpgroup's half of S: 18
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;

constexpr uint32_t kQBox = kHeads * kRowBytes;     // a box of the queries: 8 KB
constexpr uint32_t kTBox = kTile * kRowBytes;      // a box of a tile: 4 KB
constexpr uint32_t kQBytes = kBoxes * kQBox;       // 72 KB
constexpr uint32_t kTileBytes = kBoxes * kTBox;    // 36 KB
constexpr uint32_t kQ = 0;
constexpr uint32_t kT = kQ + kQBytes;
constexpr uint32_t kX = kT + kStages * kTileBytes;  // the S halves' exchange: [2 tiles][2 warpgroups][16][128] f32
constexpr uint32_t kBar = kX + 2 * 2 * (kTile / 2) * 128 * 4;
constexpr uint32_t kSmemBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
static_assert(kSmemBytes <= 232448, "a block's shared memory on sm_90");

struct MlaParams {
  float* out;   // [B, H, R]
  float* part;  // acc [B * H][nsplit][R], then (m, l) [B * H][nsplit][2]; unused with one split
  int heads, kv_len, keys_per_split, nsplit;
  float scale;
};

// where the sequence (heads for the queries, slots for the cache), head
// and batch coordinates go among each map's dimensions 1..3
struct MlaDims {
  int qa[3], qr[3], c[3], r[3];
};

// two f32 weights as bf16 hi = bf16(x) and lo = bf16(x - hi), packed in pairs
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_kernel(const __grid_constant__ CUtensorMap qa_map, const __grid_constant__ CUtensorMap qr_map,
                      const __grid_constant__ CUtensorMap c_map, const __grid_constant__ CUtensorMap r_map,
                      const MlaParams p, const MlaDims dims) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + kBar;
  auto full = [&](int s) { return base + kBar + 8 * (1 + s); };
  auto empty = [&](int s) { return base + kBar + 8 * (1 + kStages + s); };
  auto tile = [&](int s) { return base + kT + s * kTileBytes; };
  float* xs = reinterpret_cast<float*>(smem + kX);

  const int split = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * kHeads;
  const int tid = threadIdx.x;
  const int k_begin = split * p.keys_per_split;
  const int k_end = min(k_begin + p.keys_per_split, p.kv_len);
  const int ntiles = (k_end - k_begin + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues every load
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int nb = 0; nb < kR / kBox; ++nb)
        tma_load(base + kQ + nb * kQBox, &qa_map, q_full, dims.qa, nb * kBox, h0, 0, b);
      tma_load(base + kQ + (kR / kBox) * kQBox, &qr_map, q_full, dims.qr, 0, h0, 0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        const int key0 = k_begin + t * kTile;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);  // passes at once on a fresh stage
        mbar_expect_tx(full(s), kTileBytes);
#pragma unroll
        for (int nb = 0; nb < kR / kBox; ++nb)
          tma_load(tile(s) + nb * kTBox, &c_map, full(s), dims.c, nb * kBox, key0, 0, b);
        tma_load(tile(s) + (kR / kBox) * kTBox, &r_map, full(s), dims.r, 0, key0, 0, b);
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();

  // consumers: warpgroup wg owns O's columns [256 wg, 256 wg + 256); this
  // thread holds heads ra and ra + 8 of the block's 64, columns
  // 8j + 2 (lane % 4) + {0, 1} of each accumulator
  const int wg = warpgroup_idx();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  float o[kR / 4];
#pragma unroll
  for (int i = 0; i < kR / 4; ++i) o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float sc[kTile / 2];
  uint32_t ph[kTile / 16][4], pl[kTile / 16][4];  // P_hi and P_lo of the tile whose P.V is next

  // this warpgroup's half of S = [q_abs | q_rope] . [ckv | krope]^T of
  // tile t: 18 of the 36 k-steps of 16 columns
  auto issue_s = [&](int t) {
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) sc[i] = 0.f;
    wgmma_fence();  // after every register write the products read
    const uint32_t tl = tile(t % kStages);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int kk = kSteps * wg + k;
      const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the swizzled row
      wgmma_ss_n32(sc, sw128_desc(base + kQ + (kk / 4) * kQBox + off, 16, 1024),
                   sw128_desc(tl + (kk / 4) * kTBox + off, 16, 1024));
    }
    wgmma_commit();
  };
  // O += P_hi.V + P_lo.V of tile t: V [keys][512] is the MN-major B
  // operand, 16 keys a step (2 KB of 128-byte rows), 64-column blocks a box
  // (kTile rows) apart; this warpgroup's 256 columns start at box 4 wg
  auto issue_pv = [&](int t) {
    const uint32_t tl = tile(t % kStages);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t db = sw128_desc(tl + 4 * wg * kTBox + kk * 16 * kRowBytes, kTBox, 1024);
      wgmma_rs<256>(o, ph[kk], db);
      wgmma_rs<256>(o, pl[kk], db);
    }
    wgmma_commit();
  };
  // S from the two halves: this warpgroup's (in sc) and the other's,
  // handed over through shared memory in the accumulator's layout; both
  // warpgroups add the same two numbers, so their S are the same bits.
  // The buffers alternate by tile: the other warpgroup reads tile t's
  // before it reaches tile t + 1's barrier, so t + 2's writes find them free
  auto exchange = [&](int t) {
    float* mine = xs + ((t & 1) * 2 + wg) * (kTile / 2) * 128 + tid % 128;
    const float* other = xs + ((t & 1) * 2 + (1 - wg)) * (kTile / 2) * 128 + tid % 128;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) mine[i * 128] = sc[i];
    named_sync(1, kConsumers);
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) sc[i] += other[i * 128];
  };
  // the online softmax of tile t's scores: P (f32, in sc), m, l, and the
  // factors O must be rescaled by once the last P.V is done
  auto softmax = [&](int t, float& al_a, float& al_b) {
    const int key0 = k_begin + t * kTile;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) sc[i] *= p.scale;
    if (key0 + kTile > p.kv_len) {  // the tile at kv_len: its zero-filled slots masked
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (key0 + 8 * j + col + c >= p.kv_len) sc[4 * j + c] = sc[4 * j + 2 + c] = kNegInf;
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 2));
    // every tile holds a live slot, so the new max is finite; exp(x - m)
    // as 2^(x log2 e - m log2 e): one FFMA and one MUFU a score
    const float mc_a = fmaxf(m_a, mx_a), mc_b = fmaxf(m_b, mx_b);
    const float ml_a = mc_a * kLog2e, ml_b = mc_b * kLog2e;
    al_a = ex2(fmaf(m_a, kLog2e, -ml_a));
    al_b = ex2(fmaf(m_b, kLog2e, -ml_b));
    m_a = mc_a;
    m_b = mc_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sc[4 * j + c] = ex2(fmaf(sc[4 * j + c], kLog2e, -ml_a));
        sc[4 * j + 2 + c] = ex2(fmaf(sc[4 * j + 2 + c], kLog2e, -ml_b));
        sum_a += sc[4 * j + c];
        sum_b += sc[4 * j + 2 + c];
      }
    }
    l_a = l_a * al_a + sum_a;  // this thread's share of the row sums, from the f32 p
    l_b = l_b * al_b + sum_b;
  };
  // P = P_hi + P_lo in bf16, once the last P.V has read the previous ones;
  // the accumulator's (row, column) layout is the A fragment's
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], ph[kk][i], pl[kk][i]);
  };
  auto rescale = [&](float al_a, float al_b) {
#pragma unroll
    for (int j = 0; j < kR / 16; ++j) {
      o[4 * j + 0] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }
  };

  // tile t's S is issued with tile t-1's P.V, and t's softmax runs while
  // that P.V is in flight; O is rescaled by t's factors once it is done.
  // Straight-line prologue, steady loop and drain: a wgmma issued under a
  // condition makes ptxas serialise them
  mbar_wait(q_full, 0);
  mbar_wait(full(0), 0);
  issue_s(0);
  wgmma_wait_all();
  fence_regs(sc);
  exchange(0);
  float al_a, al_b;
  softmax(0, al_a, al_b);  // O is still zero: no rescale
  pack();
  for (int t = 1; t < ntiles; ++t) {
    mbar_wait(full(t % kStages), (t / kStages) & 1);
    issue_s(t);
    issue_pv(t - 1);
    wgmma_wait_one();  // S of tile t done; the P.V still runs
    fence_regs(sc);
    exchange(t);
    softmax(t, al_a, al_b);
    wgmma_wait_all();  // P.V of tile t-1 done: O and its P are free
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(empty((t - 1) % kStages));
    rescale(al_a, al_b);
    pack();
  }
  wgmma_fence();
  issue_pv(ntiles - 1);
  wgmma_wait_all();
  fence_regs(o);
  mbar_arrive(empty((ntiles - 1) % kStages));

  l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 1);
  l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 2);
  l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 1);
  l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 2);
  const int ha = h0 + ra, hb = ha + 8;
  const bool live_a = ha < p.heads, live_b = hb < p.heads;
  const int c0 = 256 * wg + col;
  if (p.nsplit == 1) {
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    float* out_a = p.out + (static_cast<size_t>(b) * p.heads + ha) * kR + c0;
    float* out_b = out_a + 8 * kR;
#pragma unroll
    for (int j = 0; j < kR / 16; ++j) {
      if (live_a) *reinterpret_cast<float2*>(out_a + 8 * j) = make_float2(o[4 * j] / den_a, o[4 * j + 1] / den_a);
      if (live_b)
        *reinterpret_cast<float2*>(out_b + 8 * j) = make_float2(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
    }
    return;
  }
  // this split's partial: acc rows of the (batch, head) rows, then (m, l)
  const size_t rows = static_cast<size_t>(gridDim.z) * p.heads;
  const size_t row_a = (static_cast<size_t>(b) * p.heads + ha) * p.nsplit + split;
  const size_t row_b = row_a + 8 * static_cast<size_t>(p.nsplit);
  float* acc_a = p.part + row_a * kR + c0;
  float* acc_b = p.part + row_b * kR + c0;
#pragma unroll
  for (int j = 0; j < kR / 16; ++j) {
    if (live_a) *reinterpret_cast<float2*>(acc_a + 8 * j) = make_float2(o[4 * j], o[4 * j + 1]);
    if (live_b) *reinterpret_cast<float2*>(acc_b + 8 * j) = make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
  if (wg == 0 && lane % 4 == 0) {  // m and l are the same in both warpgroups and in the row's 4 threads
    float* ml = p.part + rows * p.nsplit * kR;
    if (live_a) *reinterpret_cast<float2*>(ml + 2 * row_a) = make_float2(m_a, l_a);
    if (live_b) *reinterpret_cast<float2*>(ml + 2 * row_b) = make_float2(m_b, l_b);
  }
}

// the splits' partials of one (batch, head) row merged in split order;
// 128 threads, four columns each
__global__ void __launch_bounds__(kR / 4) mla_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                                                           int rows, int nsplit) {
  const int row = blockIdx.x, d = threadIdx.x * 4;
  const float* acc = part + static_cast<size_t>(row) * nsplit * kR + d;
  const float* ml = part + static_cast<size_t>(rows) * nsplit * kR + static_cast<size_t>(row) * nsplit * 2;
  float mx = kNegInf;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, ml[2 * i]);
  float lsum = 0.f, x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int i = 0; i < nsplit; ++i) {
    const float wi = expf(ml[2 * i] - mx);
    lsum = fmaf(wi, ml[2 * i + 1], lsum);
    const float4 a = *reinterpret_cast<const float4*>(acc + static_cast<size_t>(i) * kR);
    x[0] = fmaf(wi, a.x, x[0]);
    x[1] = fmaf(wi, a.y, x[1]);
    x[2] = fmaf(wi, a.z, x[2]);
    x[3] = fmaf(wi, a.w, x[3]);
  }
  const float dn = fmaxf(lsum, 1e-30f);
  *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * kR + d) =
      make_float4(x[0] / dn, x[1] / dn, x[2] / dn, x[3] / dn);
}

}  // namespace

// q_abs [B, H, 512] and q_rope [B, H, 64] bf16 (contiguous), the caches
// ckv [B, Smax, 512] and krope [B, Smax, 64] bf16 (unit stride in the last
// dimension; batch and slot element strides given, each a multiple of 8;
// 16-byte aligned), out f32 [B, H, 512] (contiguous). The slots [0, kv_len)
// are cut into nsplit splits of keys_per_split keys (a multiple of 32;
// nsplit = ceil(kv_len / keys_per_split) <= 64); `part` is f32 scratch of
// B * H * nsplit * (512 + 2) floats when nsplit > 1 (unused otherwise).
// Launches the split kernel and, when nsplit > 1, the merge kernel after
// it on the same stream; returns 0, cudaGetLastError() after a launch, or
// a tensor map's encoding error, negated.
extern "C" int th_mla_decode(const void* q_abs, const void* q_rope, const void* ckv, const void* krope, void* out,
                             int batch, int heads, long long ckv_b, long long ckv_s, long long kr_b, long long kr_s,
                             int kv_len, int keys_per_split, int nsplit, float scale, void* part, void* stream) {
  if (batch < 1 || heads < 1 || kv_len < 1 || keys_per_split <= 0 || keys_per_split % kTile || nsplit < 1 ||
      nsplit > kMaxSplits || nsplit != (kv_len + keys_per_split - 1) / keys_per_split)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qa_map, qr_map, c_map, r_map;
  MlaDims dims;
  // the queries as [B, 1, H, D] views (rows along the heads, zeros past H),
  // the caches as [B, 1, kv_len, D] (zeros past kv_len)
  const long long qa_st[3] = {static_cast<long long>(heads) * kR, 0, kR};
  const long long qr_st[3] = {static_cast<long long>(heads) * kRope, 0, kRope};
  const long long c_st[3] = {ckv_b, 0, ckv_s};
  const long long r_st[3] = {kr_b, 0, kr_s};
  int err = make_map(&qa_map, q_abs, kR, heads, 1, batch, qa_st, kHeads, dims.qa);
  if (!err) err = make_map(&qr_map, q_rope, kRope, heads, 1, batch, qr_st, kHeads, dims.qr);
  if (!err) err = make_map(&c_map, ckv, kR, kv_len, 1, batch, c_st, kTile, dims.c);
  if (!err) err = make_map(&r_map, krope, kRope, kv_len, 1, batch, r_st, kTile, dims.r);
  if (err) return err;
  MlaParams p;
  p.out = static_cast<float*>(out);
  p.part = static_cast<float*>(part);
  p.heads = heads;
  p.kv_len = kv_len;
  p.keys_per_split = keys_per_split;
  p.nsplit = nsplit;
  p.scale = scale;
  static bool sized = false;  // the attribute is set once
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nsplit, (heads + kHeads - 1) / kHeads, batch);
  mla_decode_kernel<<<grid, kThreads, kSmemBytes, st>>>(qa_map, qr_map, c_map, r_map, p, dims);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  mla_merge_kernel<<<batch * heads, kR / 4, 0, st>>>(static_cast<const float*>(part), static_cast<float*>(out),
                                                     batch * heads, nsplit);
  return static_cast<int>(cudaGetLastError());
}
