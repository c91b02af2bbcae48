// Flash attention (online softmax) for Hopper on the tensor cores: bf16
// q, k, v at head_dim 64, 80, 128 or 256, the prefill route of the serving
// path and the training forward (gemma2's at 256, hubert-xlarge's encoder
// at 80), and q/k at 192 with v at 128 (deepseek-v3's expanded MLA
// prefill).
//
// Replaces the Pallas TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention/kernel.py, _flash_kernel). For query
// head h of batch b against KV head h / G (GQA, G = Hq / Hkv):
//   s   = (q . k) * (1 / sqrt(D))          f32 accumulation, scale after it
//   s   = c * tanh(s / c)                  when softcap c > 0
//   s   = -1e30 where key j >= kv_len, or (causal) j > q_offset + i,
//         or (sliding window W) j <= q_offset + i - W
//   out = softmax(s) v                     online: m, l, acc in f32
// with the TPU kernel's numerics: -1e30 (not -inf) masks, alpha =
// exp(m_prev - m_cur), l = l * alpha + sum(p), acc / max(l, 1e-30) rounded
// once to bf16; the scale is computed in double as the TPU's Python scalar.
// Sources of error that the TPU kernel (f32 throughout) does not have: P
// is rounded to bf16 before the P.V product (relative error 2^-9 a term,
// the same rounding the tensor cores need for their operands); exp is
// ex2.approx of a prescaled argument (relative error ~2^-22, far below
// that rounding); each row's sum l is added up by four threads apart and
// joined at the end; the output is acc times the reciprocal of max(l,
// 1e-30) in f32 (within an ulp of the quotient) before its one rounding to
// bf16. All sit well inside the bf16 tolerance (2e-2).
//
// Bound: at the serving path's prefill shape (16 x 32 heads x 512 x 128,
// causal) the work is 34.4 GFLOP of live q.k pairs against 168 MB of q, k,
// v and o: 0.035 ms at the tensor cores' 989 TFLOP/s, 0.050 ms for the
// bytes at 3.35 TB/s. At gemma2's prefill (4 x 8 heads x 4608 x 256,
// causal, window 4096) 0.343 TFLOP of live pairs take 0.347 ms at the
// tensor cores' peak, the bytes 0.068. Both products run as wgmma on the
// tensor cores, so the CUDA cores keep only the softmax (and the softcap's
// tanh, one a score).
//
// Head_dim 64 and 128 (flash_tc_kernel; the wide plans below differ).
// Design (the "usual shape" of a Hopper kernel). A work item is 192 query
// rows of one query head; one persistent block an SM walks the items, the
// causal ones with the most key tiles first, so one item's loads and
// epilogue overlap the next one's math. A block is three consumer
// warpgroups of 64 rows and one producer warp (three, not two: while one
// warpgroup runs its softmax on the CUDA cores the others keep the tensor
// cores busy). GQA keeps one head an
// item: the G items of a KV group read the same K/V tiles, which the 50 MB
// L2 serves after the first (packing the group into one tile would cut the
// query positions a tile covers, not the bytes a FLOP). The producer's
// lane 0 issues TMA loads: an item's Q tile into one of two Q buffers,
// then K and V tiles of 64 keys into a ring of kStages stages that runs on
// across items, each completing on its own mbarrier (K and V apart, so
// Q.K^T starts while V is still in flight); the consumers release a stage
// and a Q buffer on "empty" mbarriers. Tiles land with the 128-byte
// swizzle that wgmma reads: a 128-wide bf16 row is two 64-element boxes.
// Each consumer warpgroup runs S = Q.K^T as wgmma.m64n64k16 with both
// operands K-major in shared memory, the online softmax in registers on
// the accumulator's layout (row max and sum over the 4 threads that share
// a row; exp(x - m) as ex2.approx of x log2 e - m log2 e, one FFMA and
// one MUFU a score), rounds P to bf16 in registers, where the
// accumulator's layout is already the A fragment's, and runs O += P.V as
// wgmma.m64nDk16 with A from registers and V as a transposed (MN-major) B
// operand. Key tiles past an item's last live key are not loaded at all
// (causal skipping), and under a window neither are the tiles wholly
// before the item's first row's window; a warpgroup whose own rows end
// earlier, or whose window starts later, skips the tile's math; only the
// diagonal tiles, the window's edge tiles and the kv_len edge are masked.
// The tensor maps are built per call from each tensor's own strides (the
// serving path's v is a view with sequence stride Hkv * D), with the
// sequence extent of K and V set to kv_len, so TMA fills keys past kv_len
// with zeros (a cache's stale slots never reach the math). The output
// goes out through shared memory: each warpgroup writes its normalised
// tile into its own rows of the item's Q buffer (its Q.K^T are done) in
// the 128-byte swizzle and one thread stores it by TMA, which clips the
// rows past Sq; the Q buffer is released once the store has read it.
//
// Head_dim 80 (hubert-xlarge: 1280 / 16 heads) runs the head_dim-128 plan
// (template DT = 80): a row of 80 bf16 is 160 bytes, not a whole number of
// the 64-element, 128-byte-swizzled boxes every tile row is made of, so
// the tensor maps of Q, K, V and O carry the true inner extent of 80 and
// TMA fills columns 80-127 of each row's second box with zeros on every
// load (the transaction count is the whole box's). S = Q.K^T runs five
// k-steps of 16 columns, the true width; O += P.V runs as m64n128k16 over
// all 128 columns, the last 48 of them P times zeros, and the TMA store
// clips the output at column 80 (a strided view's next head is never
// written). Cost: (80 + 128) / (2 x 80) = 1.3x the products of a native
// 80-wide plan (a 64-column box plus a 16-column box with a narrower
// swizzle and m64n80 for P.V: later work). The scale is 1/sqrt(80), from
// the host's true width. Every other instance has DT = DK and compiles as
// before.
//
// For the backward (flash_attention_bwd.cu) the epilogue also writes each
// row's log-sum-exp, m + log(max(l, 1e-30)) in f32, to lse [B, Hq, Sq]
// when the pointer is not null: m and the joined l are in registers there.
// The serving path passes null and pays one predicated branch an item.
//
// The wide plans, q/k head_dim 192 with v 128 (deepseek-v3's expanded MLA,
// Plan<192, 128>) and 256 (gemma2, Plan<256, 256>), run a kernel of their
// own (flash_tc_wide_kernel), since a 64 x 256 f32 accumulator (128
// registers a thread), 192-wide Q tiles (72 KB at 192 rows) and the
// softcap break the plan above. Its design:
//
// * Items of 128 query rows, two consumer warpgroups of 64, and a producer
//   warpgroup that gives its registers back (setmaxnreg: 40 a thread, the
//   consumers 232; 2 x 128 x 232 + 128 x 40 <= 65536). 128-row items divide
//   the served 512-row prompts exactly (192-row items would leave a third
//   of the last item's warpgroups idle).
// * The order of the items. Each block takes, in round r, the item at
//   position r G + (b or, in odd rounds, G - 1 - b) of a list (G the grid,
//   b the block): the snake pairs a heavy item in one round with a light one
//   in the next. The list is sorted heaviest first (the most live key tiles:
//   the last query tiles when causal or unwindowed) within windows: windows
//   of the whole list (the tile-major order of the plans above) when a round
//   of it already puts two or more items on every K/V head it reads
//   (G x group >= 2 B Hq: gemma2's 8/4 heads), else windows of one round
//   over the items listed head by head (MLA's 128 heads of their own K/V),
//   so a head's query tiles run in one round, side by side, and its K/V
//   comes from HBM once (tile-major, 512 items would separate them: ~168 MB
//   of other heads' K/V through the 50 MB L2). flash_attention's
//   tc_wide_order is the host copy.
// * Each warpgroup's 64 Q rows have their own mbarriers, and its output
//   goes out through them (its Q.K^T are done): the normalised tile,
//   rounded to bf16, as stmatrix 8 x 8 blocks in the 128-byte swizzle, then
//   one TMA store (rows past Sq clipped); the rows are freed once the store
//   has read them (far cheaper than each thread storing its bf16 pairs to
//   device memory, four bytes a store). Plan<192, 128> has two Q buffers, so
//   the next item's Q is in place before this one's output leaves;
//   Plan<256, 256> has one (a third K stage takes the room of the second),
//   so its next Q loads once the store has read the rows.
// * K and V have rings of their own, each slot released on its own "empty"
//   mbarrier: K after the Q.K^T that reads it, V after the P.V.
// * Each warpgroup overlaps its softmax with the tensor cores twice over.
//   Within it, tile j's S = Q.K^T is issued together with tile j-1's O +=
//   P.V, and the softmax of S_j runs while that P.V is in flight
//   (wgmma.wait_group 1; O is rescaled by tile j's alpha after the P.V
//   completes and before the next one is issued). Between the two, named
//   barriers hand the tensor cores from one warpgroup to the other
//   (ping-pong): one issues its products while the other runs its softmax. An item is ntiles + 1 turns
//   for each warpgroup; a warpgroup computes only the run of tiles whose
//   keys its rows see (its first S alone, then S with the previous P.V,
//   then the last P.V alone: straight-line code, so ptxas keeps the wgmma
//   asynchronous) and passes the other turns empty.
// * The softmax works in log2 units, s2 = s log2 e: exp(s - m) is
//   2^(s2 - m2), without a softcap one FMA and ex2.approx a score, dot x
//   (scale log2 e) - m2 (the row max taken on the raw dots). Each row's
//   running max m2 moves only when a tile's max passes it by more than 8
//   (kSlack): P = 2^(s2 - m2) stays <= 256, O and l share the same m2 so
//   O / l is the softmax still, and O is rescaled a few times a row rather
//   than at every new max (alpha is exactly 1 where m2 stays, and a warp
//   whose rows all keep theirs skips the multiplies). The softcap
//   c tanh(x / c) is
//       s2 = c2 - 2 c2 / (2^(dot x k) + 1),  c2 = c log2 e,  k = 2 log2 e scale / c
//   (tanh(x) = 1 - 2 / (e^(2x) + 1)): one multiply, ex2.approx, an add,
//   rcp.approx and one FMA a score, against an IEEE division and libdevice's
//   tanhf before. The constants are folded in double and rounded once. It
//   saturates to +-c2 at +-inf (1/inf = 0, 2^-inf = 0). Error in t = tanh:
//   ex2.approx's 2^-22 relative error moves t by at most 2e/(e+1)^2 x 2^-22
//   <= 1.2e-7, the rounding of the argument by <= 2.4e-8, rcp.approx's ulp
//   of r = 1/(e+1) <= 1 by <= 2.4e-7 (as t -> -1), the add and the FMA by
//   <= 1.2e-7: |dt| <= 4.5e-7, so the softcapped score is within 4.5e-7 c of
//   c tanh(x / c), and of the backward's recomputation tanhf(x / c) (within
//   ~2 ulp of tanh) to ~6e-7 c. (tanh.approx.f32, 2^-11 relative, would
//   be 0.024 at c = 50.) The log-sum-exp written for the backward is
//   m2 ln 2 + log(max(l, 1e-30)): m + log(l) of any m the sums were taken
//   against, its meaning kept.
//
// Shared memory: Plan<192, 128>: two Q buffers of 128 x 192 (48 KB each),
// three K tiles of 64 x 192 (24 KB) and three V tiles of 64 x 128 (16 KB):
// 96 + 72 + 48 = 216 KB. Plan<256, 256>: one Q buffer of 128 x 256 (64 KB),
// three K tiles and two V tiles of 64 x 256 (32 KB each): 64 + 96 + 64 =
// 224 KB (two Q buffers would leave room for one K/V stage). A 192-wide row
// is three 64-element boxes, a 256-wide row four; O += P.V runs as
// m64n128k16 on 128 columns (two at 256).
//
// Bound at MLA's served prefill (4 x 128 heads x 512, causal): 2 x 4 x 128
// x 131,328 live pairs x (192 + 128) = 43.0 GFLOP, 0.043 ms at 989 TFLOP/s,
// against 335.5 MB of q, k, v and o (every head has its own K and V),
// 0.100 ms at 3.35 TB/s: bound by bytes.
//
// The TMA, mbarrier and wgmma helpers and the tensor maps live in
// hopper.cuh, shared with the backward (flash_attention_bwd_tc.cu).

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBK = 64;  // keys a tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kSlack = 8.f;  // log2 units the wide kernel's running max may lag the true one

// The tile plan of head_dim 64 and 128: items of 192 query rows (three
// consumer warpgroups) and a producer warp, two Q buffers, three K/V stages
template <int DK, int DV>
struct Plan {
  static constexpr int kWarpgroups = 3;  // consumer warpgroups: 64 query rows each
  static constexpr int kStages = 3;      // K/V ring depth
  static constexpr int kProducer = 32;   // a producer warp
  static constexpr int kBQ = 64 * kWarpgroups;       // query rows a work item
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + kProducer;
  static constexpr int kQBufs = 2;       // Q buffers: the next item's loads early
};

struct TcParams {
  __nv_bfloat16* o;
  float* lse;  // [B, Hq, Sq] or null
  long long os[3];  // element strides of o: batch, head, sequence
  int batch, hq, group, sq, num_q_tiles, causal, q_offset, kv_len;
  int window;  // the sliding window, or 2^30 for none
  float scale, softcap;
};

// where the sequence, head and batch coordinates go among a map's
// dimensions 1..3 (the host sorts those dimensions by stride)
struct MapDims {
  int q[3], k[3], v[3], o[3];
};

template <int DK, int DV>
struct Layout {
  using P = Plan<DK, DV>;
  static constexpr uint32_t kQBytes = P::kBQ * DK * 2;
  static constexpr uint32_t kKBytes = kBK * DK * 2;  // a K tile
  static constexpr uint32_t kVBytes = kBK * DV * 2;  // a V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + P::kQBufs * kQBytes;
  static constexpr uint32_t kV = kK + P::kStages * kKBytes;
  static constexpr uint32_t kBar = kV + P::kStages * kVBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (4 + 3 * P::kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// W: the call has a window. The unwindowed instances carry none of the
// window's tile bounds, compares or all-masked-row guard, so a call
// without a window runs the code it ran before the window came. DT: the
// true width of q/k, whose columns Q.K^T sums (80 on the 128 plan)
template <int DK, int DV, bool W, int DT = DK>
__global__ void __launch_bounds__(Plan<DK, DV>::kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                    const TcParams p, const MapDims dims) {
  using L = Layout<DK, DV>;
  using P = Plan<DK, DV>;
  constexpr int kBQ = P::kBQ, kStages = P::kStages, kConsumers = P::kConsumers;
  constexpr int NBK = DK / kBox;  // 64-element boxes a Q or K row
  constexpr int NBV = DV / kBox;  // and a V or O row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  // the Q buffer of the n-th item and the parity of its use
  auto q_of = [](int n) { return n & 1; };
  auto q_par = [](int n) { return (n >> 1) & 1; };
  auto bar = [&](int i) { return base + L::kBar + 8 * i; };
  auto q_full = [&](int i) { return bar(i); };
  auto q_empty = [&](int i) { return bar(2 + i); };
  auto k_full = [&](int s) { return bar(4 + s); };
  auto v_full = [&](int s) { return bar(4 + kStages + s); };
  auto empty = [&](int s) { return bar(4 + 2 * kStages + s); };
  auto q_buf = [&](int i) { return base + L::kQ + i * L::kQBytes; };
  auto k_tile = [&](int s) { return base + L::kK + s * L::kKBytes; };
  auto v_tile = [&](int s) { return base + L::kV + s * L::kVBytes; };

  const int tid = threadIdx.x;
  const int nbh = p.batch * p.hq;
  const int nwork = p.num_q_tiles * nbh;
  // work item w: query tile num_q_tiles - 1 - w / nbh of head row w % nbh
  // (the items with the most live key tiles first: the last query tiles
  // when causal or unwindowed; without causality a window leaves the first
  // query tiles the most, so they go first); block i takes i, i + grid, ...
  const bool last_first = p.causal || !W;
  struct Work {
    int q0, b, h, t0, ntiles;
  };
  auto work = [&](int w) {
    Work x;
    const int bh = w % nbh;
    x.q0 = (last_first ? p.num_q_tiles - 1 - w / nbh : w / nbh) * kBQ;
    x.b = bh / p.hq;
    x.h = bh % p.hq;
    // live keys [kv_start, kv_end); tiles wholly outside are not loaded
    const int last = min(p.sq, x.q0 + kBQ) - 1;
    const int kv_end = p.causal ? min(p.kv_len, p.q_offset + last + 1) : p.kv_len;
    const int kv_start = W ? max(0, p.q_offset + x.q0 - p.window + 1) : 0;
    x.t0 = kv_start / kBK;
    x.ntiles = (kv_end + kBK - 1) / kBK - x.t0;
    return x;
  };

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues every load
    if (tid == kConsumers) {
      int it = 0;  // tiles loaded so far: the ring's position
      for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
        const Work x = work(w);
        const int qb = q_of(n);
        mbar_wait(q_empty(qb), q_par(n) ^ 1);  // passes at once on a fresh buffer
        mbar_expect_tx(q_full(qb), L::kQBytes);
#pragma unroll
        for (int nb = 0; nb < NBK; ++nb)
          tma_load(q_buf(qb) + nb * kBQ * kRowBytes, &qmap, q_full(qb), dims.q, nb * kBox, x.q0, x.h, x.b);
        const int hk = x.h / p.group;
        for (int t = x.t0; t < x.t0 + x.ntiles; ++t, ++it) {
          const int s = it % kStages;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full(s), L::kKBytes);
#pragma unroll
          for (int nb = 0; nb < NBK; ++nb)
            tma_load(k_tile(s) + nb * kBK * kRowBytes, &kmap, k_full(s), dims.k, nb * kBox, t * kBK, hk, x.b);
          mbar_expect_tx(v_full(s), L::kVBytes);
#pragma unroll
          for (int nb = 0; nb < NBV; ++nb)
            tma_load(v_tile(s) + nb * kBK * kRowBytes, &vmap, v_full(s), dims.v, nb * kBox, t * kBK, hk, x.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [row0, row0 + 64) of a tile; this
  // thread holds rows ra and ra + 8 of them, columns 8j + 2 (lane % 4) + {0, 1}
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const bool capped = p.softcap > 0.f;
  int it = 0;
  for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
    const Work x = work(w);
    const int qb = q_of(n);
    const int row0 = x.q0 + wg * 64;
    const int pos_a = p.q_offset + row0 + ra, pos_b = pos_a + 8;
    const int wg_end = p.causal ? min(p.kv_len, p.q_offset + min(p.sq, row0 + 64)) : p.kv_len;
    const int wg_kv_end = row0 < p.sq ? wg_end : 0;  // a warpgroup past Sq does no math
    const int wg_kv_start = p.q_offset + row0 - p.window + 1;  // its first row's first key (may be < 0)
    const int pos_last = p.q_offset + row0 + 63;               // its last row's position
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    const uint32_t q_base = q_buf(qb) + wg * 64 * kRowBytes;
    mbar_wait(q_full(qb), q_par(n));

    for (int t = x.t0; t < x.t0 + x.ntiles; ++t, ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = t * kBK;
      mbar_wait(k_full(s), ph);
      if (k0 < wg_kv_end && (!W || k0 + kBK > wg_kv_start)) {
        float sc[kBK / 2];
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the swizzled row
          const uint64_t da = sw128_desc(q_base + (kk / 4) * kBQ * kRowBytes + off, 16, 1024);
          const uint64_t db = sw128_desc(k_tile(s) + (kk / 4) * kBK * kRowBytes + off, 16, 1024);
          wgmma_ss_n64(sc, da, db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // s = dot * scale (then softcap); masks only on the diagonal, the
        // window's edge and the kv_len edge tiles
        const bool edge = k0 + kBK > p.kv_len || (p.causal && k0 + kBK - 1 > p.q_offset + row0) ||
                          (W && k0 <= pos_last - p.window);
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) sc[i] *= p.scale;
        if (capped) {
#pragma unroll
          for (int i = 0; i < kBK / 2; ++i) sc[i] = p.softcap * tanhf(sc[i] / p.softcap);
        }
        if (edge) {
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kpos = k0 + 8 * j + col + c;
              const bool in = kpos < p.kv_len;
              if (!(in && (!p.causal || kpos <= pos_a) && (!W || kpos > pos_a - p.window))) sc[4 * j + c] = kNegInf;
              if (!(in && (!p.causal || kpos <= pos_b) && (!W || kpos > pos_b - p.window))) sc[4 * j + 2 + c] = kNegInf;
            }
          }
        }
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 2));
        const float mc_a = fmaxf(m_a, mx_a), mc_b = fmaxf(m_b, mx_b);
        // exp(x - m) as 2^(x log2 e - m log2 e): one FFMA and one MUFU a
        // score. A row that has seen only masked keys so far (a window's
        // first tiles) takes m log2 e = 0, so its masked scores give 0, not
        // 2^(the FFMA's rounding error of -1e30 log2 e), which may be inf;
        // the alpha of its first live tile wipes its (zero) sums as before
        const float ml_a = W && mc_a == kNegInf ? 0.f : mc_a * kLog2e;
        const float ml_b = W && mc_b == kNegInf ? 0.f : mc_b * kLog2e;
        const float al_a = ex2(m_a * kLog2e - ml_a), al_b = ex2(m_b * kLog2e - ml_b);
        m_a = mc_a;
        m_b = mc_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            sc[4 * j + c] = ex2(fmaf(sc[4 * j + c], kLog2e, -ml_a));
            sc[4 * j + 2 + c] = ex2(fmaf(sc[4 * j + 2 + c], kLog2e, -ml_b));
            sum_a += sc[4 * j + c];
            sum_b += sc[4 * j + 2 + c];
          }
        }
        l_a = l_a * al_a + sum_a;  // this thread's share of the row sums
        l_b = l_b * al_b + sum_b;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[4 * j + 0] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }
        // P in bf16: the accumulator's (row, column) layout is the A fragment's
        uint32_t pa[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        mbar_wait(v_full(s), ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // V [keys][D] is the MN-major B operand: 16 keys a step (2 KB of
          // 128-byte rows), 64-element column blocks kBK rows apart
          wgmma_rs<DV>(o, pa[kk], sw128_desc(v_tile(s) + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      mbar_arrive(empty(s));
    }

    l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 1);
    l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 2);
    l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 1);
    l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 2);
    if (p.lse != nullptr && lane % 4 == 0) {  // m and l are the same in the row's 4 threads
      float* lrow = p.lse + (static_cast<long long>(x.b) * p.hq + x.h) * p.sq;
      if (row0 + ra < p.sq) lrow[row0 + ra] = m_a + logf(fmaxf(l_a, 1e-30f));
      if (row0 + ra + 8 < p.sq) lrow[row0 + ra + 8] = m_b + logf(fmaxf(l_b, 1e-30f));
    }
    const float den_a = 1.f / fmaxf(l_a, 1e-30f), den_b = 1.f / fmaxf(l_b, 1e-30f);  // reciprocals
    // the tile, normalised and rounded, into this warpgroup's rows of the
    // Q buffer (its Q.K^T are done) in the 128-byte swizzle, then one TMA
    // store a 64-column box; rows past Sq are clipped by the map
    const uint32_t stage = q_buf(qb) + wg * 64 * kRowBytes;
    uint8_t* stage_p = smem + (stage - base);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int nb = j / 8, jj = j % 8;
      uint8_t* box = stage_p + nb * kBQ * kRowBytes;
      const int rb = ra + 8;
      *reinterpret_cast<uint32_t*>(box + ra * kRowBytes + ((jj ^ (ra & 7)) << 4) + col * 2) =
          pack_bf16(o[4 * j] * den_a, o[4 * j + 1] * den_a);
      *reinterpret_cast<uint32_t*>(box + rb * kRowBytes + ((jj ^ (rb & 7)) << 4) + col * 2) =
          pack_bf16(o[4 * j + 2] * den_b, o[4 * j + 3] * den_b);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid % 128 == 0) {
#pragma unroll
      for (int nb = 0; nb < NBV; ++nb) tma_store(&omap, stage + nb * kBQ * kRowBytes, dims.o, nb * kBox, row0, x.h, x.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    mbar_arrive(q_empty(qb));  // Q.K^T and the store's reads of the buffer are done
  }
  if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DK, int DV, bool W, int DT>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const CUtensorMap& om, const TcParams& p,
           const MapDims& dims, int blocks, cudaStream_t stream) {
  constexpr int bytes = Layout<DK, DV>::kBytes;
  static bool sized = false;  // the attribute is set once a kernel
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_tc_kernel<DK, DV, W, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  flash_tc_kernel<DK, DV, W, DT><<<blocks, Plan<DK, DV>::kThreads, bytes, stream>>>(qm, km, vm, om, p, dims);
  return static_cast<int>(cudaGetLastError());
}

// the maps, the work items and the launch of the (DK, DV) plan on tensors
// of the true width DT (head_dim 80 on the 128 plan; else DK = DV)
template <int DK, int DV, int DT = DK>
int run(const void* q, const void* k, const void* v, void* o, const long long* strides, int batch, int hq, int hkv,
        int sq, TcParams& p, int window, cudaStream_t s) {
  static_assert(DK == DV && DT <= DK, "the 64/128 plans, at their width or on a narrower one");
  constexpr int kBQ = Plan<DK, DV>::kBQ;
  CUtensorMap qm, km, vm, om;
  MapDims dims;
  int err = make_map(&qm, q, DT, sq, hq, batch, strides + 0, kBQ, dims.q);
  if (err == 0) err = make_map(&km, k, DT, p.kv_len, hkv, batch, strides + 3, kBK, dims.k);
  if (err == 0) err = make_map(&vm, v, DT, p.kv_len, hkv, batch, strides + 6, kBK, dims.v);
  if (err == 0) err = make_map(&om, o, DT, sq, hq, batch, strides + 9, 64, dims.o);
  if (err != 0) return err;
  p.num_q_tiles = (sq + kBQ - 1) / kBQ;
  static int sms = 0;  // one persistent block an SM
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess) sms = 132;
  const int work = p.num_q_tiles * batch * hq;
  const int blocks = work < sms ? work : sms;
  return window > 0 ? launch<DK, DV, true, DT>(qm, km, vm, om, p, dims, blocks, s)
                    : launch<DK, DV, false, DT>(qm, km, vm, om, p, dims, blocks, s);
}

// ---- the wide plans (see the header) ----

template <int DK, int DV>
struct WidePlan {
  static_assert((DK == 192 && DV == 128) || (DK == 256 && DV == 256), "the wide plans: (192, 128) and (256, 256)");
  static constexpr int kBQ = 128;        // query rows a work item: two consumer warpgroups of 64
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
  static constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // 2 x 128 x 232 + 128 x 40 <= 65536
  static constexpr int kQBufs = DK == 192 ? 2 : 1;
  static constexpr int kKStages = 3;
  static constexpr int kVStages = DK == 192 ? 3 : 2;
  static constexpr uint32_t kQHalf = 64 * DK * 2;   // a warpgroup's 64 rows of a Q tile
  static constexpr uint32_t kKBytes = kBK * DK * 2;  // a K tile
  static constexpr uint32_t kVBytes = kBK * DV * 2;  // a V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBufs * 2 * kQHalf;
  static constexpr uint32_t kV = kK + kKStages * kKBytes;
  static constexpr uint32_t kBar = kV + kVStages * kVBytes;
  static constexpr int kBars = 4 * kQBufs + 2 * (kKStages + kVStages);
  static constexpr uint32_t kBytes = kBar + 8 * kBars + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

// the wide kernel's parameters (TcParams, which the head_dim 64/128 kernel
// takes, stays as it is)
struct WideParams {
  float* lse;  // [B, Hq, Sq] or null
  int batch, hq, group, sq, num_q_tiles, nwork, causal, q_offset, kv_len;
  int window;      // the sliding window, or 2^30 for none
  int last_first;  // the last query tiles have the most live key tiles (causal, or no window)
  int head_major;  // the list in windows of one round, head by head (see the header)
  float kscale;    // scale log2 e
  float kcap, c2;  // the softcap's 2 log2 e scale / c and c log2 e
};

struct WideWork {
  int q0, b, h, t0, ntiles;
};

// the item at position u of the list (see the header; tc_wide_order in
// flash_attention/__init__.py is its host copy)
template <bool W>
__device__ __forceinline__ WideWork wide_work(const WideParams& p, int u, int grid) {
  const int nq = p.num_q_tiles, nbh = p.batch * p.hq;
  int bh, j;
  if (!p.head_major) {  // the tile-major order: heaviest query tile of every head first
    bh = u % nbh;
    j = p.last_first ? nq - 1 - u / nbh : u / nbh;
  } else {
    // round u / grid lists items [v0, v1) head by head (item v: head v / nq,
    // query tile v % nq), heaviest tile first, then by head
    const int v0 = u - u % grid, v1 = min(v0 + grid, p.nwork);
    int s = u - v0;
    bh = 0;
    j = 0;
    for (int i = 0; i < nq; ++i) {
      const int jt = p.last_first ? nq - 1 - i : i;
      const int count = (v1 + nq - 1 - jt) / nq - (v0 + nq - 1 - jt) / nq;  // items of tile jt in [v0, v1)
      if (s < count) {
        bh = (v0 + (jt - v0 % nq + nq) % nq) / nq + s;
        j = jt;
        break;
      }
      s -= count;
    }
  }
  WideWork x;
  x.q0 = j * 128;
  x.b = bh / p.hq;
  x.h = bh % p.hq;
  // live keys [kv_start, kv_end); tiles wholly outside are not loaded
  const int last = min(p.sq, x.q0 + 128) - 1;
  const int kv_end = p.causal ? min(p.kv_len, p.q_offset + last + 1) : p.kv_len;
  const int kv_start = W ? max(0, p.q_offset + x.q0 - p.window + 1) : 0;
  x.t0 = kv_start / kBK;
  x.ntiles = (kv_end + kBK - 1) / kBK - x.t0;
  return x;
}

// the position of block b's item in round r: the snake
__device__ __forceinline__ int wide_pos(int r, int grid) {
  return r * grid + ((r & 1) ? grid - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x));
}

template <int DK, int DV, bool W>
__global__ void __launch_bounds__(WidePlan<DK, DV>::kThreads, 1)
    flash_tc_wide_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                         const WideParams p, const MapDims dims) {
  using P = WidePlan<DK, DV>;
  constexpr int KS = P::kKStages, VS = P::kVStages, QB = P::kQBufs;
  constexpr int NBK = DK / kBox;  // 64-element boxes a Q or K row
  constexpr int NBV = DV / kBox;  // and a V row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  auto bar = [&](int i) { return base + P::kBar + 8 * i; };
  auto q_full = [&](int qb, int g) { return bar(2 * qb + g); };  // buffer qb, warpgroup g's rows
  auto q_empty = [&](int qb, int g) { return bar(2 * QB + 2 * qb + g); };
  auto k_full = [&](int s) { return bar(4 * QB + s); };
  auto k_empty = [&](int s) { return bar(4 * QB + KS + s); };
  auto v_full = [&](int s) { return bar(4 * QB + 2 * KS + s); };
  auto v_empty = [&](int s) { return bar(4 * QB + 2 * KS + VS + s); };
  auto q_half = [&](int qb, int g) { return base + P::kQ + (2 * qb + g) * P::kQHalf; };
  auto k_tile = [&](int s) { return base + P::kK + s * P::kKBytes; };
  auto v_tile = [&](int s) { return base + P::kV + s * P::kVBytes; };
  const int grid = gridDim.x;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2 * QB; ++i) {
      mbar_init(bar(i), 1);           // q_full
      mbar_init(bar(2 * QB + i), 1);  // q_empty: a warpgroup's output has left its rows
    }
    for (int s = 0; s < KS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), P::kConsumers);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= P::kConsumers) {  // the producer warpgroup: one thread issues every load
    regs_dec<P::kProducerRegs>();
    if (tid == P::kConsumers) {
      int kt = 0;  // tiles loaded so far: the rings' position
      for (int r = 0, n = 0; r * grid < p.nwork; ++r) {
        const int u = wide_pos(r, grid);
        if (u >= p.nwork) continue;  // the last round may be short
        const WideWork x = wide_work<W>(p, u, grid);
        const int qb = n % QB;
        const uint32_t qpar = (n / QB) & 1;
        for (int g = 0; g < 2; ++g) {
          mbar_wait(q_empty(qb, g), qpar ^ 1);  // passes at once on a fresh buffer
          if (x.q0 + 64 * g < p.sq) {
            mbar_expect_tx(q_full(qb, g), P::kQHalf);
#pragma unroll
            for (int nb = 0; nb < NBK; ++nb)
              tma_load(q_half(qb, g) + nb * 64 * kRowBytes, &qmap, q_full(qb, g), dims.q, nb * kBox, x.q0 + 64 * g,
                       x.h, x.b);
          } else {
            mbar_arrive(q_full(qb, g));  // rows wholly past Sq: nothing to load
          }
        }
        const int hk = x.h / p.group;
        for (int t = x.t0; t < x.t0 + x.ntiles; ++t, ++kt) {
          const int ks = kt % KS, vs = kt % VS;
          mbar_wait(k_empty(ks), ((kt / KS) & 1) ^ 1);
          mbar_expect_tx(k_full(ks), P::kKBytes);
#pragma unroll
          for (int nb = 0; nb < NBK; ++nb)
            tma_load(k_tile(ks) + nb * kBK * kRowBytes, &kmap, k_full(ks), dims.k, nb * kBox, t * kBK, hk, x.b);
          mbar_wait(v_empty(vs), ((kt / VS) & 1) ^ 1);
          mbar_expect_tx(v_full(vs), P::kVBytes);
#pragma unroll
          for (int nb = 0; nb < NBV; ++nb)
            tma_load(v_tile(vs) + nb * kBK * kRowBytes, &vmap, v_full(vs), dims.v, nb * kBox, t * kBK, hk, x.b);
        }
        ++n;
      }
    }
    return;
  }
  regs_inc<P::kConsumerRegs>();

  // consumers: warpgroup wg owns rows [row0, row0 + 64) of an item; this
  // thread holds rows ra and ra + 8 of them, columns 8j + 2 (lane % 4) + {0, 1}
  const int wg = warpgroup_idx(), warp = (tid % 128) / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const bool capped = p.kcap > 0.f;
  const float k2 = capped ? 1.f : p.kscale;  // the scores' factor to log2 units inside the exponent
  // the tensor cores' turns: warpgroup g waits at barrier 1 + g and then
  // opens the other's; warpgroup 0 goes first
  if (wg == 1) named_arrive(1, P::kConsumers);
  int kt = 0;
  for (int r = 0, n = 0; r * grid < p.nwork; ++r) {
    const int u = wide_pos(r, grid);
    if (u >= p.nwork) continue;
    const WideWork x = wide_work<W>(p, u, grid);
    const int qb = n % QB;
    const uint32_t qpar = (n / QB) & 1;
    ++n;
    const int row0 = x.q0 + wg * 64;
    const int pos_a = p.q_offset + row0 + ra, pos_b = pos_a + 8;
    const int wg_end = p.causal ? min(p.kv_len, p.q_offset + min(p.sq, row0 + 64)) : p.kv_len;
    const int wg_kv_end = row0 < p.sq ? wg_end : 0;  // a warpgroup past Sq does no math
    const int wg_kv_start = p.q_offset + row0 - p.window + 1;  // its first row's first key (may be < 0)
    const int pos_last = p.q_offset + row0 + 63;               // its last row's position
    // this warpgroup's live tiles [lo, hi) of the item: those with keys its
    // rows see (a contiguous run; none for rows past Sq)
    const int t_end = min(x.t0 + x.ntiles, (wg_kv_end + kBK - 1) / kBK);
    const int t_beg = W ? max(x.t0, wg_kv_start > 0 ? wg_kv_start / kBK : 0) : x.t0;
    const int lo = t_end > t_beg ? t_beg - x.t0 : 0, hi = t_end > t_beg ? t_end - x.t0 : 0;
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // m in log2 units
    float al_a = 1.f, al_b = 1.f;
    float sc[kBK / 2];         // S, then P, of the current tile
    uint32_t pa[kBK / 16][4];  // P of the previous tile, bf16 A fragments
    const uint32_t q_base = q_half(qb, wg);
    mbar_wait(q_full(qb, wg), qpar);
    auto k_stage = [&](int i) { return (kt + i) % KS; };
    auto k_phase = [&](int i) { return static_cast<uint32_t>(((kt + i) / KS) & 1); };
    auto v_stage = [&](int i) { return (kt + i) % VS; };
    auto v_phase = [&](int i) { return static_cast<uint32_t>(((kt + i) / VS) & 1); };
    // turn i of the item (0..ntiles) issues tile i's S = Q.K^T and tile
    // i - 1's O += P.V where this warpgroup has them, then hands over; after
    // it, tile i's K and tile i - 1's V are released. A turn with neither
    // product only keeps the alternation
    auto release = [&](int i) {
      if (i < x.ntiles) mbar_arrive(k_empty(k_stage(i)));
      if (i > 0) mbar_arrive(v_empty(v_stage(i - 1)));
    };
    // an empty turn releases tiles it has not waited for: the turns keep
    // the warpgroups within one of each other, so the other one has
    // released the slot's previous tile (KS, VS >= 2) and waits for this
    // one, which it reads
    auto empty_turn = [&](int i) {
      named_sync(1 + wg, P::kConsumers);
      named_arrive(2 - wg, P::kConsumers);
      release(i);
    };
    auto issue_s = [&](int i) {
      mbar_wait(k_full(k_stage(i)), k_phase(i));
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the swizzled row
        const uint64_t da = sw128_desc(q_base + (kk / 4) * 64 * kRowBytes + off, 16, 1024);
        const uint64_t db = sw128_desc(k_tile(k_stage(i)) + (kk / 4) * kBK * kRowBytes + off, 16, 1024);
        wgmma_ss_n64(sc, da, db);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int i) {  // tile i's P.V
      mbar_wait(v_full(v_stage(i)), v_phase(i));
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<DV>(o, pa[kk], sw128_desc(v_tile(v_stage(i)) + kk * 16 * kRowBytes, kBK * kRowBytes, 1024));
      wgmma_commit();
    };
    auto zero_s = [&] {
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.f;
    };
    // tile i's S into P (f32, in sc), the running max and sums, and alpha
    auto softmax = [&](int i) {
      const int k0 = (x.t0 + i) * kBK;
      // with a softcap the scores go to log2 units here (see the header);
      // without one the dots stay raw and k2 scales them inside the
      // exponent's FMA. Masks only on the diagonal, the window's edge and
      // the kv_len edge tiles
      if (capped) {
#pragma unroll
        for (int j = 0; j < kBK / 2; ++j) sc[j] = fmaf(-2.f * p.c2, rcp(ex2(sc[j] * p.kcap) + 1.f), p.c2);
      }
      const bool edge = k0 + kBK > p.kv_len || (p.causal && k0 + kBK - 1 > p.q_offset + row0) ||
                        (W && k0 <= pos_last - p.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = k0 + 8 * j + col + c;
            const bool in = kpos < p.kv_len;
            if (!(in && (!p.causal || kpos <= pos_a) && (!W || kpos > pos_a - p.window))) sc[4 * j + c] = kNegInf;
            if (!(in && (!p.causal || kpos <= pos_b) && (!W || kpos > pos_b - p.window))) sc[4 * j + 2 + c] = kNegInf;
          }
        }
      }
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 2));
      // the tile's max in log2 units (a row with no live key keeps -1e30);
      // the running max m moves only when the tile's passes it by more
      // than kSlack, so P = 2^(s2 - m) <= 2^kSlack and O and l are rescaled
      // a few times a row, not at every new max (the quotient O / l is the
      // same; alpha is exactly 1 where m stays)
      const float mt_a = mx_a == kNegInf ? kNegInf : mx_a * k2, mt_b = mx_b == kNegInf ? kNegInf : mx_b * k2;
      const float mc_a = mt_a > m_a + kSlack ? mt_a : m_a, mc_b = mt_b > m_b + kSlack ? mt_b : m_b;
      // a row that has seen only masked keys so far (a window's first
      // tiles) subtracts 0, so its masked scores give 2^-1e30 = 0 and the
      // alpha of its first live tile wipes its (zero) sums
      const float mu_a = W && mc_a == kNegInf ? 0.f : mc_a;
      const float mu_b = W && mc_b == kNegInf ? 0.f : mc_b;
      al_a = ex2(m_a - mu_a);
      al_b = ex2(m_b - mu_b);
      m_a = mc_a;
      m_b = mc_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[4 * j + c] = ex2(fmaf(sc[4 * j + c], k2, -mu_a));
          sc[4 * j + 2 + c] = ex2(fmaf(sc[4 * j + 2 + c], k2, -mu_b));
          sum_a += sc[4 * j + c];
          sum_b += sc[4 * j + 2 + c];
        }
      }
      l_a = l_a * al_a + sum_a;  // this thread's share of the row sums
      l_b = l_b * al_b + sum_b;
    };
    // P in bf16: the accumulator's (row, column) layout is the A fragment's
    auto pack = [&] {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    int i = 0;
    for (; i < lo; ++i) empty_turn(i);
    if (lo < hi) {
      // turn lo: the first S alone
      named_sync(1 + wg, P::kConsumers);
      zero_s();
      wgmma_fence();
      issue_s(lo);
      named_arrive(2 - wg, P::kConsumers);
      wgmma_wait_all();
      fence_regs(sc);
      release(lo);
      softmax(lo);
      pack();
      // turns lo + 1 .. hi - 1: S of tile i with P.V of tile i - 1; the
      // softmax of S runs while the P.V is in flight
      for (i = lo + 1; i < hi; ++i) {
        named_sync(1 + wg, P::kConsumers);
        zero_s();
        wgmma_fence();  // after the registers' last writes: sc's zeros, O's rescale, P
        issue_s(i);
        issue_pv(i - 1);
        named_arrive(2 - wg, P::kConsumers);
        wgmma_wait_one();  // S done; the P.V still runs
        fence_regs(sc);
        mbar_arrive(k_empty(k_stage(i)));
        softmax(i);
        wgmma_wait_all();  // the previous P.V: O and its P are free
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(v_empty(v_stage(i - 1)));
        // O *= alpha before the next P.V; alpha is exactly 1 where a row's
        // max did not move, and a warp whose rows all kept theirs skips it
        if (__any_sync(0xFFFFFFFFu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            o[4 * j + 0] *= al_a;
            o[4 * j + 1] *= al_a;
            o[4 * j + 2] *= al_b;
            o[4 * j + 3] *= al_b;
          }
        }
        pack();
      }
      // turn hi: the last P.V
      named_sync(1 + wg, P::kConsumers);
      wgmma_fence();
      issue_pv(hi - 1);
      named_arrive(2 - wg, P::kConsumers);
      wgmma_wait_all();
      fence_regs(o);
      release(hi);
      i = hi + 1;
    }
    for (; i <= x.ntiles; ++i) empty_turn(i);
    kt += x.ntiles;

    l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 1);
    l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 2);
    l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 1);
    l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 2);
    const bool in_a = row0 + ra < p.sq, in_b = row0 + ra + 8 < p.sq;
    if (p.lse != nullptr && lane % 4 == 0) {  // m and l are the same in the row's 4 threads
      float* lrow = p.lse + (static_cast<long long>(x.b) * p.hq + x.h) * p.sq;
      if (in_a) lrow[row0 + ra] = m_a * kLn2 + logf(fmaxf(l_a, 1e-30f));
      if (in_b) lrow[row0 + ra + 8] = m_b * kLn2 + logf(fmaxf(l_b, 1e-30f));
    }
    const float den_a = 1.f / fmaxf(l_a, 1e-30f), den_b = 1.f / fmaxf(l_b, 1e-30f);  // reciprocals
    // the tile, normalised and rounded, into this warpgroup's rows of the
    // Q buffer (its Q.K^T are done) in the 128-byte swizzle, four 8 x 8
    // matrices a stmatrix; then one thread stores it by TMA (rows past Sq
    // clipped) and frees the rows once the store has read them. Rows
    // wholly past Sq have no output
    const uint32_t stage = q_half(qb, wg);
    if (hi > lo) {
      const int mrow = (lane / 8 % 2) * 8 + lane % 8, r = warp * 16 + mrow;  // the row this lane addresses
#pragma unroll
      for (int j = 0; j < DV / 8; j += 2) {
        const int chunk = j + lane / 16;  // 16-byte chunk of the row: 8 columns
        stmatrix_x4(stage + (chunk / 8) * 64 * kRowBytes + r * kRowBytes + (((chunk % 8) ^ (r & 7)) << 4),
                    pack_bf16(o[4 * j] * den_a, o[4 * j + 1] * den_a), pack_bf16(o[4 * j + 2] * den_b, o[4 * j + 3] * den_b),
                    pack_bf16(o[4 * j + 4] * den_a, o[4 * j + 5] * den_a),
                    pack_bf16(o[4 * j + 6] * den_b, o[4 * j + 7] * den_b));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + wg, 128);
    }
    if (tid % 128 == 0) {
      if (hi > lo) {
#pragma unroll
        for (int nb = 0; nb < NBV; ++nb) tma_store(&omap, stage + nb * 64 * kRowBytes, dims.o, nb * kBox, row0, x.h, x.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      mbar_arrive(q_empty(qb, wg));
    }
  }
  if (wg == 0) named_sync(1, P::kConsumers);  // takes warpgroup 1's last opening of warpgroup 0's turn
  if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DK, int DV, bool W>
int launch_wide(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const CUtensorMap& om,
                const WideParams& p, const MapDims& dims, int blocks, cudaStream_t stream) {
  constexpr int bytes = WidePlan<DK, DV>::kBytes;
  static bool sized = false;  // the attribute is set once a kernel
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_tc_wide_kernel<DK, DV, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  flash_tc_wide_kernel<DK, DV, W><<<blocks, WidePlan<DK, DV>::kThreads, bytes, stream>>>(qm, km, vm, om, p, dims);
  return static_cast<int>(cudaGetLastError());
}

// the maps, the work list and the launch of a wide plan
template <int DK, int DV>
int run_wide(const void* q, const void* k, const void* v, void* o, const long long* strides, int hkv,
             const TcParams& t, int window, cudaStream_t s) {
  CUtensorMap qm, km, vm, om;
  MapDims dims;
  int err = make_map(&qm, q, DK, t.sq, t.hq, t.batch, strides + 0, 64, dims.q);
  if (err == 0) err = make_map(&km, k, DK, t.kv_len, hkv, t.batch, strides + 3, kBK, dims.k);
  if (err == 0) err = make_map(&vm, v, DV, t.kv_len, hkv, t.batch, strides + 6, kBK, dims.v);
  if (err == 0) err = make_map(&om, o, DV, t.sq, t.hq, t.batch, strides + 9, 64, dims.o);
  if (err != 0) return err;
  WideParams p;
  p.lse = t.lse;
  p.batch = t.batch;
  p.hq = t.hq;
  p.group = t.group;
  p.sq = t.sq;
  p.num_q_tiles = (t.sq + WidePlan<DK, DV>::kBQ - 1) / WidePlan<DK, DV>::kBQ;
  p.nwork = p.num_q_tiles * t.batch * t.hq;
  p.causal = t.causal;
  p.q_offset = t.q_offset;
  p.kv_len = t.kv_len;
  p.window = t.window;
  p.last_first = t.causal || window <= 0;
  static int sms = 0;  // one persistent block an SM
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess) sms = 132;
  const int blocks = p.nwork < sms ? p.nwork : sms;
  p.head_major = blocks * p.group < 2 * t.batch * t.hq;
  // folded in double, rounded once (the scale as the TPU kernel's Python scalar)
  const double scale = 1.0 / sqrt(static_cast<double>(DK)), log2e = 1.4426950408889634;
  p.kscale = static_cast<float>(scale * log2e);
  p.kcap = t.softcap > 0.f ? static_cast<float>(2.0 * log2e * scale / t.softcap) : 0.f;
  p.c2 = static_cast<float>(static_cast<double>(t.softcap) * log2e);
  return window > 0 ? launch_wide<DK, DV, true>(qm, km, vm, om, p, dims, blocks, s)
                    : launch_wide<DK, DV, false>(qm, km, vm, om, p, dims, blocks, s);
}

}  // namespace

// bf16 q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv], o [B, Hq,
// Sq, Dv], each by its pointer and its (batch, head, sequence) element
// strides in `strides` (a host array of 12: q, k, v, o); (D, Dv) in {(64,
// 64), (80, 80), (128, 128), (256, 256), (192, 128)}; the scale 1/sqrt(D); pointers and
// strides of q, k and v 16-byte aligned; 1 <= kv_len <= Sk; window > 0 a
// sliding window, 0 none; lse f32 [B, Hq, Sq] or null. Returns
// cudaGetLastError() after the launch, or a tensor-map encoding failure
// negated.
extern "C" int th_flash_attention_tc(const void* q, const void* k, const void* v, void* o, const long long* strides,
                                     int batch, int hq, int hkv, int sq, int d, int dv, int causal, float softcap,
                                     int q_offset, int kv_len, int window, float* lse, void* stream) {
  const bool mla = d == 192 && dv == 128;
  if (!mla && (dv != d || (d != 64 && d != 80 && d != 128 && d != 256))) return static_cast<int>(cudaErrorInvalidValue);
  TcParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.batch = batch;
  p.hq = hq;
  p.group = hq / hkv;
  p.sq = sq;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.window = window > 0 ? window : 1 << 30;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));  // as the TPU kernel's Python scalar
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return run<64, 64>(q, k, v, o, strides, batch, hq, hkv, sq, p, window, s);
    case 80: return run<128, 128, 80>(q, k, v, o, strides, batch, hq, hkv, sq, p, window, s);  // on the 128 plan
    case 128: return run<128, 128>(q, k, v, o, strides, batch, hq, hkv, sq, p, window, s);
    case 192: return run_wide<192, 128>(q, k, v, o, strides, hkv, p, window, s);
    default: return run_wide<256, 256>(q, k, v, o, strides, hkv, p, window, s);
  }
}
