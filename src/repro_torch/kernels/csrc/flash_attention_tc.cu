// Flash attention (online softmax) for Hopper on the tensor cores: bf16
// q, k, v at head_dim 64, 128 or 256, the prefill route of the serving path
// and the training forward (gemma2's at 256), and q/k at 192 with v at 128
// (deepseek-v3's expanded MLA prefill).
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
// For the backward (flash_attention_bwd.cu) the epilogue also writes each
// row's log-sum-exp, m + log(max(l, 1e-30)) in f32, to lse [B, Hq, Sq]
// when the pointer is not null: m and the joined l are in registers there.
// The serving path passes null and pays one predicated branch an item.
//
// Head_dim 256 (gemma2) has a plan of its own (Plan<256>): its 64 x 256
// f32 accumulator is 128 registers a thread beside the 32 of S and the 16
// of P, which three consumer warpgroups and a producer warp cannot hold
// (416 threads leave 152 a thread), and two Q buffers of 192 rows with
// three stages of 32 KB K and V tiles would not fit 227 KB. So an item is
// 128 query rows of two consumer warpgroups, the producer is a warpgroup
// that gives its registers back (setmaxnreg: 24 a thread, so each consumer
// thread has 240, as in the backward), there is one Q buffer (the next
// item's Q loads once this item's output has left it) and the K/V ring has
// two stages of 64 keys: 64 KB + 2 x (32 + 32) KB = 192 KB of shared
// memory. A 256-wide row is four 64-element boxes, and O += P.V runs as two
// m64n128k16 products on the two halves of V's columns. The plans of
// head_dim 64 and 128 are the ones they had before.
//
// Each plan has a score width DK (Q and K) and a value width DV (V and O),
// equal but for deepseek-v3's expanded MLA (Plan<192, 128>): q/k rows of
// 128 + 64 (the decoupled rope part) and v rows of 128. S = Q.K^T runs over
// 12 k-steps of 16, O += P.V as m64n128k16, the scale is 1/sqrt(192), and
// the registers are D = 128's (o is 64 x 128). Shared memory is the catch:
// a 192-row Q buffer 192 wide is 72 KB, a K tile 24 KB and a V tile 16 KB,
// so D = 128's two Q buffers and three stages (264 KB) do not fit 227 KB.
// The plan keeps three consumer warpgroups and a producer warp, with one Q
// buffer (the next item's Q loads once this item's output has left it, as
// at 256) and three K/V stages: 72 + 3 x (24 + 16) = 192 KB. A 192-wide row
// is three 64-element boxes; the output (128 wide) goes out through the
// first two boxes of the Q buffer. Bound at the served prefill (4 x 128
// heads x 512, causal): 2 x 4 x 128 x 131,328 live pairs x (192 + 128) =
// 43.0 GFLOP, 0.043 ms at 989 TFLOP/s, against 335.5 MB of q, k, v and o
// (every head has its own K and V), 0.100 ms at 3.35 TB/s: bound by bytes.
//
// The TMA, mbarrier and wgmma helpers and the tensor maps live in
// hopper.cuh, shared with the backward (flash_attention_bwd_tc.cu).

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBK = 64;  // keys a tile
constexpr float kNegInf = -1e30f;

// The tile plan of a (score, value) head_dim pair. D = 64, 128: items of
// 192 query rows (three consumer warpgroups) and a producer warp, two Q
// buffers, three K/V stages
template <int DK, int DV>
struct Plan {
  static constexpr int kWarpgroups = 3;  // consumer warpgroups: 64 query rows each
  static constexpr int kQBufs = 2;       // Q buffers: the next item's loads early
  static constexpr int kStages = 3;      // K/V ring depth
  static constexpr int kProducer = 32;   // a producer warp
  static constexpr int kConsumerRegs = 0, kProducerRegs = 0;  // no setmaxnreg
  static constexpr int kBQ = 64 * kWarpgroups;       // query rows a work item
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + kProducer;
};

// D = 256: items of 128 rows (two consumer warpgroups), a producer
// warpgroup under setmaxnreg (2 x 128 x 240 + 128 x 24 <= 65536), one Q
// buffer and two K/V stages (see the header)
template <>
struct Plan<256, 256> {
  static constexpr int kWarpgroups = 2;
  static constexpr int kQBufs = 1;
  static constexpr int kStages = 2;
  static constexpr int kProducer = 128;
  static constexpr int kConsumerRegs = 240, kProducerRegs = 24;
  static constexpr int kBQ = 64 * kWarpgroups;
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + kProducer;
};

// (192, 128), MLA: D = 128's warpgroups and producer warp, one Q buffer and
// three K/V stages (see the header)
template <>
struct Plan<192, 128> {
  static constexpr int kWarpgroups = 3;
  static constexpr int kQBufs = 1;
  static constexpr int kStages = 3;
  static constexpr int kProducer = 32;
  static constexpr int kConsumerRegs = 0, kProducerRegs = 0;
  static constexpr int kBQ = 64 * kWarpgroups;
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + kProducer;
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
// without a window runs the code it ran before the window came
template <int DK, int DV, bool W>
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
  auto q_of = [](int n) { return P::kQBufs == 2 ? n & 1 : 0; };
  auto q_par = [](int n) { return P::kQBufs == 2 ? (n >> 1) & 1 : n & 1; };
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

  if (tid >= kConsumers) {  // the producer warp (warpgroup at D = 256): one thread issues every load
    if constexpr (P::kProducerRegs > 0) regs_dec<P::kProducerRegs>();
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
  if constexpr (P::kConsumerRegs > 0) regs_inc<P::kConsumerRegs>();

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
        for (int kk = 0; kk < DK / 16; ++kk) {
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

template <int DK, int DV, bool W>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const CUtensorMap& om, const TcParams& p,
           const MapDims& dims, int blocks, cudaStream_t stream) {
  constexpr int bytes = Layout<DK, DV>::kBytes;
  static bool sized = false;  // the attribute is set once a kernel
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_tc_kernel<DK, DV, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  flash_tc_kernel<DK, DV, W><<<blocks, Plan<DK, DV>::kThreads, bytes, stream>>>(qm, km, vm, om, p, dims);
  return static_cast<int>(cudaGetLastError());
}

// the maps, the work items and the launch of the (DK, DV) plan
template <int DK, int DV>
int run(const void* q, const void* k, const void* v, void* o, const long long* strides, int batch, int hq, int hkv,
        int sq, TcParams& p, int window, cudaStream_t s) {
  constexpr int kBQ = Plan<DK, DV>::kBQ;
  CUtensorMap qm, km, vm, om;
  MapDims dims;
  int err = make_map(&qm, q, DK, sq, hq, batch, strides + 0, kBQ, dims.q);
  if (err == 0) err = make_map(&km, k, DK, p.kv_len, hkv, batch, strides + 3, kBK, dims.k);
  if (err == 0) err = make_map(&vm, v, DV, p.kv_len, hkv, batch, strides + 6, kBK, dims.v);
  if (err == 0) err = make_map(&om, o, DV, sq, hq, batch, strides + 9, 64, dims.o);
  if (err != 0) return err;
  p.num_q_tiles = (sq + kBQ - 1) / kBQ;
  static int sms = 0;  // one persistent block an SM
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess) sms = 132;
  const int work = p.num_q_tiles * batch * hq;
  const int blocks = work < sms ? work : sms;
  return window > 0 ? launch<DK, DV, true>(qm, km, vm, om, p, dims, blocks, s)
                    : launch<DK, DV, false>(qm, km, vm, om, p, dims, blocks, s);
}

}  // namespace

// bf16 q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv], o [B, Hq,
// Sq, Dv], each by its pointer and its (batch, head, sequence) element
// strides in `strides` (a host array of 12: q, k, v, o); (D, Dv) in {(64,
// 64), (128, 128), (256, 256), (192, 128)}; the scale 1/sqrt(D); pointers and
// strides of q, k and v 16-byte aligned; 1 <= kv_len <= Sk; window > 0 a
// sliding window, 0 none; lse f32 [B, Hq, Sq] or null. Returns
// cudaGetLastError() after the launch, or a tensor-map encoding failure
// negated.
extern "C" int th_flash_attention_tc(const void* q, const void* k, const void* v, void* o, const long long* strides,
                                     int batch, int hq, int hkv, int sq, int d, int dv, int causal, float softcap,
                                     int q_offset, int kv_len, int window, float* lse, void* stream) {
  const bool mla = d == 192 && dv == 128;
  if (!mla && (dv != d || (d != 64 && d != 128 && d != 256))) return static_cast<int>(cudaErrorInvalidValue);
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
    case 128: return run<128, 128>(q, k, v, o, strides, batch, hq, hkv, sq, p, window, s);
    case 192: return run<192, 128>(q, k, v, o, strides, batch, hq, hkv, sq, p, window, s);
    default: return run<256, 256>(q, k, v, o, strides, batch, hq, hkv, sq, p, window, s);
  }
}
