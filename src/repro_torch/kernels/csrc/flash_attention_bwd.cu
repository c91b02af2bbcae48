// The flash-attention backward for Hopper, f32 arithmetic on the CUDA
// cores: dQ, dK and dV of the forward kernels (flash_attention.cu,
// flash_attention_tc.cu), which is what the training step needs from
// every layer. This is the `cuda_core` backward route: f32, f16 and bf16
// at head_dim 16, 32, 64, 128 and 256, every call the tensor-core backward
// (flash_attention_bwd_tc.cu, bf16 at head_dim 64/128/256) does not take.
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
// with the forward's masks: key j is live for row i when j < kv_len,
// (causal) j <= q_offset + i and (sliding window W) j > q_offset + i - W; a
// masked pair contributes nothing (its P is 0). Keys past kv_len, and keys
// no row's window reaches, get zero gradients. What attention_backward_plain
// (kernels/flash_attention/__init__.py) computes in plain PyTorch; exp is
// __expf (ex2.approx of a prescaled argument, a few ulp where P matters),
// and under a softcap 1 - t^2 is taken from s_c as 1 - (s_c / c)^2.
//
// Bound: at the f32 training shape (q [16, 32, 576, 128], k/v
// [16, 8, 576, 128], causal) five products of 2 D FLOPs a live (query,
// key) pair over 85 M live pairs are 0.109 TFLOP, 1.625 ms at the CUDA
// cores' 67 TFLOP/s; the bytes (q, o, dO, dQ, k, v, dK, dV and the lse
// once each, 0.30 GB) take 0.09 ms: it is bound by operations. The
// products stay f32 FMAs (the f32 contract is 2e-5; the tensor cores take
// f32 only as TF32). This design computes seven products (S and dP in
// both the dK/dV and the dQ kernel), a floor of 2.27 ms at peak: handing
// dQ between key tiles would need atomics (results that depend on the
// order blocks run in) or 1.5 GB of partials, and writing dS out for a
// second pass needs scratch that grows with Sq x Sk.
//
// Design. No atomics, so the result is deterministic (two runs give the
// same bits): three kernels in stream order, each owning its outputs.
//  1. pre: D_i = rowsum(dO * O) once a row (a group of up to 32 lanes a
//     row), written with the forward's lse into a stats scratch in the
//     packed-row order of the tiles (packed_row, vec.cuh: a 64-row
//     sub-tile is 64 / G positions x the G heads of a KV head), 512 bytes
//     a sub-tile (lse [64], then D_i [64]), so a tile's row statistics
//     arrive with one copy and no block recomputes them.
//  2. dK/dV: one block of 256 threads a (batch, KV head, 64-key tile). Its
//     K and V tiles stay in shared memory; the sub-tiles of Q, dO and
//     their stats that can see its keys (causal: from the one holding
//     position k0 - q_offset; window W: up to the one holding the tile's
//     last key + W - 1 - q_offset) stream through a ring of two stages by
//     16-byte cp.async, the next arriving while this one computes. Per
//     sub-tile four quarters of 64 threads compute S^T = K Q^T and dP^T =
//     V dO^T, each over half of D, 8 x 8 a thread (keys hx + 8a, rows tx +
//     8c), and trade partial sums through the P^T and dS^T tiles; the S^T
//     quarters form P^T (into its tile) and P^T (1 - t^2), the dP^T
//     quarters put the whole dP^T into the dS^T tile, and the S^T quarters
//     turn it into dS^T. Then half the block accumulates dV += P^T dO and
//     the other half dK += dS^T Q, 8 keys x 8 RowCols columns a thread, in
//     registers. Four barriers a sub-tile.
//  3. dQ: one block a (batch, KV head, 128 packed query rows). Q, dO and
//     their stats stay in shared memory; K and V tiles of 32 keys stream
//     through the ring from the window's start for the block's first
//     position up to the causal / kv_len edge (tiles outside are
//     skipped). The quarters compute S = Q K^T and dP = dO V^T as in dK/dV
//     (rows hx + 16a, keys tx + 4c), dS goes into an f32 tile, and all
//     threads accumulate dQ += dS K, 8 rows x 8 RowCols columns a thread.
// Every product is 8 x 8 a thread, so each float a thread loads from
// shared memory feeds 4 FMAs: what the 128 bytes a clock an SM's shared
// memory delivers to its 128 FMA lanes need (an 8 x 4 tile, 2.7 a float,
// would leave a third of them idle). 64 x 64 and 128 x 32 score tiles are
// only 32 scores a thread of 128, hence the split of D and the trade.
// Tiles are row-major and unpadded in the 16-byte-chunk XOR swizzle (Swz,
// vec.cuh), which keeps the products' 16-byte reads free of bank conflicts
// and fits the budget: dK/dV at head_dim 128 in f32 takes 232,448 bytes,
// all 227 KB a block may use, dQ 231,424. The P and dS tiles have a pitch
// of their row count + 4 floats, so a quarter warp's 16-byte stores of 8
// rows fall on 8 bank groups (dQ's stores of 4 keys x 2 row groups are at
// most 2-way). Rows and keys past Sq and kv_len are filled with zeros
// by the copies themselves (src-size 0), so a dead cache slot's NaN never
// reaches a product. The longest blocks are launched first (the first key
// tiles for dK/dV, the last query tiles for dQ).
//
// Head_dim 256 (gemma2) has a kernel of its own, one launch of its dK/dV
// and dQ items after pre, on the same sub-tile geometry (section 4 below).
//
// Inputs are strided in batch, head and sequence (unit stride in D, rows
// 16-byte aligned for the copies); outputs likewise.

#include <cmath>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = 128;             // threads of a half: dV (0) or dK (1) in dK/dV
constexpr int kKeys = 64;              // keys a dK/dV block
constexpr int kStats = 2 * kSub;       // floats of a sub-tile's stats: lse [64], then D_i [64]
constexpr int kPre = 256;              // threads of a pre block

struct BwdParams {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;  // [B, Hq, Sq] from the forward
  float* stats;      // [B * Hkv][nsub2][kStats], written by pre
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];  // batch, head, sequence
  int batch, hq, hkv, group, sq, sk, qpt, nsub, nsub2, causal, q_offset, kv_len;
  int window;  // the sliding window, or 2^30 for none
  float inv_group, scale, softcap;
};

__device__ __forceinline__ const float* stats_of(const BwdParams& p, int bkv, int sub) {
  return p.stats + (static_cast<long long>(bkv) * p.nsub2 + sub) * kStats;
}

// whether key j is live for a row at position `pos` (-1 for a padding row);
// the window's compare only where W: the dK/dV and dQ kernels are
// instantiated with and without a window, so a call without one runs the
// code it ran before the window came (both sit at 254-255 registers at
// head_dim 128 in f32, where one more live value spills or costs time)
template <bool W>
__device__ __forceinline__ bool live(const BwdParams& p, int pos, int j) {
  return pos >= 0 && j < p.kv_len && (!p.causal || j <= p.q_offset + pos) && (!W || j > p.q_offset + pos - p.window);
}

// raw dots s of a tile into s * scale, and under a softcap c into
// s_c = c tanh(s * scale / c) (one branch a tile)
template <int N, int M>
__device__ __forceinline__ void scale_cap(const BwdParams& p, float (&f)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) f[i][j] *= p.scale;
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) f[i][j] = p.softcap * tanhf(f[i][j] / p.softcap);
  }
}

// P = exp(s_c - lse) (0 where the pair is masked) and the factor of dS it
// carries, P (1 - (s_c / c)^2) under a softcap c (inv_cap = 1 / c, else 0);
// exp is __expf, ex2.approx of a prescaled argument (relative error ~2^-21
// where P matters)
__device__ __forceinline__ float2 p_and_factor(float x, float lse, float inv_cap, bool ok) {
  const float pr = ok ? __expf(x - lse) : 0.f;
  const float t = x * inv_cap;
  return make_float2(pr, pr * (1.f - t * t));
}

// -- 1. D_i = rowsum(dO * O) and the stats tiles ---------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kPre) flash_bwd_pre_kernel(const BwdParams p) {
  constexpr int L = D / 4 < 32 ? D / 4 : 32;  // lanes a row
  const int row = (blockIdx.x * kPre + threadIdx.x) / L;  // of B * Hkv * nsub2 * 64
  const int lane = threadIdx.x % L;
  if (row >= p.batch * p.hkv * p.nsub2 * kSub) return;  // whole groups of L lanes
  const int r = row % kSub, sub = (row / kSub) % p.nsub2, bkv = row / (kSub * p.nsub2);
  const int b = bkv / p.hkv, hk = bkv % p.hkv;
  int g, i;
  float acc = 0.f, lse = 0.f;
  if (packed_row(p.group, p.inv_group, p.qpt, p.sq, sub, r, g, i)) {  // the same for the row's lanes
    const int h = hk * p.group + g;
    const T* orow = static_cast<const T*>(p.o) + b * p.os[0] + h * p.os[1] + static_cast<long long>(i) * p.os[2];
    const T* grow = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[1] + static_cast<long long>(i) * p.dos[2];
    for (int d = lane * 4; d < D; d += 4 * L) acc = fma4(load4(orow + d), load4(grow + d), acc);
    lse = p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + i];
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if (lane == 0) {
    float* st = p.stats + (static_cast<long long>(bkv) * p.nsub2 + sub) * kStats;
    st[r] = lse;
    st[kSub + r] = acc;
  }
}

// -- 2. dK and dV ----------------------------------------------------------------

// The score products of dK/dV and dQ run in four quarters of 64 threads:
// quarter q computes S (q < 2) or dP (q >= 2) over half q % 2 of D, 8 x 8
// a thread; the two halves of a product trade the partial sums of each
// other's rows through an f32 tile, the lower half finalizing a thread's
// rows a < 4 and the upper a >= 4. kQuarter threads, kFin rows finalized.
constexpr int kQuarter = 64;
constexpr int kFin = 4;

template <typename T, int D>
struct DkdvLayout {
  static constexpr int kPP = kSub + 4;  // pitch of the P^T and dS^T tiles [64 rows][64 key slots]
  static constexpr size_t kKV = size_t(kKeys) * D * sizeof(T);
  static constexpr size_t kTile = size_t(kSub) * D * sizeof(T);
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + kKV;
  static constexpr size_t kQ = kV + kKV;         // [2][64][D]
  static constexpr size_t kDO = kQ + 2 * kTile;  // [2][64][D]
  static constexpr size_t kSt = kDO + 2 * kTile; // [2][kStats]
  static constexpr size_t kP = kSt + 2 * kStats * sizeof(float);
  static constexpr size_t kDS = kP + size_t(kSub) * kPP * sizeof(float);
  static constexpr size_t kBytes = kDS + size_t(kSub) * kPP * sizeof(float);
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

template <typename T, int D, bool W>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(const BwdParams p) {
  using L = DkdvLayout<T, D>;
  constexpr int PP = L::kPP;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* ks = reinterpret_cast<T*>(smem + L::kK);
  T* vs = reinterpret_cast<T*>(smem + L::kV);
  T* qbuf = reinterpret_cast<T*>(smem + L::kQ);
  T* dobuf = reinterpret_cast<T*>(smem + L::kDO);
  float* stbuf = reinterpret_cast<float*>(smem + L::kSt);
  float* pb = reinterpret_cast<float*>(smem + L::kP);   // P^T as [row][key slot]
  float* db = reinterpret_cast<float*>(smem + L::kDS);  // dS^T as [row][key slot]

  const int tid = threadIdx.x;
  const int q = tid / kQuarter;                     // warp-uniform
  const int prod = q / 2, dh = q % 2;               // S^T (0) or dP^T (1), over half dh of D
  const int hx = (tid % kQuarter) / 8, tx = tid % 8;  // scores: keys hx + 8a, rows tx + 8c
  const int half = tid / kHalf;                     // accumulation: dV (0) or dK (1)
  const int ky = (tid % kHalf) / 16, cx = tid % 16;   // key slots 8 ky + a (keys ky + 8a), RowCols columns of cx
  const int mine = kFin * dh, other = kFin * (1 - dh);
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;
  const int nbkv = p.batch * p.hkv;
  const int bkv = blockIdx.x % nbkv;
  const int k0 = (blockIdx.x / nbkv) * kKeys;  // the first key tiles (the most query rows) first
  const int b = bkv / p.hkv, hk = bkv % p.hkv;

  using C = RowCols<D>;
  float acc[8][C::kPer];  // dV (half 0) or dK (half 1) of keys ky + 8a
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) acc[a][c] = 0.f;

  // sub-tiles whose rows can see a key of this tile (none if it starts at
  // or past kv_len): from the one holding position k0 - q_offset, up to
  // the one holding the last position whose window reaches the tile's last
  // live key, k_last + window - 1 - q_offset
  const int first = p.causal ? max(0, k0 - p.q_offset) / p.qpt : 0;
  const int pos_last = min(k0 + kKeys, p.kv_len) - 1 + p.window - 1 - p.q_offset;
  const int s_end = !W ? p.nsub : pos_last < 0 ? 0 : min(p.nsub, pos_last / p.qpt + 1);
  const int s_begin = k0 < p.kv_len ? first : s_end;

  // a sub-tile row's position less the sub-tile's first (-1 for padding)
  int rel[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int r = tx + 8 * c;
    rel[c] = r < p.qpt * p.group ? r / p.group : -1;
  }

  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + static_cast<long long>(hk) * p.group * p.qs[1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.dos[0] + static_cast<long long>(hk) * p.group * p.dos[1];
  auto copy_sub = [&](int sub, int stage) {
    copy_tile<T, D, kSub, kThreads>(qbuf + stage * kSub * D, [&](int r) -> const T* {
      int g, i;
      return packed_row(p.group, p.inv_group, p.qpt, p.sq, sub, r, g, i) ? qg + g * p.qs[1] + i * p.qs[2] : nullptr;
    }, qg);
    copy_tile<T, D, kSub, kThreads>(dobuf + stage * kSub * D, [&](int r) -> const T* {
      int g, i;
      return packed_row(p.group, p.inv_group, p.qpt, p.sq, sub, r, g, i) ? dog + g * p.dos[1] + i * p.dos[2] : nullptr;
    }, dog);
    if (tid < kStats / 4) cp_async16(stbuf + stage * kStats + tid * 4, stats_of(p, bkv, sub) + tid * 4, true);
  };

  if (s_begin < s_end) {
    copy_rows<T, D, kKeys, kThreads>(ks, kg, p.ks[2], k0, p.kv_len);
    copy_rows<T, D, kKeys, kThreads>(vs, vg, p.vs[2], k0, p.kv_len);
    copy_sub(s_begin, 0);
    cp_async_commit();
  }
  for (int sub = s_begin, it = 0; sub < s_end; ++sub, ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // sub-tile `sub` is in; every thread is done with the other stage, pb and db
    if (sub + 1 < s_end) {
      copy_sub(sub + 1, st ^ 1);
      cp_async_commit();
    }
    const T* qt = qbuf + st * kSub * D;
    const T* dot = dobuf + st * kSub * D;
    const float* lse_s = stbuf + st * kStats;
    const float* di_s = lse_s + kSub;

    // S^T = K Q^T or dP^T = V dO^T over this quarter's half of D
    float s[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[a][c] = 0.f;
    nt_product<T, D, D / 2, 8, 8, 8, 8>(s, prod ? vs : ks, hx, prod ? dot : qt, tx, dh * (D / 2));
    float* buf = prod ? db : pb;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float o[kFin];
#pragma unroll
      for (int i = 0; i < kFin; ++i) o[i] = dh ? s[i][c] : s[kFin + i][c];
      store_n<kFin>(buf + (tx + 8 * c) * PP + 8 * hx + other, o);
    }
    __syncthreads();
    float f[kFin][8];  // S^T or dP^T of keys hx + 8 (mine + i), rows tx + 8c
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float o[kFin];
      load_n<kFin>(buf + (tx + 8 * c) * PP + 8 * hx + mine, o);
#pragma unroll
      for (int i = 0; i < kFin; ++i) f[i][c] = (dh ? s[kFin + i][c] : s[i][c]) + o[i];
    }
    if (prod == 0) {  // P^T into pb; P^T (1 - t^2) kept for dS^T
      scale_cap(p, f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int y = tx + 8 * c;
        const int pos = rel[c] >= 0 && sub * p.qpt + rel[c] < p.sq ? sub * p.qpt + rel[c] : -1;
        const float lse = lse_s[y];
        float pr[kFin];
#pragma unroll
        for (int i = 0; i < kFin; ++i) {
          const float2 v = p_and_factor(f[i][c], lse, inv_cap, live<W>(p, pos, k0 + hx + 8 * (mine + i)));
          pr[i] = v.x;
          f[i][c] = v.y;
        }
        store_n<kFin>(pb + y * PP + 8 * hx + mine, pr);
      }
    } else {  // the whole dP^T into db
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float o[kFin];
#pragma unroll
        for (int i = 0; i < kFin; ++i) o[i] = f[i][c];
        store_n<kFin>(db + (tx + 8 * c) * PP + 8 * hx + mine, o);
      }
    }
    __syncthreads();
    if (prod == 0) {  // dS^T = P^T (1 - t^2) * (dP^T - D_i)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int y = tx + 8 * c;
        const float di = di_s[y];
        float o[kFin];
        load_n<kFin>(db + y * PP + 8 * hx + mine, o);
#pragma unroll
        for (int i = 0; i < kFin; ++i) o[i] = f[i][c] * (o[i] - di);
        store_n<kFin>(db + y * PP + 8 * hx + mine, o);
      }
    }
    __syncthreads();
    // dV[key] += sum_r P^T[key][r] dO[r] (half 0), dK[key] += sum_r dS^T[key][r] Q[r] (half 1)
    nn_product<T, D, 8, PP, kSub>(acc, half ? db : pb, 8 * ky, half ? qt : dot, cx);
  }

  T* outg = half ? static_cast<T*>(p.dk) + b * p.dks[0] + hk * p.dks[1]
                 : static_cast<T*>(p.dv) + b * p.dvs[0] + hk * p.dvs[1];
  const long long ostride = half ? p.dks[2] : p.dvs[2];
  const float scale = half ? p.scale : 1.f;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = k0 + ky + 8 * a;  // slot 8 ky + a
    if (j >= p.sk) continue;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      float x[C::kW];
#pragma unroll
      for (int e = 0; e < C::kW; ++e) x[e] = acc[a][g * C::kW + e] * scale;
      store_n<C::kW>(outg + static_cast<long long>(j) * ostride + C::col(g, cx), x);
    }
  }
}

// -- 3. dQ -----------------------------------------------------------------------

constexpr int kRows = 2 * kSub;  // packed query rows a dQ block
constexpr int kQKeys = 32;       // keys a K/V tile of the dQ kernel

template <typename T, int D>
struct DqLayout {
  static constexpr int kPP = kRows + 4;  // pitch of the dS^T and dP^T tiles [32 keys][128 row slots]
  static constexpr size_t kTile = size_t(kRows) * D * sizeof(T);
  static constexpr size_t kKV = size_t(kQKeys) * D * sizeof(T);
  static constexpr size_t kQ = 0;
  static constexpr size_t kDO = kQ + kTile;
  static constexpr size_t kK = kDO + kTile;     // [2][32][D]
  static constexpr size_t kV = kK + 2 * kKV;    // [2][32][D]
  static constexpr size_t kSt = kV + 2 * kKV;   // [2 sub-tiles][kStats]
  static constexpr size_t kDS = kSt + 2 * kStats * sizeof(float);
  static constexpr size_t kDP = kDS + size_t(kQKeys) * kPP * sizeof(float);
  static constexpr size_t kBytes = kDP + size_t(kQKeys) * kPP * sizeof(float);
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

template <typename T, int D, bool W>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const BwdParams p) {
  using L = DqLayout<T, D>;
  constexpr int BK = kQKeys, PP = L::kPP;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* qs = reinterpret_cast<T*>(smem + L::kQ);
  T* dos = reinterpret_cast<T*>(smem + L::kDO);
  T* kbuf = reinterpret_cast<T*>(smem + L::kK);
  T* vbuf = reinterpret_cast<T*>(smem + L::kV);
  float* sts = reinterpret_cast<float*>(smem + L::kSt);
  float* db = reinterpret_cast<float*>(smem + L::kDS);  // dS^T as [key][row slot]
  float* xb = reinterpret_cast<float*>(smem + L::kDP);  // dP^T as [key][row slot]

  const int tid = threadIdx.x;
  const int q = tid / kQuarter;                     // warp-uniform
  const int prod = q / 2, dh = q % 2;               // S (0) or dP (1), over half dh of D
  const int hx = (tid % kQuarter) / 4, tx = tid % 4;  // scores: rows hx + 16a, keys tx + 4c
  const int ty = tid / 16, cx = tid % 16;           // accumulation: row slots 8 ty + a (rows ty + 16a), columns of cx
  const int mine = kFin * dh, other = kFin * (1 - dh);
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;
  const int ntiles_q = p.nsub2 / 2;
  const int nbkv = p.batch * p.hkv;
  const int bkv = blockIdx.x % nbkv;
  const int tile = ntiles_q - 1 - blockIdx.x / nbkv;  // the last query tiles (the most keys) first
  const int b = bkv / p.hkv, hk = bkv % p.hkv;
  const int sub0 = 2 * tile;

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + static_cast<long long>(hk) * p.group * p.qs[1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.dos[0] + static_cast<long long>(hk) * p.group * p.dos[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];

  // live keys [kv_start, kv_end), kv_start from the block's first
  // position; tiles outside are skipped
  const int pos_end = min(p.sq, (sub0 + 2) * p.qpt);
  const int kv_end = p.causal ? min(p.kv_len, p.q_offset + pos_end) : p.kv_len;
  const int t0 = W ? max(0, p.q_offset + sub0 * p.qpt - p.window + 1) / BK : 0;
  const int ntiles = (kv_end + BK - 1) / BK - t0;

  copy_tile<T, D, kRows, kThreads>(qs, [&](int r) -> const T* {
    int g, i;
    return packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0 + r / kSub, r % kSub, g, i) ? qg + g * p.qs[1] + i * p.qs[2]
                                                                             : nullptr;
  }, qg);
  copy_tile<T, D, kRows, kThreads>(dos, [&](int r) -> const T* {
    int g, i;
    return packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0 + r / kSub, r % kSub, g, i) ? dog + g * p.dos[1] + i * p.dos[2]
                                                                             : nullptr;
  }, dog);
  if (tid < 2 * kStats / 4) cp_async16(sts + tid * 4, stats_of(p, bkv, sub0) + tid * 4, true);  // both sub-tiles
  auto copy_kv = [&](int t, int stage) {
    copy_rows<T, D, BK, kThreads>(kbuf + stage * BK * D, kg, p.ks[2], t * BK, kv_end);
    copy_rows<T, D, BK, kThreads>(vbuf + stage * BK * D, vg, p.vs[2], t * BK, kv_end);
  };
  copy_kv(t0, 0);
  cp_async_commit();

  // the rows this thread finalizes, hx + 16 (mine + i): positions (-1 for
  // padding) and, once the stats are in, lse and D_i
  int qpos[kFin];
#pragma unroll
  for (int i = 0; i < kFin; ++i) {
    const int r = hx + 16 * (mine + i);
    int g, pos;
    qpos[i] = packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0 + r / kSub, r % kSub, g, pos) ? pos : -1;
  }
  float lse[kFin], di[kFin];

  using C = RowCols<D>;
  float dq[8][C::kPer];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) dq[a][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = (t0 + t) * BK;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every thread is done with the other stage, db and xb
    if (t + 1 < ntiles) {
      copy_kv(t0 + t + 1, (t + 1) & 1);
      cp_async_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < kFin; ++i) {
        const int r = hx + 16 * (mine + i);
        lse[i] = sts[(r / kSub) * kStats + r % kSub];
        di[i] = sts[(r / kSub) * kStats + kSub + r % kSub];
      }
    }
    const T* kt = kbuf + (t & 1) * BK * D;
    const T* vt = vbuf + (t & 1) * BK * D;

    // S = Q K^T or dP = dO V^T over this quarter's half of D
    float s[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[a][c] = 0.f;
    nt_product<T, D, D / 2, 8, 8, 16, 4>(s, prod ? dos : qs, hx, prod ? vt : kt, tx, dh * (D / 2));
    float* buf = prod ? xb : db;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float o[kFin];
#pragma unroll
      for (int i = 0; i < kFin; ++i) o[i] = dh ? s[i][c] : s[kFin + i][c];
      store_n<kFin>(buf + (tx + 4 * c) * PP + 8 * hx + other, o);
    }
    __syncthreads();
    float f[kFin][8];  // S or dP of rows hx + 16 (mine + i), keys tx + 4c
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float o[kFin];
      load_n<kFin>(buf + (tx + 4 * c) * PP + 8 * hx + mine, o);
#pragma unroll
      for (int i = 0; i < kFin; ++i) f[i][c] = (dh ? s[kFin + i][c] : s[i][c]) + o[i];
    }
    if (prod == 0) {  // P (1 - t^2), kept for dS
      scale_cap(p, f);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int i = 0; i < kFin; ++i)
          f[i][c] = p_and_factor(f[i][c], lse[i], inv_cap, live<W>(p, qpos[i], k0 + tx + 4 * c)).y;
    } else {  // the whole dP into xb
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float o[kFin];
#pragma unroll
        for (int i = 0; i < kFin; ++i) o[i] = f[i][c];
        store_n<kFin>(xb + (tx + 4 * c) * PP + 8 * hx + mine, o);
      }
    }
    __syncthreads();
    if (prod == 0) {  // dS = P (1 - t^2) * (dP - D_i)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float o[kFin];
        load_n<kFin>(xb + (tx + 4 * c) * PP + 8 * hx + mine, o);
#pragma unroll
        for (int i = 0; i < kFin; ++i) o[i] = f[i][c] * (o[i] - di[i]);
        store_n<kFin>(db + (tx + 4 * c) * PP + 8 * hx + mine, o);
      }
    }
    __syncthreads();
    // dQ[row] += sum_j dS[row][j] K[j]
    nn_product<T, D, 8, PP, BK>(dq, db, 8 * ty, kt, cx);
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = ty + 16 * a;  // slot 8 ty + a
    int g, i;
    if (!packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0 + r / kSub, r % kSub, g, i)) continue;
    const int h = hk * p.group + g;
    T* row = dqg + b * p.dqs[0] + h * p.dqs[1] + static_cast<long long>(i) * p.dqs[2];
#pragma unroll
    for (int gc = 0; gc < C::kGroups; ++gc) {
      float x[C::kW];
#pragma unroll
      for (int e = 0; e < C::kW; ++e) x[e] = dq[a][gc * C::kW + e] * p.scale;
      store_n<C::kW>(row + C::col(gc, cx), x);
    }
  }
}

// -- 4. head_dim 256: one persistent launch of the dK/dV and dQ items ---------------

// At D = 256 the plans above do not fit: K and V of 64 keys alone are 128
// KB in f32, a 64-row Q or dO sub-tile 64 KB, and a thread's dK or dV of 8
// keys x 16 columns 128 registers. So D = 256 has a kernel of its own,
// flash_bwd_cc256_kernel: after pre (which takes D = 256 as it is), one
// persistent launch for the whole call, on the sub-tile geometry above
// (kSub, packed_row and pre's stats):
//
// * Items of 32 rows. A dK/dV item is 32 keys of a KV head (its K and V
//   stay in shared memory; the Q and dO sub-tiles of 64 packed rows that
//   see them stream through the ring); a dQ item is 32 packed rows, half a
//   sub-tile (Q, dO and the sub-tile's stats stay; the K and V tiles of 64
//   keys its rows see stream through). As on the tensor cores, one code
//   serves both: the fixed pair (K, V or Q, dO; 32 rows) is A of both score
//   products and the streamed pair (Q, dO or K, V; 64 rows) B, the scores
//   go into f32 tiles laid out [B row][A row], and the accumulation sums
//   over B rows: dV += P^T dO, dK += dS^T Q (B rows the packed query rows),
//   dQ += dS K (B rows the keys). 32-key dK/dV items keep the heaviest item
//   near the mean at phase 7's shape (2 x 8/4 heads x 512: key tile 0 of 64
//   keys would take 66 of the mean 31 units of work a block); each item
//   owns its outputs (a dQ item sums its two halves' partials in shared
//   memory in a fixed order), so there are no atomics and two runs give the
//   same bits.
// * The work list, as the tensor-core kernel's (bwd256_order on the host,
//   "cuda_core" geometry): min(items, SMs) persistent blocks, each walking
//   its own items heaviest first.
// * Slabs. The streamed pair comes in two slabs of 128 of its 256 columns
//   by cp.async, each in a stage of its own: four steps a tile, the scores
//   over slab 0, then slab 1, the accumulation over slab 0, then slab 1 (the
//   slabs the scores read, still in place). Slab 1 loads while the scores
//   run over slab 0, and the next tile's slab 0 while the accumulation runs
//   over slab 1; each slab crosses from the L2 once a tile.
// * Thread tiles of 4 x 8 on every product. The scores: quarters of 64
//   threads compute S (quarters 0, 1) or dP (2, 3) over half of each slab's
//   columns (quarter % 2), 4 A rows x 8 B rows a thread (A rows ty + 8a, B
//   rows tx + 8c), and the two halves of a product trade partial sums once a
//   tile through the score tiles (each finishes two of its four rows). Then
//   the S and the dP thread of the same elements each form P and dS for one
//   of those two rows, handing each other the other's value, so every
//   thread takes a share of the softmax. The accumulation: half the block
//   dV and half dK (dQ: each half over 32 of the tile's 64 keys, the
//   halves' partial sums added at the item's end), 4 rows x 8 columns of a
//   slab a thread. Each float a thread loads feeds 2.7 FMAs, against 2 (2 x
//   4) and 1.3 (4 x 2) before.
// * An item's first loads (its fixed pair once the scores are done with
//   the last item's, its first slab beside the accumulation) go out under
//   the last item's last tile.
// * The arithmetic stays IEEE: tanhf and an IEEE division under a softcap
//   (the f32 gate is 2e-5, and the fast form's 4.5e-7 c is 2.3e-5 at c =
//   50), __expf for P, f32 FMAs for every product.
// Shared memory in f32: the fixed pair 2 x 32 KB, two stages of 2 x 32 KB
// slabs, the P and dS tiles 2 x 64 x 36 floats and the stats 2 x 512 B:
// 216,064 bytes (half the pair and slabs in bf16 and f16). Registers: 64
// accumulators (2 slabs x 4 x 8), 32 scores, 12 float4 operands.
constexpr int kRows256 = 32;    // rows of an item's fixed pair (keys, or packed query rows)
constexpr int kSlab = 128;      // columns of a streamed slab
constexpr int kTP = kRows256 + 4;  // pitch of the score tiles [64 B rows][32 A rows]

template <typename T>
struct Cc256Layout {
  static constexpr size_t kFixed = size_t(kRows256) * 256 * sizeof(T);  // K or Q (then V or dO)
  static constexpr size_t kSlabBytes = size_t(kSub) * kSlab * sizeof(T);
  static constexpr size_t kA = 0;
  static constexpr size_t kB = kA + 2 * kFixed;               // [2 stages][2 slabs]
  static constexpr size_t kP = kB + 4 * kSlabBytes;           // P as [B row][A row]
  static constexpr size_t kDS = kP + size_t(kSub) * kTP * sizeof(float);
  static constexpr size_t kSt = kDS + size_t(kSub) * kTP * sizeof(float);  // a dQ item's sub-tile, a dK/dV tile's
  static constexpr size_t kBytes = kSt + 2 * kStats * sizeof(float);
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
  static_assert(size_t(kRows256) * 256 * sizeof(float) <= 2 * kSlabBytes, "room for dQ's partials in a stage");
};

template <int K>
struct Kind {
  static constexpr int value = K;
};

// the head_dim-256 kernel's parameters: the call's and the work list
struct Cc256Params : BwdParams {
  const int* work;  // [grid + 1] each block's first item, then an item's kind, batch, KV head, tile
};

// an item: kind 0 dK/dV (keys from 32 t), kind 1 dQ (packed rows from 32 (t
// % 2) of sub-tile t / 2); its first streamed tile (a sub-tile, or a key
// tile of 64) and its live tiles n
struct CcItem {
  int kind, b, hk, t, first, n;
};

template <bool W>
__device__ __forceinline__ CcItem cc_item(const BwdParams& p, int kind, int b, int hk, int t) {
  CcItem x;
  x.kind = kind;
  x.b = b;
  x.hk = hk;
  x.t = t;
  x.n = 0;
  if (kind == 0) {  // the sub-tiles whose rows see a key of the item, as the dK/dV kernel above
    const int k0 = t * kRows256;
    x.first = p.causal ? max(0, k0 - p.q_offset) / p.qpt : 0;
    const int pos_last = min(k0 + kRows256, p.kv_len) - 1 + p.window - 1 - p.q_offset;
    const int s_end = !W ? p.nsub : pos_last < 0 ? 0 : min(p.nsub, pos_last / p.qpt + 1);
    if (k0 < p.kv_len) x.n = max(s_end - x.first, 0);
  } else {  // the key tiles of 64 its rows' positions see
    const int sub = t / 2, r0 = (t % 2) * kRows256, rows = p.qpt * p.group;
    const int pos0 = sub * p.qpt + r0 / p.group;
    const int pos1 = min(p.sq - 1, sub * p.qpt + (min(r0 + kRows256, rows) - 1) / p.group);
    x.first = 0;
    if (r0 < rows && pos0 < p.sq) {
      const int kv_end = p.causal ? min(p.kv_len, p.q_offset + pos1 + 1) : p.kv_len;
      x.first = W ? max(0, p.q_offset + pos0 - p.window + 1) / kSub : 0;
      x.n = (kv_end + kSub - 1) / kSub - x.first;
    }
  }
  return x;
}

// acc[a][c] += A[ra0 + 8a][d0 + e] . B[rb0 + 8c][b0 + e] over e < 64: A a
// swizzled tile of rows of 256, B a swizzled slab of rows of kSlab
template <typename T>
__device__ __forceinline__ void slab_scores(float (&acc)[4][8], const T* A, int ra0, int d0, const T* B, int rb0,
                                            int b0) {
  using SA = Swz<T, 256>;
  using SB = Swz<T, kSlab>;
  const T* ar = A + ra0 * 256;
  const T* br = B + rb0 * kSlab;
  const int fa = SA::f(ra0), fb = SB::f(rb0);
#pragma unroll 4
  for (int e = 0; e < 64; e += 4) {
    const int ea = SA::col(d0 + e, fa), eb = SB::col(b0 + e, fb);
    float4 av[4], bv[8];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = load4(ar + a * 8 * 256 + ea);
#pragma unroll
    for (int c = 0; c < 8; ++c) bv[c] = load4(br + c * 8 * kSlab + eb);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = fma4(av[a], bv[c], acc[a][c]);
  }
}

// acc[a][c] += sum_j S[j][r0 + a] X[j][cx 4 + c % 4 + 64 (c / 4)] over j in
// [j0, j0 + J): S a score tile of pitch kTP, X a swizzled slab
template <typename T, int J>
__device__ __forceinline__ void slab_accumulate(float (&acc)[4][8], const float* S, int j0, int r0, const T* X,
                                                int cx) {
  using SX = Swz<T, kSlab>;
#pragma unroll 4
  for (int j = j0; j < j0 + J; ++j) {
    const float4 s = *reinterpret_cast<const float4*>(S + j * kTP + r0);
    const int fj = SX::f(j);
    const float4 x0 = load4(X + j * kSlab + SX::col(cx * 4, fj));
    const float4 x1 = load4(X + j * kSlab + SX::col(64 + cx * 4, fj));
    const float sv[4] = {s.x, s.y, s.z, s.w};
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(sv[a], xv[c], acc[a][c]);
  }
}

template <typename T, bool W>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_cc256_kernel(const Cc256Params p) {
  constexpr int D = 256;
  using L = Cc256Layout<T>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* a0 = reinterpret_cast<T*>(smem + L::kA);
  T* a1 = reinterpret_cast<T*>(smem + L::kA + L::kFixed);
  auto slab = [&](int stage, int m) { return reinterpret_cast<T*>(smem + L::kB + (2 * stage + m) * L::kSlabBytes); };
  float* pt = reinterpret_cast<float*>(smem + L::kP);   // P as [B row][A row]
  float* dst = reinterpret_cast<float*>(smem + L::kDS);  // dS as [B row][A row]
  float* st_fixed = reinterpret_cast<float*>(smem + L::kSt);  // a dQ item's sub-tile stats
  float* st_tile = st_fixed + kStats;                         // a dK/dV tile's
  float* part = reinterpret_cast<float*>(smem + L::kB + 2 * L::kSlabBytes);  // dQ's second half's partials: stage 1
  const int* items = p.work + gridDim.x + 1;
  const int u0 = p.work[blockIdx.x], u1 = p.work[blockIdx.x + 1];

  const int tid = threadIdx.x;
  const int q = tid / kQuarter;                        // warp-uniform
  const int prod = q / 2, dh = q % 2;                  // S (0) or dP (1), over half dh of each slab
  const int ty = (tid % kQuarter) / 8, tx = tid % 8;   // scores: A rows ty + 8a, B rows tx + 8c
  const int half = tid / kHalf;                        // accumulation: dV (0) or dK (1); dQ over keys 32 half..
  const int ky = (tid % kHalf) / 16, cx = tid % 16;    // accumulation: rows 4 ky + a, columns cx 4 (+ 64) + c
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;

  // the streamed pair's slab k (0, 1) of item y's tile i into stage k, with
  // a dK/dV tile's stats beside slab 0; the accumulation reads the slabs
  // the scores left there. One commit group
  auto load_slab = [&](const CcItem& y, int i, int k) {
    const int d0 = k * kSlab, bkv = y.b * p.hkv + y.hk;
    if (y.kind == 0) {
      const int sub = y.first + i;
      auto rows = [&](const T* g, long long hs, long long ss) {
        return [&, g, hs, ss](int r) -> const T* {
          int gg, pos;
          return packed_row(p.group, p.inv_group, p.qpt, p.sq, sub, r, gg, pos) ? g + gg * hs + pos * ss + d0 : nullptr;
        };
      };
      const T* qg = static_cast<const T*>(p.q) + y.b * p.qs[0] + static_cast<long long>(y.hk) * p.group * p.qs[1];
      const T* dog = static_cast<const T*>(p.dout) + y.b * p.dos[0] + static_cast<long long>(y.hk) * p.group * p.dos[1];
      copy_tile<T, kSlab, kSub, kThreads>(slab(k, 0), rows(qg, p.qs[1], p.qs[2]), qg);
      copy_tile<T, kSlab, kSub, kThreads>(slab(k, 1), rows(dog, p.dos[1], p.dos[2]), dog);
      if (k == 0 && tid < kStats / 4) cp_async16(st_tile + tid * 4, stats_of(p, bkv, sub) + tid * 4, true);
    } else {
      const int key0 = (y.first + i) * kSub;
      copy_rows<T, kSlab, kSub, kThreads>(slab(k, 0), static_cast<const T*>(p.k) + y.b * p.ks[0] + y.hk * p.ks[1] + d0,
                                          p.ks[2], key0, p.kv_len);
      copy_rows<T, kSlab, kSub, kThreads>(slab(k, 1), static_cast<const T*>(p.v) + y.b * p.vs[0] + y.hk * p.vs[1] + d0,
                                          p.vs[2], key0, p.kv_len);
    }
    cp_async_commit();
  };
  // item y's fixed pair, and a dQ item's stats (committed with the next slab)
  auto load_fixed = [&](const CcItem& y) {
    const int bkv = y.b * p.hkv + y.hk;
    if (y.kind == 0) {
      copy_rows<T, D, kRows256, kThreads>(a0, static_cast<const T*>(p.k) + y.b * p.ks[0] + y.hk * p.ks[1], p.ks[2],
                                          y.t * kRows256, p.kv_len);
      copy_rows<T, D, kRows256, kThreads>(a1, static_cast<const T*>(p.v) + y.b * p.vs[0] + y.hk * p.vs[1], p.vs[2],
                                          y.t * kRows256, p.kv_len);
    } else {
      const int sub = y.t / 2, r0 = (y.t % 2) * kRows256;
      auto rows = [&](const T* g, long long hs, long long ss) {
        return [&, g, hs, ss](int r) -> const T* {
          int gg, pos;
          return packed_row(p.group, p.inv_group, p.qpt, p.sq, sub, r0 + r, gg, pos) ? g + gg * hs + pos * ss : nullptr;
        };
      };
      const T* qg = static_cast<const T*>(p.q) + y.b * p.qs[0] + static_cast<long long>(y.hk) * p.group * p.qs[1];
      const T* dog = static_cast<const T*>(p.dout) + y.b * p.dos[0] + static_cast<long long>(y.hk) * p.group * p.dos[1];
      copy_tile<T, D, kRows256, kThreads>(a0, rows(qg, p.qs[1], p.qs[2]), qg);
      copy_tile<T, D, kRows256, kThreads>(a1, rows(dog, p.dos[1], p.dos[2]), dog);
      if (tid < kStats / 4) cp_async16(st_fixed + tid * 4, stats_of(p, bkv, sub) + tid * 4, true);
    }
  };
  auto item_at = [&](int u) {
    const int* w = items + 4 * u;
    return cc_item<W>(p, w[0], w[1], w[2], w[3]);
  };

  // an item's first loads go out under the last item's last tile (its
  // fixed pair once the scores are done with the last one's, its first slab
  // beside the accumulation), so only the first item waits for them
  CcItem x = item_at(u0 < u1 ? u0 : 0);
  if (u0 < u1 && x.n > 0) {
    load_fixed(x);
    load_slab(x, 0, 0);
  }
  for (int u = u0; u < u1; ++u) {
    const bool more = u + 1 < u1;
    const CcItem xn = more ? item_at(u + 1) : x;
    const bool early = more && xn.n > 0;  // the next item's loads go out under this one
    const int b = x.b, hk = x.hk;
    const int sub0 = x.t / 2, r0 = (x.t % 2) * kRows256;  // a dQ item's sub-tile and first row
    const int k0 = x.t * kRows256;                         // a dK/dV item's first key
    float acc[2][4][8];  // the accumulation, slab by slab
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[j][a][c] = 0.f;

    auto run = [&](auto kind) {
      constexpr int K = decltype(kind)::value;
      // this thread's A rows' and B rows' positions (-1 for padding) for
      // the masks: a dQ item's rows are fixed, a dK/dV tile's change
      int apos[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        int gg, pos;
        apos[a] = K == 0 ? k0 + ty + 8 * a
                         : (packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0, r0 + ty + 8 * a, gg, pos) ? pos : -1);
      }

      for (int i = 0; i < x.n; ++i) {
        float s[4][8];  // S or dP of A rows ty + 8a, B rows tx + 8c (partial over half the columns)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) s[a][c] = 0.f;
        // the tile's four steps, each with its k known at compile time (the
        // accumulators are picked by it)
        auto step = [&](auto kc) {
          constexpr int k = decltype(kc)::value;
          cp_async_wait_all();
          __syncthreads();  // step k's slabs are in; every thread is done with the other stage
          if (k == 0)  // the scores' second slab
            load_slab(x, i, 1);
          else if (k == 2 && i + 1 == x.n && early)  // the scores are done with the fixed pair
            load_fixed(xn);
          else if (k == 3 && i + 1 < x.n)  // slab 0 is free again: the next tile's
            load_slab(x, i + 1, 0);
          else if (k == 3 && early)  // or the next item's
            load_slab(xn, 0, 0);
          if constexpr (k < 2) {  // the scores over slab k
            slab_scores<T>(s, prod ? a1 : a0, ty, k * kSlab + dh * 64, slab(k & 1, prod), tx, dh * 64);
          }
          if constexpr (k == 1) {
            // trade the halves' partial sums: this thread finishes A rows ty
            // + mine + 8e (e < 2) and hands the other two over (registers
            // are picked by selects, never by a runtime index, which would
            // put the array in local memory)
            float* tr = prod ? dst : pt;
            const int mine = 16 * dh, other = 16 - mine;
#pragma unroll
            for (int c = 0; c < 8; ++c)
#pragma unroll
              for (int e = 0; e < 2; ++e) tr[(tx + 8 * c) * kTP + ty + other + 8 * e] = dh ? s[e][c] : s[2 + e][c];
            __syncthreads();  // the partial sums are in
            float f[2][8];  // the finished S or dP of A rows ty + mine + 8e
            int fpos[2];    // their positions (keys of a dK/dV item, query positions of a dQ item)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              fpos[e] = dh ? apos[2 + e] : apos[e];
#pragma unroll
              for (int c = 0; c < 8; ++c)
                f[e][c] = (dh ? s[2 + e][c] : s[e][c]) + tr[(tx + 8 * c) * kTP + ty + mine + 8 * e];
            }
            // the S thread and the dP thread of the same elements (quarters
            // dh and 2 + dh, same ty and tx) each finish one of the two rows:
            // row e = prod. Each hands the other its product's value of the
            // other's row (S through the P tile, dP through the dS tile)
            const int ar = ty + mine + 8 * prod;  // the A row this thread finishes
#pragma unroll
            for (int c = 0; c < 8; ++c)
              (prod ? dst : pt)[(tx + 8 * c) * kTP + ty + mine + 8 * (1 - prod)] = prod ? f[0][c] : f[1][c];
            __syncthreads();  // the other's values are in
            const int fp = prod ? fpos[1] : fpos[0];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int br = tx + 8 * c, at = br * kTP + ar;
              int gg, bpos = -1;
              if (K == 0 && !packed_row(p.group, p.inv_group, p.qpt, p.sq, x.first + i, br, gg, bpos)) bpos = -1;
              const bool ok = K == 0 ? live<W>(p, bpos, fp) : live<W>(p, fp, (x.first + i) * kSub + br);
              const float lse = K == 0 ? st_tile[br] : st_fixed[r0 + ar];
              const float di = K == 0 ? st_tile[kSub + br] : st_fixed[kSub + r0 + ar];
              float sv = (prod ? pt[at] : f[0][c]) * p.scale;
              const float dpv = prod ? f[1][c] : dst[at];
              if (p.softcap > 0.f) sv = p.softcap * tanhf(sv / p.softcap);
              const float2 pf = p_and_factor(sv, lse, inv_cap, ok);  // P, and P (1 - t^2)
              pt[at] = pf.x;
              dst[at] = pf.y * (dpv - di);  // dS = P (1 - t^2) (dP - D_i)
            }
          }
          if constexpr (k >= 2) {  // the accumulation over slab k - 2 (the step's __syncthreads made dS visible)
            if (K == 0)
              slab_accumulate<T, kSub>(acc[k - 2], half ? dst : pt, 0, 4 * ky, slab(k & 1, half ? 0 : 1), cx);
            else
              slab_accumulate<T, kSub / 2>(acc[k - 2], dst, half * (kSub / 2), 4 * ky, slab(k & 1, 0), cx);
          }
        };
        step(Kind<0>{});
        step(Kind<1>{});
        step(Kind<2>{});
        step(Kind<3>{});
      }
    };
    if (x.n > 0) {
      if (x.kind == 0)
        run(Kind<0>{});
      else
        run(Kind<1>{});
    }

    if (x.kind == 0) {  // dV (half 0) and dK (half 1); zeros for keys no row sees
      T* outg = half ? static_cast<T*>(p.dk) + b * p.dks[0] + hk * p.dks[1]
                     : static_cast<T*>(p.dv) + b * p.dvs[0] + hk * p.dvs[1];
      const long long ostride = half ? p.dks[2] : p.dvs[2];
      const float scale = half ? p.scale : 1.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = k0 + 4 * ky + a;
        if (j >= p.sk) continue;
#pragma unroll
        for (int sl = 0; sl < 2; ++sl)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float xv[4] = {acc[sl][a][4 * h2] * scale, acc[sl][a][4 * h2 + 1] * scale,
                                 acc[sl][a][4 * h2 + 2] * scale, acc[sl][a][4 * h2 + 3] * scale};
            store_n<4>(outg + static_cast<long long>(j) * ostride + sl * kSlab + 64 * h2 + cx * 4, xv);
          }
      }
    } else if (x.n > 0) {  // dQ: half 1's partials through stage 1, summed by half 0
      __syncthreads();  // every read of stage 1 is done
      if (half) {
#pragma unroll
        for (int sl = 0; sl < 2; ++sl)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 8; ++c) part[((sl * 4 + a) * 8 + c) * kHalf + tid % kHalf] = acc[sl][a][c];
      }
      __syncthreads();
      if (!half) {
        T* dqg = static_cast<T*>(p.dq);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          int gg, i;
          if (!packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0, r0 + 4 * ky + a, gg, i)) continue;
          T* row = dqg + b * p.dqs[0] + (hk * p.group + gg) * p.dqs[1] + static_cast<long long>(i) * p.dqs[2];
#pragma unroll
          for (int sl = 0; sl < 2; ++sl)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              float xv[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = 4 * h2 + e;
                xv[e] = (acc[sl][a][c] + part[((sl * 4 + a) * 8 + c) * kHalf + tid]) * p.scale;
              }
              store_n<4>(row + sl * kSlab + 64 * h2 + cx * 4, xv);
            }
        }
      }
    }
    __syncthreads();  // the shared memory is free for the next item
    if (x.n == 0 && early) {  // no tile to send them out under
      load_fixed(xn);
      load_slab(xn, 0, 0);
    }
    x = xn;
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t bytes, int blocks, int threads, const BwdParams& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                      void* dk, void* dv, const float* lse, float* stats, const long long* strides, int batch,
                      int hq, int hkv, int sq, int sk, int d, int causal, float softcap, int q_offset, int kv_len,
                      int window) {
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
  p.stats = stats;
  long long* dst[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.batch = batch;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.sq = sq;
  p.sk = sk;
  p.qpt = kSub / p.group;
  p.inv_group = 1.f / static_cast<float>(p.group);
  p.nsub = (sq + p.qpt - 1) / p.qpt;
  p.nsub2 = p.nsub + p.nsub % 2;  // whole 128-row tiles of the dQ kernel
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.window = window > 0 ? window : 1 << 30;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));  // as the forward's
  p.softcap = softcap;
  return p;
}

enum Which { kPreK, kDkdvK, kDqK };

template <typename T, int D>
int run(const BwdParams& p, Which which, cudaStream_t s) {
  const int nbkv = p.batch * p.hkv;
  switch (which) {
    case kPreK: {
      constexpr int L = D / 4 < 32 ? D / 4 : 32;
      const long long lanes = static_cast<long long>(nbkv) * p.nsub2 * kSub * L;
      return launch(flash_bwd_pre_kernel<T, D>, 0, static_cast<int>((lanes + kPre - 1) / kPre), kPre, p, s);
    }
    case kDkdvK:
      if constexpr (D == 256) {
        return static_cast<int>(cudaErrorInvalidValue);  // th_flash_bwd_dkdv_dq's
      } else {
        return launch(p.window < (1 << 30) ? flash_bwd_dkdv_kernel<T, D, true> : flash_bwd_dkdv_kernel<T, D, false>,
                      DkdvLayout<T, D>::kBytes, nbkv * ((p.sk + kKeys - 1) / kKeys),
                      kThreads, p, s);
      }
    default:
      if constexpr (D == 256) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        return launch(p.window < (1 << 30) ? flash_bwd_dq_kernel<T, D, true> : flash_bwd_dq_kernel<T, D, false>,
                      DqLayout<T, D>::kBytes, nbkv * (p.nsub2 / 2), kThreads, p, s);
      }
  }
}

// the head_dim-256 kernel on `grid` blocks walking `work`
template <typename T>
int run256(const BwdParams& bp, const int* work, int grid, cudaStream_t s) {
  Cc256Params p;
  static_cast<BwdParams&>(p) = bp;
  p.work = work;
  constexpr size_t bytes = Cc256Layout<T>::kBytes;
  auto kernel = bp.window < (1 << 30) ? flash_bwd_cc256_kernel<T, true> : flash_bwd_cc256_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const BwdParams& p, int d, Which which, cudaStream_t s) {
  switch (d) {
    case 16: return run<T, 16>(p, which, s);
    case 32: return run<T, 32>(p, which, s);
    case 64: return run<T, 64>(p, which, s);
    case 128: return run<T, 128>(p, which, s);
    case 256: return run<T, 256>(p, which, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int entry(Which which, const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
          void* dk, void* dv, const float* lse, float* stats, const long long* strides, int dtype, int batch,
          int hq, int hkv, int sq, int sk, int d, int causal, float softcap, int q_offset, int kv_len,
          int window, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || hq / hkv > kSub) return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p = make_params(q, k, v, o, dout, dq, dk, dv, lse, stats, strides, batch, hq, hkv, sq, sk, d,
                                  causal, softcap, q_offset, kv_len, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(p, d, which, s);
    case 1: return dispatch<__nv_bfloat16>(p, d, which, s);
    case 2: return dispatch<__half>(p, d, which, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq [B, Hq, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D]: pointers,
// and their (batch, head, sequence) element strides in `strides` (a host
// array of 24 in the order q, k, v, o, dout, dq, dk, dv); lse f32
// [B, Hq, Sq] contiguous, from the forward; stats f32 scratch of
// B * Hkv * nsub2 * 128 floats (nsub2: ceil(Sq / (64 / G)) rounded up to
// even); dtype 0 = float32, 1 = bfloat16, 2 = float16 (every tensor but
// lse and stats); D in {16, 32, 64, 128, 256}; Hq / Hkv <= 64; 1 <= kv_len <=
// Sk; window > 0 a sliding window, 0 none. In this order on one stream: th_flash_bwd_pre writes stats,
// th_flash_bwd_dkdv writes dk and dv (zeros past kv_len), th_flash_bwd_dq
// writes dq (D 16-128); at D 256 th_flash_bwd_dkdv_dq (a work list beside
// the arguments) writes all three. Each returns cudaGetLastError() after
// its launch.
#define TH_BWD_ARGS                                                                                             \
  const void *q, const void *k, const void *v, const void *o, const void *dout, void *dq, void *dk, void *dv,  \
      const float *lse, float *stats, const long long *strides, int dtype, int batch, int hq, int hkv, int sq, \
      int sk, int d, int causal, float softcap, int q_offset, int kv_len, int window, void *stream
#define TH_BWD_PASS                                                                                         \
  q, k, v, o, dout, dq, dk, dv, lse, stats, strides, dtype, batch, hq, hkv, sq, sk, d, causal, softcap, q_offset, \
      kv_len, window, stream

extern "C" int th_flash_bwd_pre(TH_BWD_ARGS) { return entry(kPreK, TH_BWD_PASS); }
extern "C" int th_flash_bwd_dkdv(TH_BWD_ARGS) { return entry(kDkdvK, TH_BWD_PASS); }
extern "C" int th_flash_bwd_dq(TH_BWD_ARGS) { return entry(kDqK, TH_BWD_PASS); }

// D = 256 only, after th_flash_bwd_pre: dk, dv and dq in one launch of
// `grid` persistent blocks walking the work list `work` (int32 on the
// device: grid + 1 offsets, then four ints an item; flash_attention's
// bwd256_order)
extern "C" int th_flash_bwd_dkdv_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                    void* dq, void* dk, void* dv, const float* lse, float* stats,
                                    const long long* strides, int dtype, int batch, int hq, int hkv, int sq, int sk,
                                    int d, int causal, float softcap, int q_offset, int kv_len, int window,
                                    const int* work, int grid, void* stream) {
  if (d != 256 || grid < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > kSub)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p = make_params(q, k, v, o, dout, dq, dk, dv, lse, stats, strides, batch, hq, hkv, sq, sk, d,
                                  causal, softcap, q_offset, kv_len, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run256<float>(p, work, grid, s);
    case 1: return run256<__nv_bfloat16>(p, work, grid, s);
    case 2: return run256<__half>(p, work, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
