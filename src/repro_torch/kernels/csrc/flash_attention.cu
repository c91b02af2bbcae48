// Flash attention (online softmax) for Hopper, f32 arithmetic on the CUDA
// cores: the `f32` route, which takes every call the tensor-core and
// decode routes do not (f32 and f16 throughout, bf16 at head_dim 16, 32
// and 256, decode-sized calls a caller names it for).
//
// Replaces the Pallas TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention/kernel.py, _flash_kernel). For query
// head row b*Hq + h against KV row b*Hkv + h / G (G = Hq / Hkv, GQA):
//   s   = (q . k) * (1 / sqrt(D))          f32 dot, scale after it
//   s   = c * tanh(s / c)                  when softcap c > 0
//   s   = -1e30 where key j >= kv_len, or (causal) j > q_offset + i,
//         or (sliding window W) j <= q_offset + i - W
//   out = softmax(s) v                     online: m, l, acc in f32
// with the TPU kernel's numerics: -1e30 (not -inf) for masked scores,
// alpha = exp(m_prev - m_cur), l = l * alpha + sum(p), and the final
// acc / max(l, 1e-30), rounded once to the input dtype; exp is __expf
// (ex2.approx of a prescaled argument: a few ulp where p matters, well
// inside the route's 2e-5). With q_offset = 0
// and kv_len = Sk it computes what the TPU kernel computes; the two
// runtime arguments are what the model's decode step needs (one query at
// position cache_len against a cache of which cache_len + 1 slots hold
// keys).
//
// Bound: at the f32 training shape (q [16, 32, 576, 128], k/v
// [16, 8, 576, 128], causal) two products of 2 D FLOPs over 85 M live
// (query, key) pairs are 43.5 GFLOP, 0.650 ms at the CUDA cores' 67
// TFLOP/s, against 0.151 GB of q, k, v and o, 0.045 ms at 3.35 TB/s: it
// is bound by operations. The products stay f32 FMAs (the f32 contract is
// 2e-5; the tensor cores take f32 only as TF32, three decimal digits).
//
// Design. The TPU kernel carries m, l and acc in VMEM across a sequential
// grid axis over key tiles; Hopper blocks run in no order, so one block of
// 256 threads owns a tile of BQ packed query rows and loops over the key
// tiles itself:
//  * The G query heads that share a KV head are packed into the tile
//    (packed_row, vec.cuh: 64-row sub-tiles of 64 / G positions x G
//    heads), so each K/V tile loaded serves all of them.
//  * Copies are asynchronous: Q once, then K and V tiles of BK keys
//    through a ring of two stages by 16-byte cp.async, so tile t + 1
//    arrives while tile t computes. Keys at or past the live end are
//    filled with zeros by the copy itself (src-size 0), so a dead cache
//    slot's NaN never reaches a product.
//  * Tiles are kept row-major in the 16-byte-chunk XOR swizzle (Swz,
//    vec.cuh) and unpadded, which is what lets BQ = 128, two K/V stages,
//    the P tile and the rows' alpha and l fit 227 KB at head_dim 128 in
//    f32 (231,424 bytes).
//  * 8 x 8 register micro-tiles, so each float a thread loads from shared
//    memory feeds 4 FMAs: an SM's shared memory delivers 128 bytes a clock
//    to its 128 FMA lanes, and a 8 x 4 tile (2.7 FMAs a float) would
//    leave a third of them idle. A 128 x 64 score tile is 32 scores a
//    thread, so the block's two halves each sum it over half of D (rows
//    hx + 16a, keys tx + 8c, 8 x 8 a thread; nt_product) and trade the
//    partial sums of each other's rows through the P tile; each half then
//    finalizes 4 of a thread's rows: masks, the row max and sum over the 8
//    lanes of a row by shuffles, the online-softmax update of m and l, P
//    into the P tile transposed (P[key][slot], slot 8 hx + a; pitch BQ + 4,
//    so a quarter warp's 16-byte stores of 8 keys fall on 8 bank groups)
//    and the row's alpha into a vector. All 256 threads then rescale and
//    accumulate P V, 8 rows (slots 8 ty + a) x 8 RowCols columns a thread
//    (nn_product; 4-wide groups 64 apart from head_dim 64 up, one group of
//    D/16 below it, so head_dim 16 and 32 are not padded). Three barriers
//    a tile.
//  * A block loops only over the key tiles that hold a live key: tiles at
//    or past kv_len, (causal) past the tile's last query position and
//    (window W) wholly at or before its first position - W, the smallest
//    of the qpt positions a packed sub-tile spans, are skipped, not masked,
//    so a decode step's cost follows cache_len and a windowed layer's the
//    window. Causal blocks with the most key tiles are launched first.
// Tile plan (the same for f32, bf16 and f16; 16-bit tiles keep their
// type in shared memory and convert as they are read): BQ 128 rows and BK
// 64 keys at head_dim 16-128 (BQ 64 where the whole call is one sub-tile,
// a decode step's size), BQ 64 and BK 32 at head_dim 256.
//
// Inputs are strided in batch, head and sequence (unit stride in D), so
// the wrapper hands over views without copies; each row must be 16-byte
// aligned for the copies (the wrapper's _aligned).
//
// For the backward (flash_attention_bwd.cu) the kernel also writes each
// row's log-sum-exp, m + log(max(l, 1e-30)) in f32, to lse [B, Hq, Sq]
// when the pointer is not null (the serving path passes null).
//
// q/k and v of other widths: the reduced deepseek-v3's MLA attention has
// q/k of 24 (16 + 8 rope) and v of 16, which the 8 x 8 micro-tiles (half of
// D a block half, RowCols) do not split. That pair runs on the head_dim-32
// tiles (template DK, DV: the true widths, D the tiles'): Q and K rows are
// copied at 24 columns and V rows at 16, the tiles' columns past them
// zero-filled by the copies (src-size 0; nothing past a row's true width
// is read), so each score is the 24-term dot plus exact zeros, in the same
// order; the scale is 1 / sqrt(24) from the host's width, never the tiles';
// and the output is stored at its 16 columns only (RowCols<32> gives a
// thread 2 adjacent columns, so the clip takes whole pairs), so a strided
// view's neighbouring columns are never written.
//
// Head_dim 80 (hubert-xlarge's 1280 / 16 heads, zamba2's attention) runs
// the same way on the head_dim-128 tiles (DK = DV = 80, D = 128). Native
// 80-wide tiles do not fit this design: the XOR swizzle needs a power of
// two of 16-byte chunks a row (80 f32 columns are 20 chunks, so a chunk
// index XORed with up to 7 leaves the row), and RowCols<80> would give a
// thread 5 columns, no whole group of 4. So Q, K and V rows are copied at
// 80 columns (320 B in f32, 160 B in bf16 and f16: whole 16-byte chunks)
// and the tiles' columns 80-127 are zeros; each half of the block sums
// its scores over half of the true width, 40 columns (KH below, D / 2 in
// every instance whose DK and DV differ or equal D), so Q K^T costs the
// true width's FMAs; P V still runs over the tile's 128 columns, 48 of
// them zeros. The forward thus does (80 + 128) / (2 x 80) = 1.3x the FMAs
// of native tiles, and the output is stored at its 80 columns (whole
// 4-wide groups: cx < 4 of the second group). Every instance with DK = DV
// = D, and (24, 16), compiles as before.

#include <cmath>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Hq, Sq] or null
  long long qs[3], ks[3], vs[3], os[3];  // element strides: batch, head, sequence
  int hkv, group, sq, qpt, ntiles, causal, q_offset, kv_len;
  int window;  // the sliding window, or 2^30 for none
  float inv_group, scale, softcap;
};

// Q [BQ][D], K and V [2][BK][D] (T, swizzled), P^T [BK][BQ + 4] (f32),
// and each row's alpha and l (f32, by slot)
template <typename T, int D, int NSUB, int BK>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t(kSub) * NSUB * D + 4 * size_t(BK) * D) +
         sizeof(float) * (size_t(BK) * (kSub * NSUB + 4) + 2 * size_t(kSub) * NSUB);
}

// W: the call has a window. The unwindowed instances carry neither the
// window's compare nor its first tile, so a call without a window runs
// the code it ran before the window came (the mask loop sits at 254-255
// registers at head_dim 128 in f32, where one more live value costs time)
template <typename T, int D, int NSUB, int BK, bool W, int DK = D, int DV = D>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(const Params p) {
  constexpr int BQ = kSub * NSUB;
  constexpr int RA = BQ / 16;  // rows a thread: hx + 16a in the scores, slots RA ty + a in P V
  constexpr int RC = BK / 8;   // keys a thread of a half: tx + 8c
  constexpr int FA = RA / 2;   // rows a thread finalizes: a in [FA h, FA h + FA)
  constexpr int PP = BQ + 4;   // pitch of the P^T tile
  constexpr int KH = DK == DV ? DK / 2 : D / 2;  // the score columns each half sums (the header: head_dim 80)
  using C = RowCols<D>;
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* kbuf = qs + BQ * D;
  T* vbuf = kbuf + 2 * BK * D;
  float* pt = reinterpret_cast<float*>(vbuf + 2 * BK * D);  // [BK][PP]: P^T[key][slot]
  float* alpha_s = pt + BK * PP;                            // [BQ] by slot
  float* l_s = alpha_s + BQ;                                // [BQ] by slot

  const int tid = threadIdx.x;
  const int h = tid / 128;                      // warp-uniform: the half of D this thread's scores sum
  const int hx = (tid % 128) / 8, tx = tid % 8;  // scores: rows hx + 16a, keys tx + 8c
  const int ty = tid / 16, cx = tid % 16;        // P V: row slots RA ty + a (rows ty + 16a), RowCols columns of cx
  const int nbkv = gridDim.x / p.ntiles;
  const int bkv = blockIdx.x % nbkv;
  const int tile = p.ntiles - 1 - blockIdx.x / nbkv;  // longest causal tiles first
  const int b = bkv / p.hkv, hk = bkv % p.hkv;
  const int sub0 = tile * NSUB;

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + static_cast<long long>(hk) * p.group * p.qs[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];

  // live keys: [kv_start, kv_end); tiles outside are skipped (the TPU
  // kernel's `live`), kv_start from the block's first position
  const int pos_end = min(p.sq, (sub0 + NSUB) * p.qpt);
  const int kv_end = p.causal ? min(p.kv_len, p.q_offset + pos_end) : p.kv_len;
  const int t0 = W ? max(0, p.q_offset + sub0 * p.qpt - p.window + 1) / BK : 0;
  const int ntiles = (kv_end + BK - 1) / BK - t0;

  copy_tile<T, D, BQ, kThreads, DK>(qs, [&](int r) -> const T* {
    int g, i;
    if (!packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0 + r / kSub, r % kSub, g, i)) return nullptr;
    return qg + g * p.qs[1] + i * p.qs[2];
  }, qg);
  auto copy_kv = [&](int t, int stage) {
    copy_rows<T, D, BK, kThreads, DK>(kbuf + stage * BK * D, kg, p.ks[2], t * BK, kv_end);
    copy_rows<T, D, BK, kThreads, DV>(vbuf + stage * BK * D, vg, p.vs[2], t * BK, kv_end);
  };
  copy_kv(t0, 0);
  cp_async_commit();

  // the rows this thread finalizes, hx + 16 (FA h + i): positions (padding
  // rows see no key), running max and sum
  int qpos[FA];
  float m[FA], l[FA];
#pragma unroll
  for (int i = 0; i < FA; ++i) {
    const int r = hx + 16 * (FA * h + i);
    int g, pos;
    qpos[i] = packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0 + r / kSub, r % kSub, g, pos) ? p.q_offset + pos : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[RA][C::kPer];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < C::kPer; ++c) acc[a][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = (t0 + t) * BK;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1's stage, pt and alpha_s
    if (t + 1 < ntiles) {
      copy_kv(t0 + t + 1, (t + 1) & 1);
      cp_async_commit();
    }
    const T* kt = kbuf + (t & 1) * BK * D;
    const T* vt = vbuf + (t & 1) * BK * D;

    // partial scores over this half of D, 8 x 8 (RA x RC) a thread
    float s[RA][RC];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RC; ++c) s[a][c] = 0.f;
    nt_product<T, D, KH, RA, RC, 16, 8>(s, qs, hx, kt, tx, h * KH);

    // the other half's rows' partials go through pt; this half's come back
    float f[FA][RC];
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      float o[FA];
#pragma unroll
      for (int i = 0; i < FA; ++i) o[i] = h ? s[i][c] : s[FA + i][c];
      store_n<FA>(pt + (tx + 8 * c) * PP + RA * hx + FA * (1 - h), o);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      float o[FA];
      load_n<FA>(pt + (tx + 8 * c) * PP + RA * hx + FA * h, o);
#pragma unroll
      for (int i = 0; i < FA; ++i) f[i][c] = (h ? s[FA + i][c] : s[i][c]) + o[i];
    }

    // scale and softcap (one branch a tile), then the online softmax of the
    // finalized rows; the 8 threads of a row are lanes 8k .. 8k + 7 of a
    // warp (they differ in tx only). exp is __expf, ex2.approx of a
    // prescaled argument (relative error ~2^-21 where p matters)
#pragma unroll
    for (int i = 0; i < FA; ++i)
#pragma unroll
      for (int c = 0; c < RC; ++c) f[i][c] *= p.scale;
    if (p.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < FA; ++i)
#pragma unroll
        for (int c = 0; c < RC; ++c) f[i][c] = p.softcap * tanhf(f[i][c] / p.softcap);
    }
#pragma unroll
    for (int i = 0; i < FA; ++i) {
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int kpos = k0 + tx + 8 * c;
        const bool ok = kpos < p.kv_len && (p.causal ? kpos <= qpos[i] : qpos[i] >= 0) && (!W || kpos > qpos[i] - p.window);
        f[i][c] = ok ? f[i][c] : kNegInf;
        rmax = fmaxf(rmax, f[i][c]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xFFFFFFFFu, rmax, off));
      const float m_cur = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        f[i][c] = __expf(f[i][c] - m_cur);
        rsum += f[i][c];
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xFFFFFFFFu, rsum, off);
      const float alpha = __expf(m[i] - m_cur);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_cur;
      if (tx == 0) alpha_s[RA * hx + FA * h + i] = alpha;
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      float o[FA];
#pragma unroll
      for (int i = 0; i < FA; ++i) o[i] = f[i][c];
      store_n<FA>(pt + (tx + 8 * c) * PP + RA * hx + FA * h, o);
    }
    __syncthreads();

    // acc[a] = acc[a] * alpha + sum_j P[row a][j] * V[j][C::col(g, cx) + e]
    float al[RA];
    load_n<RA>(alpha_s + RA * ty, al);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < C::kPer; ++c) acc[a][c] *= al[a];
    nn_product<T, D, RA, PP, BK>(acc, pt, RA * ty, vt, cx);
  }

  // the finalizing threads hold m and l: the lse, and l for the P V threads
#pragma unroll
  for (int i = 0; i < FA; ++i) {
    const int r = hx + 16 * (FA * h + i);
    const float den = fmaxf(l[i], 1e-30f);
    if (tx != 0) continue;
    l_s[RA * hx + FA * h + i] = den;
    int g, pos;
    if (p.lse != nullptr && packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0 + r / kSub, r % kSub, g, pos))
      p.lse[(static_cast<long long>(b) * p.hkv * p.group + hk * p.group + g) * p.sq + pos] = m[i] + logf(den);
  }
  __syncthreads();
  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 16 * a;  // slot RA ty + a
    int g, i;
    if (!packed_row(p.group, p.inv_group, p.qpt, p.sq, sub0 + r / kSub, r % kSub, g, i)) continue;
    const int hh = hk * p.group + g;
    const float den = l_s[RA * ty + a];
    T* orow = og + b * p.os[0] + hh * p.os[1] + i * p.os[2];
#pragma unroll
    for (int gc = 0; gc < C::kGroups; ++gc) {
      static_assert(DV % C::kW == 0, "the clip takes a thread's groups whole");
      if (DV < D && C::col(gc, cx) >= DV) continue;
      float x[C::kW];
#pragma unroll
      for (int e = 0; e < C::kW; ++e) x[e] = acc[a][gc * C::kW + e] / den;
      store_n<C::kW>(orow + C::col(gc, cx), x);
    }
  }
}

template <typename T, int D, int NSUB, int BK, int DK = D, int DV = D>
int launch(Params p, int nsub, int bkv, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, D, NSUB, BK>();
  static_assert(bytes <= 232448, "a block's shared memory on sm_90");
  const auto kernel = p.window < (1 << 30) ? flash_kernel<T, D, NSUB, BK, true, DK, DV>
                                           : flash_kernel<T, D, NSUB, BK, false, DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  p.ntiles = (nsub + NSUB - 1) / NSUB;
  kernel<<<p.ntiles * bkv, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the tile plan a head_dim: BQ 128 rows (64 for a call of one sub-tile)
// and BK 64 keys up to head_dim 128 (and 80, on its tiles), BQ 64 and BK
// 32 at 256; DK and DV the true widths where they are narrower than the
// tiles' D
template <typename T, int D, int DK = D, int DV = D>
int plan(const Params& p, int nsub, int bkv, cudaStream_t stream) {
  if constexpr (D == 256) {
    return launch<T, D, 1, 32>(p, nsub, bkv, stream);
  } else {
    return nsub == 1 ? launch<T, D, 1, 64, DK, DV>(p, nsub, bkv, stream)
                     : launch<T, D, 2, 64, DK, DV>(p, nsub, bkv, stream);
  }
}

template <typename T>
int dispatch(const Params& p, int d, int dv, int nsub, int bkv, cudaStream_t stream) {
  if (d == 24 && dv == 16) return plan<T, 32, 24, 16>(p, nsub, bkv, stream);  // the reduced deepseek-v3's MLA
  if (d == 80 && dv == 80) return plan<T, 128, 80, 80>(p, nsub, bkv, stream);  // hubert-xlarge, on the 128 tiles
  if (dv != d) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return plan<T, 16>(p, nsub, bkv, stream);
    case 32: return plan<T, 32>(p, nsub, bkv, stream);
    case 64: return plan<T, 64>(p, nsub, bkv, stream);
    case 128: return plan<T, 128>(p, nsub, bkv, stream);
    case 256: return plan<T, 256>(p, nsub, bkv, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv, Sk, Dv], o [B, Hq, Sq, Dv],
// each given by its pointer and its (batch, head, sequence) element strides
// in `strides` (a host array of 12: q, k, v, o); dtype 0 = float32,
// 1 = bfloat16, 2 = float16; D in {16, 32, 64, 80, 128, 256} with Dv = D,
// or (D, Dv) = (24, 16); Hq / Hkv <= 64;
// 1 <= kv_len <= Sk; window > 0 a sliding window, 0 none;
// lse f32 [B, Hq, Sq] or null. Returns cudaGetLastError() after the launch.
extern "C" int th_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  const long long* strides, int dtype, int batch, int hq,
                                  int hkv, int sq, int d, int dv, int causal, float softcap,
                                  int q_offset, int kv_len, int window, float* lse, void* stream) {
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
  if (p.group < 1 || p.group > kSub) return static_cast<int>(cudaErrorInvalidValue);
  p.sq = sq;
  p.qpt = kSub / p.group;
  p.inv_group = 1.f / static_cast<float>(p.group);
  const int nsub = (sq + p.qpt - 1) / p.qpt;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.window = window > 0 ? window : 1 << 30;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));  // as the TPU kernel's Python scalar
  p.softcap = softcap;
  const int bkv = batch * hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(p, d, dv, nsub, bkv, s);
    case 1: return dispatch<__nv_bfloat16>(p, d, dv, nsub, bkv, s);
    case 2: return dispatch<__half>(p, d, dv, nsub, bkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
