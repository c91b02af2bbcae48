// Split-KV flash attention for decode (flash-decoding), on the CUDA cores.
//
// Replaces the Pallas TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention/kernel.py, _flash_kernel) for every
// call whose packed query rows fit one tile, Sq * G <= 64 (G = Hq / Hkv):
// the serving path's decode step (Sq = 1, G = 4) and short chunks behind
// a cache. It computes what flash_attention.cu and the TPU kernel compute
// (scores scaled after the f32 dot, c * tanh(s / c), -1e30 masks for keys
// at or past kv_len, causal, past q_offset + i and, under a sliding window
// W, at or before q_offset + i - W; softmax in f32, acc / max(l, 1e-30)
// rounded once), f32 or bf16, head_dim 64/80/128/256.
//
// Bound: a decode step reads the live keys and values of every KV head
// once (37.7 MB at the serving shape, kv_len 576) and does 4 FLOPs a key
// a query row: bound by bytes, so the tensor cores buy nothing. What the
// one-block-a-KV-head design lacked was parallelism: 128 blocks on 132
// SMs, each walking its keys in series. Here the key range [kv_start,
// kv_end) (kv_end = kv_len, or q_offset + Sq when causal; kv_start =
// q_offset - W + 1 under a window W, the first key the first row sees,
// else 0, so keys before the window are neither loaded nor scored) is cut
// into splits of
// keys_per_split keys (a multiple of 64, chosen by the wrapper from kv_end
// and the batch so that the grid is about one wave of this kernel on the
// 132 SMs: 640 blocks of 128 keys at the serving shape, where 1152 blocks
// of 64 keys measured slower, each block's fixed costs outweighing the
// parallelism), one block per (batch x KV head,
// split); splits past kv_end are not launched. A block stages each
// 64-key K and V tile with 16-byte cp.async (zeros past its split; K rows
// at a pitch of an odd multiple of 32 bytes, padded by 32 where the row is
// not one already, so that threads reading different rows hit different
// banks) and converts its packed query rows (row r is query r / G of head
// hk * G + r % G) to f32 in shared memory while the tiles fly. Two
// neighbouring threads score a key, each half of its 16-byte chunks
// against four rows at a time (one shuffle joins the halves); a warp a row
// runs the TPU kernel's online softmax over the tile; for P V a thread
// takes a chunk of columns and a slot of keys against four rows at a
// time, each V element converted once for all rows, and the slots' sums
// meet in the K tile's space. The block writes a partial (m, l, acc[D]) in
// f32 to the scratch the wrapper allocated and counts its split done on a
// per-(batch, KV head) counter; the block that counts the last split
// merges the partials of its rows and resets the counter to 0, so one
// launch does the whole step. (f32 at head_dim 256 takes 32-key tiles, so
// 64 rows still fit the shared memory.) The merge: M = max m_i, out = sum
// exp(m_i - M) acc_i / max(sum exp(m_i - M) l_i, 1e-30). A split in which
// a row saw only masked keys has m_i = -1e30 and drops out exactly
// (exp(-1e30 - M) = 0), as the TPU kernel's alpha wipes such a tile; every
// row sees a key of some split (the wrapper refuses a window that leaves a
// row none). Where the caller asks for it, the merging block also writes
// each row's log-sum-exp, M + log(max(sum exp(m_i - M) l_i, 1e-30)), in the
// units of the scores after the scale and the softcap: what a caller needs
// to merge this call's output with another call's over other keys (the
// hybrid's ring cache sharded along its slots, one call a rank).
//
// Head_dim 80 (zamba2's shared attention block) has instances of its own,
// not the 128 tile zero-filled past column 80: decode is bound by the K/V
// bytes it reads, and a native row moves 160 B (bf16) or 320 B (f32). A row
// is then 10 (bf16) or 20 (f32) 16-byte chunks, which do not divide the 128
// threads: in P V a thread takes chunk tid % CH of key slot tid / CH, the
// 12 (bf16) or 6 (f32) whole slots cover threads 0-119, and threads 120-127
// sit that product out (they still meet every barrier); the slots' partial
// sums take at most kThreads x 16 B x kRB, as at the other widths. The bf16
// row of 160 B is an odd multiple of 32 B, so its K rows take no padding
// (a pitch of 192 B would put keys j and j + 2 of a quarter-warp's load on
// the same banks); the f32 row of 320 B takes 32 B, a pitch of 352 B.
//
// Numerics against the TPU kernel: the same f32 operations, summed in
// another order (a dot product in two halves; P V in key slots; a split's
// partial, then the merge, where the TPU kernel carries one running sum
// over its key tiles): relative differences of order 1e-7 in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // keys a tile
constexpr int kMaxRows = 64;   // packed query rows a block
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;    // acc [BHkv][nsplit][rows][D], then (m, l) [BHkv][nsplit][rows][2]
  float* lse;     // [B][Hq][Sq] f32 (element strides Hq * Sq, Sq, 1), or null: no log-sum-exp written
  int* counters;  // [BHkv] splits done, 0 between calls (the merging block resets its own)
  long long qs[3], ks[3], vs[3], os[3];  // element strides: batch, head, sequence
  int hkv, group, rows, sq, causal, q_offset, kv_start, kv_end, window, keys_per_split, nsplit;  // window: 2^30 for none
  float scale, softcap;
};

__device__ __forceinline__ float2 bf2(uint32_t u) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = u;
  return __bfloat1622float2(h);
}

// E (4 or 8) consecutive elements as floats, from 16-byte aligned rows
template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&x)[E]) {
  static_assert(E == 8, "one 16-byte chunk of bf16");
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const float2 a = bf2(u.x), b = bf2(u.y), c = bf2(u.z), d = bf2(u.w);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y; x[4] = c.x; x[5] = c.y; x[6] = d.x; x[7] = d.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int nbytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(nbytes) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, off));
  return x;
}

// keys a tile: 32 for f32 at head_dim 256, so 64 rows still fit
__host__ __device__ constexpr int tile_keys(int d, int isz) { return isz == 4 && d == 256 ? 32 : kTile; }

constexpr int kRB = 4;  // rows a thread carries at once in registers

// K row pitch in bytes: an odd multiple of 32 (the row, or the row and 32
// bytes of padding), so the four keys a quarter-warp's 16-byte loads read in
// the scores land on four different pairs of 16-byte bank groups
__host__ __device__ constexpr int k_pitch_bytes(int d, int isz) { return d * isz % 64 == 32 ? d * isz : d * isz + 32; }

// shared memory of a split block: q and acc [rows][D] f32, scores
// [rows][TK] f32, m, l, alpha [rows]; then the K tile [TK][pitch]
// in T, whose space the P.V partial sums [slots][kRB][D] f32 reuse once
// the scores are taken; then the V tile [TK][D] in T
__host__ __device__ constexpr size_t split_floats(int rows, int d, int isz) {
  return size_t(rows) * d * 2 + size_t(rows) * tile_keys(d, isz) + 3 * size_t(rows);
}

__host__ __device__ constexpr size_t k_region(int d, int isz) {
  // the partial sums: (kThreads / chunks a row) slots x kRB x D f32, at most
  // kThreads x (16 / isz) x kRB f32 (equal where the chunks divide kThreads)
  return size_t(tile_keys(d, isz)) * k_pitch_bytes(d, isz) > size_t(kThreads) * 64 * kRB / isz
             ? size_t(tile_keys(d, isz)) * k_pitch_bytes(d, isz)
             : size_t(kThreads) * 64 * kRB / isz;
}

__host__ __device__ constexpr size_t split_smem(int rows, int d, int isz) {
  return (split_floats(rows, d, isz) * 4 + 15) / 16 * 16 + k_region(d, isz) + size_t(tile_keys(d, isz)) * d * isz;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const DecodeParams p) {
  constexpr int VE = 16 / int(sizeof(T));            // elements a 16-byte chunk
  constexpr int CH = D / VE;                         // chunks a row
  constexpr int TK = tile_keys(D, int(sizeof(T)));   // keys a tile
  constexpr int KP = k_pitch_bytes(D, int(sizeof(T))) / int(sizeof(T));  // K row pitch (no bank conflicts)
  constexpr int TPK = kThreads / TK;                 // threads a key in the scores (2, or 4 at TK 32)
  constexpr int NSL = kThreads / CH;                 // key slots in P.V (threads NSL * CH .. kThreads - 1 idle)
  static_assert(D % VE == 0 && CH % TPK == 0, "a row is whole chunks, shared evenly by a key's threads");
  extern __shared__ float4 smem4[];
  const int rows = p.rows;
  float* qf = reinterpret_cast<float*>(smem4);
  float* acc = qf + rows * D;
  float* sc = acc + rows * D;
  float* ms = sc + rows * TK;
  float* ls = ms + rows;
  float* al = ls + rows;
  uint8_t* kreg = reinterpret_cast<uint8_t*>(smem4) + (split_floats(rows, D, int(sizeof(T))) * 4 + 15) / 16 * 16;
  T* kt = reinterpret_cast<T*>(kreg);
  float* red = reinterpret_cast<float*>(kreg);  // after the scores: [NSL][kRB][D]
  T* vt = reinterpret_cast<T*>(kreg + k_region(D, int(sizeof(T))));

  const int split = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / p.hkv, hk = bkv % p.hkv;
  const int k_begin = p.kv_start + split * p.keys_per_split;
  const int k_end = min(k_begin + p.keys_per_split, p.kv_end);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];

  for (int r = tid; r < rows; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  for (int t0 = k_begin; t0 < k_end; t0 += TK) {
    __syncthreads();  // the last tile's reads are done
    // K and V tiles by 16-byte cp.async, zeros past the split
    for (int idx = tid; idx < TK * CH; idx += kThreads) {
      const int j = idx / CH, ch = idx % CH;
      const bool live = t0 + j < k_end;
      const int row = live ? t0 + j : k_begin;
      cp_async16(kt + j * KP + ch * VE, kg + row * p.ks[2] + ch * VE, live ? 16 : 0);
      cp_async16(vt + j * D + ch * VE, vg + row * p.vs[2] + ch * VE, live ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (t0 == k_begin) {  // q rows as f32 (row r is query r / G of head hk * G + r % G), while the tiles fly
      for (int idx = tid; idx < rows * CH; idx += kThreads) {
        const int r = idx / CH, ch = idx % CH;
        const int h = hk * p.group + r % p.group, i = r / p.group;
        float x[VE];
        load_row<VE>(qg + h * p.qs[1] + i * p.qs[2] + ch * VE, x);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          qf[r * D + ch * VE + e] = x[e];
          acc[r * D + ch * VE + e] = 0.f;
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // scores: TPK threads a key (neighbouring lanes), each the chunks
    // part, part + TPK, ... of it, kRB rows at a time
    {
      const int j = tid / TPK, part = tid % TPK;
      const T* krow = kt + j * KP;
      for (int r0 = 0; r0 < rows; r0 += kRB) {
        float dot[kRB];
#pragma unroll
        for (int rb = 0; rb < kRB; ++rb) dot[rb] = 0.f;
#pragma unroll
        for (int cc = 0; cc < CH / TPK; ++cc) {
          const int c = cc * TPK + part;
          float kv[VE];
          load_row<VE>(krow + c * VE, kv);
#pragma unroll
          for (int rb = 0; rb < kRB; ++rb) {
            if (r0 + rb < rows) {
              float qv[VE];
              load_row<VE>(qf + (r0 + rb) * D + c * VE, qv);
#pragma unroll
              for (int e = 0; e < VE; ++e) dot[rb] = fmaf(qv[e], kv[e], dot[rb]);
            }
          }
        }
#pragma unroll
        for (int rb = 0; rb < kRB; ++rb) {
#pragma unroll
          for (int off = TPK / 2; off > 0; off >>= 1) dot[rb] += __shfl_xor_sync(0xFFFFFFFFu, dot[rb], off);
          if (part == 0 && r0 + rb < rows) sc[(r0 + rb) * TK + j] = dot[rb];
        }
      }
    }
    __syncthreads();

    // online softmax of the tile, a warp a row
    for (int r = warp; r < rows; r += kWarps) {
      const int qpos = p.q_offset + r / p.group;
      constexpr int PL = TK / 32;  // keys a lane
      float x[PL];
      float mx = kNegInf;
#pragma unroll
      for (int cc = 0; cc < PL; ++cc) {
        const int kpos = t0 + lane + 32 * cc;
        float s = sc[r * TK + lane + 32 * cc] * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        x[cc] = (kpos < k_end && (!p.causal || kpos <= qpos) && kpos > qpos - p.window) ? s : kNegInf;
        mx = fmaxf(mx, x[cc]);
      }
      const float m_prev = ms[r];
      const float m_cur = fmaxf(m_prev, warp_max(mx));
      float part_sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < PL; ++cc) {
        x[cc] = expf(x[cc] - m_cur);
        part_sum += x[cc];
        sc[r * TK + lane + 32 * cc] = x[cc];
      }
      const float sum = warp_sum(part_sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        al[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_cur;
      }
    }
    __syncthreads();

    // P V: a thread a chunk of VE columns and a key slot, kRB rows at a
    // time; the slots' sums meet in shared memory (the K tile's space).
    // Where the chunks do not divide the block (head_dim 80), the threads
    // past the last whole slot take no part
    {
      const int c = tid % CH, ks = tid / CH;
      for (int r0 = 0; r0 < rows; r0 += kRB) {
        if (NSL * CH == kThreads || ks < NSL) {  // folds to true where the chunks divide the block
          float a[kRB][VE];
#pragma unroll
          for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
            for (int e = 0; e < VE; ++e) a[rb][e] = 0.f;
#pragma unroll 4
          for (int j = ks; j < TK; j += NSL) {
            float vv[VE];
            load_row<VE>(vt + j * D + c * VE, vv);
#pragma unroll
            for (int rb = 0; rb < kRB; ++rb) {
              if (r0 + rb < rows) {
                const float pj = sc[(r0 + rb) * TK + j];
#pragma unroll
                for (int e = 0; e < VE; ++e) a[rb][e] = fmaf(pj, vv[e], a[rb][e]);
              }
            }
          }
#pragma unroll
          for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
            for (int e = 0; e < VE; e += 4)
              *reinterpret_cast<float4*>(red + (ks * kRB + rb) * D + c * VE + e) =
                  make_float4(a[rb][e], a[rb][e + 1], a[rb][e + 2], a[rb][e + 3]);
        }
        __syncthreads();
        for (int idx = tid; idx < kRB * D; idx += kThreads) {
          const int rb = idx / D, d = idx % D, r = r0 + rb;
          if (r < rows) {
            float sum = 0.f;
#pragma unroll
            for (int sl = 0; sl < NSL; ++sl) sum += red[(sl * kRB + rb) * D + d];
            acc[r * D + d] = acc[r * D + d] * al[r] + sum;
          }
        }
        __syncthreads();
      }
    }
  }

  // this split's partial (m, l, acc) out; the block that finishes the last
  // split of its (batch, KV head) merges them
  const size_t part = size_t(bkv) * p.nsplit + split;
  float* pacc = p.part + part * rows * D;
  for (int idx = tid; idx < rows * D; idx += kThreads) pacc[idx] = acc[idx];
  float* ml = p.part + size_t(gridDim.y) * p.nsplit * rows * D + size_t(bkv) * p.nsplit * rows * 2;
  for (int r = tid; r < rows; r += kThreads) {
    ml[(split * rows + r) * 2] = ms[r];
    ml[(split * rows + r) * 2 + 1] = ls[r];
  }
  __threadfence();  // the partial is visible to the merging block before the count says so
  __syncthreads();
  __shared__ int merging;
  if (tid == 0) {
    merging = atomicAdd(p.counters + bkv, 1) == p.nsplit - 1;
    if (merging) p.counters[bkv] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!merging) return;
  __threadfence();

  // out = sum_i exp(m_i - M) acc_i / max(sum_i exp(m_i - M) l_i, 1e-30):
  // every (m_i, l_i) of the rows loaded at once into the q and acc space
  // (free now), a row's weights and denominator computed once, then each
  // thread reads its four columns of all the partials in one go
  const int ns = p.nsplit;
  float* w = qf;   // [ns][rows]: m_i, then exp(m_i - M)
  float* lv = acc;  // [ns][rows]: l_i
  for (int idx = tid; idx < ns * rows; idx += kThreads) {
    w[idx] = __ldcg(ml + 2 * idx);
    lv[idx] = __ldcg(ml + 2 * idx + 1);
  }
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    float m = kNegInf;
    for (int i = 0; i < ns; ++i) m = fmaxf(m, w[i * rows + r]);
    float l = 0.f;
    for (int i = 0; i < ns; ++i) {
      const float wi = expf(w[i * rows + r] - m);
      w[i * rows + r] = wi;
      l = fmaf(wi, lv[i * rows + r], l);
    }
    al[r] = fmaxf(l, 1e-30f);
    if (p.lse != nullptr) {  // the row's log-sum-exp of its scaled scores, in the units of the other routes'
      const int h = hk * p.group + r % p.group, i = r / p.group;
      p.lse[(size_t(b) * p.hkv * p.group + h) * p.sq + i] = m + logf(al[r]);
    }
  }
  __syncthreads();
  const float* accs = p.part + size_t(bkv) * ns * rows * D;
  T* og = static_cast<T*>(p.o) + b * p.os[0];
  for (int idx = tid; idx < rows * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int i = 0; i < ns; ++i) {
      const float wi = w[i * rows + r];
      const float4 a = __ldcg(reinterpret_cast<const float4*>(accs + (size_t(i) * rows + r) * D + d));
      x[0] = fmaf(wi, a.x, x[0]);
      x[1] = fmaf(wi, a.y, x[1]);
      x[2] = fmaf(wi, a.z, x[2]);
      x[3] = fmaf(wi, a.w, x[3]);
    }
    const int h = hk * p.group + r % p.group, i = r / p.group;
    T* out = og + h * p.os[1] + i * p.os[2] + d;
#pragma unroll
    for (int e = 0; e < 4; ++e) store(out + e, x[e] / al[r]);
  }
}

template <typename T, int D>
int launch(const DecodeParams& p, int bkv, cudaStream_t stream) {
  static bool sized = false;  // room for the most rows, set once a kernel
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<T, D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 int(split_smem(kMaxRows, D, sizeof(T))));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const dim3 grid(p.nsplit, bkv);
  flash_decode_kernel<T, D><<<grid, kThreads, split_smem(p.rows, D, sizeof(T)), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const DecodeParams& p, int d, int bkv, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(p, bkv, stream);
    case 80: return launch<T, 80>(p, bkv, stream);
    case 128: return launch<T, 128>(p, bkv, stream);
    case 256: return launch<T, 256>(p, bkv, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], o [B, Hq, Sq, D], each by its
// pointer and its (batch, head, sequence) element strides in `strides` (a
// host array of 12: q, k, v, o); dtype 0 = float32, 1 = bfloat16; D in
// {64, 80, 128, 256}; Sq * Hq / Hkv <= 64; rows 16-byte aligned; 1 <= kv_len
// <= Sk; window > 0 a sliding window, 0 none. The key range [kv_start,
// kv_end) is cut into nsplit splits of keys_per_split keys (a multiple of
// 64; nsplit = ceil((kv_end - kv_start) / keys_per_split) <= 64); `part`
// is f32 scratch of B * Hkv * nsplit *
// Sq * G * (D + 2) floats, `counters` B * Hkv int32 zeros, left zero (the
// merging blocks reset them; calls that share them must not overlap).
// `lse`, unless null, is a contiguous f32 [B, Hq, Sq] that takes each row's
// log-sum-exp, M + log(max(sum_i exp(m_i - M) l_i, 1e-30)), of its scores
// after the scale and the softcap (the tensor_core and f32 routes' lse);
// the output is the same with it or without it.
// One launch; returns cudaGetLastError() after it.
extern "C" int th_flash_decode(const void* q, const void* k, const void* v, void* o, const long long* strides,
                               int dtype, int batch, int hq, int hkv, int sq, int d, int causal, float softcap,
                               int q_offset, int kv_len, int window, int keys_per_split, int nsplit, void* part,
                               void* counters, void* lse, void* stream) {
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part = static_cast<float*>(part);
  p.lse = static_cast<float*>(lse);
  p.sq = sq;
  p.counters = static_cast<int*>(counters);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.hkv = hkv;
  p.group = hq / hkv;
  p.rows = sq * p.group;
  p.causal = causal;
  p.q_offset = q_offset;
  p.kv_end = causal ? (q_offset + sq < kv_len ? q_offset + sq : kv_len) : kv_len;
  p.kv_start = window > 0 && q_offset - window + 1 > 0 ? q_offset - window + 1 : 0;
  p.window = window > 0 ? window : 1 << 30;
  p.keys_per_split = keys_per_split;
  p.nsplit = nsplit;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));  // as the TPU kernel's Python scalar
  p.softcap = softcap;
  if (p.rows > kMaxRows || keys_per_split <= 0 || keys_per_split % kTile || nsplit > kMaxSplits ||
      p.kv_start >= p.kv_end || nsplit != (p.kv_end - p.kv_start + keys_per_split - 1) / keys_per_split)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(p, d, batch * hkv, s);
    case 1: return dispatch<__nv_bfloat16>(p, d, batch * hkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
