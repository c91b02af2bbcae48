// End-to-end transfer checksum (paper 4.6) for Hopper.
//
// Replaces the Pallas TPU kernel checksum_words
// (src/repro/kernels/checksum/kernel.py, _checksum_kernel): over the
// buffer's little-endian uint32 words w_i (the last word zero-padded),
//   s1 = sum(w_i)                      mod 2^32
//   s2 = sum(((i & 0xFFFF) + 1) * w_i) mod 2^32
// The host folds (s2 << 32) | s1 and remaps a fold of 0.
//
// Bound: bytes. It reads every byte once and does three integer ops per
// 4 bytes, so the card's memory rate is the limit (1 GiB at 3.35 TB/s is
// 0.32 ms). Design: a grid-stride loop of 16-byte loads (4 words a
// thread a step) keeps enough loads in flight; each thread holds uint32
// partials whose wraparound is the mod-2^32 sum, with the weight taken
// from the GLOBAL word index. Warp shuffles, then shared memory, reduce a
// block to one pair, and two atomicAdds fold it into a zeroed uint32[2].
// Modular addition is associative and commutative, so the result is
// exact whatever order the blocks finish in; that replaces the TPU's
// sequential-grid accumulator.
//
// Alignment: views handed in by range reads and chunk slices need not be
// 16-byte aligned and lengths need not be multiples of 4. The vector loop
// runs only over a 16-byte aligned pointer; every word it does not cover
// (all of them for an unaligned pointer, else the few past the last full
// vector, including the zero-padded ragged tail) is assembled from byte
// loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add_word(uint32_t w, uint64_t i, uint32_t& s1, uint32_t& s2) {
  s1 += w;
  s2 += ((static_cast<uint32_t>(i) & 0xFFFFu) + 1u) * w;
}

__global__ void __launch_bounds__(kThreads)
checksum_kernel(const uint8_t* __restrict__ data, uint64_t nbytes, uint64_t nvec,
                uint32_t* __restrict__ out) {
  uint32_t s1 = 0, s2 = 0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  const uint64_t tid = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  // aligned body: nvec 16-byte vectors = words [0, 4 * nvec)
  const uint4* vec = reinterpret_cast<const uint4*>(data);
  for (uint64_t v = tid; v < nvec; v += stride) {
    const uint4 q = __ldg(vec + v);
    const uint64_t i = v * 4;
    add_word(q.x, i, s1, s2);
    add_word(q.y, i + 1, s1, s2);
    add_word(q.z, i + 2, s1, s2);
    add_word(q.w, i + 3, s1, s2);
  }

  // byte-assembled words [4 * nvec, ceil(nbytes / 4)), zero-padded
  const uint64_t nwords = (nbytes + 3) / 4;
  for (uint64_t i = 4 * nvec + tid; i < nwords; i += stride) {
    const uint64_t b = 4 * i;
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (b + k < nbytes) w |= static_cast<uint32_t>(data[b + k]) << (8 * k);
    }
    add_word(w, i, s1, s2);
  }

  // warp, then block reduction (uint32 wraparound is the modulus)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xFFFFFFFFu, s1, off);
    s2 += __shfl_down_sync(0xFFFFFFFFu, s2, off);
  }
  __shared__ uint32_t part1[kThreads / 32];
  __shared__ uint32_t part2[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part1[warp] = s1;
    part2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kThreads / 32 ? part1[lane] : 0u;
    s2 = lane < kThreads / 32 ? part2[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_down_sync(0xFFFFFFFFu, s1, off);
      s2 += __shfl_down_sync(0xFFFFFFFFu, s2, off);
    }
    if (lane == 0) {
      atomicAdd(out, s1);
      atomicAdd(out + 1, s2);
    }
  }
}

}  // namespace

// out must hold two zeroed uint32 words; num_blocks > 0. Returns
// cudaGetLastError() after the launch.
extern "C" int th_checksum(const void* data, uint64_t nbytes, void* out, int num_blocks,
                           void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  const uint64_t nvec = (reinterpret_cast<uintptr_t>(p) % 16 == 0) ? nbytes / 16 : 0;
  checksum_kernel<<<num_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, nbytes, nvec, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
