// Staged reshard repack (a run-driven byte gather) for Hopper.
//
// Replaces the Pallas TPU kernel gather_bytes
// (src/repro/kernels/repack/kernel.py, _repack_kernel). A resharded pull
// lands its interval reads, in plan order, in one contiguous staging
// buffer per destination transfer unit; the repack moves each
// (staging_offset, unit_offset, nbytes) run to its place in the unit
// payload. Output bytes no run covers must read 0 (the wrapper zero-fills
// the output first only when the runs do not tile it).
//
// Bound: bytes. Every byte is read once and written once (2 N bytes over
// the HBM rate) with no arithmetic. The TPU kernel built a per-byte int32
// index map on the host (4 bytes of index per byte moved) and held the
// whole staging buffer in VMEM. Here the kernel reads the run triples
// themselves (an int64 [R, 3] device table, R ~ 20 per tensor), so the
// only traffic is the payload. Design: blockIdx.y picks a run and the
// blocks along x stride over that run's bytes. Where the source and
// destination addresses agree modulo 16 the body moves as 16-byte vectors
// (modulo 8, 4 or 2: the widest word they agree on; bf16 intervals can sit
// on 2-byte alignment), with byte moves for the ragged head and tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__device__ __forceinline__ void copy_words(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                                           uint64_t nwords, uint64_t tid, uint64_t nthreads) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  for (uint64_t i = tid; i < nwords; i += nthreads) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
gather_runs_kernel(const uint8_t* __restrict__ staging, uint8_t* __restrict__ out,
                   const int64_t* __restrict__ runs, int num_runs) {
  const uint64_t tid = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint64_t nthreads = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (int r = blockIdx.y; r < num_runs; r += gridDim.y) {
    const uint8_t* src = staging + runs[3 * r];
    uint8_t* dst = out + runs[3 * r + 1];
    const uint64_t n = static_cast<uint64_t>(runs[3 * r + 2]);
    const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
    const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
    int w = 16;  // the widest word both sides agree on (uniform over the block)
    while (w > 1 && (sa % w) != (da % w)) w >>= 1;
    uint64_t head = (w - da % w) % w;
    if (head > n) head = n;
    const uint64_t nwords = (n - head) / w;
    for (uint64_t i = tid; i < head; i += nthreads) dst[i] = src[i];
    switch (w) {
      case 16: copy_words<uint4>(src + head, dst + head, nwords, tid, nthreads); break;
      case 8: copy_words<uint2>(src + head, dst + head, nwords, tid, nthreads); break;
      case 4: copy_words<uint32_t>(src + head, dst + head, nwords, tid, nthreads); break;
      case 2: copy_words<uint16_t>(src + head, dst + head, nwords, tid, nthreads); break;
      default: copy_words<uint8_t>(src + head, dst + head, nwords, tid, nthreads); break;
    }
    for (uint64_t i = head + nwords * w + tid; i < n; i += nthreads) dst[i] = src[i];
  }
}

}  // namespace

// runs: device int64 [num_runs, 3] of (staging_offset, out_offset, nbytes),
// each inside its buffer (the wrapper checks). blocks_x blocks stride over
// each run, blocks_y (<= 65535) runs are taken at once. Returns
// cudaGetLastError() after the launch.
extern "C" int th_gather_bytes(const void* staging, void* out, const void* runs, int num_runs,
                               int blocks_x, int blocks_y, void* stream) {
  if (num_runs <= 0 || blocks_x <= 0 || blocks_y <= 0 || blocks_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
  gather_runs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(staging), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(runs), num_runs);
  return static_cast<int>(cudaGetLastError());
}
