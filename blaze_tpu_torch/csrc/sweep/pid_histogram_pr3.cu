// The earlier design of pid_histogram.cu, kept unchanged as a baseline for
// kernels/sweep.py and chip_smoke.py, which time it beside the shipped
// kernel.  Its caller zeroes `out` first (two launches per call).  It is
// not part of the kernel library (kernels/build.py SOURCES).
//
// Rows per shuffle partition: the per-partition counts of a hash
// exchange's map output.
//
// Replaces the Pallas TPU kernel `pid_histogram`
// (blaze_tpu/kernels/pallas_ops.py, `_histogram_kernel`).
//
// Computes out[p] = #{i : pids[i] == p} for p in [0, n_parts); a pid
// outside that range (the -1 of padding rows) is not counted.  The
// counts are int32 and exact.
//
// Bound: bytes.  A row reads one 4-byte pid; the output is n_parts
// words.  Design: a grid-stride loop in which every warp walks 32
// neighbouring rows at a time (coalesced loads).  Lanes holding the
// same pid find each other with __match_any_sync and their lowest
// lane adds the group's size, so a warp issues one atomic per distinct
// pid instead of 32 to a handful of addresses.  The counts go into a
// histogram privatized in shared memory, which each block flushes with
// one global atomic per nonzero bin.  When n_parts bins do not fit in
// shared memory, the same kernel adds straight into the global counts.
// The TPU kernel's one-hot (p_pad, 128) accumulator and its padding of
// the pids to whole tiles are gone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// the most bins privatized in shared memory: 48 KB, the dynamic shared
// memory a block gets without opting in
constexpr int kSharedBins = 48 * 1024 / 4;

__global__ void pid_histogram_kernel(const int32_t* __restrict__ pids, int64_t n,
                                     int32_t n_parts, bool privatized,
                                     int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  int32_t* acc = privatized ? bins : out;
  if (privatized) {
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x) bins[p] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // warp-uniform loop: every lane of a warp runs the same iterations,
  // so the full-mask __match_any_sync is legal at the ragged end
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x + (threadIdx.x - lane);
       base < n; base += stride) {
    const int64_t i = base + lane;
    const int32_t p = i < n ? __ldg(pids + i) : -1;
    const bool counted = p >= 0 && p < n_parts;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, counted ? p : -1);
    if (counted && lane == __ffs(peers) - 1) atomicAdd(acc + p, __popc(peers));
  }
  if (privatized) {
    __syncthreads();
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
      const int32_t c = bins[p];
      if (c) atomicAdd(out + p, c);
    }
  }
}

}  // namespace

// pids: n int32; out: n_parts int32 counts, zeroed by the caller.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int blaze_pid_histogram_pr3(const void* pids, int64_t n, int32_t n_parts, void* out,
                                   void* stream) {
  if (n < 1 || n_parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool privatized = n_parts <= kSharedBins;
  const int64_t blocks_needed = (n + kThreads - 1) / kThreads;
  // about four resident blocks per SM; each block flushes its bins once
  const int blocks = static_cast<int>(blocks_needed < 132 * 4 ? blocks_needed : 132 * 4);
  const size_t shared = privatized ? static_cast<size_t>(n_parts) * sizeof(int32_t) : 0;
  pid_histogram_kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pids), n, n_parts, privatized, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
