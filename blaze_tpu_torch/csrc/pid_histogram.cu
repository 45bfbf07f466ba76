// Rows per shuffle partition: the per-partition counts of a hash
// exchange's map output.
//
// Replaces the Pallas TPU kernel `pid_histogram`
// (blaze_tpu/kernels/pallas_ops.py, `_histogram_kernel`).
//
// Computes out[p] = #{i : pids[i] == p} for p in [0, n_parts); a pid
// outside that range (the -1 of padding rows) is not counted.  The
// counts are int32 and exact.  The TPU kernel's one-hot (p_pad, 128)
// accumulator and its padding of the pids to whole tiles are gone.
//
// Bound: bytes.  A row reads one 4-byte pid; the output is n_parts
// words.  At the exchanges' sizes (2^20 rows and fewer) the bytes take
// about a microsecond, so what costs is fixed: launches, the round
// trips of the loads, and the combine across blocks.  The earlier
// design (csrc/sweep/pid_histogram_pr3.cu) paid two launches a call
// (its caller zeroed `out`), flushed 8 bins from each of up to 528
// blocks with global atomics on the same 8 words, and kept one 4-byte
// load a thread in flight.  This one:
//
// - Is ONE launch with no memset on paths (a) and (b) below: `out` is
//   written with plain stores, not added to, so the wrapper allocates
//   it with torch.empty.
// - Reads the rows as 16-byte int4 loads, kLoads of them in flight a
//   thread; a view that does not start on 16 bytes takes its first
//   1-3 rows, and the 0-3 rows past the last whole int4, one a thread.
// - Specialises on n_parts:
//   (a) n_parts <= kRegisterBins (32; the exchanges' 8): each thread
//       keeps kBins (8, 16 or 32) counters in registers, updated by
//       compare-and-add over the unrolled bins; no atomic in the row
//       loop.  Warps reduce with __reduce_add_sync, the block through
//       shared memory.
//   (b) n_parts <= kSharedBins (57,344 bins: 229,376 bytes of the
//       232,448 bytes of dynamic shared memory a block of the H100 may
//       opt in to): bins in shared memory, shared atomics in the row
//       loop (aggregating a warp's equal pids with __match_any_sync
//       first measured slower at 200 bins).
//   (c) more bins: global atomics straight into `out`, which the
//       caller zeroes: the one path of two launches.  No TPC-H query
//       reaches it (their exchanges have 8 or 200 partitions).
// - Runs a persistent grid: at most SMs x resident blocks, no more than
//   the rows need, and no more than the wrapper's `max_blocks` (one
//   block an SM on path (b), where every block adds n_parts tickets).
//   One block writes `out` directly.
// - Combines across blocks without a memset, in one L2 round trip: the
//   wrapper owns, per device and stream, n_parts 64-bit tickets that
//   are 0 between launches (zeroed once when they are made).  Each
//   block adds to every bin's ticket its count (low 40 bits) plus one
//   arrival (high 24 bits) with one atomic; the block whose add is the
//   bin's last sees every other block's count in what the atomic
//   returns, stores out[p] and sets the ticket back to 0 for the next
//   launch on its stream.  Atomics on one word are ordered, so no fence
//   is needed.  Partials in scratch combined by the last block to
//   arrive or by a cooperative grid took two more round trips
//   (csrc/sweep/pid_histogram_rows.cu).
// kernels/sweep.py builds the switches below, both earlier designs,
// and times them; the shipped values are its choice (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 2;                 // int4 loads a thread has in flight
constexpr int kRegisterBins = 32;         // path (a) up to here
constexpr int kSharedBins = 56 * 1024;    // path (b) up to here

__device__ __forceinline__ bool in_range(int32_t p, int32_t n_parts) {
  return static_cast<uint32_t>(p) < static_cast<uint32_t>(n_parts);
}

// kBins > 0: path (a), that many register bins a thread; 0: path (b).
template <int kBins>
__global__ void __launch_bounds__(kThreads)
    pid_histogram_kernel(const int32_t* __restrict__ pids, int64_t n, int32_t n_parts,
                         int32_t* __restrict__ out, unsigned long long* __restrict__ tickets) {
  constexpr int kB = kBins > 0 ? kBins : 1;
  extern __shared__ int32_t bins[];     // path (b): n_parts bins
  __shared__ int32_t warp_bins[kBins > 0 ? kWarps : 1][kB];
  __shared__ int32_t block_bins[kB];    // path (a): the block's counts
  const int tid = threadIdx.x, lane = tid & 31;
  int32_t c[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) c[b] = 0;
  if constexpr (kBins == 0) {
    for (int p = tid; p < n_parts; p += kThreads) bins[p] = 0;
    __syncthreads();
  }
  auto count = [&](int32_t p) {
    if constexpr (kBins > 0) {
      const int32_t q = in_range(p, n_parts) ? p : kBins;  // kBins matches no bin
#pragma unroll
      for (int b = 0; b < kBins; ++b) c[b] += q == b;
    } else if (in_range(p, n_parts)) {
      atomicAdd(bins + p, 1);
    }
  };

  // rows [0, head) and [tail, n) one a thread in block 0, the rest as int4
  const int64_t lead = static_cast<int64_t>(((16 - (reinterpret_cast<uintptr_t>(pids) & 15)) & 15) >> 2);
  const int64_t head = lead < n ? lead : n;
  const int4* vec = reinterpret_cast<const int4*>(pids + head);
  const int64_t nvec = (n - head) >> 2;
  const int64_t tail = head + (nvec << 2);
  if (blockIdx.x == 0) {
    if (tid < head) count(pids[tid]);
    if (tid < n - tail) count(pids[tail + tid]);
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kLoads;
  for (int64_t v0 = static_cast<int64_t>(blockIdx.x) * kThreads * kLoads; v0 < nvec; v0 += step) {
    int4 x[kLoads];
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int64_t j = v0 + l * kThreads + tid;
      x[l] = j < nvec ? __ldg(vec + j) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      count(x[l].x);
      count(x[l].y);
      count(x[l].z);
      count(x[l].w);
    }
  }

  // the block's counts, in shared memory
  int32_t* mine = bins;
  if constexpr (kBins > 0) {
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      const int32_t s = __reduce_add_sync(0xFFFFFFFFu, c[b]);
      if (lane == 0) warp_bins[tid >> 5][b] = s;
    }
    __syncthreads();
    if (tid < kBins) {
      int32_t s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_bins[w][tid];
      block_bins[tid] = s;
    }
    mine = block_bins;
  }
  __syncthreads();
  if (gridDim.x == 1) {
    for (int p = tid; p < n_parts; p += kThreads) out[p] = mine[p];
    return;
  }

  // the tickets: count in the low 40 bits, arrivals in the high 24
  constexpr unsigned long long kArrival = 1ull << 40;
  const unsigned long long last_arrival = static_cast<unsigned long long>(gridDim.x - 1) << 40;
  for (int p = tid; p < n_parts; p += kThreads) {
    const unsigned long long prev = atomicAdd(tickets + p, kArrival + static_cast<unsigned>(mine[p]));
    if ((prev & ~(kArrival - 1)) == last_arrival) {
      out[p] = static_cast<int32_t>((prev & (kArrival - 1)) + static_cast<unsigned>(mine[p]));
      tickets[p] = 0;
    }
  }
}

// Path (c): bins past shared memory, added into the zeroed `out`.
__global__ void __launch_bounds__(kThreads)
    pid_histogram_kernel_global(const int32_t* __restrict__ pids, int64_t n, int32_t n_parts,
                                int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // warp-uniform loop, so the full-mask __match_any_sync is legal at the ragged end
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x - lane); base < n;
       base += stride) {
    const int64_t i = base + lane;
    const int32_t p = i < n ? __ldg(pids + i) : -1;
    const bool counted = in_range(p, n_parts);
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, counted ? p : -1);
    if (counted && lane == __ffs(peers) - 1) atomicAdd(out + p, __popc(peers));
  }
}

int resident_blocks(const void* kernel, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

template <int kBins>
int launch(const int32_t* pids, int64_t n, int32_t n_parts, int32_t* out, unsigned long long* tickets,
           int32_t max_blocks, cudaStream_t stream) {
  auto kernel = pid_histogram_kernel<kBins>;
  const size_t smem = kBins > 0 ? 0 : static_cast<size_t>(n_parts) * sizeof(int32_t);
  cudaError_t err;
  // above 48 KB a launch is refused unless the kernel opts in
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem))) !=
          cudaSuccess)
    return static_cast<int>(err);
  int resident = 0;
  if (const int e = resident_blocks(reinterpret_cast<const void*>(kernel), smem, &resident)) return e;
  const int64_t rows_per_block = static_cast<int64_t>(kThreads) * 4 * kLoads;
  int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > resident) blocks = resident;
  if (blocks > max_blocks) blocks = max_blocks;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(pids, n, n_parts, out, tickets);
  return static_cast<int>(cudaGetLastError());
}

int launch_global(const int32_t* pids, int64_t n, int32_t n_parts, int32_t* out, int32_t max_blocks,
                  cudaStream_t stream) {
  int resident = 0;
  if (const int e = resident_blocks(reinterpret_cast<const void*>(pid_histogram_kernel_global), 0, &resident))
    return e;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks > max_blocks) blocks = max_blocks;
  pid_histogram_kernel_global<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(pids, n, n_parts, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pids: n int32 (4-byte aligned; any 16-byte alignment); out: n_parts
// int32, written whole (zeroed by the caller only past kSharedBins).
// tickets: at least n_parts uint64 that are 0 between launches on
// `stream` (may be null when max_blocks is 1).  Launches on `stream`,
// returns cudaGetLastError() (0 on success).
extern "C" int blaze_pid_histogram(const void* pids, int64_t n, int32_t n_parts, void* out, void* tickets,
                                   int32_t max_blocks, void* stream) {
  if (n < 1 || n_parts < 1 || max_blocks < 1 || (reinterpret_cast<uintptr_t>(pids) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_blocks > 1 && n_parts <= kSharedBins && tickets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto* p = static_cast<const int32_t*>(pids);
  auto* o = static_cast<int32_t*>(out);
  auto* t = static_cast<unsigned long long*>(tickets);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_parts <= kRegisterBins) {
    if (n_parts <= 8) return launch<8>(p, n, n_parts, o, t, max_blocks, s);
    if (n_parts <= 16) return launch<16>(p, n, n_parts, o, t, max_blocks, s);
    return launch<32>(p, n, n_parts, o, t, max_blocks, s);
  }
  if (n_parts <= kSharedBins) return launch<0>(p, n, n_parts, o, t, max_blocks, s);
  return launch_global(p, n, n_parts, o, max_blocks, s);
}
