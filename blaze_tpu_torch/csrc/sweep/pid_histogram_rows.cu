// A design of pid_histogram.cu that kernels/sweep.py builds and times
// beside the shipped one, kept because it measured slower at the
// exchanges' 8 partitions (PERF.md, PR 4): each block stores its
// n_parts counts to its row of a `partials` scratch with plain stores,
// and the rows are combined without a zeroed output either
// (kCooperative == false) by the block that arrives last on a counter
// that is 0 between launches (one acquire-release atomic after the
// block's barrier; the last block reads every row with __ldcg, as
// 16-byte columns when n_parts is a multiple of 4, writes `out` and
// sets the counter back to 0), or (kCooperative) by every block after
// cg::this_grid().sync() of a cooperative launch, each block a slice of
// the bins.  With kCluster > 1 the blocks of a cluster first add their
// counts into rank 0's row through distributed shared memory.  The row
// loop and paths (a)-(c) are those of pid_histogram.cu.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 2;                 // int4 loads a thread has in flight
constexpr int kRegisterBins = 32;         // path (a) up to here
constexpr int kSharedBins = 56 * 1024;    // path (b) up to here
constexpr int kCluster = 1;               // blocks that pre-reduce through DSMEM
constexpr bool kCooperative = false;      // combine: grid sync, not last-block arrival
constexpr int kBatch = 16;                // loads in flight a thread in the combine

__device__ __forceinline__ bool in_range(int32_t p, int32_t n_parts) {
  return static_cast<uint32_t>(p) < static_cast<uint32_t>(n_parts);
}

// out[p0, p0 + q) = the sums over all rows of partials, by the whole
// block.  With V = 4 (n_parts, p0 and q multiples of 4) a thread reads
// four bins with one 16-byte load.  Each thread sums one column of V
// bins over every g-th row (g = the threads that share the column),
// kBatch / V loads in flight at a time, read from L2 (__ldcg: another
// launch's combine may have left a stale line of this scratch in L1);
// lanes of a column fold by shuffles when the columns divide 32, then
// through shared atomics on acc (q words of shared memory).
template <int V>
__device__ void combine(const int32_t* partials, unsigned rows, int32_t n_parts, int32_t p0, int32_t q,
                        int32_t* out, int32_t* acc) {
  constexpr int kRows = kBatch / V;
  const int tid = threadIdx.x, lane = tid & 31;
  const int cols = q / V;
  const int groups = cols >= kThreads ? 1 : kThreads / cols;
  auto sum_column = [&](int c, unsigned r0, int32_t (&s)[V]) {
    for (unsigned r = r0; r < rows; r += kRows * groups) {
      int32_t v[kRows][V];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const unsigned rk = r + k * groups;
        const int32_t* at = partials + static_cast<int64_t>(rk < rows ? rk : 0) * n_parts + p0 + c * V;
        if constexpr (V == 4) {
          const int4 x = rk < rows ? __ldcg(reinterpret_cast<const int4*>(at)) : make_int4(0, 0, 0, 0);
          v[k][0] = x.x; v[k][1] = x.y; v[k][2] = x.z; v[k][3] = x.w;
        } else {
          v[k][0] = rk < rows ? __ldcg(at) : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) s[j] += v[k][j];
    }
  };
  if (cols >= kThreads) {  // a thread per column
    for (int c = tid; c < cols; c += kThreads) {
      int32_t s[V] = {};
      sum_column(c, 0, s);
#pragma unroll
      for (int j = 0; j < V; ++j) out[p0 + c * V + j] = s[j];
    }
    return;
  }
  const bool active = tid < groups * cols;
  const int c = tid % cols;
  int32_t s[V] = {};
  if (active) sum_column(c, tid / cols, s);
  const bool pow2 = (cols & (cols - 1)) == 0;
  if (pow2) {
    for (int o = 16; o >= cols; o >>= 1)
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += __shfl_xor_sync(0xFFFFFFFFu, s[j], o);
  }
  for (int i = tid; i < q; i += kThreads) acc[i] = 0;
  __syncthreads();
  if (active && (!pow2 || lane < cols))
#pragma unroll
    for (int j = 0; j < V; ++j) atomicAdd(acc + c * V + j, s[j]);
  __syncthreads();
  for (int i = tid; i < q; i += kThreads) out[p0 + i] = acc[i];
}

// kBins > 0: path (a), that many register bins a thread; 0: path (b).
template <int kBins>
__global__ void __launch_bounds__(kThreads)
    pid_histogram_kernel(const int32_t* __restrict__ pids, int64_t n, int32_t n_parts,
                         int32_t* __restrict__ out, int32_t* __restrict__ partials,
                         unsigned* __restrict__ arrivals) {
  constexpr int kB = kBins > 0 ? kBins : 1;
  extern __shared__ int32_t bins[];     // path (b): n_parts bins
  __shared__ int32_t warp_bins[kBins > 0 ? kWarps : 1][kB];
  __shared__ int32_t block_bins[kB];    // path (a): the block's counts
  __shared__ bool last;
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

  // one row of partials per block, or per cluster
  unsigned rows = gridDim.x, row = blockIdx.x;
  bool writes = true;  // rank 0 of a cluster writes the cluster's row
  if constexpr (kCluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned size = cluster.num_blocks();
    if (size > 1) {
      cluster.sync();
      rows = gridDim.x / size;
      row = blockIdx.x / size;
      writes = cluster.block_rank() == 0;
      if (writes) {
        for (int p = tid; p < n_parts; p += kThreads) {
          int32_t s = 0;
          for (unsigned r = 0; r < size; ++r) s += cluster.map_shared_rank(mine, r)[p];
          partials[static_cast<int64_t>(row) * n_parts + p] = s;
        }
      }
      cluster.sync();  // rank 0 has read every block's shared memory
    }
  }
  if (kCluster == 1 || (writes && rows == gridDim.x)) {
    for (int p = tid; p < n_parts; p += kThreads) partials[static_cast<int64_t>(row) * n_parts + p] = mine[p];
  }

  if constexpr (kCooperative) {
    // every block combines its own slice of the bins
    cg::this_grid().sync();
    const bool vec = (n_parts & 3) == 0;
    int32_t q = static_cast<int32_t>((n_parts + gridDim.x - 1) / gridDim.x);
    if (vec) q = (q + 3) & ~3;
    const int32_t p0 = static_cast<int32_t>(blockIdx.x) * q;
    if (p0 >= n_parts) return;
    if (q > n_parts - p0) q = n_parts - p0;
    if (vec) combine<4>(partials, rows, n_parts, p0, q, out, mine);
    else combine<1>(partials, rows, n_parts, p0, q, out, mine);
  } else {
    if (!writes) return;
    __syncthreads();  // the block's row is stored before thread 0 arrives
    if (tid == 0) {
      // release: the row, ordered before by the barrier, is visible to
      // whoever sees this arrival; acquire: the last block sees every row
      unsigned prev;
      asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(prev) : "l"(arrivals) : "memory");
      last = prev == rows - 1;
    }
    __syncthreads();
    if (!last) return;
    if (tid == 0) *arrivals = 0;  // ready for the next launch on this stream
    if ((n_parts & 3) == 0) combine<4>(partials, rows, n_parts, 0, n_parts, out, mine);
    else combine<1>(partials, rows, n_parts, 0, n_parts, out, mine);
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
int launch(const int32_t* pids, int64_t n, int32_t n_parts, int32_t* out, int32_t* partials,
           int32_t max_blocks, unsigned* arrivals, cudaStream_t stream) {
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

  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  if (kCluster > 1 && blocks >= kCluster) {
    blocks -= blocks % kCluster;
    attrs[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
    attrs[cfg.numAttrs].val.clusterDim.x = kCluster;
    attrs[cfg.numAttrs].val.clusterDim.y = 1;
    attrs[cfg.numAttrs].val.clusterDim.z = 1;
    ++cfg.numAttrs;
  }
  if (kCooperative && blocks > 1) {
    attrs[cfg.numAttrs].id = cudaLaunchAttributeCooperative;
    attrs[cfg.numAttrs].val.cooperative = 1;
    ++cfg.numAttrs;
    if (cfg.numAttrs == 2) {  // co-resident clusters, not blocks, cap a clustered grid
      cfg.gridDim = dim3(static_cast<unsigned>(blocks));
      int clusters = 0;
      if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess)
        return static_cast<int>(err);
      if (blocks > static_cast<int64_t>(clusters) * kCluster) blocks = static_cast<int64_t>(clusters) * kCluster;
    }
  }
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  if ((err = cudaLaunchKernelEx(&cfg, kernel, pids, n, n_parts, out, partials, arrivals)) != cudaSuccess)
    return static_cast<int>(err);
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
// partials: at least max_blocks x n_parts int32 of scratch, and
// arrivals: one uint32 that is 0 between launches on `stream`; both
// may be null when max_blocks is 1 (and arrivals when kCooperative).
// Launches on `stream`, returns cudaGetLastError() (0 on success).
extern "C" int blaze_pid_histogram_rows(const void* pids, int64_t n, int32_t n_parts, void* out, void* partials,
                                   int32_t max_blocks, void* arrivals, void* stream) {
  if (n < 1 || n_parts < 1 || max_blocks < 1 || (reinterpret_cast<uintptr_t>(pids) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool combine = max_blocks > 1 && n_parts <= kSharedBins;
  if (combine && (partials == nullptr || (!kCooperative && arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* p = static_cast<const int32_t*>(pids);
  auto* o = static_cast<int32_t*>(out);
  auto* part = static_cast<int32_t*>(partials);
  auto* arr = static_cast<unsigned*>(arrivals);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_parts <= kRegisterBins) {
    if (n_parts <= 8) return launch<8>(p, n, n_parts, o, part, max_blocks, arr, s);
    if (n_parts <= 16) return launch<16>(p, n, n_parts, o, part, max_blocks, arr, s);
    return launch<32>(p, n, n_parts, o, part, max_blocks, arr, s);
  }
  if (n_parts <= kSharedBins) return launch<0>(p, n, n_parts, o, part, max_blocks, arr, s);
  return launch_global(p, n, n_parts, o, max_blocks, s);
}
