// Candidate ranges of hash-join probe keys in the sorted build-key table.
//
// Replaces the Pallas TPU kernel `sorted_lookup`
// (blaze_tpu/kernels/pallas_ops.py, `_sorted_lookup_kernel`).
//
// Computes, per probe key q: lo = #{t < q} and hi = #{t <= q} over the
// build table sorted in UNSIGNED 64-bit order (the all-ones sentinel
// of null and padding rows sorts last).  The table may be of any
// length (the TPU kernel's 8192-row bound is gone): the TPU kernel
// counts all N x T pairs only because the TPU has no cheap per-lane
// search.
//
// Bound: bytes.  A probe reads its 8-byte key and writes two 4-byte
// bounds; the table (30 000 keys are 240 KB) is read once in the ideal
// case.  What the first design lost: one thread ran two binary
// searches per probe in global memory, about 2 x 15 DEPENDENT loads,
// so the kernel waited on chained L2 latency at a tenth of its bound.
//
// This design takes the chain out of global memory:
// - Each block stages a sample of the table in shared memory, every
//   S-th key, S the least power of two whose sample fits the wrapper's
//   budget (cuda_ops.sorted_lookup_geometry: 64 KB, so S = 4 for
//   q03's tables), each thread's loads of it issued together; beside
//   it, a radix directory over the sample keys' top bits.  The grid is
//   persistent, one block per SM, so each SM stages the sample once
//   per launch; __syncthreads() orders the staging and the directory
//   before any search.
// - A probe's directory bucket holds a key or two of hash keys, so its
//   lower bound in the sample takes one or two shared-memory steps
//   instead of a dozen, and names the segment of S keys that holds its
//   lower bound.  A segment of kSeg keys is ONE round trip of two
//   16-byte loads (8-byte loads when the table is not 16-byte aligned,
//   as a view of a slice may be), and lo and hi are counted in
//   registers.  With S == 1 the sample is the table and nothing is
//   read from global memory.  Past the budget S grows, and a few
//   global binary steps narrow the segment to kSeg keys first.
// - hi comes from the same segment unless a run of keys equal to q
//   reaches its end; then an upper-bound search of the sample and one
//   more segment finish it, however long the run (a table of one key,
//   or of sentinels, is legal input: its directory puts every key in
//   one bucket, searched by halving).
// - Each thread carries kProbes probes through every phase together,
//   so their shared-memory steps and global loads overlap.
// What bounds it now is the fixed cost of staging (every block reads
// its own sample, a 32-byte sector for each 8-byte key at S = 4) and
// the segments' traffic from L2; PERF.md has the sweep over S and
// block shapes (kernels/sweep.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 1024;
constexpr int kProbes = 2;        // probes a thread carries at once
constexpr int kSeg = 4;           // keys of one segment: two 16-byte loads
constexpr int kStageLoads = 8;    // sample keys a thread loads in one round trip
constexpr int kMaxDirBits = 13;   // directory of 2^13 + 1 uint16 entries, 16 KB
constexpr int kMaxSmemBytes = 227 * 1024;

// The staged sample: m sorted keys, and a directory over their top
// `bits` bits: dir[b] = #{keys whose top bits are < b}, b in [0, 2^bits].
// Keys in [dir[b], dir[b + 1]) share the top bits b, so a bound of q
// searches only its own bucket: a key or two for hash keys, all of
// the sample at worst (a table of one key, or of sentinels).
struct Sample {
  const u64* key;
  const uint16_t* dir;
  int m;
  int bits;

  // #{key < q} (kStrict) or #{key <= q}; m >= 1
  template <bool kStrict>
  __device__ __forceinline__ int bound(u64 q) const {
    const int b = static_cast<int>(static_cast<uint32_t>(q >> 32) >> (32 - bits));
    int lo = dir[b], hi = dir[b + 1];
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const u64 v = key[mid];
      if (kStrict ? v < q : v <= q) lo = mid + 1; else hi = mid;
    }
    return lo;
  }
};

// directory bits for m sample keys: about one key per bucket
__host__ __device__ __forceinline__ int dir_bits(int64_t m) {
  int bits = 1;
  while (bits < kMaxDirBits && (int64_t{1} << bits) < m) ++bits;
  return bits;
}

// Narrows [beg, end) around a bound of q.  On entry and exit every
// key before beg is below the bound (< q, or <= q for !kStrict) and
// every key at or after end is not.  Stops once the window, its start
// rounded down to an even index on the 16-byte path, is kSeg keys.
// Table indices fit int: the host takes t < 2^31.
template <bool kStrict, bool kVec>
__device__ __forceinline__ void narrow(const u64* __restrict__ table, int& beg, int& end, u64 q) {
  while (end - (kVec ? (beg & ~1) : beg) > kSeg) {
    const int m = beg + ((end - beg) >> 1);
    const u64 v = __ldg(table + m);
    if (kStrict ? v < q : v <= q) beg = m + 1; else end = m;
  }
  if (kVec) beg &= ~1;
}

// Reads the keys of [beg, end) (end - beg <= kSeg, beg even on the
// 16-byte path), never past end; the rest are all-ones, which no key
// is below.  A whole segment is two 16-byte loads.
template <bool kVec>
__device__ __forceinline__ void load_segment(const u64* __restrict__ table, int beg, int end,
                                             u64 (&k)[kSeg]) {
  if (kVec && end - beg == kSeg) {
    const ulonglong2 v0 = __ldg(reinterpret_cast<const ulonglong2*>(table + beg));
    const ulonglong2 v1 = __ldg(reinterpret_cast<const ulonglong2*>(table + beg) + 1);
    k[0] = v0.x; k[1] = v0.y; k[2] = v1.x; k[3] = v1.y;
    return;
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) k[j] = beg + j < end ? __ldg(table + beg + j) : ~0ull;
}

// (#{k < q}, #{k <= q}) among the w real keys of a loaded segment
__device__ __forceinline__ void count_segment(const u64 (&k)[kSeg], int w, u64 q, int& lt, int& le) {
  lt = le = 0;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    lt += k[j] < q;
    le += k[j] <= q;
  }
  if (q == ~0ull) le -= kSeg - w;  // the all-ones padding is <= only the sentinel
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    sorted_lookup_kernel(const u64* __restrict__ table, int t, int log2_stride,
                         const u64* __restrict__ probe, int64_t n, int32_t* __restrict__ lo_out,
                         int32_t* __restrict__ hi_out) {
  extern __shared__ u64 smem[];
  const int m = static_cast<int>((int64_t{t} + (int64_t{1} << log2_stride) - 1) >> log2_stride);
  const Sample sample{smem, reinterpret_cast<const uint16_t*>(smem + m), m, dir_bits(m)};
  // every thread issues all its loads of a round before it stores any
  for (int i0 = 0; i0 < m; i0 += kStageLoads * kThreads) {
    u64 v[kStageLoads];
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int i = i0 + j * kThreads + threadIdx.x;
      v[j] = i < m ? __ldg(table + (int64_t{i} << log2_stride)) : 0ull;
    }
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int i = i0 + j * kThreads + threadIdx.x;
      if (i < m) smem[i] = v[j];
    }
  }
  __syncthreads();
  if (m > 0) {
    // key i (and past the end, i = m with top bits 2^bits) fills the
    // buckets after the previous key's, up to its own
    auto* dir = reinterpret_cast<uint16_t*>(smem + m);
    const int shift = 64 - sample.bits;
    for (int i = threadIdx.x; i <= m; i += kThreads) {
      const int top = i < m ? static_cast<int>(smem[i] >> shift) : 1 << sample.bits;
      const int prev = i > 0 ? static_cast<int>(smem[i - 1] >> shift) : -1;
      for (int b = prev + 1; b <= top; ++b) dir[b] = static_cast<uint16_t>(i);
    }
  }
  __syncthreads();

  // segment bounds in unsigned: a << log2_stride may pass 2^31 - 1
  const auto seg_start = [&](int a) { return static_cast<unsigned>(a) << log2_stride; };
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; first < n;
       first += kProbes * threads) {
    u64 q[kProbes];
    int a[kProbes];
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const int64_t i = first + p * threads;
      q[p] = i < n ? __ldg(probe + i) : 0ull;
    }
    if (m == 0) {
#pragma unroll
      for (int p = 0; p < kProbes; ++p) {
        const int64_t i = first + p * threads;
        if (i < n) lo_out[i] = hi_out[i] = 0;
      }
      continue;
    }
#pragma unroll
    for (int p = 0; p < kProbes; ++p) a[p] = sample.bound<true>(q[p]);

    if (log2_stride == 0) {  // the sample is the table
#pragma unroll
      for (int p = 0; p < kProbes; ++p) {
        const int64_t i = first + p * threads;
        if (i >= n) continue;
        const bool run = a[p] < m && smem[a[p]] == q[p];
        lo_out[i] = a[p];
        hi_out[i] = run ? sample.bound<false>(q[p]) : a[p];
      }
      continue;
    }

    // the segment that holds each lower bound: keys before beg are
    // < q (sample[a - 1] is), keys from end on are >= q (sample[a] is)
    int beg[kProbes], end[kProbes];
    u64 k[kProbes][kSeg];
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      beg[p] = a[p] > 0 ? static_cast<int>(seg_start(a[p] - 1)) : 0;
      end[p] = a[p] > 0 ? static_cast<int>(min(seg_start(a[p]), static_cast<unsigned>(t))) : 0;
      narrow<true, kVec>(table, beg[p], end[p], q[p]);
      load_segment<kVec>(table, beg[p], end[p], k[p]);
    }
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const int64_t i = first + p * threads;
      if (i >= n) continue;
      const int w = end[p] - beg[p];
      int lt, le;
      count_segment(k[p], w, q[p], lt, le);
      lo_out[i] = beg[p] + lt;
      if (le < w) {  // a key above q inside the segment
        hi_out[i] = beg[p] + le;
        continue;
      }
      // every key of the segment is <= q; keys from end on are >= q:
      // the run of q goes on past end only if the next key is q
      const int e = end[p];
      const bool at_sample = static_cast<unsigned>(e) == seg_start(a[p]) && a[p] < m;
      const bool run = e < t && (at_sample ? smem[a[p]] : __ldg(table + e)) == q[p];
      if (!run) {
        hi_out[i] = e;
        continue;
      }
      // keys before the segment of b - 1 are <= sample[b - 1] <= q;
      // keys from b * S on are > q
      const int b = sample.bound<false>(q[p]);
      int hb = max(e, static_cast<int>(seg_start(b - 1)));
      int he = static_cast<int>(min(seg_start(b), static_cast<unsigned>(t)));
      narrow<false, kVec>(table, hb, he, q[p]);
      u64 k2[kSeg];
      load_segment<kVec>(table, hb, he, k2);
      count_segment(k2, he - hb, q[p], lt, le);
      hi_out[i] = hb + le;
    }
  }
}

}  // namespace

// table: t sorted uint64 keys; probe: n uint64 keys; lo/hi: n int32
// outputs.  log2_stride: the sample takes every 2^log2_stride-th key
// (cuda_ops.sorted_lookup_geometry), ceil(t / 2^log2_stride) keys of
// shared memory per block, beside its directory.  Launches on
// `stream`, returns cudaGetLastError().
extern "C" int blaze_sorted_lookup(const void* table, int64_t t, int32_t log2_stride,
                                   const void* probe, int64_t n, void* lo, void* hi,
                                   void* stream) {
  if (n < 1 || t < 0 || t >= (int64_t{1} << 31) || log2_stride < 0 || log2_stride > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t m = (t + (int64_t{1} << log2_stride) - 1) >> log2_stride;
  const int64_t smem = m * static_cast<int64_t>(sizeof(u64)) +
                       (m > 0 ? ((int64_t{1} << dir_bits(m)) + 1) * static_cast<int64_t>(sizeof(uint16_t)) : 0);
  if (smem > kMaxSmemBytes || m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const void* kernel = vec ? reinterpret_cast<const void*>(&sorted_lookup_kernel<true>)
                           : reinterpret_cast<const void*>(&sorted_lookup_kernel<false>);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  // one block per SM, fewer when the probes would leave threads idle
  const int64_t blocks_needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks_needed < sms ? blocks_needed : sms);
  auto* tb = static_cast<const u64*>(table);
  auto* pb = static_cast<const u64*>(probe);
  auto* lo32 = static_cast<int32_t*>(lo);
  auto* hi32 = static_cast<int32_t*>(hi);
  auto s = static_cast<cudaStream_t>(stream);
  const int t32 = static_cast<int>(t);
  if (vec)
    sorted_lookup_kernel<true><<<blocks, kThreads, smem, s>>>(tb, t32, log2_stride, pb, n, lo32, hi32);
  else
    sorted_lookup_kernel<false><<<blocks, kThreads, smem, s>>>(tb, t32, log2_stride, pb, n, lo32, hi32);
  return static_cast<int>(cudaGetLastError());
}
