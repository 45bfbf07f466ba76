// Candidate ranges of hash-join probe keys in the sorted build-key table.
//
// Replaces the Pallas TPU kernel `sorted_lookup`
// (blaze_tpu/kernels/pallas_ops.py, `_sorted_lookup_kernel`).
//
// Computes, per probe key q: lo = #{t < q} and hi = #{t <= q} over the
// build table sorted in UNSIGNED 64-bit order (the all-ones sentinel
// of null and padding rows sorts last).  Both are binary searches, so
// the kernel takes a table of any length and gives the TPU kernel's
// answer; the TPU kernel counts all N x T pairs only because the TPU
// has no cheap per-lane search.
//
// Bound: bytes.  A probe reads its 8-byte key and writes two 4-byte
// bounds; the table is read once in the ideal case (it is small and
// stays in L2: 30 000 keys are 240 KB).  Design: one thread per probe,
// a lower-bound search then an upper-bound search that starts from the
// lower bound, comparing as uint64, over the table in global memory
// through the read-only cache.  Staging the table in shared memory is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void sorted_lookup_kernel(const unsigned long long* __restrict__ table, int64_t t,
                                     const unsigned long long* __restrict__ probe, int64_t n,
                                     int32_t* __restrict__ lo_out,
                                     int32_t* __restrict__ hi_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long q = __ldg(probe + i);
    int64_t a = 0, b = t;
    while (a < b) {  // first index with table[m] >= q
      const int64_t m = (a + b) >> 1;
      if (__ldg(table + m) < q) a = m + 1; else b = m;
    }
    const int64_t lo = a;
    b = t;
    while (a < b) {  // first index with table[m] > q
      const int64_t m = (a + b) >> 1;
      if (__ldg(table + m) <= q) a = m + 1; else b = m;
    }
    lo_out[i] = static_cast<int32_t>(lo);
    hi_out[i] = static_cast<int32_t>(a);
  }
}

}  // namespace

// table: t sorted uint64 keys; probe: n uint64 keys; lo/hi: n int32
// outputs.  Launches on `stream`, returns cudaGetLastError().
extern "C" int blaze_sorted_lookup(const void* table, int64_t t, const void* probe, int64_t n,
                                   void* lo, void* hi, void* stream) {
  if (n < 1 || t < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const int64_t blocks_needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks_needed < 132 * 64 ? blocks_needed : 132 * 64);
  sorted_lookup_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(table), t,
      static_cast<const unsigned long long*>(probe), n, static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi));
  return static_cast<int>(cudaGetLastError());
}
