// Small-cardinality grouped float32 sums with the filter folded into
// the group ids: the TPC-H q01 shape.
//
// Replaces the Pallas TPU kernel `fused_group_sums`
// (blaze_tpu/kernels/pallas_ops.py, `_group_sums_kernel`).
//
// Computes out[k][g] = sum of values[k][i] over the rows i with
// gids[i] == g, for K float32 value columns and g in [0, G).  A gid
// outside [0, G) (the -1 of filtered-out and padding rows) contributes
// nothing.
//
// Bound: bytes.  A row reads a 4-byte gid and K 4-byte values; the
// output is K x G floats.  Design: one thread per row over a
// grid-stride loop, neighbouring threads on neighbouring rows, so
// every column read is coalesced and each byte is read once.  Float
// atomics make the summation order vary from run to run, so the design
// keeps the number of values that meet in one float32 accumulator
// small:
//
// - K <= 8 and G <= 8 (q01: K = 4, G = 6): each thread keeps all K x G
//   partials in registers, adding a value where its gid matches, as the
//   TPU kernel adds one-hot x value over its lanes.  At the end of the
//   loop the block reduces every partial over its warps by shuffles,
//   then across warps in shared memory, and adds it to the output with
//   one global atomic.
// - larger K x G that fit in shared memory: the K x G partials are
//   privatized in shared memory (shared float atomics), each block then
//   flushing one global atomic per partial.
// - K x G past shared memory: the same kernel adds straight into the
//   output in global memory.
//
// A launch takes at most kMaxValues columns, whose pointers travel by
// value in the kernel's parameters; the wrapper launches once per
// group of columns, each into its own rows of the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxValues = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegGroups = 8;  // the most groups the register path takes
// the most partials privatized in shared memory: 48 KB, the dynamic
// shared memory a block gets without opting in
constexpr int kSharedPartials = 48 * 1024 / 4;

struct ValueColumns {
  const float* data[kMaxValues];
};

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
group_sums_registers(const int32_t* __restrict__ gids, ValueColumns vals, int k, int g_count,
                     int64_t n, float* __restrict__ out) {
  float acc[KMAX][kRegGroups];
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk)
#pragma unroll
    for (int g = 0; g < kRegGroups; ++g) acc[kk][g] = 0.f;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t gid = __ldg(gids + i);
    float v[KMAX];
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) v[kk] = kk < k ? __ldg(vals.data[kk] + i) : 0.f;
#pragma unroll
    for (int g = 0; g < kRegGroups; ++g) {
      const bool hit = gid == g && g < g_count;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) acc[kk][g] += hit ? v[kk] : 0.f;
    }
  }

  __shared__ float partial[kWarps][KMAX * kRegGroups];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk)
#pragma unroll
    for (int g = 0; g < kRegGroups; ++g) {
      float s = acc[kk][g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, off);
      if (lane == 0) partial[warp][kk * kRegGroups + g] = s;
    }
  __syncthreads();
  for (int j = threadIdx.x; j < k * kRegGroups; j += blockDim.x) {
    const int g = j % kRegGroups;
    if (g >= g_count) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w][j];
    atomicAdd(out + (j / kRegGroups) * g_count + g, s);
  }
}

__global__ void __launch_bounds__(kThreads)
group_sums_atomic(const int32_t* __restrict__ gids, ValueColumns vals, int k, int g_count,
                  int64_t n, bool privatized, float* __restrict__ out) {
  extern __shared__ float sums[];
  const int kg = k * g_count;
  float* acc = privatized ? sums : out;
  if (privatized) {
    for (int j = threadIdx.x; j < kg; j += blockDim.x) sums[j] = 0.f;
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t gid = __ldg(gids + i);
    if (gid < 0 || gid >= g_count) continue;
    for (int kk = 0; kk < k; ++kk) atomicAdd(acc + kk * g_count + gid, __ldg(vals.data[kk] + i));
  }
  if (privatized) {
    __syncthreads();
    for (int j = threadIdx.x; j < kg; j += blockDim.x) {
      const float s = sums[j];
      if (s != 0.f) atomicAdd(out + j, s);
    }
  }
}

}  // namespace

// gids: n int32; values: k (<= kMaxValues) pointers to n float32 each;
// out: k x g_count float32, zeroed by the caller.  Launches on
// `stream`, returns cudaGetLastError().
extern "C" int blaze_fused_group_sums(const void* gids, const void* const* values, int32_t k,
                                      int32_t g_count, int64_t n, void* out, void* stream) {
  if (n < 1 || k < 1 || k > kMaxValues || g_count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ValueColumns vals{};
  for (int kk = 0; kk < k; ++kk) vals.data[kk] = static_cast<const float*>(values[kk]);
  const int64_t blocks_needed = (n + kThreads - 1) / kThreads;
  // about four resident blocks per SM; each block flushes its partials once
  const int blocks = static_cast<int>(blocks_needed < 132 * 4 ? blocks_needed : 132 * 4);
  auto s = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<const int32_t*>(gids);
  auto o = static_cast<float*>(out);
  if (g_count <= kRegGroups) {
    if (k <= 4)
      group_sums_registers<4><<<blocks, kThreads, 0, s>>>(g, vals, k, g_count, n, o);
    else
      group_sums_registers<8><<<blocks, kThreads, 0, s>>>(g, vals, k, g_count, n, o);
  } else {
    const bool privatized = static_cast<int64_t>(k) * g_count <= kSharedPartials;
    const size_t shared = privatized ? static_cast<size_t>(k) * g_count * sizeof(float) : 0;
    group_sums_atomic<<<blocks, kThreads, shared, s>>>(g, vals, k, g_count, n, privatized, o);
  }
  return static_cast<int>(cudaGetLastError());
}
