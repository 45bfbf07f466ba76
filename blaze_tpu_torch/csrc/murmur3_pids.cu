// Spark murmur3 (seed 42) partition ids over fixed-width key columns.
//
// Replaces the Pallas TPU kernel `murmur3_pids`
// (blaze_tpu/kernels/pallas_ops.py, `_murmur3_pids_kernel`).
//
// Computes, per row: h = 42; for each key column c, in order, mix the
// column's value into h as Spark's Murmur3_x86_32 does (a 4-byte
// value: one word then fmix(.., 4); an 8-byte value: low word, high
// word, then fmix(.., 8)); a null key leaves h as it was.  The
// partition id is pmod(int32(h), n_parts).
//
// Bound: bytes.  A row reads 4 or 8 bytes per key column and 1 byte
// of validity per key column, and writes a 4-byte pid; the mixing is
// about 15 integer operations per 32-bit word, far below the ALU rate
// for that traffic.  What the first design lost: a fixed grid of up
// to 8448 blocks (four waves of blocks at N = 2^20), and a column loop
// behind a runtime bound (`break` on k) and a runtime width branch, so
// a row's loads issued column by column.
//
// This design:
// - The grid is persistent, sized to the card (SMs x resident blocks
//   of this specialisation), so no launch runs more than one wave of
//   blocks; each thread walks the rows a grid apart.
// - The kernel is specialised on the column count K (1..kMaxKeys), so
//   the column loop unrolls on compile-time indices, and every load of
//   a step (each column's value and validity, the running hash) is
//   issued before any mixing.
// - A thread takes kRows rows a step, neighbouring threads neighbouring
//   rows, so each warp's load of a column is whole 128-byte lines
//   whatever the view's alignment: a column view of a slice may start
//   at any element and needs no other path.  Four rows a thread, and
//   four consecutive rows with 16-byte loads (which need every pointer
//   aligned), measured no faster at N = 2^20 and slower at the few
//   thousand rows of q03's aggregate exchange, and a ring of 1-D bulk
//   copies into shared memory slower at both (PERF.md, the sweep in
//   kernels/sweep.py): the time left is the launch's ramp and the
//   DRAM traffic itself.
//
// A launch takes at most kMaxKeys columns, whose table travels by
// value in the kernel's parameters.  Longer key lists are chained: a
// launch with n_parts == 0 writes the running hash instead of the pid,
// and the next launch starts from it (h_in) instead of the seed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxKeys = 8;
constexpr int kThreads = 256;
constexpr int kRows = 1;  // rows a thread carries a step, a grid apart

struct KeyColumns {
  const void* data[kMaxKeys];     // int32 (width 1) or int64 (width 2)
  const uint8_t* valid[kMaxKeys];  // torch.bool: 1 = valid
  int32_t width[kMaxKeys];
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  h1 ^= h1 >> 16;
  return h1;
}

// h mixed with one value of `width` (1: the word lo; 2: lo then hi)
__device__ __forceinline__ uint32_t mix_value(uint32_t h, int32_t width, uint32_t lo, uint32_t hi) {
  if (width == 1) return fmix(mix_h1(h, mix_k1(lo)), 4u);
  return fmix(mix_h1(mix_h1(h, mix_k1(lo)), mix_k1(hi)), 8u);
}

// the output word: the pid, or the running hash for a next launch
__device__ __forceinline__ int32_t finish(uint32_t h, int32_t n_parts) {
  if (n_parts == 0) return static_cast<int32_t>(h);
  // C's % truncates toward zero; adding n_parts to a negative
  // remainder gives Spark's pmod (the floor modulo of the int32 hash)
  const int32_t m = static_cast<int32_t>(h) % n_parts;
  return m < 0 ? m + n_parts : m;
}

// h_in may be null (start from the seed) or alias out: each thread
// reads its rows' running hash before it writes those rows.
template <int K>
__global__ void __launch_bounds__(kThreads)
    murmur3_pids_kernel(KeyColumns cols, int64_t n, const int32_t* h_in, int32_t n_parts,
                        int32_t* out) {
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; first < n;
       first += kRows * threads) {
    uint32_t lo[kRows][K], hi[kRows][K], h[kRows];
    bool valid[kRows][K];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t i = first + r * threads;
      const bool in = i < n;
      h[r] = h_in && in ? static_cast<uint32_t>(h_in[i]) : 42u;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        lo[r][c] = hi[r][c] = 0;
        valid[r][c] = false;
        if (!in) continue;
        if (cols.width[c] == 1) {
          lo[r][c] = __ldg(static_cast<const uint32_t*>(cols.data[c]) + i);
        } else {
          const unsigned long long v = __ldg(static_cast<const unsigned long long*>(cols.data[c]) + i);
          lo[r][c] = static_cast<uint32_t>(v);
          hi[r][c] = static_cast<uint32_t>(v >> 32);
        }
        valid[r][c] = __ldg(cols.valid[c] + i) != 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const uint32_t hv = mix_value(h[r], cols.width[c], lo[r][c], hi[r][c]);
        if (valid[r][c]) h[r] = hv;
      }
      const int64_t i = first + r * threads;
      if (i < n) out[i] = finish(h[r], n_parts);
    }
  }
}

template <int K>
int launch(const KeyColumns& cols, int64_t n, const int32_t* h_in, int32_t n_parts, int32_t* out,
           cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, murmur3_pids_kernel<K>, kThreads,
                                                           0)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t blocks_needed = (n + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(blocks_needed < resident ? blocks_needed : resident);
  murmur3_pids_kernel<K><<<blocks, kThreads, 0, stream>>>(cols, n, h_in, n_parts, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data/valid: host arrays of k device pointers; widths: host array of
// k widths (1 or 2).  h_in: null, or the (n,) running hash of the key
// columns before these.  n_parts >= 1 writes pids; 0 writes the
// running hash for a next launch.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int blaze_murmur3_pids(const void* const* data, const void* const* valid,
                                  const int32_t* widths, int32_t k, int64_t n,
                                  const void* h_in, int32_t n_parts, void* out,
                                  void* stream) {
  if (k < 1 || k > kMaxKeys || n < 1 || n_parts < 0) return static_cast<int>(cudaErrorInvalidValue);
  KeyColumns cols{};
  for (int c = 0; c < k; ++c) {
    if (widths[c] != 1 && widths[c] != 2) return static_cast<int>(cudaErrorInvalidValue);
    cols.data[c] = data[c];
    cols.valid[c] = static_cast<const uint8_t*>(valid[c]);
    cols.width[c] = widths[c];
  }
  auto* o = static_cast<int32_t*>(out);
  auto* hin = static_cast<const int32_t*>(h_in);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(cols, n, hin, n_parts, o, s);
    case 2: return launch<2>(cols, n, hin, n_parts, o, s);
    case 3: return launch<3>(cols, n, hin, n_parts, o, s);
    case 4: return launch<4>(cols, n, hin, n_parts, o, s);
    case 5: return launch<5>(cols, n, hin, n_parts, o, s);
    case 6: return launch<6>(cols, n, hin, n_parts, o, s);
    case 7: return launch<7>(cols, n, hin, n_parts, o, s);
    default: return launch<8>(cols, n, hin, n_parts, o, s);
  }
}
