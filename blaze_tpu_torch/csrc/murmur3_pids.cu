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
// for that traffic.  Design: one thread per row over a grid-stride
// loop, neighbouring threads on neighbouring rows, so every column
// read and the pid write are coalesced; each byte is read once and
// the hash stays in a register across columns.  An 8-byte column is
// read as one 64-bit load (its low then high little-endian word),
// with none of the TPU kernel's (M, 128) padding.
//
// A launch takes at most kMaxKeys columns, whose table travels by
// value in the kernel's parameters.  Longer key lists are chained: a
// launch with n_parts == 0 writes the running hash instead of the pid,
// and the next launch starts from it (h_in) instead of the seed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxKeys = 8;

struct KeyColumns {
  const void* data[kMaxKeys];     // int32 (width 1) or int64 (width 2)
  const uint8_t* valid[kMaxKeys];  // torch.bool: 1 = valid
  int32_t width[kMaxKeys];
  int32_t k;
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

// h_in may be null (start from the seed) or alias out (each thread
// reads its row's running hash before it writes that row).
__global__ void murmur3_pids_kernel(KeyColumns cols, int64_t n, const int32_t* h_in,
                                    int32_t n_parts, int32_t* out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = h_in ? static_cast<uint32_t>(h_in[i]) : 42u;
    // fully unrolled: constant indices keep the column table in the
    // parameter bank instead of a local-memory copy
#pragma unroll
    for (int c = 0; c < kMaxKeys; ++c) {
      if (c >= cols.k) break;
      uint32_t hv;
      if (cols.width[c] == 1) {
        const uint32_t w = __ldg(static_cast<const uint32_t*>(cols.data[c]) + i);
        hv = fmix(mix_h1(h, mix_k1(w)), 4u);
      } else {
        const uint64_t v =
            __ldg(reinterpret_cast<const unsigned long long*>(cols.data[c]) + i);
        uint32_t h1 = mix_h1(h, mix_k1(static_cast<uint32_t>(v)));
        h1 = mix_h1(h1, mix_k1(static_cast<uint32_t>(v >> 32)));
        hv = fmix(h1, 8u);
      }
      if (__ldg(cols.valid[c] + i)) h = hv;
    }
    if (n_parts == 0) {  // a link of a chain: hand the hash on
      out[i] = static_cast<int32_t>(h);
      continue;
    }
    // C's % truncates toward zero; adding n_parts to a negative
    // remainder gives Spark's pmod (the floor modulo of the int32 hash)
    const int32_t m = static_cast<int32_t>(h) % n_parts;
    out[i] = m < 0 ? m + n_parts : m;
  }
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
  if (k < 1 || k > kMaxKeys || n_parts < 0) return static_cast<int>(cudaErrorInvalidValue);
  KeyColumns cols{};
  for (int c = 0; c < k; ++c) {
    cols.data[c] = data[c];
    cols.valid[c] = static_cast<const uint8_t*>(valid[c]);
    cols.width[c] = widths[c];
  }
  cols.k = k;
  constexpr int kThreads = 256;
  const int64_t blocks_needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks_needed < 132 * 64 ? blocks_needed : 132 * 64);
  murmur3_pids_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cols, n, static_cast<const int32_t*>(h_in), n_parts, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
