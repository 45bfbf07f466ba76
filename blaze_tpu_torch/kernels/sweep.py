"""Design sweep of ``sorted_lookup`` and ``murmur3_pids`` on the card.

    python3 -m blaze_tpu_torch.kernels.sweep

Builds variants of the two sources (the shipped text with a tuning
constant changed, or another design spliced in), holds each variant to
the plain version, and times it as ``chip_smoke.py`` does: CUDA events
around each call with L2 flushed and the card held by a spin kernel
before it (``time_ms``).
``sorted_lookup`` runs at every sample stride that fits shared memory
and at other block shapes; ``murmur3_pids`` one row a thread, and with
a ring of 1-D bulk copies (``cp.async.bulk``) into shared memory, and
also after an L2 flush that only reads.  Needs one CUDA card and
``nvcc``; ``PERF.md`` cites it as "the sweep".
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import build, cuda_ops

END_NS = "}  // namespace"
VEC4 = r'''
bool aligned(const void* p, uintptr_t to) { return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0; }

// 4 consecutive rows a thread: one 16-byte load per int32 plane, two
// per int64 plane, one 4-byte load of 4 validity bytes, one 16-byte
// store; the rows past the last whole group of 4 one row a thread.
template <int K>
__global__ void __launch_bounds__(kThreads)
    murmur3_pids_vec4(KeyColumns cols, int64_t n, const int32_t* h_in, int32_t n_parts, int32_t* out) {
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t groups = n >> 2;
  for (int64_t g = tid; g < groups; g += threads) {
    uint32_t lo[K][4], hi[K][4], valid[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (cols.width[c] == 1) {
        const uint4 w = __ldg(static_cast<const uint4*>(cols.data[c]) + g);
        lo[c][0] = w.x; lo[c][1] = w.y; lo[c][2] = w.z; lo[c][3] = w.w;
        hi[c][0] = hi[c][1] = hi[c][2] = hi[c][3] = 0;
      } else {
        const ulonglong2* p = static_cast<const ulonglong2*>(cols.data[c]) + 2 * g;
        const ulonglong2 a = __ldg(p), b = __ldg(p + 1);
        const unsigned long long v[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          lo[c][r] = static_cast<uint32_t>(v[r]);
          hi[c][r] = static_cast<uint32_t>(v[r] >> 32);
        }
      }
      valid[c] = __ldg(reinterpret_cast<const uint32_t*>(cols.valid[c]) + g);
    }
    uint32_t h[4] = {42u, 42u, 42u, 42u};
    if (h_in) {
      const int4 x = reinterpret_cast<const int4*>(h_in)[g];
      h[0] = x.x; h[1] = x.y; h[2] = x.z; h[3] = x.w;
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t hv = mix_value(h[r], cols.width[c], lo[c][r], hi[c][r]);
        if ((valid[c] >> (8 * r)) & 0xFFu) h[r] = hv;
      }
    }
    reinterpret_cast<int4*>(out)[g] = make_int4(finish(h[0], n_parts), finish(h[1], n_parts),
                                                finish(h[2], n_parts), finish(h[3], n_parts));
  }
  for (int64_t i = (groups << 2) + tid; i < n; i += threads) {
    uint32_t h = h_in ? static_cast<uint32_t>(h_in[i]) : 42u;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      uint32_t lo, hi = 0;
      if (cols.width[c] == 1) {
        lo = __ldg(static_cast<const uint32_t*>(cols.data[c]) + i);
      } else {
        const unsigned long long v = __ldg(static_cast<const unsigned long long*>(cols.data[c]) + i);
        lo = static_cast<uint32_t>(v);
        hi = static_cast<uint32_t>(v >> 32);
      }
      const uint32_t hv = mix_value(h, cols.width[c], lo, hi);
      if (__ldg(cols.valid[c] + i)) h = hv;
    }
    out[i] = finish(h, n_parts);
  }
}

template <int K>
int launch_vec4(const KeyColumns& cols, int64_t n, const int32_t* h_in, int32_t n_parts, int32_t* out,
                cudaStream_t stream) {
  bool ok = aligned(out, 16) && (h_in == nullptr || aligned(h_in, 16));
  for (int c = 0; c < K; ++c) ok = ok && aligned(cols.data[c], 16) && aligned(cols.valid[c], 4);
  if (!ok) return (launch<K>)(cols, n, h_in, n_parts, out, stream);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, murmur3_pids_vec4<K>, kThreads, 0)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int64_t blocks_needed = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(blocks_needed < resident ? blocks_needed : resident);
  murmur3_pids_vec4<K><<<blocks, kThreads, 0, stream>>>(cols, n, h_in, n_parts, out);
  return static_cast<int>(cudaGetLastError());
}

'''
BULK_RING = r'''
bool aligned(const void* p, uintptr_t to) { return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0; }

constexpr int kTileRows = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A ring of two stages per block: thread 0 bulk-copies the next tile's
// planes, validity and running hash into one stage while the block
// hashes the other.
template <int K>
__global__ void __launch_bounds__(kThreads)
    murmur3_pids_bulk(KeyColumns cols, int64_t tiles, const int32_t* h_in, int32_t n_parts,
                      int32_t* out) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[2];
  int off_data[K], off_valid[K], stage = 0;
#pragma unroll
  for (int c = 0; c < K; ++c) { off_data[c] = stage; stage += kTileRows * 4 * cols.width[c]; }
#pragma unroll
  for (int c = 0; c < K; ++c) { off_valid[c] = stage; stage += kTileRows; }
  const int off_h = stage;
  if (h_in) stage += kTileRows * 4;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&full[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&full[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto copy = [&](unsigned char* dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
  };
  auto issue = [&](int64_t tile, int s) {
    unsigned char* st = ring + s * stage;
    const uint32_t bar = smem_u32(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(stage) : "memory");
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const uint32_t bytes = kTileRows * 4 * cols.width[c];
      copy(st + off_data[c], static_cast<const char*>(cols.data[c]) + tile * bytes, bytes, bar);
      copy(st + off_valid[c], cols.valid[c] + tile * kTileRows, kTileRows, bar);
    }
    if (h_in) copy(st + off_h, h_in + tile * kTileRows, kTileRows * 4, bar);
  };
  int it = 0;
  int64_t tile = blockIdx.x;
  if (threadIdx.x == 0 && tile < tiles) issue(tile, 0);
  for (; tile < tiles; tile += gridDim.x, ++it) {
    const int s = it & 1;
    if (threadIdx.x == 0 && tile + gridDim.x < tiles) issue(tile + gridDim.x, s ^ 1);
    asm volatile(
        "{\n .reg .pred P1;\n LAB_WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}"
        :: "r"(smem_u32(&full[s])), "r"((it >> 1) & 1) : "memory");
    const unsigned char* st = ring + s * stage;
    for (int r = threadIdx.x; r < kTileRows; r += kThreads) {
      uint32_t h = h_in ? reinterpret_cast<const uint32_t*>(st + off_h)[r] : 42u;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        uint32_t lo, hi = 0;
        if (cols.width[c] == 1) {
          lo = reinterpret_cast<const uint32_t*>(st + off_data[c])[r];
        } else {
          const unsigned long long v = reinterpret_cast<const unsigned long long*>(st + off_data[c])[r];
          lo = static_cast<uint32_t>(v);
          hi = static_cast<uint32_t>(v >> 32);
        }
        const uint32_t hv = mix_value(h, cols.width[c], lo, hi);
        if (st[off_valid[c] + r]) h = hv;
      }
      out[tile * kTileRows + r] = finish(h, n_parts);
    }
    __syncthreads();
  }
}

template <int K>
int launch_bulk(const KeyColumns& cols, int64_t n, const int32_t* h_in, int32_t n_parts, int32_t* out,
                cudaStream_t stream) {
  bool ok = h_in == nullptr || aligned(h_in, 16);
  int stage = h_in ? kTileRows * 4 : 0;
  for (int c = 0; c < K; ++c) {
    ok = ok && aligned(cols.data[c], 16) && aligned(cols.valid[c], 16);
    stage += kTileRows * (4 * cols.width[c] + 1);
  }
  const int64_t tiles = n / kTileRows;
  if (!ok || tiles == 0) return (launch<K>)(cols, n, h_in, n_parts, out, stream);
  const int smem = 2 * stage;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(murmur3_pids_bulk<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, murmur3_pids_bulk<K>, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);
  murmur3_pids_bulk<K><<<blocks, kThreads, smem, stream>>>(cols, tiles, h_in, n_parts, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t r0 = tiles * kTileRows;  // the rows past the last whole tile
  if (r0 == n) return 0;
  KeyColumns rest = cols;
  for (int c = 0; c < K; ++c) {
    rest.data[c] = static_cast<const char*>(cols.data[c]) + r0 * 4 * cols.width[c];
    rest.valid[c] = cols.valid[c] + r0;
  }
  return (launch<K>)(rest, n - r0, h_in ? h_in + r0 : nullptr, n_parts, out + r0, stream);
}

'''

LOOKUP_VARIANTS = [
    ("shipped", {}),
    ("1 probe a thread", {"constexpr int kProbes = 2;": "constexpr int kProbes = 1;"}),
    ("4 probes a thread", {"constexpr int kProbes = 2;": "constexpr int kProbes = 4;"}),
    ("512 threads, 4 probes a thread", {"constexpr int kThreads = 1024;": "constexpr int kThreads = 512;",
                                        "constexpr int kProbes = 2;": "constexpr int kProbes = 4;"}),
    ("512 threads, 2 blocks an SM", {"constexpr int kThreads = 1024;": "constexpr int kThreads = 512;",
                                     "__launch_bounds__(kThreads, 1)": "__launch_bounds__(kThreads, 2)",
                                     "blocks_needed < sms ? blocks_needed : sms":
                                     "blocks_needed < 2 * sms ? blocks_needed : 2 * sms"}),
]
MURMUR3_VARIANTS = [
    ("shipped", {}),
    ("4 rows a thread, a grid apart", {"constexpr int kRows = 1;": "constexpr int kRows = 4;"}),
    ("4 consecutive rows, 16-byte loads", {END_NS: VEC4 + END_NS, "return launch<": "return launch_vec4<"}),
    ("bulk-copy ring", {END_NS: BULK_RING + END_NS, "return launch<": "return launch_bulk<"}),
]


class ReadingFlush:
    """An L2 flush whose ``zero_()`` reads the buffer instead of
    writing it, so the timed kernel finds clean lines to evict."""

    def __init__(self, buf: torch.Tensor):
        self.buf = buf.view(torch.int64)

    def zero_(self) -> None:
        self.buf.max()


def compile_variant(src: str, repl: dict, out: Path) -> subprocess.Popen:
    text = (build.CSRC / src).read_text()
    for old, new in repl.items():
        if old not in text:
            raise ValueError(f"{src}: a variant does not apply ({old[:60]!r})")
        text = text.replace(old, new)
    out.with_suffix(".cu").write_text(text)
    return subprocess.Popen([build.find_nvcc(), *build.COMPILE_FLAGS, "-shared", str(out.with_suffix(".cu")),
                             "-o", str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(build._PKG.parent))
    import chip_smoke as S

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    out_dir = Path(tempfile.mkdtemp(prefix="sweep-"))
    variants = [("sorted_lookup.cu", "blaze_sorted_lookup", n, r) for n, r in LOOKUP_VARIANTS]
    variants += [("murmur3_pids.cu", "blaze_murmur3_pids", n, r) for n, r in MURMUR3_VARIANTS]
    procs = [compile_variant(src, r, out_dir / f"v{i}.so") for i, (src, _, _, r) in enumerate(variants)]
    libs = {}
    for i, ((src, symbol, name, _), p) in enumerate(zip(variants, procs)):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} {name}:\n{log}")
        regs = sorted({int(line.split("Used ")[1].split()[0]) for line in log.splitlines() if "Used " in line})
        spills = sum(int(line.split(" bytes spill stores")[0].split()[-1]) for line in log.splitlines()
                     if "spill stores" in line)
        print(f"{src} {name}: registers {regs}, spill stores {spills} bytes", flush=True)
        fn = getattr(ctypes.CDLL(str(out_dir / f"v{i}.so")), symbol)
        fn.argtypes, fn.restype = build.SIGNATURES[symbol], ctypes.c_int
        libs[(symbol, name)] = fn

    flush = torch.empty(S.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    one = torch.zeros(1, device="cuda")
    print(f"floor: one-element add_ {S.time_ms(torch, lambda: one.add_(1), 50, flush):.4f} ms", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    for t, n in ((30000, 1 << 20), (30210, 97338), (19497, 382270)):
        table, probe = S.lookup_inputs(torch, t, n, seed=3)
        plo, phi = cuda_ops.sorted_lookup_plain(table, probe)
        lo = torch.empty(n, dtype=torch.int32, device="cuda")
        hi = torch.empty(n, dtype=torch.int32, device="cuda")
        shipped = cuda_ops.sorted_lookup_geometry(t)[0]
        for name, _ in LOOKUP_VARIANTS:
            for ls in range(0, 6) if name == "shipped" else (shipped,):
                if (t + (1 << ls) - 1) >> ls > 3 * 8192:  # past shared memory
                    continue
                call = functools.partial(libs[("blaze_sorted_lookup", name)], table.data_ptr(), t, ls,
                                         probe.data_ptr(), n, lo.data_ptr(), hi.data_ptr(), stream)
                if call() != 0:
                    raise RuntimeError(f"sorted_lookup {name} S={1 << ls}: launch failed")
                torch.cuda.synchronize()
                if not (torch.equal(lo, plo) and torch.equal(hi, phi)):
                    raise AssertionError(f"sorted_lookup {name} S={1 << ls}: differs from the plain version")
                tag = " (shipped stride)" if ls == shipped else ""
                print(f"sorted_lookup T={t} N={n} {name} S={1 << ls}{tag}: "
                      f"{S.time_ms(torch, call, 50, flush):.4f} ms", flush=True)

    for n, kinds in ((1 << 20, ("int64",)), (1 << 20, ("int64", "date32", "int32")), (381682, ("int64",)),
                     (10321, ("int64", "date32", "int32"))):
        planes, widths, valids = S.murmur3_inputs(torch, cuda_ops, n, kinds, seed=1)
        want = cuda_ops.murmur3_pids_plain(planes, widths, valids, 8)
        out = torch.empty(n, dtype=torch.int32, device="cuda")
        k = len(planes)
        arrays = ((ctypes.c_void_p * k)(*[p.data_ptr() for p in planes]),
                  (ctypes.c_void_p * k)(*[v.data_ptr() for v in valids]), (ctypes.c_int32 * k)(*widths))
        for name, _ in MURMUR3_VARIANTS:
            call = functools.partial(libs[("blaze_murmur3_pids", name)],
                                     *(ctypes.cast(a, ctypes.c_void_p) for a in arrays), k, n, None, 8,
                                     out.data_ptr(), stream)
            if call() != 0:
                raise RuntimeError(f"murmur3_pids {name}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"murmur3_pids {name}: differs from the plain version")
            print(f"murmur3_pids N={n} keys={'/'.join(kinds)} {name}: {S.time_ms(torch, call, 50, flush):.4f} ms, "
                  f"{S.time_ms(torch, call, 50, ReadingFlush(flush)):.4f} ms after a reading flush", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
