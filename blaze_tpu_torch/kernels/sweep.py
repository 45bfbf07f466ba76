"""Design sweep of ``sorted_lookup``, ``murmur3_pids`` and
``pid_histogram`` on the card.

    python3 -m blaze_tpu_torch.kernels.sweep [--only NAME ...]

Builds variants of the sources (the shipped text with a tuning
constant changed, or another design spliced in), holds each variant to
the plain version, and times it as ``chip_smoke.py`` does: CUDA events
around each call with L2 flushed and the card held by a spin kernel
before it (``time_ms``).
``sorted_lookup`` runs at every sample stride that fits shared memory
and at other block shapes; ``murmur3_pids`` one row a thread, and with
a ring of 1-D bulk copies (``cp.async.bulk``) into shared memory, and
also after an L2 flush that only reads.  ``pid_histogram`` runs every
entry of ``PID_HISTOGRAM_VARIANTS`` (the PR 3 design, frozen in
``csrc/sweep/pid_histogram_pr3.cu``, and the partial-rows combines of
``csrc/sweep/pid_histogram_rows.cu`` among them) by events and by
CUPTI device time, and the shipped kernel with one block against a
grid about the small-N threshold and with one against four blocks an
SM.  Needs one CUDA card and
``nvcc``; ``PERF.md`` cites it as "the sweep".
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import build, cuda_ops

KERNELS = ("sorted_lookup", "murmur3_pids", "pid_histogram")
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

# pid_histogram: the shipped source, and the two earlier designs in
# sources of their own, each with its C entry (symbol, argument types)
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
HISTOGRAM_SOURCES = {
    "pid_histogram.cu": ("blaze_pid_histogram", build.SIGNATURES["blaze_pid_histogram"]),
    # partial rows in scratch, an arrival counter; `out` written whole
    "sweep/pid_histogram_rows.cu": ("blaze_pid_histogram_rows", [_P, _I64, _I32, _P, _P, _I32, _P, _P]),
    # the PR 3 design: the caller zeroes `out`
    "sweep/pid_histogram_pr3.cu": ("blaze_pid_histogram_pr3", [_P, _I64, _I32, _P, _P]),
}
PR3_HISTOGRAM_SOURCE = "sweep/pid_histogram_pr3.cu"
_ROWS = "sweep/pid_histogram_rows.cu"
# the row loop's counts on path (b) aggregated over a warp's equal pids
# (every lane of the warp calls count_vec together: the loop is block-uniform)
MATCH_ANY_COUNT = r'''  auto count_vec = [&](int32_t p) {
    if constexpr (kBins == 0) {
      const bool counted = in_range(p, n_parts);
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, counted ? p : -1);
      if (counted && lane == __ffs(peers) - 1) atomicAdd(bins + p, __popc(peers));
    } else {
      count(p);
    }
  };
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kLoads;'''
_const = lambda name, old, new: {f"constexpr {name} = {old};": f"constexpr {name} = {new};"}
PID_HISTOGRAM_VARIANTS = [
    ("shipped", "pid_histogram.cu", {}),
    ("PR 3 design", PR3_HISTOGRAM_SOURCE, {}),
    ("shared bins at P <= 32", "pid_histogram.cu", _const("int kRegisterBins", 32, 0)),
    ("match-any shared atomics", "pid_histogram.cu", {
        "  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kLoads;": MATCH_ANY_COUNT,
        **{f"      count(x[l].{f});": f"      count_vec(x[l].{f});" for f in "xyzw"}}),
    ("1024 threads", "pid_histogram.cu", _const("int kThreads", 512, 1024)),
    ("1 int4 load in flight", "pid_histogram.cu", _const("int kLoads", 2, 1)),
    ("4 int4 loads in flight", "pid_histogram.cu", _const("int kLoads", 2, 4)),
    ("partials, last-block combine", _ROWS, {}),
    ("partials, last-block combine, sequentially consistent fences", _ROWS, {
        'asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(prev) : "l"(arrivals) : "memory");':
        '__threadfence(); prev = atomicAdd(arrivals, 1u); __threadfence();'}),
    ("partials, cooperative combine", _ROWS, _const("bool kCooperative", "false", "true")),
    ("partials, cooperative combine, 1024 threads", _ROWS, {**_const("bool kCooperative", "false", "true"),
                                                           **_const("int kThreads", 512, 1024)}),
    ("partials, last-block combine, clusters of 4", _ROWS, _const("int kCluster", 1, 4)),
    ("partials, cooperative combine, clusters of 4", _ROWS, {**_const("bool kCooperative", "false", "true"),
                                                            **_const("int kCluster", 1, 4)}),
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


def ptxas_summary(log: str):
    """(registers of each kernel, spill-store bytes in all) from ptxas -v."""
    regs = sorted({int(line.split("Used ")[1].split()[0]) for line in log.splitlines() if "Used " in line})
    spills = sum(int(line.split(" bytes spill stores")[0].split()[-1]) for line in log.splitlines()
                 if "spill stores" in line)
    return regs, spills


def load_variant(path: Path, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def pr3_histogram(fn):
    """pid_histogram by the PR 3 design: a zeroed output, then its
    kernel (two launches a call)."""
    def call(pids: torch.Tensor, n_parts: int, blocks: int = 0) -> torch.Tensor:
        out = torch.zeros(n_parts, dtype=torch.int32, device=pids.device)
        if fn(pids.data_ptr(), pids.shape[0], n_parts, out.data_ptr(), torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("pid_histogram PR 3 design: launch failed")
        return out
    return call


def variant_histogram(fn, src: str, max_blocks: int):
    """pid_histogram by a variant built from ``src``, at most
    ``max_blocks`` blocks: the shipped source with tickets of its own,
    the partial-rows source with scratch and an arrival counter of its
    own (both 0 at rest)."""
    zero_at_rest = torch.zeros(cuda_ops.HIST_SHARED_BINS, dtype=torch.int64, device="cuda")

    def call(pids: torch.Tensor, n_parts: int, blocks: int = max_blocks) -> torch.Tensor:
        out = torch.empty(n_parts, dtype=torch.int32, device=pids.device)
        stream = torch.cuda.current_stream().cuda_stream
        if src == _ROWS:
            scratch = torch.empty(blocks * n_parts, dtype=torch.int32, device=pids.device)
            err = fn(pids.data_ptr(), pids.shape[0], n_parts, out.data_ptr(), scratch.data_ptr(), blocks,
                     zero_at_rest.data_ptr(), stream)
        else:
            err = fn(pids.data_ptr(), pids.shape[0], n_parts, out.data_ptr(), zero_at_rest.data_ptr(), blocks, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def sweep_pid_histogram(S, hists, flush, max_blocks: int) -> None:
    """Every variant at the exchanges' shapes (exact, also summed over
    100 back-to-back calls), timed by events, then the shipped kernel
    with one block against its grid about the small-N threshold; then
    the CUPTI device time of every timed call, in one profiler session."""
    jobs = []
    shapes = [(1 << 20, 8, 0), (1 << 20, 200, 0), (400_000, 8, 0), (50_000, 8, 0), ((1 << 20) + 3, 8, 1),
              (1 << 20, 20_000, 0)]
    for n, n_parts, offset in shapes:
        pids = S.hist_pids(torch, n, n_parts, seed=n + n_parts, offset=offset)
        want = cuda_ops.pid_histogram_plain(pids, n_parts)
        for name, fn in hists.items():
            label = f"pid_histogram N={n} P={n_parts}{f' offset {offset}' if offset else ''} {name}"
            call = functools.partial(fn, pids, n_parts)
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError as e:  # a variant the card refuses is reported, not shipped
                print(f"{label}: refused ({e})", flush=True)
                continue
            summed = sum(call().to(torch.int64) for _ in range(100))
            if not (torch.equal(got, want) and torch.equal(summed, 100 * want.to(torch.int64))):
                raise AssertionError(f"{label}: differs from the plain version")
            print(f"{label}: {S.time_ms(torch, call, 50, flush):.4f} ms", flush=True)
            jobs.append((label, call))
    shipped = hists["shipped"]
    for n in (4096, 8192, 12288, 16384, 24576, 32768, 65536):
        for n_parts in (8, 200):
            pids = S.hist_pids(torch, n, n_parts, seed=n)
            want = cuda_ops.pid_histogram_plain(pids, n_parts)
            for blocks in (1, max_blocks):
                call = functools.partial(shipped, pids, n_parts, blocks=blocks)
                if not torch.equal(call(), want):
                    raise AssertionError(f"pid_histogram N={n} P={n_parts} blocks<={blocks}: differs")
                label = f"pid_histogram N={n} P={n_parts} shipped, at most {blocks} blocks"
                print(f"{label}: {S.time_ms(torch, call, 50, flush):.4f} ms", flush=True)
                jobs.append((label, call))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n_parts in (8, 200, 20_000, cuda_ops.HIST_SHARED_BINS):
        pids = S.hist_pids(torch, 1 << 20, n_parts, seed=n_parts)
        want = cuda_ops.pid_histogram_plain(pids, n_parts)
        for blocks in (sms, max_blocks):
            call = functools.partial(shipped, pids, n_parts, blocks=blocks)
            if not torch.equal(call(), want):
                raise AssertionError(f"pid_histogram P={n_parts} blocks<={blocks}: differs")
            label = f"pid_histogram N={1 << 20} P={n_parts} shipped, at most {blocks} blocks"
            print(f"{label}: {S.time_ms(torch, call, 50, flush):.4f} ms", flush=True)
            jobs.append((label, call))
    times, _ = S.device_times(torch, cuda_ops, [(fn, "pid_histogram_kernel", 1) for _, fn in jobs], 20, flush)
    for (label, _), ms in zip(jobs, times):
        print(f"{label}: device time {ms:.4f} ms (CUPTI)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=list(KERNELS), help="kernels to sweep")
    only = ap.parse_args().only
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(build._PKG.parent))
    import chip_smoke as S

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    out_dir = Path(tempfile.mkdtemp(prefix="sweep-"))
    variants = []
    if "sorted_lookup" in only:
        variants += [("sorted_lookup.cu", "blaze_sorted_lookup", n, r) for n, r in LOOKUP_VARIANTS]
    if "murmur3_pids" in only:
        variants += [("murmur3_pids.cu", "blaze_murmur3_pids", n, r) for n, r in MURMUR3_VARIANTS]
    if "pid_histogram" in only:
        variants += [(src, HISTOGRAM_SOURCES[src][0], n, r) for n, src, r in PID_HISTOGRAM_VARIANTS]
    procs = [compile_variant(src, r, out_dir / f"v{i}.so") for i, (src, _, _, r) in enumerate(variants)]
    libs = {}
    for i, ((src, symbol, name, _), p) in enumerate(zip(variants, procs)):
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} {name}:\n{log}")
        regs, spills = ptxas_summary(log)
        print(f"{src} {name}: registers {regs}, spill stores {spills} bytes", flush=True)
        argtypes = HISTOGRAM_SOURCES[src][1] if src in HISTOGRAM_SOURCES else build.SIGNATURES[symbol]
        libs[(symbol, name)] = load_variant(out_dir / f"v{i}.so", symbol, argtypes)

    flush = torch.empty(S.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    one = torch.zeros(1, device="cuda")
    print(f"floor: one-element add_ {S.time_ms(torch, lambda: one.add_(1), 50, flush):.4f} ms", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    for t, n in ((30000, 1 << 20), (30210, 97338), (19497, 382270)) if "sorted_lookup" in only else ():
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
                     (10321, ("int64", "date32", "int32"))) if "murmur3_pids" in only else ():
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
    if "pid_histogram" in only:
        max_blocks = torch.cuda.get_device_properties(0).multi_processor_count * 2048 // cuda_ops.HIST_THREADS
        hists = {name: pr3_histogram(libs[(HISTOGRAM_SOURCES[src][0], name)]) if src == PR3_HISTOGRAM_SOURCE
                 else variant_histogram(libs[(HISTOGRAM_SOURCES[src][0], name)], src, max_blocks)
                 for name, src, _ in PID_HISTOGRAM_VARIANTS}
        sweep_pid_histogram(S, hists, flush, max_blocks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
