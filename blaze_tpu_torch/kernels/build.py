"""Build of the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object, all
sources at once in parallel; the objects link into one shared library
with a plain ``extern "C"`` interface, loaded with ``ctypes``.  The
library lands in ``kernels/_build/<hash of sources and flags>/``
(ignored by git), so the first use in a fresh checkout builds it and
later uses load it.  No PyTorch headers are compiled in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "kernels" / "_build"
SOURCES = ("murmur3_pids.cu", "sorted_lookup.cu", "pid_histogram.cu", "fused_group_sums.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libblaze_tpu_torch_kernels.so"

_P = ctypes.c_void_p
# every pointer and the stream as c_void_p (a bare int would be cut to 32 bits)
SIGNATURES = {
    "blaze_murmur3_pids": [_P, _P, _P, ctypes.c_int32, ctypes.c_int64, _P, ctypes.c_int32, _P, _P],
    "blaze_sorted_lookup": [_P, ctypes.c_int64, _P, ctypes.c_int64, _P, _P, _P],
    "blaze_pid_histogram": [_P, ctypes.c_int64, ctypes.c_int32, _P, _P],
    "blaze_fused_group_sums": [_P, _P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, _P, _P],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float   # 0.0 when an earlier build was reused
    log: str         # nvcc's output (ptxas register and spill report)


def find_nvcc() -> str:
    candidates = [os.environ.get("NVCC", "")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels cannot be built")


def source_digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile and link the kernel library unless this exact build
    already exists; raises with nvcc's output when a step fails."""
    out = BUILD_DIR / source_digest() / LIB_NAME
    if out.exists():
        return BuildInfo(out, 0.0, "")
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        objs: List[Path] = [tmp / (Path(s).stem + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += link.stdout
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log}")
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(out, time.perf_counter() - t0, log)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build: Optional[BuildInfo] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, last_build
    with _lock:
        if _lib is None:
            last_build = build()
            lib = ctypes.CDLL(str(last_build.path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
