"""Filesystem abstraction for scans and sinks (the port's own copy of
``blaze_tpu/io/fs.py``).

``get_fs(path)`` resolves a scheme-registered FileSystem: a host
runtime registers a ``CallbackFileSystem`` whose callables reach its
storage (HDFS, S3A, ...) through positioned reads, while local paths
use ``LocalFileSystem`` directly.  Every reader and writer in
``blaze_tpu_torch.io`` opens files through this module, so remote
storage needs only a registration.
"""

from __future__ import annotations

import io
import os
import threading
from typing import BinaryIO, Callable, Dict, Optional, Tuple

_REGISTRY: Dict[str, "FileSystem"] = {}
_LOCK = threading.Lock()


def _split_scheme(path: str) -> Tuple[str, str]:
    if "://" in path:
        scheme, rest = path.split("://", 1)
        return scheme, rest
    return "", path


class FileSystem:
    """≙ hadoop_fs::Fs (open/create/mkdirs; readers must support
    read/seek/tell for positioned reads)."""

    def open(self, path: str) -> BinaryIO:
        raise NotImplementedError

    def create(self, path: str) -> BinaryIO:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def open(self, path: str) -> BinaryIO:
        return open(_split_scheme(path)[1], "rb")

    def create(self, path: str) -> BinaryIO:
        p = _split_scheme(path)[1]
        d = os.path.dirname(p)
        if d:
            os.makedirs(d, exist_ok=True)
        return open(p, "wb")

    def mkdirs(self, path: str) -> None:
        os.makedirs(_split_scheme(path)[1], exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(_split_scheme(path)[1])

    def size(self, path: str) -> int:
        return os.path.getsize(_split_scheme(path)[1])


class _CallbackReadStream(io.RawIOBase):
    """File-like over positioned-read callbacks (≙ the reference's
    FSDataInputStream wrapper: read(pos, n) round trips per call)."""

    def __init__(self, pread: Callable[[int, int], bytes], length: int):
        self._pread = pread
        self._len = length
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = self._len + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._len - self._pos
        n = max(0, min(n, self._len - self._pos))
        if n == 0:
            return b""
        out = self._pread(self._pos, n)
        self._pos += len(out)
        return out

    def readinto(self, b) -> int:  # BufferedReader's actual entry point
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)


class CallbackFileSystem(FileSystem):
    """FS over host callbacks — the gateway registers this with
    callables that cross into the host runtime (e.g. JNI->HDFS).

    open_cb(path) -> (pread: (pos, n) -> bytes, length: int)
    create_cb(path) -> writable file-like
    """

    def __init__(
        self,
        open_cb: Callable[[str], Tuple[Callable[[int, int], bytes], int]],
        create_cb: Optional[Callable[[str], BinaryIO]] = None,
        mkdirs_cb: Optional[Callable[[str], None]] = None,
        exists_cb: Optional[Callable[[str], bool]] = None,
    ):
        self._open_cb = open_cb
        self._create_cb = create_cb
        self._mkdirs_cb = mkdirs_cb
        self._exists_cb = exists_cb

    def open(self, path: str) -> BinaryIO:
        pread, length = self._open_cb(path)
        return io.BufferedReader(_CallbackReadStream(pread, length))

    def create(self, path: str) -> BinaryIO:
        assert self._create_cb is not None, "no create callback registered"
        return self._create_cb(path)

    def mkdirs(self, path: str) -> None:
        if self._mkdirs_cb is not None:
            self._mkdirs_cb(path)

    def exists(self, path: str) -> bool:
        assert self._exists_cb is not None, "no exists callback registered"
        return self._exists_cb(path)


_LOCAL = LocalFileSystem()


def register_fs(scheme: str, fs: FileSystem) -> None:
    with _LOCK:
        _REGISTRY[scheme] = fs


def unregister_fs(scheme: str) -> None:
    with _LOCK:
        _REGISTRY.pop(scheme, None)


def get_fs(path: str) -> FileSystem:
    scheme, _ = _split_scheme(path)
    with _LOCK:
        fs = _REGISTRY.get(scheme)
    if fs is not None:
        return fs
    if scheme in ("", "file"):
        return _LOCAL
    raise KeyError(
        f"no FileSystem registered for scheme {scheme!r} (register_fs)"
    )
