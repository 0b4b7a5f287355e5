"""ctypes bindings for the native stream runtime (libsdr_stream.so).

Port of sdr_tpu/native: `stream_runtime.cpp` is the reference's source,
unchanged, and BlockReader / BlockWriter are its ctypes bindings.  The
library is built at first use with g++ into `build/native/<hash>/` at the
root of the checkout (listed in .gitignore), keyed by a hash of the
source and flags; nothing is built into the package directory.  Where no
host compiler is found or the build fails, `available()` is False and the
CLI keeps its synchronous reader and sink (sdr_tpu_torch/cli.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "stream_runtime.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsdr_stream.so"


def build() -> Path:
    """Compile the runtime unless a library of the same hash exists;
    raises RuntimeError when there is no compiler or it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or $CXX) found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


@functools.cache
def _load() -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        return None
    lib.sdr_reader_create.restype = ctypes.c_void_p
    lib.sdr_reader_create.argtypes = [ctypes.c_int, ctypes.c_uint64,
                                      ctypes.c_uint64]
    lib.sdr_reader_next.restype = ctypes.c_int
    lib.sdr_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.sdr_reader_blocks_read.restype = ctypes.c_uint64
    lib.sdr_reader_blocks_read.argtypes = [ctypes.c_void_p]
    lib.sdr_reader_tail.restype = ctypes.c_uint64
    lib.sdr_reader_tail.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.sdr_reader_destroy.argtypes = [ctypes.c_void_p]
    lib.sdr_writer_create.restype = ctypes.c_void_p
    lib.sdr_writer_create.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lib.sdr_writer_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64]
    lib.sdr_writer_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _load() is not None


class BlockReader:
    """Native threaded block reader with bounded-ring backpressure
    (reference rf_thread + queue, src/project.cpp:48-80)."""

    def __init__(self, fd: int, block_bytes: int, capacity: int = 3):
        lib = _load()
        if lib is None:
            raise RuntimeError("native stream runtime unavailable")
        self._lib = lib
        self._block_bytes = block_bytes
        self._h = lib.sdr_reader_create(fd, block_bytes, capacity)
        self._buf = ctypes.create_string_buffer(block_bytes)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        rc = self._lib.sdr_reader_next(self._h, self._buf)
        if rc != 0:
            raise StopIteration
        return np.frombuffer(self._buf.raw, dtype=np.uint8).copy()

    @property
    def blocks_read(self) -> int:
        return self._lib.sdr_reader_blocks_read(self._h)

    def tail(self) -> np.ndarray:
        """Partial final block left at EOF (empty if none)."""
        if not self._h:
            return np.zeros(0, np.uint8)
        n = self._lib.sdr_reader_tail(self._h, self._buf)
        return np.frombuffer(self._buf.raw[:n], dtype=np.uint8).copy()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.sdr_reader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class BlockWriter:
    """Native threaded byte writer: enqueue and return, drain off-thread."""

    def __init__(self, fd: int, capacity: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native stream runtime unavailable")
        self._lib = lib
        self._h = lib.sdr_writer_create(fd, capacity)

    def push(self, data: bytes | np.ndarray):
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self._lib.sdr_writer_push(self._h, data, len(data))

    write = push  # file-like sink interface (cli._audio_sink)

    def close(self):
        """Drain the ring and join the writer thread."""
        if getattr(self, "_h", None):
            self._lib.sdr_writer_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
