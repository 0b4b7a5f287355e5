"""Build and load the port's CUDA kernels.

At first use, `library()` compiles every `sdr_tpu_torch/csrc/*.cu` with
`nvcc`, one process per source, all started together, links the objects
into one shared library with a plain C interface and loads it with
ctypes.  The build lands in `build/kernels/<hash>/` at the root of the
checkout (listed in .gitignore), keyed by a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
No PyTorch header is compiled, which keeps a build to seconds.

Flags: sm_90a (Hopper), -O3, and deliberately no --use_fast_math: the FM
discriminator's division and the mixers' cosf must stay IEEE.  `-Xptxas
-v` writes each kernel's registers, shared memory and spills to
`build.log` beside the library.  The parallel build takes ~5 s on an
H100 machine against ~14 s for one nvcc of all sources (PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry points of csrc/*.cu: name -> (restype, argtypes)
SIGNATURES = {
    "sdr_error_string": (ctypes.c_char_p, [_I]),
    "sdr_frontend_demod_blocks": (_LL, [_LL]),
    "sdr_frontend_iq": (_I, [_P, _P, _I, _LL, _I, _I, _P, _I, _F, _P, _P,
                             _P]),
    "sdr_frontend_demod": (_I, [_P, _P, _I, _LL, _I, _I, _P, _I, _F, _P, _P,
                                _P, _I, _P, _P, _P, _P, _P]),
    "sdr_ifbank_mix": (_I, [_P, _P, _I, _I, _LL, _P, _I, _I, _P, _P, _P, _P,
                            _P, _P, _I, _P, _P, _P, _P, _P]),
    "sdr_ffmix": (_I, [_P, _P, _P, _I, _I, _LL, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P, _P, _I, _P]),
    "sdr_audio_pair": (_I, [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _P, _I, _I,
                            _P, _P, _P]),
}

# launches of each CUDA kernel in this process, one count per kernel: a
# wrapper adds one where it launches its kernel and nowhere else (set the
# counts to 0 to start a count)
LAUNCHES = {"frontend_demod": 0, "frontend": 0, "ifbank_mix": 0, "ffmix": 0,
            "audio_pair": 0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsdr_kernels.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in sources():
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], None
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, stderr)
    tmp = out.with_name(f"{out.name}.{tag}")
    if failed is None:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (proc.returncode, proc.stderr)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out.parent / "build.log").write_text("".join(log))
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{failed[1][-4000:]}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().sdr_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")
