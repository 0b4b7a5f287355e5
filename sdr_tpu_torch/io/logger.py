"""Signal tracing: .dat dumps for gnuplot-style inspection.

Port of sdr_tpu/io/logger.py.  Reference: src/logfunc.cpp:14-43
(`genIndexVector`, `logVector`).  Each dump is an x/y two-column text file
consumed by the reference's gnuplot scripts (data/example.gnuplot etc.).
The NumPy functions are copies of the reference's; `stage_scope` names a
range in torch.profiler traces (`record_function`) where the reference
annotates jax.profiler traces, and records its wall time as the
reference's does; `named_scope` is the receivers' range, opened only
while a profiler records.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def gen_index_vector(n: int) -> np.ndarray:
    """0..n-1 index vector (reference src/logfunc.cpp:14-21)."""
    return np.arange(n, dtype=np.float32)


def log_vector(filename: str, x: np.ndarray, y: np.ndarray) -> None:
    """Write '<x>\t<y>' lines with 5-digit precision, .dat suffix
    (reference src/logfunc.cpp:23-43)."""
    x = np.asarray(x).ravel()
    y = np.asarray(y).ravel()
    with open(f"{filename}.dat", "w") as f:
        f.write("# x\ty\n")
        for xi, yi in zip(x, y):
            f.write(f"{xi:.5f}\t{yi:.5f}\n")


class PsdAnimWriter:
    """Streaming multi-frame PSD .dat writer (the P6 animated-PSD parity,
    reference model/fmMonoAnim.py:42-135).

    Frames are separated by two blank lines so gnuplot's `index` keyword
    addresses frame k directly — the format examples/psd_anim.gnuplot
    renders into an animated GIF.  Appends incrementally: O(1) host memory
    on unbounded streams.
    """

    def __init__(self, filename: str, freq: np.ndarray):
        self._freq = np.asarray(freq).ravel()
        self._f = open(f"{filename}.dat", "w")
        self._f.write("# animated PSD series; frame k = gnuplot index k\n")
        self._f.write("# x: frequency (kHz)  y: PSD (dB/Hz)\n")
        self.frames = 0

    def append(self, psd_db: np.ndarray, label: str | None = None) -> None:
        psd_db = np.asarray(psd_db).ravel()
        self._f.write(f"# frame {self.frames}"
                      + (f" ({label})" if label else "") + "\n")
        np.savetxt(self._f, np.column_stack([self._freq, psd_db]),
                   fmt="%.5f", delimiter="\t")
        self._f.write("\n\n")
        self.frames += 1

    def close(self) -> None:
        self._f.close()


@contextlib.contextmanager
def stage_scope(name: str):
    """Named profiling scope: shows up in torch.profiler traces and
    records wall time.  Usage: `with stage_scope('rf_frontend'): ...`."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _STAGE_TIMES.setdefault(name, []).append(time.perf_counter() - t0)


_STAGE_TIMES: dict[str, list[float]] = {}


def named_scope(name: str):
    """A range named `name` in torch.profiler traces: the counterpart of
    the reference's jax.named_scope on its receiver's stages.  The range
    is opened only while a profiler records: record_function costs about
    ten microseconds of host time a call even with no profiler running,
    a null context under one (PERF.md).  No sync, no copy."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def stage_times() -> dict[str, float]:
    """Mean wall time per recorded stage (seconds)."""
    return {k: float(np.mean(v)) for k, v in _STAGE_TIMES.items()}


def reset_stage_times() -> None:
    _STAGE_TIMES.clear()


def print_real_vector(x, max_elems: int = 10) -> str:
    """Pretty-print helper (reference src/iofunc.cpp:15-21 `printRealVector`)."""
    x = np.asarray(x).ravel()
    shown = ", ".join(f"{v:.5f}" for v in x[:max_elems])
    tail = ", ..." if len(x) > max_elems else ""
    return f"[{shown}{tail}] ({len(x)} elems)"


def print_complex_vector(x, max_elems: int = 10) -> str:
    """Pretty-print helper (reference src/iofunc.cpp:23-29 `printComplexVector`)."""
    x = np.asarray(x).ravel()
    shown = ", ".join(f"{v.real:.5f}{v.imag:+.5f}j" for v in x[:max_elems])
    tail = ", ..." if len(x) > max_elems else ""
    return f"[{shown}{tail}] ({len(x)} elems)"
