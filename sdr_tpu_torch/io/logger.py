"""Signal tracing: .dat dumps for gnuplot-style inspection.

Port of sdr_tpu/io/logger.py.  Reference: src/logfunc.cpp:14-43
(`genIndexVector`, `logVector`).  Each dump is an x/y two-column text file
consumed by the reference's gnuplot scripts (data/example.gnuplot etc.).
The NumPy functions are copies of the reference's.  `stage_scope` is
the program's one span, where the reference annotates jax.profiler
traces: a `record_function` range in torch.profiler traces and a total
and count of its wall time per name, kept only while a profiler records
or the CLI's --stats asks (set_tracing); `count` keeps the program's
counters under the same switch.  NAMES lists every span and counter.
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


# Every span and counter name of the program.  Readers: the CLI's --stats
# table, benchmark/metrics/, tools/trace_gaps.py, chip_smoke.py's ranges()
# (a range is not a kernel) and the tests (every `stage_scope` and `count`
# of the package names one of these).
NAMES = (
    # the receiver's host side (models/receiver.py; receiver.h2d is
    # io/stream.py's to_device, every entry path's copy onto the device)
    "receiver.run", "receiver.h2d", "receiver.step",
    # counters of receiver.h2d, one a copy: it read page-locked host
    # memory (a reused block registered by io/stream.py HostPins), or not
    "h2d.pinned", "h2d.pageable",
    # its stages, inside receiver.step
    "rf_frontend", "demod", "mono_path", "if_filters", "ifbank_fused",
    "ifbank_fused_mix", "carrier_ff_pair", "carrier_ff_from_sums",
    "carrier_ffmix", "pll_joint", "pll_scan", "pll_pallas", "pll_chunked",
    "pll_pallas_chunked", "pll_ff", "audio_resample_pair",
    "audio_pair_kernel", "stereo_matrix", "rds_resample", "rds_rrc",
    # the wideband receiver (models/wideband.py)
    "channelize", "wideband_ingest",
    # the host RDS decoder (rds/streaming.py)
    "rds.push", "rds.symbols", "rds.framing",
    # the CLI's stream loops (cli.py)
    "cli.read", "cli.drain",
    # counters (rds/streaming.py), added once a push
    "rds.windows", "rds.groups", "rds.sync_losses", "rds.bits_corrected",
    "rds.symbols_recovered", "rds.windows_skipped",
)

_profiler_enabled = torch.autograd._profiler_enabled
_tracing = False                  # set_tracing(True): on with no profiler
_NULL = contextlib.nullcontext()  # the span while tracing is off
_SPANS: dict[str, list] = {}      # name -> [total_s, count, children_s]
_COUNTS: dict[str, int] = {}
_OPEN: list = []                  # spans open now, innermost last


class _Span:
    """One open span: a record_function range while a profiler records,
    and its perf_counter duration added to its name's total (and to its
    parent's children) on exit."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        _OPEN.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _OPEN.pop()
        rec = _SPANS.get(self.name)
        if rec is None:
            rec = _SPANS[self.name] = [0.0, 0, 0.0]
        rec[0] += dt
        rec[1] += 1
        if _OPEN:
            _SPANS.setdefault(_OPEN[-1].name, [0.0, 0, 0.0])[2] += dt
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def stage_scope(name: str):
    """The program's span: `with stage_scope('rf_frontend'): ...`.

    On while a torch profiler records, or after set_tracing(True) (the
    CLI's --stats).  Then it opens a record_function range named `name`
    while the profiler records (its start, end and parent in the trace, on
    the clock of the device's kernels and copies), and adds its wall time
    to an O(1) total and count per name (totals(), stage_times()).  Off,
    it returns one shared null context: no allocation, no clock read, no
    sync.  Spans nest within one thread; `name` is one of NAMES."""
    if not (_tracing or _profiler_enabled()):
        return _NULL
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` (one of NAMES), under stage_scope's
    switch."""
    if _tracing or _profiler_enabled():
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def set_tracing(on: bool) -> None:
    """Record spans and counters with no profiler running (--stats)."""
    global _tracing
    _tracing = bool(on)


def totals() -> tuple[dict[str, tuple[float, int]], dict[str, int]]:
    """({span: (total seconds, count)}, {counter: value}) since the last
    reset_stage_times()."""
    return ({k: (v[0], v[1]) for k, v in _SPANS.items() if v[1]},
            dict(_COUNTS))


def self_times() -> dict[str, float]:
    """Total seconds of each span less the seconds its child spans took."""
    return {k: v[0] - v[2] for k, v in _SPANS.items() if v[1]}


def stage_times() -> dict[str, float]:
    """Mean wall time per recorded stage (seconds)."""
    return {k: v[0] / v[1] for k, v in _SPANS.items() if v[1]}


def reset_stage_times() -> None:
    """Clear every span total and counter."""
    _SPANS.clear()
    _COUNTS.clear()


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
