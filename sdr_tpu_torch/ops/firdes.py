"""FIR filter design (runs once at receiver setup; pure NumPy, float64 design).

Copy of sdr_tpu/ops/firdes.py (importing sdr_tpu pulls in jax, which the
GPU machine does not have); tests/test_torch_host_copies.py pins the two.

Implements the reference's windowed-sinc designers with identical math:
  - low-pass  (reference: src/filter.cpp:14-37  `impulseResponseLPF`)
  - band-pass (reference: src/filter.cpp:39-64  `impulseResponseBPF`)
plus a root-raised-cosine designer for the RDS matched filter, which the
reference spec requires (spec pp.13-14) but the reference code never built.

Both reference designers use a Hann window written as sin^2(i*pi/N) and place
the center tap by the closed-form limit of sinc.  The LPF takes an integer
`gain` used to compensate zero-stuffing energy loss in interpolating
resamplers (reference: src/filter.cpp:35, src/project.cpp:117).
"""

from __future__ import annotations

import numpy as np


def lowpass(fs: float, fc: float, num_taps: int, gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc LPF, Hann window.  Reference: src/filter.cpp:14-37."""
    norm_fc = fc / (fs / 2.0)
    i = np.arange(num_taps, dtype=np.float64)
    center = (num_taps - 1) * 0.5
    arg = np.pi * norm_fc * (i - center)
    # sinc with exact center-tap limit
    h = np.where(i == center, norm_fc, norm_fc * np.sin(arg) / np.where(arg == 0.0, 1.0, arg))
    h *= np.sin(i * np.pi / num_taps) ** 2  # Hann window
    h *= gain
    return h.astype(np.float32)


def bandpass(fs: float, fb: float, fe: float, num_taps: int) -> np.ndarray:
    """Windowed-sinc BPF via cosine shift.  Reference: src/filter.cpp:39-64.

    Note the reference centers on integer (num_taps-1)/2 (integer division,
    src/filter.cpp:49); for odd taps this equals the true center.
    """
    norm_cent = (fe + fb) / fs
    norm_pass = 2.0 * (fe - fb) / fs
    i = np.arange(num_taps, dtype=np.float64)
    center = (num_taps - 1) // 2
    arg = np.pi * (norm_pass * 0.5) * (i - (num_taps - 1) * 0.5)
    h = np.where(i == center, norm_pass, norm_pass * np.sin(arg) / np.where(arg == 0.0, 1.0, arg))
    h *= np.cos(i * np.pi * norm_cent)
    h *= np.sin(i * np.pi / num_taps) ** 2
    return h.astype(np.float32)


def root_raised_cosine(fs: float, num_taps: int, symbol_rate: float = 2375.0,
                       beta: float = 0.9) -> np.ndarray:
    """Root-raised-cosine matched filter for the RDS bitstream.

    The reference never implemented this (its RDS chain stops at the mixer,
    SURVEY §2.5); the spec's RDS data-processing chain requires an RRC matched
    filter ahead of clock/data recovery (spec p.14).  beta=0.9 is the rolloff
    conventionally used for RBDS receivers in this course project family.
    """
    ts = fs / symbol_rate  # samples per symbol period
    i = np.arange(num_taps, dtype=np.float64)
    t = (i - (num_taps - 1) / 2.0) / fs
    x = t / (ts / fs)  # t normalized to symbol periods
    num = np.sin(np.pi * x * (1 - beta)) + 4 * beta * x * np.cos(np.pi * x * (1 + beta))
    den = np.pi * x * (1 - (4 * beta * x) ** 2)
    h = np.empty_like(x)
    # generic samples
    with np.errstate(divide="ignore", invalid="ignore"):
        h = num / den
    # t = 0 limit
    h = np.where(x == 0.0, 1 - beta + 4 * beta / np.pi, h)
    # |x| = 1/(4 beta) limit
    sing = np.isclose(np.abs(x), 1.0 / (4 * beta))
    hs = (beta / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))
    )
    h = np.where(sing, hs, h)
    h /= np.sqrt(ts)  # unit-energy-ish normalization
    return h.astype(np.float32)


def allpass_delay(num_taps: int) -> np.ndarray:
    """Unit impulse delayed by (num_taps-1)/2 — used to group-delay-align a
    signal path against a linear-phase FIR path (spec Fig 10 'all-pass')."""
    h = np.zeros(num_taps, dtype=np.float32)
    h[(num_taps - 1) // 2] = 1.0
    return h
