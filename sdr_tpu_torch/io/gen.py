"""Test-signal generators (reference: src/genfunc.cpp:13-41).

The reference's generators are host-side test utilities (sinusoid, sum of
sines, uniform random); ours are NumPy with explicit seeding (the reference
used unseeded std::rand — nondeterministic across runs, SURVEY §4.1 — which
we deliberately fix).
"""

from __future__ import annotations

import numpy as np


def generate_sin(fs: float, freq: float, n: int, amplitude: float = 1.0,
                 phase: float = 0.0) -> np.ndarray:
    """Sinusoid synth (reference src/genfunc.cpp:13-22)."""
    t = np.arange(n, dtype=np.float64) / fs
    return (amplitude * np.sin(2 * np.pi * freq * t + phase)).astype(np.float32)


def add_sin(signals: list[np.ndarray]) -> np.ndarray:
    """Sum of sines (reference src/genfunc.cpp:24-31)."""
    return np.sum(np.stack(signals), axis=0).astype(np.float32)


def generate_random_samples(n: int, max_value: float = 10.0,
                            precision: int = 2, seed: int = 0) -> np.ndarray:
    """Uniform random vector in [-max, +max] with fixed decimal precision
    (reference src/genfunc.cpp:33-41, made deterministic via seed)."""
    rng = np.random.default_rng(seed)
    scale = 10 ** precision
    raw = rng.integers(-int(max_value * scale), int(max_value * scale) + 1, size=n)
    return (raw / scale).astype(np.float32)
