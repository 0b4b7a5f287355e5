"""Minimal WAV read/write (PCM s16) without external dependencies.

Copy of sdr_tpu/io/wav.py (importing sdr_tpu pulls in jax, which the GPU
machine does not have); tests/test_torch_host_copies.py pins the two.

The reference emits golden WAVs via scipy (model/fmMonoBlock.py:295-298,
model/fmStereoBlock.py:389-396) with samples scaled (x/2)*32767; helpers for
that convention are provided for golden-file comparison.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """Read a PCM-16 WAV; returns (rate, samples) with samples shape (N,) mono
    or (N, C) multichannel, dtype int16."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        assert w.getsampwidth() == 2, "only PCM-16 supported"
        data = np.frombuffer(w.readframes(n), dtype="<i2")
    if ch > 1:
        data = data.reshape(-1, ch)
    return rate, data


def write_wav(path: str, rate: int, samples: np.ndarray) -> None:
    """Write int16 samples ((N,) or (N, C)) as PCM-16 WAV."""
    samples = np.asarray(samples, dtype="<i2")
    ch = 1 if samples.ndim == 1 else samples.shape[1]
    with wave.open(path, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(samples.tobytes())


def float_to_wav_s16(x: np.ndarray) -> np.ndarray:
    """Golden-model scaling: int16((x/2) * 32767)
    (reference model/fmMonoBlock.py:297, fmStereoBlock.py:391)."""
    return ((np.asarray(x) / 2.0) * 32767.0).astype(np.int16)
