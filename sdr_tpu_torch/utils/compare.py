"""Signal-quality metrics: tone SNR, stereo separation, stream SNR vs golden.

Copy of sdr_tpu/utils/compare.py (importing sdr_tpu pulls in jax, which
the GPU machine does not have); tests/test_torch_host_copies.py pins the
two.

The reference's validation methodology is golden-file comparison plus visual
PSD inspection (spec p.5, SURVEY §4.2); these helpers make it quantitative.
"""

from __future__ import annotations

import numpy as np


def tone_snr_db(x: np.ndarray, fs: float, freq: float,
                bw: float = 50.0, skip: int = 0) -> float:
    """SNR of a sinusoid at `freq` within x: signal power in +-bw around the
    tone vs total power elsewhere (excluding DC), in dB."""
    x = np.asarray(x, np.float64)[skip:]
    x = x - x.mean()
    win = np.hanning(len(x))
    spec = np.abs(np.fft.rfft(x * win)) ** 2
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    sig_mask = np.abs(freqs - freq) <= bw
    dc_mask = freqs <= 20.0
    sig = spec[sig_mask].sum()
    noise = spec[~sig_mask & ~dc_mask].sum()
    return 10.0 * np.log10(sig / max(noise, 1e-30))


def band_power_db(x: np.ndarray, fs: float, freq: float, bw: float = 50.0,
                  skip: int = 0) -> float:
    """Power (dB) in a +-bw band around freq."""
    x = np.asarray(x, np.float64)[skip:]
    win = np.hanning(len(x))
    spec = np.abs(np.fft.rfft(x * win)) ** 2
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    mask = np.abs(freqs - freq) <= bw
    return 10.0 * np.log10(spec[mask].sum() + 1e-30)


def stereo_separation_db(channel_with_tone: np.ndarray,
                         channel_without: np.ndarray, fs: float,
                         freq: float, skip: int = 0) -> float:
    """Crosstalk rejection: tone power in its own channel vs the other."""
    return (band_power_db(channel_with_tone, fs, freq, skip=skip)
            - band_power_db(channel_without, fs, freq, skip=skip))


def stream_snr_db(x: np.ndarray, ref: np.ndarray, skip: int = 0) -> float:
    """SNR of x against a reference stream of the same length/alignment."""
    x = np.asarray(x, np.float64)[skip:]
    ref = np.asarray(ref, np.float64)[skip:len(x) + skip]
    n = min(len(x), len(ref))
    err = x[:n] - ref[:n]
    p_sig = np.mean(ref[:n] ** 2)
    p_err = np.mean(err ** 2)
    return 10.0 * np.log10(p_sig / max(p_err, 1e-30))
