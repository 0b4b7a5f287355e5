"""Wideband spectrum survey: find FM stations in a complex IQ capture.

Port of sdr_tpu/ops/spectrum.py.  Given a wideband complex capture,
estimate the two-sided PSD on the device and detect occupied FM channels
on the broadcast raster, producing the `station_freqs` list that feeds
`WidebandChannelizer`.

Detection is classical energy sensing: Hann-windowed segment FFTs averaged
into a Bartlett PSD (reference src/fourier.cpp:35-117, complex input, two
sided), channel power integrated over the FM channel bandwidth at each
raster offset, and peaks accepted when they exceed the capture's noise
floor (median channel power) by `min_snr_db` and are local maxima within
+-1 raster step.  The PSD is one batch of `torch.fft` on the device; the
peak walk is host-side NumPy on the ~200-channel summary.
"""

from __future__ import annotations

import numpy as np
import torch


def psd_complex(i_wide: torch.Tensor, q_wide: torch.Tensor,
                nfft: int = 4096) -> torch.Tensor:
    """Two-sided Bartlett PSD of a complex baseband capture.

    Returns psd_db (nfft,), ordered from -fs/2 to +fs/2 (fftshifted), on
    the inputs' device.
    """
    x = torch.complex(i_wide.to(torch.float32), q_wide.to(torch.float32))
    n = x.shape[-1]
    if n < nfft:
        raise ValueError(
            f"capture ({n} samples) shorter than nfft ({nfft}): the PSD "
            "would average zero segments; pass a smaller nfft")
    nseg = n // nfft
    segs = x[..., : nseg * nfft].reshape(*x.shape[:-1], nseg, nfft)
    i = np.arange(nfft)
    # reference window (fourier.cpp:50-53), float64 on the host, then f32
    hann = torch.from_numpy(
        (np.sin(i * np.pi / nfft) ** 2).astype(np.float32)).to(x.device)
    xf = torch.fft.fft(segs * hann, dim=-1)
    power = torch.mean(torch.abs(xf) ** 2, dim=-2) / nfft
    return 10.0 * torch.log10(torch.fft.fftshift(power, dim=-1) + 1e-20)


def find_stations(i_wide, q_wide, fs_wide: float, *,
                  raster_hz: float = 100e3, channel_bw: float = 200e3,
                  min_snr_db: float = 10.0, dynamic_range_db: float = 50.0,
                  nfft: int = 4096, max_stations: int | None = None,
                  guard_hz: float | None = None,
                  device: torch.device | str = "cuda") -> list[float]:
    """Detect FM stations; returns center-frequency offsets (Hz) sorted by
    descending channel power.

    A channel is accepted when it is a local maximum on the raster, exceeds
    the noise floor (median channel power) by min_snr_db, and is within
    dynamic_range_db of the strongest station (an 8-bit capture cannot
    hold much more spread: anything far below the strongest is splatter,
    intermod or alias energy).  Accepted stations are kept channel_bw
    apart (strongest-first non-max suppression).  guard_hz keeps
    candidates this far from the capture edges (default: channel_bw).
    The PSD runs on `device` (default cuda).
    """
    fs_wide = float(fs_wide)
    psd_db = psd_complex(torch.as_tensor(i_wide).to(device),
                         torch.as_tensor(q_wide).to(device),
                         nfft=nfft).cpu().numpy()
    freqs = (np.arange(nfft) - nfft // 2) * (fs_wide / nfft)
    guard = channel_bw if guard_hz is None else float(guard_hz)

    # candidate raster offsets fully inside the capture
    lo = -fs_wide / 2.0 + guard
    hi = fs_wide / 2.0 - guard
    k_lo = int(np.ceil(lo / raster_hz))
    k_hi = int(np.floor(hi / raster_hz))
    cand = np.arange(k_lo, k_hi + 1, dtype=np.float64) * raster_hz
    if len(cand) == 0:
        return []

    # integrated channel power (linear) per candidate: prefix sum over the
    # sorted bin axis and two searchsorteds
    lin = 10.0 ** (psd_db / 10.0)
    half = channel_bw / 2.0
    csum = np.concatenate([[0.0], np.cumsum(lin)])
    lo_idx = np.searchsorted(freqs, cand - half, side="left")
    hi_idx = np.searchsorted(freqs, cand + half, side="left")
    power = csum[hi_idx] - csum[lo_idx]
    power_db = 10.0 * np.log10(power + 1e-20)

    floor_db = np.median(power_db)
    is_peak = np.ones(len(cand), bool)
    is_peak[:-1] &= power_db[:-1] >= power_db[1:]
    is_peak[1:] &= power_db[1:] >= power_db[:-1]
    thr = max(floor_db + min_snr_db, power_db.max() - dynamic_range_db)
    mask = is_peak & (power_db > thr)
    order = np.argsort(power_db)[::-1]
    found: list[float] = []
    for idx in order:
        if not mask[idx]:
            continue
        c = float(cand[idx])
        if all(abs(c - f) >= channel_bw for f in found):
            found.append(c)
    if max_stations is not None:
        found = found[:max_stations]
    return found
