"""Fourier transforms and Bartlett PSD estimation.

Port of sdr_tpu/ops/fourier.py.  Reference: src/fourier.cpp (DFT/IDFT
src/fourier.cpp:14-22,120-129; three FFT variants src/fourier.cpp:167-260;
Bartlett PSD src/fourier.cpp:35-117) and model/fmSupportLib.py:66-161.
The transforms are `torch.fft` (cuFFT on the card); the dense DFT is the
O(N^2) oracle.  Every function runs on the device of its input.
"""

from __future__ import annotations

import numpy as np
import torch

NFFT = 512  # reference include/dy4.h:18


def _dft_matrix(n: int, sign: float, device) -> torch.Tensor:
    k = np.arange(n)
    w = np.exp(sign * 2j * np.pi * np.outer(k, k) / n).astype(np.complex64)
    return torch.from_numpy(w).to(device)


def dft(x: torch.Tensor) -> torch.Tensor:
    """O(N^2) DFT as a dense matmul (reference src/fourier.cpp:14-22).

    The reference uses exp(+1j*2*pi*(-k)*m/N), the standard forward DFT.
    """
    x = torch.as_tensor(x)
    return x.to(torch.complex64) @ _dft_matrix(x.shape[-1], -1.0, x.device)


def idft(xf: torch.Tensor) -> torch.Tensor:
    """Inverse DFT with 1/N normalization (reference src/fourier.cpp:120-129)."""
    xf = torch.as_tensor(xf)
    n = xf.shape[-1]
    return xf.to(torch.complex64) @ (_dft_matrix(n, 1.0, xf.device) / n)


def fft(x: torch.Tensor) -> torch.Tensor:
    """FFT (stands in for the reference's recursive, twiddle-cached and
    iterative variants, src/fourier.cpp:167-260: one transform)."""
    return torch.fft.fft(torch.as_tensor(x))


def ifft(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft(torch.as_tensor(x))


def vector_magnitude(xf: torch.Tensor) -> torch.Tensor:
    """|Xf| (reference src/fourier.cpp:25-32 `computeVectorMagnitude`)."""
    return torch.abs(torch.as_tensor(xf))


def estimate_psd(samples: torch.Tensor, nfft: int = NFFT, fs: float = 1.0):
    """Bartlett PSD estimate in dB (reference src/fourier.cpp:35-117,
    model/fmSupportLib.py:86-161).

    Hann-windowed non-overlapping segments -> |FFT|^2 -> power -> dB ->
    per-bin mean over segments.  Returns (freq (nfft/2,) numpy float64,
    psd_db (..., nfft/2) float32 tensor).  Trailing samples beyond a whole
    segment are dropped, like the reference.
    """
    samples = torch.as_tensor(samples).float()
    n = samples.shape[-1]
    nseg = n // nfft
    segs = samples[..., : nseg * nfft].reshape(*samples.shape[:-1], nseg,
                                               nfft)
    i = np.arange(nfft)
    # reference window (src/fourier.cpp:50-53), rounded to float32 as the
    # reference's product with a float32 signal rounds it
    hann = torch.from_numpy((np.sin(i * np.pi / nfft) ** 2).astype(
        np.float32)).to(samples.device)
    xf = torch.fft.fft(segs * hann, dim=-1)[..., : nfft // 2]
    psd_seg = (1.0 / (fs * nfft / 2.0)) * torch.abs(xf) ** 2
    psd_seg = 2.0 * psd_seg  # fold negative-frequency energy
    psd_db = 10.0 * torch.log10(psd_seg)
    psd = torch.mean(psd_db, dim=-2)
    freq = np.arange(nfft // 2) * (fs / nfft)
    return freq, psd
