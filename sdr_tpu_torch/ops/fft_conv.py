"""FFT overlap-save block convolution — the frequency-domain filter engine.

Port of sdr_tpu/ops/fft_conv.py on `torch.fft` (cuFFT on the card), the
reference's `filter_engine='fft'`.  For U=1 resampling (plain FIR +
decimate) overlap-save is:

  per block: y_full = irfft(rfft([tail, x]) * rfft(h, padded))  then drop
  the first taps-1 warm-up samples and decimate.

For U>1 (the rational resamplers of modes 2/3) the zero-stuffed input's
spectrum is the input spectrum replicated U times, so overlap-save at the
upsampled rate costs one tiled pointwise multiply and one length-U*nfft
inverse FFT; the stuffed stream never materializes in time domain:

  y[n] = (stuff_U([tail, x]) conv h)[U*S + n*D],   S = ceil((taps-1)/U)
       = ifft(tile(fft([tail, x], nfft), U) * fft(h, U*nfft))[U*S + n*D]

Equal to the direct form up to FFT rounding.
"""

from __future__ import annotations

import numpy as np
import torch


class OverlapSaveFIR:
    """Stateful FFT-domain rational resampler, drop-in for
    PolyphaseResampler (the carried tail is the last ceil((taps-1)/U)
    input samples, in the input's dtype)."""

    def __init__(self, coeff: np.ndarray, down: int = 1, up: int = 1, *,
                 device: torch.device | str = "cuda"):
        self.taps = int(len(coeff))
        self.down = int(down)
        self.up = int(up)
        self.state_len = -(-(self.taps - 1) // self.up)
        self.device = torch.device(device)
        self._coeff = np.asarray(coeff, np.float32)
        self._h_freq_cache: dict[int, torch.Tensor] = {}

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return torch.zeros(batch_shape + (self.state_len,),
                           dtype=torch.float32, device=self.device)

    def _h_freq(self, nfft: int) -> torch.Tensor:
        """fft(h, up*nfft): rfft for up==1, full complex fft otherwise."""
        if nfft not in self._h_freq_cache:
            h = np.zeros(self.up * nfft, np.float64)
            h[: self.taps] = self._coeff
            f = np.fft.rfft(h) if self.up == 1 else np.fft.fft(h)
            self._h_freq_cache[nfft] = torch.from_numpy(
                f.astype(np.complex64)).to(self.device)
        return self._h_freq_cache[nfft]

    def __call__(self, x: torch.Tensor, tail: torch.Tensor):
        """x (..., N), tail (..., state_len) -> (y float32 (..., N*U/D),
        new_tail)."""
        n = x.shape[-1]
        if (n * self.up) % self.down or n < self.state_len:
            raise ValueError(f"block length {n}: N*U must be a multiple of "
                             f"D={self.down} and N >= {self.state_len}")
        nfft = int(2 ** np.ceil(np.log2(n + self.state_len)))
        hf = self._h_freq(nfft)
        xp = torch.cat([tail.to(torch.float32), x.to(torch.float32)], dim=-1)
        if self.up == 1:
            xf = torch.fft.rfft(xp, n=nfft, dim=-1)
            y_full = torch.fft.irfft(xf * hf, n=nfft, dim=-1)
            # output sample m of the streaming FIR = y_full[state_len + m]
            y = y_full[..., self.state_len:self.state_len + n]
        else:
            y = self._overlap_save_up(xp, hf, nfft, n)
        if self.down > 1:
            y = y[..., ::self.down]
        return (y.to(torch.float32).contiguous(),
                x[..., n - self.state_len:].clone())

    def _overlap_save_up(self, xp, hf, nfft, n):
        """U>1 overlap-save: spectral replication stands in for
        zero-stuffing.  In the upsampled domain the carried tail occupies
        positions [0, U*S) with input samples at multiples of U, so the
        streaming output n lives at linear-convolution index U*S + n*D,
        past the taps-1 circularly contaminated prefix (U*S >= taps-1)."""
        n_out = (n * self.up) // self.down
        xf = torch.fft.fft(xp, n=nfft, dim=-1)
        xu = xf.repeat(*([1] * (xf.ndim - 1)), self.up)   # fft of stuffed
        y_full = torch.fft.ifft(xu * hf, dim=-1).real
        start = self.up * self.state_len
        span = (n_out - 1) * self.down + 1
        return y_full[..., start:start + span]
