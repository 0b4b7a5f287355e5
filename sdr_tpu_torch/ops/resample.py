"""Stateful polyphase rational resampler (upsample-U / FIR / downsample-D).

Port of sdr_tpu/ops/resample.py, the reference's `resample`
(src/filter.cpp:67-103).  Per kept output n (Nout = N*U/D):

    out[n] = sum_{k ≡ (nD) mod U, k < taps} coeff[k] * x[(nD - k)/U]

with negative input indices resolved into a carried tail of the previous
block.  Outputs are grouped into super-blocks of U consecutive outputs, each
consuming a window of L input samples advancing by D; the per-phase
coefficient walk becomes a constant (L x U) matrix B and the resampler one
strided `conv1d` with U output channels (derivation in
`_build_filter_bank`).  The carried state is the last ceil((taps-1)/U)
input samples, the only reachable part of the reference's taps-1 tail.
This conv is the `conv_engine='conv'` engine; the tiled engine of the same
terms (`--fast`) is ops/banded.py, with a kernel of its own.

`fir_filter` and `resample_reference` (the scalar oracle of the unit
tests) are copies of the reference's host functions.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _build_filter_bank(coeff: np.ndarray, up: int, down: int):
    """Build the (L, U) filter-bank matrix B and window geometry.

    Output index n = u*U + v (u = super-block, v in [0,U)); with
    r_v = (vD) mod U, d_v = floor(vD/U), xp = tail ++ x, S = len(tail):
        out[uU+v] = sum_l B[l, v] * xp[S + uD - (M-1) + l],
        B[l, v]  = coeff[r_v + (d_v + M - 1 - l) * U]   (0 where out of range)
    with M = ceil(taps/U), d_max = floor((U-1)D/U), L = M + d_max.
    """
    taps = len(coeff)
    M = -(-taps // up)
    d = [(v * down) // up for v in range(up)]
    r = [(v * down) % up for v in range(up)]
    d_max = d[-1] if up > 1 else 0
    L = M + d_max
    B = np.zeros((L, up), dtype=np.float32)
    for v in range(up):
        for l in range(L):
            m = d[v] + M - 1 - l
            k = r[v] + m * up
            if 0 <= m and k < taps:
                B[l, v] = coeff[k]
    s_eff = -(-(taps - 1) // up)
    return B, L, M, s_eff


class PolyphaseResampler:
    """Stateful U/D resampler; create once, apply per block.

    compute_dtype bf16 rounds signal and coefficients to bf16 and
    accumulates in float32 (the products of two bf16 values are exact in
    float32, so this is a float32 conv of bf16-rounded operands).
    """

    def __init__(self, coeff: np.ndarray, up: int = 1, down: int = 1, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        if not (up == 1 or math.gcd(up, down) == 1):
            raise ValueError(f"U={up} and D={down} must be coprime")
        self.up = int(up)
        self.down = int(down)
        self.taps = int(len(coeff))
        B, L, M, s_eff = _build_filter_bank(np.asarray(coeff, np.float64),
                                            up, down)
        self.L = L
        self.M = M
        self.state_len = s_eff
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        # conv weight (out_channels=U, in_channels=1, width=L), already
        # rounded to the compute dtype
        self._weight = torch.from_numpy(np.ascontiguousarray(B.T[:, None, :])
                                        ).to(compute_dtype).to(
            device=self.device, dtype=torch.float32)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return torch.zeros(batch_shape + (self.state_len,),
                           dtype=torch.float32, device=self.device)

    def __call__(self, x: torch.Tensor, tail: torch.Tensor):
        """Apply to block x (..., N) with carried tail (..., state_len).

        Returns (y float32 (..., N*U/D), new_tail).
        """
        *lead, n = x.shape
        if n % self.down or n < self.state_len:
            raise ValueError(f"block length {n} must be a multiple of "
                             f"D={self.down} and >= {self.state_len}")
        nsuper = n // self.down
        start = self.state_len - (self.M - 1)
        span = (nsuper - 1) * self.down + self.L
        xp = torch.cat([tail, x], dim=-1)
        window = xp[..., start:start + span].reshape(-1, 1, span)
        out = torch.nn.functional.conv1d(
            window.to(self.compute_dtype).to(torch.float32), self._weight,
            stride=self.down)                        # (batch, U, nsuper)
        y = out.transpose(1, 2).reshape(*lead, nsuper * self.up)
        return y, x[..., n - self.state_len:].clone()


def fir_filter(coeff: np.ndarray, *,
               device: torch.device | str = "cuda") -> PolyphaseResampler:
    """Plain stateful FIR (U=1, D=1): the reference's `resample(..., 1, 1)`
    for the band-pass stages (src/project.cpp:162,165,245,255)."""
    return PolyphaseResampler(coeff, 1, 1, device=device)


def resample_reference(x, state, coeff, up, down):
    """Scalar NumPy oracle with the reference's exact loop structure
    (src/filter.cpp:67-103), in float64: (out, new_state)."""
    x = np.asarray(x, np.float64)
    coeff = np.asarray(coeff, np.float64)
    state = np.asarray(state, np.float64)
    taps = len(coeff)
    n_in = len(x)
    out = np.zeros((n_in * up) // down, dtype=np.float64)
    ssize = len(state)
    for n in range(len(out)):
        k = (n * down) % up
        while k < taps:
            j = (n * down - k) // up
            if j >= 0:
                out[n] += coeff[k] * x[j]
            else:
                out[n] += coeff[k] * state[ssize + j]
            k += up
    new_state = x[n_in - (taps - 1):] if taps > 1 else x[:0]
    return out, new_state


class MultiFIR:
    """k plain FIRs (U=1, D=1) over the same input in one conv.

    Port of sdr_tpu/ops/resample.py MultiFIR: the filters are the conv's
    output channels, shorter ones zero-padded at high k, and the carried
    tail (the last max_taps-1 inputs) is shared.  compute_dtype bf16 rounds
    signal and taps to bf16 and accumulates in float32.
    """

    def __init__(self, coeffs: list[np.ndarray], *,
                 compute_dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.taps = max(len(c) for c in coeffs)
        self.k = len(coeffs)
        self.state_len = self.taps - 1
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        w = np.stack([np.pad(np.asarray(c, np.float32),
                             (0, self.taps - len(c)))[::-1] for c in coeffs])
        self._weight = torch.from_numpy(np.ascontiguousarray(w[:, None, :])
                                        ).to(compute_dtype).to(
            device=self.device, dtype=torch.float32)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return torch.zeros(batch_shape + (self.state_len,),
                           dtype=torch.float32, device=self.device)

    def __call__(self, x: torch.Tensor, tail: torch.Tensor):
        """x (..., N), tail (..., taps-1) -> (list of k float32 outputs,
        new_tail)."""
        *lead, n = x.shape
        xp = torch.cat([tail, x], dim=-1).reshape(-1, 1, n + self.state_len)
        out = torch.nn.functional.conv1d(
            xp.to(self.compute_dtype).to(torch.float32), self._weight)
        outs = [out[:, i].reshape(*lead, n) for i in range(self.k)]
        return outs, x[..., n - self.state_len:].clone()
