"""Tiled banded-GEMM FIR/resampler: the `conv_engine='tiled'` engine.

Port of sdr_tpu/ops/banded.py `TiledBandedFIR`, the reference's `--fast`
engine for every direct-engine resampling FIR (audio, the RDS resampler,
the RRC).  The terms are the polyphase resampler's (ops/resample.py
`_build_filter_bank`): with the (L, U) bank B, M = ceil(taps/U),
S = state_len and xp = tail ++ x,

    y[..., u*U + v] = sum_l B[l, v] * xp[S + u*D - (M-1) + l].

The reference computes them as one (span x group*U) matrix product a tile
of `group` output super-blocks, with bf16 operands and float32 sums when
the compute dtype is bf16; input and tail are stored at bf16 then.  The
plain version here (`tiled_reference`) is that schedule in torch.  A CUDA
tensor goes to the hand-written kernel (ops/cuda/banded_kernel.py,
csrc/banded.cu), which reads the tail and the block through two pointers
and multiplies only B's non-zero band; a CPU tensor goes to the plain
version.  There is no fallback from one to the other.

Same state as PolyphaseResampler (state_len, the last S inputs), in the
store dtype, so checkpoints carry over between the engines.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import banded_kernel
from sdr_tpu_torch.ops.resample import _build_filter_bank


def _tile_band_matrix(B: np.ndarray, down: int, group: int) -> np.ndarray:
    """Stack G super-blocks of the (L, U) polyphase bank on strided
    diagonals: A[l, g*U + v] = B[l - g*down, v] (zero outside).

    A tile's window w[l] = window_src[j*G*down + l] then yields all G*U
    outputs of tile j as w @ A.
    """
    L, up = B.shape
    span = (group - 1) * down + L
    a = np.zeros((span, group * up), np.float32)
    for g in range(group):
        a[g * down: g * down + L, g * up: (g + 1) * up] = B
    return a


class TiledBandedFIR:
    """Stateful U/D resampler computed as tiled banded GEMMs.

    `group` = output super-blocks per tile; the reference's product is
    (C, span) @ (span, group*U) with span = (group-1)*D + L.  The window
    overlap L - D must fit in one tile advance group*D.
    `__call__(x, tail)` -> (y float32 (..., N*U/D), new_tail (..., S) in
    the store dtype: bf16 when the compute dtype is bf16, else float32).
    """

    def __init__(self, coeff: np.ndarray, up: int = 1, down: int = 1,
                 group: int | None = None,
                 compute_dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        if not (up == 1 or math.gcd(up, down) == 1):
            raise ValueError(f"U={up} and D={down} must be coprime")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("compute_dtype must be float32 or bfloat16")
        self.up = int(up)
        self.down = int(down)
        self.taps = int(len(coeff))
        B, L, M, s_eff = _build_filter_bank(np.asarray(coeff, np.float64),
                                            up, down)
        self.L = L
        self.M = M
        self.state_len = s_eff
        if group is None:
            # >= 128 output lanes a tile, and the window overlap L - D
            # within one tile advance
            group = max(1, -(-128 // up), -(-(L - down) // down))
        self.group = int(group)
        if L - down > self.group * down:
            raise ValueError(f"window overlap {L - down} exceeds tile "
                             f"advance {self.group * down}: raise group")
        self.compute_dtype = compute_dtype
        self.store_dtype = (torch.bfloat16 if compute_dtype == torch.bfloat16
                            else torch.float32)
        self.device = torch.device(device)
        # B rounded to the compute dtype, as the reference's operand cast
        self._bank = torch.from_numpy(B).to(compute_dtype).to(
            torch.float32).numpy()
        self._kernel_banks: dict = {}   # device -> the kernel's bank

    @functools.cached_property
    def band_matrix(self) -> torch.Tensor:
        """The reference's (span, group*U) matrix A, rounded to the compute
        dtype (float32 values); the plain version's operand."""
        return torch.from_numpy(_tile_band_matrix(self._bank, self.down,
                                                  self.group))

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return torch.zeros(batch_shape + (self.state_len,),
                           dtype=self.store_dtype, device=self.device)

    def __call__(self, x: torch.Tensor, tail: torch.Tensor):
        n = x.shape[-1]
        if n % self.down:
            raise ValueError(f"block length {n} % D={self.down} != 0")
        if n < self.state_len:
            raise ValueError(f"block length {n} < state {self.state_len}")
        if x.is_cuda:
            return banded_kernel.banded(self, x, tail)
        if x.device.type == "cpu":
            return tiled_reference(self, x, tail)
        raise ValueError(f"no banded-FIR kernel for device {x.device}")


# --------------------------------------------------------------- plain torch
def tile_windows(fir: TiledBandedFIR, x: torch.Tensor,
                 tail: torch.Tensor) -> torch.Tensor:
    """The reference's tile windows (..., n_tiles, span) of tail ++ x in
    the store dtype: padded to whole tiles, rows of group*D, each window
    a row and the head of the next (sdr_tpu/ops/banded.py
    `_tiled_apply`)."""
    x = x.to(fir.store_dtype)
    tail = tail.to(fir.store_dtype)
    *lead, n = x.shape
    n_tiles = -(-(n // fir.down) // fir.group)
    adv = fir.group * fir.down
    span = (fir.group - 1) * fir.down + fir.L
    xp = torch.cat([tail, x], dim=-1)
    start = fir.state_len - (fir.M - 1)
    need = start + (n_tiles + 1) * adv
    pad = need - xp.shape[-1]
    if pad > 0:
        xp = torch.cat([xp, xp.new_zeros((*lead, pad))], dim=-1)
    rows = xp[..., start:need].reshape(*lead, n_tiles + 1, adv)
    return torch.cat([rows[..., :-1, :], rows[..., 1:, :span - adv]],
                     dim=-1)


def tiled_reference(fir: TiledBandedFIR, x: torch.Tensor,
                    tail: torch.Tensor):
    """The reference's schedule in torch: one float32 product of the tile
    windows and the band matrix, both rounded to the compute dtype (the
    products of two bf16 values are exact in float32)."""
    *lead, n = x.shape
    windows = tile_windows(fir, x, tail)
    out = windows.to(fir.compute_dtype).to(torch.float32) @ (
        fir.band_matrix.to(x.device))
    y = out.reshape(*lead, -1)[..., :n // fir.down * fir.up]
    return y, x[..., n - fir.state_len:].to(fir.store_dtype).clone()
