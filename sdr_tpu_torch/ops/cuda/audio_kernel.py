"""The audio pair: both IF -> audio decimating FIRs (fm -> mono, mixed ->
stereo) in one CUDA launch.

Port of sdr_tpu/ops/pallas/audio_kernel.py `PairDecimFIR`.  The kernel is
in csrc/audio.cu and replaces the Pallas kernel `_pair_kernel`:

    y[u] = sum_l h_rev[l] * xp[D*u + l],  xp = tail[-(taps-1):] ++ x

per stream, the same terms as the U=1 polyphase resampler.  The carried
state is the last CTX raw input samples of each stream.  The bf16 compute
engine at D = 5 and 6 (the receiver's integer modes) runs on the tensor
cores: the Toeplitz tile of the taps (`audio_tile_bf16`, built here and
packed in the mma's A-fragment order by ifbank_kernel's `pack_a_bf16`)
times 8 columns of the staged window, in the padded layout
`window_index` gives; the float32 engine stays on the CUDA cores.  What
bounds it on an H100 and what its design does about it: see the source's
header; times in PERF.md.

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`pair_reference`); there is no fallback from one to the
other.  Each launch adds one to `build.LAUNCHES["audio_pair"]`.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build
from sdr_tpu_torch.ops.cuda.ifbank_kernel import MMA_K, MMA_ROWS, pack_a_bf16

CTX = 128  # carried input context columns (covers taps-1 <= 128)
KERNEL_TAPS = 51
# the bf16 engine's tensor-core FIR (csrc/audio.cu pair_mma_kernel): the
# decimations it takes, the samples a column starts before D u0 beyond the
# taps' reach (so that a lane's 4 samples of a k-step are one 8-byte
# load), the outputs of a work item and the samples staged before D u0
MMA_DOWNS = (5, 6)
MMA_PHASE = 2
ITEM_OUT = 1024
LEAD = 56


def mma_depth(down: int, taps: int = KERNEL_TAPS) -> int:
    """K of the Toeplitz tile: the 15 D + taps + MMA_PHASE samples that 16
    consecutive outputs reach, rounded up to a whole m16n8k16 step (128 at
    D = 5, 144 at D = 6)."""
    return -(-((MMA_ROWS - 1) * down + taps + MMA_PHASE) // MMA_K) * MMA_K


def audio_tile_bf16(taps: np.ndarray, down: int) -> np.ndarray:
    """The (16, K) float32 Toeplitz tile of taps h[0..T-1] at decimation
    D: row r, column kk holds h[D r + T - 1 + MMA_PHASE - kk] (0 outside
    the taps), so that tile @ x[D u0 - (T - 1 + MMA_PHASE) + kk] gives
    outputs u0 .. u0 + 15 of y[u] = sum_k h[k] x[D u - k]."""
    taps = np.asarray(taps, np.float32)
    t = len(taps)
    a = np.zeros((MMA_ROWS, mma_depth(down, t)), np.float32)
    for r in range(MMA_ROWS):
        a[r, down * r + MMA_PHASE:down * r + MMA_PHASE + t] = taps[::-1]
    return a


def window_pad(down: int) -> int:
    """Samples of padding after every 16 D staged samples, so that
    neighbouring columns (16 D samples apart) start 32 or 96 bytes past a
    multiple of 128 and a half-warp's 8-byte loads of four columns hit 32
    distinct banks: 0 at D = 5 (160 bytes), 16 at D = 6 (192 + 32)."""
    for pad in (0, 16):
        if (2 * (16 * down + pad)) % 128 in (32, 96):
            return pad
    raise ValueError(f"no conflict-free padding at D = {down}")


def window_index(q, down: int):
    """Where staged sample q (counted from D u0 - LEAD) lies in a stream's
    padded window."""
    return q + window_pad(down) * (q // (16 * down))


class PairDecimFIR:
    """Two same-filter decimating FIRs (U=1) in one launch.

    `__call__(xa, xb, tail_a, tail_b)` -> (ya, yb, new_tail_a,
    new_tail_b): ya, yb (..., n // down) in out_dtype; the tails are the
    last CTX raw input samples of each stream, in its dtype.
    `tile` and `interpret` (TPU-lowering knobs) are accepted and have no
    effect.
    """

    def __init__(self, coeff: np.ndarray, down: int, *, tile: int = 3840,
                 compute_dtype: torch.dtype = torch.float32,
                 out_dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        if len(coeff) - 1 > CTX:
            raise ValueError(f"{len(coeff)} taps exceed the {CTX}-sample "
                             "context")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("compute_dtype must be float32 or bfloat16")
        self.down = int(down)
        self.taps = len(coeff)
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype
        self.device = torch.device(device)
        t = torch.from_numpy(np.asarray(coeff, np.float64).astype(np.float32)
                             ).to(compute_dtype).to(torch.float32)
        self._kernel_taps = np.ascontiguousarray(t.numpy())
        self._weight = t.flip(0).reshape(1, 1, -1).to(self.device)
        # the bf16 engine's kernel takes the packed Toeplitz tile from a
        # buffer on the card (copied there at the first launch)
        self._mma_words = None
        self._mma_dev = None
        if (compute_dtype == torch.bfloat16 and self.down in MMA_DOWNS
                and self.taps == KERNEL_TAPS):
            self._mma_words = pack_a_bf16(audio_tile_bf16(
                self._kernel_taps, self.down)).reshape(-1)

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return torch.zeros(batch_shape + (CTX,), dtype=dtype,
                           device=self.device)

    def __call__(self, xa, xb, tail_a, tail_b,
                 interpret: bool | None = None):
        n = xa.shape[-1]
        if xb.shape != xa.shape or n % self.down or n < CTX:
            raise ValueError(f"streams must match in shape, with a length "
                             f"that is a multiple of {self.down} and at "
                             f"least {CTX}")
        tail_a, tail_b = tail_a.to(xa.dtype), tail_b.to(xb.dtype)
        if xa.is_cuda:
            ya, yb = self._kernel(xa, xb, tail_a, tail_b)
        elif xa.device.type == "cpu":
            ya, yb = pair_reference(self, xa, xb, tail_a, tail_b)
        else:
            raise ValueError(f"no audio-pair kernel for device {xa.device}")
        return ya, yb, xa[..., n - CTX:].clone(), xb[..., n - CTX:].clone()

    def _taps_ptr(self, device) -> int:
        """The kernel's taps: the host float32 array (CUDA-core engine) or
        the packed tile on the card (bf16 engine at D = 5, 6)."""
        if self._mma_words is None:
            return self._kernel_taps.ctypes.data
        if self._mma_dev is None or self._mma_dev.device != device:
            self._mma_dev = torch.from_numpy(self._mma_words).to(device)
        return self._mma_dev.data_ptr()

    def _kernel(self, xa, xb, tail_a, tail_b):
        *lead, n = xa.shape
        if self.taps != KERNEL_TAPS or self.out_dtype != torch.float32:
            raise ValueError(f"the CUDA audio pair takes {KERNEL_TAPS} taps "
                             "and a float32 output")
        if self.compute_dtype == torch.bfloat16 and \
                self.down not in MMA_DOWNS:
            raise ValueError(f"the CUDA audio pair's bf16 engine takes D in "
                             f"{MMA_DOWNS}")
        tensors = (xa, xb, tail_a, tail_b)
        if any(t.device != xa.device for t in tensors):
            raise ValueError("all inputs must be on one device")
        if any(t.dtype not in (torch.float32, torch.bfloat16)
               for t in tensors):
            raise TypeError("streams must be float32 or bfloat16")
        if tuple(tail_a.shape) != (*lead, CTX) or \
                tuple(tail_b.shape) != (*lead, CTX):
            raise ValueError(f"tails must be {(*lead, CTX)}")
        xa, xb, tail_a, tail_b = (t.contiguous() for t in tensors)
        channels = int(np.prod(lead)) if lead else 1
        m = n // self.down
        ya = torch.empty((*lead, m), dtype=torch.float32, device=xa.device)
        yb = torch.empty_like(ya)
        bf16 = torch.bfloat16
        stream = torch.cuda.current_stream(xa.device).cuda_stream
        build.check(build.library().sdr_audio_pair(
            xa.data_ptr(), xb.data_ptr(), tail_a.data_ptr(),
            tail_b.data_ptr(), int(xa.dtype == bf16), int(xb.dtype == bf16),
            channels, n, self.down, self._taps_ptr(xa.device), self.taps,
            int(self.compute_dtype == bf16), ya.data_ptr(), yb.data_ptr(),
            stream))
        build.LAUNCHES["audio_pair"] += 1
        return ya, yb


# --------------------------------------------------------------- plain torch
def pair_reference(fir: PairDecimFIR, xa, xb, tail_a, tail_b):
    """Plain PyTorch audio pair: one strided float32 conv per stream of
    compute-dtype-rounded operands."""
    *lead, n = xa.shape
    ctx = fir.taps - 1
    outs = []
    for x, tail in ((xa, tail_a), (xb, tail_b)):
        xp = torch.cat([tail[..., CTX - ctx:], x], dim=-1)
        xp = xp.reshape(-1, 1, n + ctx).to(fir.compute_dtype).to(
            torch.float32)
        y = torch.nn.functional.conv1d(xp, fir._weight.to(xp.device),
                                       stride=fir.down)
        outs.append(y.reshape(*lead, n // fir.down).to(fir.out_dtype))
    return tuple(outs)
