"""The audio pair: both IF -> audio decimating FIRs (fm -> mono, mixed ->
stereo) in one CUDA launch.

Port of sdr_tpu/ops/pallas/audio_kernel.py `PairDecimFIR`.  The kernel is
in csrc/audio.cu and replaces the Pallas kernel `_pair_kernel`:

    y[u] = sum_l h_rev[l] * xp[D*u + l],  xp = tail[-(taps-1):] ++ x

per stream, the same terms as the U=1 polyphase resampler.  The carried
state is the last CTX raw input samples of each stream.  What bounds it on
an H100 and what its design does about it: see the source's header; times
in PERF.md.

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`pair_reference`); there is no fallback from one to the
other.  Each launch adds one to `build.LAUNCHES["audio_pair"]`.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build

CTX = 128  # carried input context columns (covers taps-1 <= 128)
KERNEL_TAPS = 51


class PairDecimFIR:
    """Two same-filter decimating FIRs (U=1) in one launch.

    `__call__(xa, xb, tail_a, tail_b)` -> (ya, yb, new_tail_a,
    new_tail_b): ya, yb (..., n // down) in out_dtype; the tails are the
    last CTX raw input samples of each stream, in its dtype.
    """

    def __init__(self, coeff: np.ndarray, down: int, *,
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

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return torch.zeros(batch_shape + (CTX,), dtype=dtype,
                           device=self.device)

    def __call__(self, xa, xb, tail_a, tail_b):
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

    def _kernel(self, xa, xb, tail_a, tail_b):
        *lead, n = xa.shape
        if self.taps != KERNEL_TAPS or self.out_dtype != torch.float32:
            raise ValueError(f"the CUDA audio pair takes {KERNEL_TAPS} taps "
                             "and a float32 output")
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
            channels, n, self.down, self._kernel_taps.ctypes.data, self.taps,
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
