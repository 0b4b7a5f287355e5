"""The tiled engine's resampling FIR as one CUDA launch.

The kernel is in csrc/banded.cu and replaces the reference's tiled banded
GEMM (sdr_tpu/ops/banded.py `_tiled_apply`), the `conv_engine='tiled'`
schedule of every direct-engine resampling FIR:

    y[..., o] = sum_{j < M} P[j, o % U] * xp[..., start + (o D) // U + j]

with xp = tail ++ x read through two pointers, P the polyphase bank
(`polyphase_bank`) and start = S - (M - 1).  What bounds it on an H100
and what its design does about it: see the source's header; times in
PERF.md.

`banded(fir, x, tail)` takes CUDA tensors only; ops/banded.py
`TiledBandedFIR` sends a CPU tensor to its plain version
(`tiled_reference`) instead.  Each launch adds one to
`build.LAUNCHES["banded"]`.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build


def polyphase_bank(bank: np.ndarray, up: int, down: int, m: int
                   ) -> np.ndarray:
    """The (M, U) float32 bank P[j, v] = B[d_v + j, v], d_v = (v D) // U:
    the non-zero band of the (L, U) bank B, one column a phase."""
    d = (np.arange(up) * down) // up
    rows = d[None, :] + np.arange(m)[:, None]
    return np.ascontiguousarray(bank[rows, np.arange(up)[None, :]],
                                np.float32)


def _kernel_bank(fir, device: torch.device) -> tuple[np.ndarray,
                                                     torch.Tensor]:
    """The polyphase bank on the host (the kernels that take their taps
    in their parameters read it at launch) and on `device`, made at the
    first launch on a device and kept on the FIR."""
    cache = fir._kernel_banks
    if device not in cache:
        p = polyphase_bank(fir._bank, fir.up, fir.down, fir.M)
        cache[device] = (p, torch.from_numpy(p).to(device))
    return cache[device]


def banded(fir, x: torch.Tensor, tail: torch.Tensor):
    """One launch of the banded FIR: (y float32 (..., n // D * U), new_tail
    (..., S) in fir.store_dtype)."""
    *lead, n = x.shape
    s = fir.state_len
    if not (x.is_cuda and tail.device == x.device):
        raise ValueError("the banded-FIR kernel takes x and tail on one "
                         "CUDA device")
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in (x, tail)):
        raise TypeError("x and tail must be float32 or bfloat16")
    if tuple(tail.shape) != (*lead, s):
        raise ValueError(f"tail must be {(*lead, s)}, got "
                         f"{tuple(tail.shape)}")
    rows = int(np.prod(lead)) if lead else 1
    x, tail = x.contiguous(), tail.contiguous()
    taps, bank = _kernel_bank(fir, x.device)
    y = torch.empty((*lead, n // fir.down * fir.up), dtype=torch.float32,
                    device=x.device)
    new_tail = torch.empty((*lead, s), dtype=fir.store_dtype,
                           device=x.device)
    bf16 = torch.bfloat16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.library().sdr_banded(
        x.data_ptr(), tail.data_ptr(), int(x.dtype == bf16),
        int(tail.dtype == bf16), int(fir.store_dtype == bf16), rows, n,
        fir.up, fir.down, fir.M, s, taps.ctypes.data, bank.data_ptr(),
        y.data_ptr(), new_tail.data_ptr(), stream))
    build.LAUNCHES["banded"] += 1
    return y, new_tail
