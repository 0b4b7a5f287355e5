"""Fused RF front end: u8 decode + deinterleave + 51-tap LPF + decimate,
optionally with the FM discriminator, as one CUDA kernel.

Port of sdr_tpu/ops/pallas/frontend_kernel.py.  The kernels are in
csrc/frontend.cu and replace the Pallas kernels `_frontend_demod_kernel`
(reached through `FusedFrontend.demod_call`) and `_frontend_kernel`
(through `FusedFrontend.__call__`).  What bounds them on an H100: per IF
sample 2D = 20 bytes of u8 in and 2-8 bytes out against 2 x 51
multiply-adds, which on paper makes the float engines memory-bound and
the integer engines balanced.  The kernels read each input byte once,
keep the decoded I/Q (and, with demod, the discriminator) out of device
memory, and run the integer engines on dp4a (4 int8 multiply-adds per
instruction); the TPU's banded matmul, its carried grid state and its
8-channel padding do not carry over (see the source's header; times in
PERF.md).

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`frontend_reference`, `frontend_demod_reference`);
there is no fallback from one to the other.  `LAUNCHES` counts kernel
launches per kernel, so a run can show that its path went through them.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build
from sdr_tpu_torch.ops.cuda.build import LAUNCHES  # noqa: F401  (re-export)
from sdr_tpu_torch.ops.demod import fm_discriminator

FIX_BITS = 14  # fixed-point fraction bits of the int8x2 coefficient limbs
ENGINES = {"f32": 0, "bf16": 1, "int8": 2, "int8x2": 3}


def _quantize_limbs(a: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Two int8 limbs of a 15-bit fixed-point representation:
    a ~= (a1*128 + a2) * scale (sdr_tpu's `_quantize_limbs`, verbatim).

    The reference applies it to its band matrix, which holds only copies of
    the taps; applied to the taps themselves it gives the same integers
    and scale."""
    peak = np.abs(a).max()
    s = 2.0 ** np.ceil(np.log2(peak)) if peak > 0 else 1.0
    fix = np.round(a / s * (1 << FIX_BITS)).astype(np.int32)
    hi = np.round(fix / 128.0).astype(np.int32)
    lo = fix - 128 * hi
    if np.abs(hi).max() > 127:
        # peak an exact power of two: a/s hits 1.0, fix = +-2^FIX_BITS and
        # hi = +-128 overflows int8 — give back one fixed-point bit
        s *= 2.0
        fix = np.round(a / s * (1 << FIX_BITS)).astype(np.int32)
        hi = np.round(fix / 128.0).astype(np.int32)
        lo = fix - 128 * hi
    assert np.all(np.abs(hi) <= 127) and np.all(np.abs(lo) <= 127)
    return (hi.astype(np.int8), lo.astype(np.int8),
            float(s / (1 << FIX_BITS)))


def _quantize_int8(a: np.ndarray) -> tuple[np.ndarray, float]:
    """Single-limb int8 quantization a ~= a8 * scale (sdr_tpu's
    `_quantize_int8`, verbatim; same note on taps vs band)."""
    peak = np.abs(a).max()
    sc = (peak / 127.0) if peak > 0 else 1.0
    a8 = np.clip(np.round(a / sc), -127, 127).astype(np.int8)
    return a8, float(sc)


class FusedFrontend:
    """Stateful fused channelizer over (..., n) interleaved u8 IQ blocks.

    `__call__(u8, tail)` -> (i_ds, q_ds, new_tail);
    `demod_call(u8, tail, prev_i, prev_q)`
        -> (fm_demod, new_tail, new_prev_i, new_prev_q, power_sum),
    the reference's return tuples.  The tail is the carried last 128 u8
    bytes of the stream (2*(taps-1) = 100 rounded up as the reference
    stores it, so states convert one to one).

    compute_dtype: 'f32' | 'bf16' | 'int8' | 'int8x2' (the reference's
    coefficient engines); out_dtype: dtype of fm_demod.
    """

    def __init__(self, coeff: np.ndarray, decim: int, *,
                 compute_dtype: str = "f32",
                 out_dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu"):
        if compute_dtype not in ENGINES:
            raise ValueError(f"compute_dtype {compute_dtype!r} not in "
                             f"{sorted(ENGINES)}")
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("fm out_dtype must be float32 or bfloat16")
        # the taps as the reference's float32 band matrix holds them
        taps = np.asarray(coeff, np.float64).astype(np.float32)
        self.taps = len(taps)
        self.decim = int(decim)
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype
        self.device = torch.device(device)
        self.tail_u8 = -(-(2 * (self.taps - 1)) // 128) * 128
        self.fix_scale = 0.0
        if compute_dtype == "int8x2":
            hi, lo, self.fix_scale = _quantize_limbs(taps)
            self.int_taps = hi.astype(np.int64) * 128 + lo
            self._kernel_taps = np.concatenate([hi, lo])
        elif compute_dtype == "int8":
            a8, self.fix_scale = _quantize_int8(taps)
            self.int_taps = a8.astype(np.int64)
            self._kernel_taps = a8
        else:
            # the exact /128 decode scale folded into the taps (a power of
            # two: bit-identical in f32, unchanged bf16 rounding)
            f = torch.from_numpy(taps / np.float32(128.0))
            if compute_dtype == "bf16":
                f = f.to(torch.bfloat16)
                self._kernel_taps = f.view(torch.int16).numpy().view(np.uint16)
                f = f.to(torch.float32)
            else:
                self._kernel_taps = f.numpy()
            self.float_taps = f
        self.scale = float(np.float32(self.fix_scale / 128.0))
        # plain version: conv1d weight (cross-correlation, so taps reversed);
        # float64 holds the integer engines' sums exactly (|sum| < 2^28)
        if compute_dtype in ("int8", "int8x2"):
            w = torch.from_numpy(self.int_taps[::-1].astype(np.float64))
        else:
            w = self.float_taps.flip(0)
        self._weight = w.reshape(1, 1, -1).to(self.device)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        # value 128 decodes to 0.0 == zero-filled float tails
        return torch.full(batch_shape + (self.tail_u8,), 128,
                          dtype=torch.uint8, device=self.device)

    # ------------------------------------------------------------ dispatch
    def __call__(self, u8: torch.Tensor, tail: torch.Tensor):
        if u8.is_cuda:
            return self._kernel(u8, tail)
        _require_cpu(u8)
        return frontend_reference(self, u8, tail)

    def demod_call(self, u8: torch.Tensor, tail: torch.Tensor,
                   prev_i: torch.Tensor, prev_q: torch.Tensor):
        """Front end + FM discriminator in one launch; power_sum is
        sum(I^2+Q^2) over the block's IF samples (for RSSI)."""
        if u8.is_cuda:
            return self._demod_kernel(u8, tail, prev_i, prev_q)
        _require_cpu(u8)
        return frontend_demod_reference(self, u8, tail, prev_i, prev_q)

    # -------------------------------------------------------------- kernels
    def _check(self, u8, tail, *floats):
        *lead, n = u8.shape
        if u8.dtype != torch.uint8 or tail.dtype != torch.uint8:
            raise TypeError("u8 block and tail must be uint8")
        if tuple(tail.shape) != (*lead, self.tail_u8):
            raise ValueError(f"tail shape {tuple(tail.shape)} != "
                             f"{(*lead, self.tail_u8)}")
        if n < 2 * self.decim:
            raise ValueError(f"block of {n} bytes is shorter than one IF "
                             f"sample ({2 * self.decim} bytes)")
        tensors = (u8, tail, *floats)
        if any(t.device != u8.device for t in tensors):
            raise ValueError("all inputs must be on one device")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA front end takes contiguous tensors")
        if any(t.dtype != torch.float32 for t in floats):
            raise TypeError("prev_i / prev_q must be float32")
        channels = int(np.prod(lead)) if lead else 1
        return lead, n, channels, n // (2 * self.decim)

    def _common_args(self, u8, tail, channels, n):
        return [u8.data_ptr(), tail.data_ptr(), channels, n, self.decim,
                ENGINES[self.compute_dtype], self._kernel_taps.ctypes.data,
                self.taps, self.scale]

    def _kernel(self, u8, tail):
        lead, n, channels, n_out = self._check(u8, tail)
        i_ds = torch.empty((*lead, n_out), dtype=torch.float32,
                           device=u8.device)
        q_ds = torch.empty_like(i_ds)
        stream = torch.cuda.current_stream(u8.device).cuda_stream
        build.check(build.library().sdr_frontend_iq(
            *self._common_args(u8, tail, channels, n), i_ds.data_ptr(),
            q_ds.data_ptr(), stream))
        LAUNCHES["frontend"] += 1
        return i_ds, q_ds, u8[..., n - self.tail_u8:].clone()

    def _demod_kernel(self, u8, tail, prev_i, prev_q):
        lead, n, channels, n_out = self._check(u8, tail, prev_i, prev_q)
        if tuple(prev_i.shape) != tuple(lead) or \
                tuple(prev_q.shape) != tuple(lead):
            raise ValueError("prev_i / prev_q must have the block's "
                             "leading shape")
        dev = u8.device
        fm = torch.empty((*lead, n_out), dtype=self.out_dtype, device=dev)
        last_i = torch.empty(tuple(lead), dtype=torch.float32, device=dev)
        last_q = torch.empty_like(last_i)
        power = torch.empty_like(last_i)
        lib = build.library()
        partials = torch.empty(channels, lib.sdr_frontend_demod_blocks(n_out),
                               dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.sdr_frontend_demod(
            *self._common_args(u8, tail, channels, n), prev_i.data_ptr(), prev_q.data_ptr(), fm.data_ptr(),
            int(self.out_dtype == torch.bfloat16), last_i.data_ptr(),
            last_q.data_ptr(), partials.data_ptr(), power.data_ptr(),
            stream))
        LAUNCHES["frontend_demod"] += 1
        return (fm, u8[..., n - self.tail_u8:].clone(), last_i, last_q,
                power)


def _require_cpu(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"no front-end kernel for device {t.device}")


# --------------------------------------------------------------- plain torch
def frontend_reference(fe: FusedFrontend, u8: torch.Tensor,
                       tail: torch.Tensor):
    """Plain PyTorch front end: (i_ds, q_ds, new_tail), as the kernel.

    The integer engines run a float64 conv of x-128 with the integer taps:
    every partial sum is an integer below 2^28, so it is exact, and the conv
    runs on the CPU and on CUDA, where integer convs do not."""
    *lead, n = u8.shape
    n_out = n // (2 * fe.decim)
    ints = fe.compute_dtype in ("int8", "int8x2")
    x = torch.cat([tail, u8], dim=-1).reshape(-1, fe.tail_u8 + n)
    x = x.to(torch.float64 if ints else torch.float32) - 128.0
    # I and Q planes; plane index tail_u8/2 + j holds IF-rate sample j
    planes = torch.stack([x[:, 0::2], x[:, 1::2]]).reshape(
        -1, 1, (fe.tail_u8 + n) // 2)
    s = fe.tail_u8 // 2 - (fe.taps - 1)
    span = (n_out - 1) * fe.decim + fe.taps
    y = torch.nn.functional.conv1d(planes[..., s:s + span],
                                   fe._weight.to(planes.device),
                                   stride=fe.decim)
    if ints:
        y = y.to(torch.float32) * fe.scale
    y = y.reshape(2, *lead, n_out)
    return y[0], y[1], u8[..., n - fe.tail_u8:].clone()


def frontend_demod_reference(fe: FusedFrontend, u8: torch.Tensor,
                             tail: torch.Tensor, prev_i: torch.Tensor,
                             prev_q: torch.Tensor):
    """Plain PyTorch front end + discriminator:
    (fm_demod, new_tail, new_prev_i, new_prev_q, power_sum)."""
    i_ds, q_ds, new_tail = frontend_reference(fe, u8, tail)
    fm, last_i, last_q = fm_discriminator(i_ds, q_ds, prev_i, prev_q)
    power = torch.sum(i_ds * i_ds + q_ds * q_ds, dim=-1)
    return fm.to(fe.out_dtype), new_tail, last_i, last_q, power
