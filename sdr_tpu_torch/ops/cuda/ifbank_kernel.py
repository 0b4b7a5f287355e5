"""Fused IF bank with in-kernel mix sums (the stereo + RDS feedforward
chain's band-pass stages) as one CUDA kernel.

Port of sdr_tpu/ops/pallas/ifbank_kernel.py `FusedIFBankMix`.  The kernel
is in csrc/ifbank.cu and replaces the Pallas kernel `_ifbank_mix_kernel`.
From the demodulated IF stream and its carried 128-sample tail it computes
the stereo channel and RDS channel streams (the pilot, the RDS channel's
square and the 114 kHz carrier stay inside the kernel) and, per estimator
window, the coherent sums Z = sum x e^{-j ramp} of the pilot and of the
carrier that `ops.pll.pll_ff_params_from_sums` turns into carrier phases.
What bounds it on an H100 and what its design does about it: see the
source's header; times in PERF.md.

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`ifbank_mix_reference`); there is no fallback from one
to the other.  Each launch adds one to `build.LAUNCHES["ifbank_mix"]`.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build
from sdr_tpu_torch.ops.pll import ramp_f64

CTX = 128      # carried fm context (raw IF samples); covers taps <= 65
KERNEL_TAPS = 51
KERNEL_WINDOW = 256
# the reference TPU kernel's output tile (its default): a block of whole
# tiles is what that kernel consumes, so the receiver aligns its steps to it
OUT_TILE = 512


class FusedIFBankMix:
    """Stateful fused IF bank for the feedforward stereo + RDS chain.

    `mix_call(fm, tail)` -> (chan, rds_channel, (zpr, zpi), (zrr, zri),
    new_tail), the reference's return tuple: the two streams (..., n) in
    out_dtype, the pilot's and the carrier's per-window sums
    (..., n // window) in float32, and the last CTX fm samples.

    compute_dtype float32 | bfloat16; out_dtype None (float32) | a dtype.
    """

    def __init__(self, chan_coeff, pilot_coeff, rds_coeff, carr_coeff, *,
                 window: int = 256, pilot_freq: float,
                 rds_carrier_freq: float, fs: float,
                 compute_dtype: torch.dtype = torch.float32,
                 out_dtype: torch.dtype | None = None,
                 device: torch.device | str = "cpu"):
        coeffs = [np.asarray(c, np.float64) for c in
                  (chan_coeff, pilot_coeff, rds_coeff, carr_coeff)]
        self.taps = max(len(c) for c in coeffs)
        if 2 * (self.taps - 1) > CTX:
            raise ValueError(f"taps {self.taps} exceed the {CTX}-sample "
                             "context")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("compute_dtype must be float32 or bfloat16")
        self.window = int(window)
        self.pilot_freq = float(pilot_freq)
        self.rds_carrier_freq = float(rds_carrier_freq)
        self.fs = float(fs)
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype or torch.float32
        self.device = torch.device(device)
        self.ext = self.taps - 1
        # the taps as float32, rounded to the compute dtype; zero-padded at
        # high k to a common length (leaves each FIR unchanged)
        taps = np.stack([np.pad(c.astype(np.float32), (0, self.taps - len(c)))
                         for c in coeffs])
        t = torch.from_numpy(taps).to(compute_dtype).to(torch.float32)
        self._kernel_taps = np.ascontiguousarray(t.numpy())  # (4, taps)
        self._weight = t.flip(-1)[:, None, :].to(self.device)  # conv1d form
        self._ramp_cache: dict[tuple, tuple] = {}

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return torch.zeros(batch_shape + (CTX,), dtype=self.out_dtype,
                           device=self.device)

    def ramps(self, n: int, device) -> tuple:
        """((cos, sin) of the pilot ramp, (cos, sin) of the carrier ramp),
        each (n,) float32: float64 host tables with the wrap modulus of
        each engine (nco_scale 2 and 0.5), as the reference's `_ramps`."""
        key = (n, torch.device(device))
        if key not in self._ramp_cache:
            tabs = []
            for freq, scale in ((self.pilot_freq, 2.0),
                                (self.rds_carrier_freq, 0.5)):
                ramp = ramp_f64(n, freq, self.fs, scale)
                tabs.append(tuple(
                    torch.from_numpy(np.asarray(f(ramp), np.float32)).to(
                        device) for f in (np.cos, np.sin)))
            self._ramp_cache[key] = tuple(tabs)
        return self._ramp_cache[key]

    # ------------------------------------------------------------ dispatch
    def mix_call(self, fm: torch.Tensor, tail: torch.Tensor):
        n = fm.shape[-1]
        if n % self.window or n < CTX:
            raise ValueError(f"IF block {n} is not a multiple of the "
                             f"window {self.window}")
        tail = tail.to(fm.dtype)
        if fm.is_cuda:
            return self._kernel(fm, tail)
        if fm.device.type != "cpu":
            raise ValueError(f"no IF-bank kernel for device {fm.device}")
        return ifbank_mix_reference(self, fm, tail)

    def _kernel(self, fm, tail):
        *lead, n = fm.shape
        if (self.taps != KERNEL_TAPS or self.window != KERNEL_WINDOW
                or self.out_dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError(f"the CUDA IF bank takes {KERNEL_TAPS} taps, "
                             f"window {KERNEL_WINDOW} and a float32 or "
                             "bfloat16 output")
        if fm.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("fm must be float32 or bfloat16")
        if tuple(tail.shape) != (*lead, CTX) or tail.device != fm.device:
            raise ValueError(f"tail must be {(*lead, CTX)} on {fm.device}")
        fm, tail = fm.contiguous(), tail.contiguous()
        channels = int(np.prod(lead)) if lead else 1
        dev = fm.device
        chan = torch.empty((*lead, n), dtype=self.out_dtype, device=dev)
        rdsch = torch.empty_like(chan)
        z = torch.empty((4, *lead, n // self.window), dtype=torch.float32,
                        device=dev)
        (cp, sp), (cr, sr) = self.ramps(n, dev)
        bf16 = torch.bfloat16
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().sdr_ifbank_mix(
            fm.data_ptr(), tail.data_ptr(), int(fm.dtype == bf16), channels,
            n, self._kernel_taps.ctypes.data, self.taps,
            int(self.compute_dtype == bf16), cp.data_ptr(), sp.data_ptr(),
            cr.data_ptr(), sr.data_ptr(), chan.data_ptr(), rdsch.data_ptr(),
            int(self.out_dtype == bf16), z[0].data_ptr(), z[1].data_ptr(),
            z[2].data_ptr(), z[3].data_ptr(), stream))
        build.LAUNCHES["ifbank_mix"] += 1
        return (chan, rdsch, (z[0], z[1]), (z[2], z[3]),
                fm[..., n - CTX:].clone())


# --------------------------------------------------------------- plain torch
def ifbank_mix_reference(bank: FusedIFBankMix, fm: torch.Tensor,
                         tail: torch.Tensor):
    """Plain PyTorch IF bank + mix sums, as the kernel: float32 convs of
    compute-dtype-rounded operands, the RDS channel computed taps-1
    samples into the past so the carrier FIR needs no carried state."""
    *lead, n = fm.shape
    ext = bank.ext
    conv = torch.nn.functional.conv1d
    cdt = bank.compute_dtype
    x = torch.cat([tail.to(fm.dtype), fm], dim=-1).reshape(-1, 1, CTX + n)
    x = x.to(cdt).to(torch.float32)
    w = bank._weight.to(x.device)
    cp = conv(x[..., CTX - ext:], w[:2])                  # (C, 2, n)
    rds_ext = conv(x[..., CTX - 2 * ext:], w[2:3])[:, 0]  # (C, n + ext)
    sq = (rds_ext * rds_ext).to(cdt).to(torch.float32)
    carr = conv(sq[:, None], w[3:4])[:, 0]                # (C, n)
    (cpc, sps), (crc, srs) = bank.ramps(n, x.device)
    nw = n // bank.window

    def sums(v, cos, sin):
        v = v.reshape(-1, nw, bank.window)
        c = cos.reshape(nw, bank.window)
        s = sin.reshape(nw, bank.window)
        return ((v * c).sum(-1).reshape(*lead, nw),
                (v * -s).sum(-1).reshape(*lead, nw))
    chan = cp[:, 0].reshape(*lead, n).to(bank.out_dtype)
    rdsch = rds_ext[:, ext:].reshape(*lead, n).to(bank.out_dtype)
    return (chan, rdsch, sums(cp[:, 1], cpc, sps), sums(carr, crc, srs),
            fm[..., n - CTX:].clone())
