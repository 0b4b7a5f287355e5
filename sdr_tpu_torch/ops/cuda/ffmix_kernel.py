"""Feedforward carrier synthesis + RDS all-pass delay + both mixers as one
CUDA kernel.

Port of sdr_tpu/ops/pallas/ffmix_kernel.py `ffmix`.  The kernel is in
csrc/ffmix.cu and replaces the Pallas kernel `_ffmix_kernel`:

    mixed_s = 2 * channel     * cos(rampS + offS + slpS * rel)
    mixed_r = 2 * rds_delayed * cos(rampR + offR + slpR * rel)

with per-window (off, slope) from `ops.pll.pll_ff_params_from_sums` and the
RDS stream delayed by `delay` samples from a carried 128-column tail.  The
host folds each engine's nco_scale and phase_adjust into the float64 ramp
rows and the per-window parameters, as the reference does.  What bounds it
on an H100 and what its design does about it: see the source's header;
times in PERF.md.

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`ffmix_reference`); there is no fallback from one to
the other.  Each launch adds one to `build.LAUNCHES["ffmix"]`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build
from sdr_tpu_torch.ops.pll import f32_scalar, ramp_f64

EXT = 128  # carried columns of the rds stream for the in-kernel delay


@functools.lru_cache(maxsize=16)
def _scaled_ramp(n: int, freq: float, fs: float, nco_scale: float,
                 phase_adjust: float, device: torch.device) -> torch.Tensor:
    """(n,) float32 ramp*scale + adjust, evaluated in float64 on the host
    (the constant part of the cos argument; the reference's
    `_scaled_ramp`)."""
    ramp = ramp_f64(n, freq, fs, nco_scale)
    return torch.from_numpy(np.asarray(ramp * nco_scale + phase_adjust,
                                       np.float32)).to(device)


def ffmix(channel, rds_channel, rds_tail, params_s, params_r, *, n: int,
          window: int, pilot_freq: float, rds_freq: float, fs: float,
          delay: int, stereo_scale: float = 2.0, rds_scale: float = 0.5,
          phase_adjust: float = 0.0, tile: int | None = None,
          out_dtype=torch.float32, interpret: bool | None = None):
    """Synthesize both carriers, apply the RDS all-pass delay, and mix.

    channel / rds_channel: (..., n) IF-rate streams of one float dtype.
    rds_tail: (..., EXT) last columns of the previous block's rds_channel.
    params_s / params_r: (off, slope) pairs (..., n // window) for the
      pilot (nco_scale 2) and RDS carrier (nco_scale 0.5) engines.
    Returns (mixed_stereo, rds_baseband), both (..., n) in out_dtype.
    `tile` and `interpret` (TPU-lowering knobs) are accepted and have no
    effect.
    """
    args = _fold(channel, rds_channel, rds_tail, params_s, params_r, n,
                 window, pilot_freq, rds_freq, fs, delay, stereo_scale,
                 rds_scale, phase_adjust)
    if channel.is_cuda:
        return _kernel(*args, window, delay, out_dtype)
    if channel.device.type != "cpu":
        raise ValueError(f"no ffmix kernel for device {channel.device}")
    return _plain(*args, window, delay, out_dtype)


def _fold(channel, rds_channel, rds_tail, params_s, params_r, n, window,
          pilot_freq, rds_freq, fs, delay, stereo_scale, rds_scale,
          phase_adjust):
    """Check the shapes and fold each engine's nco_scale and phase_adjust
    into the ramp rows and the per-window scalars, as the reference does."""
    if channel.shape[-1] != n or rds_channel.shape != channel.shape:
        raise ValueError("channel and rds_channel must be (..., n)")
    if n % window or not 0 <= delay <= EXT:
        raise ValueError(f"n {n} must be a multiple of the window {window} "
                         f"and 0 <= delay {delay} <= {EXT}")
    dev = channel.device
    ramps = _scaled_ramp(n, float(pilot_freq), float(fs), float(stereo_scale),
                         float(phase_adjust), dev)
    rampr = _scaled_ramp(n, float(rds_freq), float(fs), float(rds_scale),
                         0.0, dev)
    ss = f32_scalar(stereo_scale, dev)
    rs = f32_scalar(rds_scale, dev)
    params = (params_s[0] * ss, params_s[1] * ss,
              params_r[0] * rs, params_r[1] * rs)
    return (channel, rds_channel, rds_tail.to(rds_channel.dtype), ramps,
            rampr, params)


def _kernel(channel, rds, rds_tail, ramps, rampr, params, window, delay,
            out_dtype):
    *lead, n = channel.shape
    if channel.dtype != rds.dtype or channel.dtype not in (torch.float32,
                                                           torch.bfloat16):
        raise TypeError("channel and rds_channel must share a dtype, float32"
                        " or bfloat16")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("out_dtype must be float32 or bfloat16")
    nw = n // window
    if window % 4:
        raise ValueError(f"the CUDA ffmix takes a window that is a multiple "
                         f"of 4, not {window}")
    if tuple(rds_tail.shape) != (*lead, EXT) or any(
            tuple(p.shape) != (*lead, nw) for p in params):
        raise ValueError("rds_tail must be (..., 128) and the parameters "
                         "(..., n // window)")
    tensors = (channel, rds, rds_tail, *params)
    if any(t.device != channel.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    channel, rds, rds_tail = (t.contiguous() for t in (channel, rds,
                                                       rds_tail))
    if channel.data_ptr() % 16:
        channel = channel.clone()   # the kernel loads it as 16-byte vectors
    params = [p.float().contiguous() for p in params]
    channels = int(np.prod(lead)) if lead else 1
    ms = torch.empty((*lead, n), dtype=out_dtype, device=channel.device)
    mr = torch.empty_like(ms)
    stream = torch.cuda.current_stream(channel.device).cuda_stream
    build.check(build.library().sdr_ffmix(
        channel.data_ptr(), rds.data_ptr(), rds_tail.data_ptr(),
        int(channel.dtype == torch.bfloat16), channels, n, window, delay,
        ramps.data_ptr(), rampr.data_ptr(), *(p.data_ptr() for p in params),
        ms.data_ptr(), mr.data_ptr(), int(out_dtype == torch.bfloat16),
        stream))
    build.LAUNCHES["ffmix"] += 1
    return ms, mr


# --------------------------------------------------------------- plain torch
def ffmix_reference(channel, rds_channel, rds_tail, params_s, params_r, *,
                    n: int, window: int, pilot_freq: float, rds_freq: float,
                    fs: float, delay: int, stereo_scale: float = 2.0,
                    rds_scale: float = 0.5, phase_adjust: float = 0.0,
                    out_dtype=torch.float32):
    """Plain PyTorch synthesis + delay + mixers on any device, with
    ffmix's signature: every operation rounded in the kernel's order."""
    args = _fold(channel, rds_channel, rds_tail, params_s, params_r, n,
                 window, pilot_freq, rds_freq, fs, delay, stereo_scale,
                 rds_scale, phase_adjust)
    return _plain(*args, window, delay, out_dtype)


def _plain(channel, rds, rds_tail, ramps, rampr, params, window, delay,
           out_dtype):
    *lead, n = channel.shape
    nw = n // window
    rel = (torch.arange(window, dtype=torch.float32, device=channel.device)
           - (window - 1) / 2.0)
    off_s, slp_s, off_r, slp_r = (p[..., None] for p in params)

    def nco(ramp, off, slp):
        theta = (ramp.reshape(nw, window) + off) + slp * rel
        return torch.cos(theta).reshape(*lead, n)
    delayed = torch.cat([rds_tail[..., EXT - delay:], rds], dim=-1)[..., :n]
    ms = 2.0 * channel.float() * nco(ramps, off_s, slp_s)
    mr = 2.0 * delayed.float() * nco(rampr, off_r, slp_r)
    return ms.to(out_dtype), mr.to(out_dtype)
