"""FM demodulators.  Port of sdr_tpu/ops/demod.py.

 - `fm_discriminator`: arctan-free discriminator
   (I*dQ - Q*dI)/(I^2 + Q^2) with divide-by-zero guard and carried previous
   sample (reference: src/filter.cpp:106-133 `FMDemod`).
 - `fm_arctan`: atan2 + unwrap + phase difference with carried phase
   (reference: model/fmSupportLib.py:34-63 `fmDemodArctan`).

Each elementwise operation rounds on its own, in the reference's order;
the fused CUDA front end (ops/cuda/frontend_kernel.py) writes the
discriminator with the same roundings, so the two agree bit for bit.
"""

from __future__ import annotations

import math

import torch


def fm_discriminator(i_ds: torch.Tensor, q_ds: torch.Tensor,
                     prev_i: torch.Tensor, prev_q: torch.Tensor):
    """Arctan-free FM discriminator, block-streaming.

    Args:
      i_ds, q_ds: (..., N) downsampled IF I/Q.
      prev_i, prev_q: (...,) last sample of the previous block.
    Returns:
      (demod (..., N), new_prev_i (...,), new_prev_q (...,))
    """
    i_prev = torch.cat([prev_i[..., None], i_ds[..., :-1]], dim=-1)
    q_prev = torch.cat([prev_q[..., None], q_ds[..., :-1]], dim=-1)
    num = i_ds * (q_ds - q_prev) - q_ds * (i_ds - i_prev)
    den = i_ds * i_ds + q_ds * q_ds
    zero = den == 0.0
    demod = torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))
    return demod, i_ds[..., -1], q_ds[..., -1]


def _unwrap(p: torch.Tensor) -> torch.Tensor:
    """numpy/jax `unwrap` along the last axis (discont = pi, period 2*pi)."""
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), math.pi, ddmod)
    correct = torch.where(dd.abs() < math.pi, 0.0, ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(correct, dim=-1)],
                     dim=-1)


def fm_arctan(i_ds: torch.Tensor, q_ds: torch.Tensor,
              prev_phase: torch.Tensor):
    """atan2/unwrap/diff demodulator (reference model/fmSupportLib.py:34-63).

    The carried phase is re-wrapped into (-pi, pi]: shifting the origin by a
    multiple of 2*pi leaves every later difference unchanged but avoids the
    unbounded float32 drift the reference suffers on long streams.
    """
    phase = torch.atan2(q_ds, i_ds)
    full = torch.cat([prev_phase[..., None], phase], dim=-1)
    unwrapped = _unwrap(full)
    demod = torch.diff(unwrapped, dim=-1)
    new_prev = torch.remainder(unwrapped[..., -1] + math.pi,
                               2 * math.pi) - math.pi
    return demod, new_prev
