"""Carrier recovery, feedforward family.

Port of the feedforward engines of sdr_tpu/ops/pll.py: `pll_feedforward`,
`pll_ff_params_from_sums`, `pll_feedforward_from_sums` and
`pll_feedforward_multi`, with the state type they share with the loop
engines.  The sequential loop engines (`pll`, `pll_chunked` and their
Pallas kernels) are not ported yet (ROADMAP.md, the PLL slice).

The engine, per block of n samples and per window of `window` samples:
  1. MIX: Z_c = sum_i x_i e^{-j ramp_i}, the ramp's cos/sin from float64
     host tables (no runtime trig, no float32 phase drift);
  2. ESTIMATE: phi_c = atan2 of Z_c rotated by the carried start phase r0;
  3. UNWRAP: wrapped first differences + cumsum give a continuous track;
  4. SYNTHESIZE: nco[i] = cos((ramp + r0 + phi_c + slope*rel) * scale
     + phase_adjust), piecewise linear in each window.
State mapping (as the reference): phase_acc = the phase track modulo the
wrap modulus, integrator = the last per-sample slope, trig_offset = the
carrier ramp's phase at the block start.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch


class PLLState(NamedTuple):
    """Carried carrier-recovery state (the reference's five scalars)."""
    integrator: torch.Tensor
    phase_acc: torch.Tensor
    feedback_i: torch.Tensor
    feedback_q: torch.Tensor
    trig_offset: torch.Tensor


def pll_init(batch_shape: tuple[int, ...] = (),
             device: torch.device | str = "cpu") -> PLLState:
    """Initial state (integrator=0, phase=0, feedbackI=1, feedbackQ=0,
    trigOffset=0), as the reference's src/project.cpp:106-111."""
    z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
    o = torch.ones(batch_shape, dtype=torch.float32, device=device)
    return PLLState(integrator=z, phase_acc=z, feedback_i=o, feedback_q=z,
                    trig_offset=z)


def _wrap_modulus(nco_scale: float) -> float:
    """Smallest W = 2*pi*k such that W*nco_scale is also a multiple of 2*pi."""
    frac = Fraction(nco_scale).limit_denominator(64)
    return 2.0 * np.pi * frac.denominator


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return n


def ramp_f64(n: int, freq: float, fs: float, nco_scale: float) -> np.ndarray:
    """The carrier ramp 2*pi*(freq/fs)*i modulo the wrap modulus, i < n,
    in float64 on the host (the reference's `_ff_tables` ramp)."""
    w0 = 2.0 * np.pi * (float(freq) / float(fs))
    return (w0 * np.arange(n, dtype=np.float64)) % _wrap_modulus(nco_scale)


@functools.lru_cache(maxsize=16)
def _ff_tables_cached(n, window, freq, fs, nco_scale, phase_adjust, device):
    ramp = ramp_f64(n, freq, fs, nco_scale).reshape(n // window, window)
    wmod = _wrap_modulus(nco_scale)
    w0 = 2.0 * np.pi * (float(freq) / float(fs))

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return dict(cos_ramp=f32(np.cos(ramp)), sin_ramp=f32(np.sin(ramp)),
                ramp_mod=f32(ramp), r_adv=f32((w0 * n) % wmod),
                wmod=f32(wmod), scale=f32(nco_scale), adj=f32(phase_adjust))


def _ff_tables(n: int, window: int, freq: float, fs: float,
               nco_scale: float, phase_adjust: float,
               device: torch.device | str = "cpu") -> dict:
    """Host-f64 carrier ramp tables, cast to float32 on `device`; shaped
    (n // window, window) with float32 0-d constants beside them.  Cached
    by their arguments (a step reuses its block length)."""
    return _ff_tables_cached(int(n), int(window), float(freq), float(fs),
                             float(nco_scale), float(phase_adjust),
                             torch.device(device))


def f32_scalar(value: float, device) -> torch.Tensor:
    """A float32 0-d tensor of `value` (rounded as np.float32 rounds).  A
    fill, not a copy from the host: a copy would make the host wait for
    the device on every step."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _ff_estimate(zr, zi, st: PLLState, wmod, r_adv, window: int):
    """ESTIMATE + UNWRAP from per-window coherent sums (..., nc): the
    per-window synthesis parameters (off = r0 + phi_c, slope) and the new
    state, without synthesizing the NCO."""
    two_pi = f32_scalar(2.0 * np.pi, zr.device)
    r0 = st.trig_offset[..., None]
    cr0, sr0 = torch.cos(r0), torch.sin(r0)
    # z' = e^{-j r0} (zr + j zi)
    zr_r = zr * cr0 + zi * sr0
    zi_r = zi * cr0 - zr * sr0
    phi_hat = torch.atan2(zi_r, zr_r)
    acc = st.phase_acc[..., None]
    prev = torch.cat([acc, phi_hat[..., :-1]], dim=-1)
    d = phi_hat - prev
    d = d - two_pi * torch.round(d / two_pi)             # (-pi, pi]
    phi_c = acc + torch.cumsum(d, dim=-1)                # continuous
    slope = d / float(window)
    phi_last = torch.remainder(phi_c[..., -1], wmod)
    new = PLLState(integrator=slope[..., -1], phase_acc=phi_last,
                   feedback_i=torch.cos(phi_last),
                   feedback_q=torch.sin(phi_last),
                   trig_offset=torch.remainder(r0[..., 0] + r_adv, wmod))
    return r0 + phi_c, slope, new


def _ff_finish(zr, zi, st: PLLState, tabs: dict, *, n: int, window: int,
               out_dtype=torch.float32):
    """ESTIMATE + UNWRAP + SYNTHESIZE from per-window sums Z_c (without
    the block's start rotation r0, which is applied here)."""
    rel = (torch.arange(window, dtype=torch.float32, device=zr.device)
           - (window - 1) / 2.0)
    off, slope, new = _ff_estimate(zr, zi, st, tabs["wmod"], tabs["r_adv"],
                                   window)
    theta = (tabs["ramp_mod"] + off[..., None]
             + slope[..., None] * rel)                   # (..., nc, window)
    nco = torch.cos(theta * tabs["scale"] + tabs["adj"]).to(out_dtype)
    return nco.reshape(*nco.shape[:-2], n), new


def _ff_run(x, st: PLLState, tabs: dict, *, n: int, window: int,
            out_dtype=torch.float32):
    """MIX against the raw ramp, then _ff_finish."""
    x2 = x.reshape(*x.shape[:-1], n // window, window).float()
    zr = (x2 * tabs["cos_ramp"]).mean(dim=-1)
    zi = (-x2 * tabs["sin_ramp"]).mean(dim=-1)
    return _ff_finish(zr, zi, st, tabs, n=n, window=window,
                      out_dtype=out_dtype)


def pll_feedforward(x: torch.Tensor, state: PLLState, *, freq: float,
                    fs: float, nco_scale: float = 1.0,
                    phase_adjust: float = 0.0, window: int = 256,
                    out_dtype=torch.float32):
    """Feedforward carrier recovery over block x (..., n): returns
    (nco (..., n), new_state).  The window shrinks to the largest divisor
    of n that is at most `window`, as in the reference.  (The reference's
    `norm_bandwidth` sets nothing here and is not taken.)"""
    n = x.shape[-1]
    window = _largest_divisor_at_most(n, window)
    tabs = _ff_tables(n, window, freq, fs, nco_scale, phase_adjust,
                      x.device)
    return _ff_run(x, state, tabs, n=n, window=window, out_dtype=out_dtype)


def pll_ff_params_from_sums(zr: torch.Tensor, zi: torch.Tensor,
                            state: PLLState, *, freq: float, fs: float,
                            n: int, nco_scale: float = 1.0,
                            window: int = 256):
    """ESTIMATE only, from precomputed MIX sums (..., n // window):
    ((off, slope), new_state), for a fused SYNTHESIZE + mix pass."""
    wmod_f = _wrap_modulus(nco_scale)
    w0 = 2.0 * np.pi * (float(freq) / float(fs))
    off, slope, new = _ff_estimate(
        zr, zi, state, f32_scalar(wmod_f, zr.device),
        f32_scalar((w0 * n) % wmod_f, zr.device), window)
    return (off, slope), new


def pll_feedforward_from_sums(zr: torch.Tensor, zi: torch.Tensor,
                              state: PLLState, *, freq: float, fs: float,
                              n: int, nco_scale: float = 1.0,
                              phase_adjust: float = 0.0, window: int = 256,
                              out_dtype=torch.float32):
    """Feedforward carrier recovery from precomputed per-window MIX sums:
    (nco (..., n), new_state)."""
    tabs = _ff_tables(n, window, freq, fs, nco_scale, phase_adjust,
                      zr.device)
    return _ff_finish(zr, zi, state, tabs, n=n, window=window,
                      out_dtype=out_dtype)


def pll_feedforward_multi(xs, states, *, params, window: int = 256,
                          out_dtype=torch.float32):
    """Several feedforward engines over same-shape inputs; params entries
    are (freq, fs, nco_scale, phase_adjust).  The reference stacks them
    into one fused program; eagerly there is nothing to fuse, so each
    engine runs on its own.  Returns (ncos, new_states) in input order."""
    if not len(xs) == len(states) == len(params):
        raise ValueError("xs, states and params must have one entry each")
    n = xs[0].shape[-1]
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError("engine inputs must match in shape")
    window = _largest_divisor_at_most(n, window)
    ncos, news = [], []
    for x, st, (freq, fs, scale, adj) in zip(xs, states, params):
        tabs = _ff_tables(n, window, freq, fs, scale, adj, x.device)
        nco, new = _ff_run(x, st, tabs, n=n, window=window,
                           out_dtype=out_dtype)
        ncos.append(nco)
        news.append(new)
    return tuple(ncos), tuple(news)
