"""Carrier recovery: the loop engines and the feedforward family.

Port of sdr_tpu/ops/pll.py.  The loop engines reproduce the reference
PLL (src/filter.cpp:136-174): per sample, phase detect
atan2(-x fbQ, x fbI), PI loop filter (Kp = bw*2.666, Ki = bw^2*3.555),
NCO cos(trigArg*ncoScale + phaseAdjust):
  - `pll`, the scan engine, in both of the reference's modes: wrap_phase
    (the combined NCO argument carried modulo a period) and the
    trigOffset counter of compat_pll; with or without lag correction.
    On the CPU a loop over time, vectorised over channels; on a CUDA
    tensor the sequential kernel (ops/cuda/pll_kernel.py, csrc/pll.cu)
    with libm atan2f.
  - `pll_chunked`, the frozen-feedback engine: the feedback phase is held
    over a chunk, every detector error of the chunk is measured at once,
    and the PI updates are applied exactly from prefix sums.  On the CPU a
    loop over chunks in the reference's XLA form; on a CUDA tensor the
    chunked kernel with libm atan2f.
The feedforward engines `pll_feedforward`, `pll_ff_params_from_sums`,
`pll_feedforward_from_sums` and `pll_feedforward_multi`, per block of n
samples and per window of `window` samples:
  1. MIX: Z_c = sum_i x_i e^{-j ramp_i}, the ramp's cos/sin from float64
     host tables (no runtime trig, no float32 phase drift);
  2. ESTIMATE: phi_c = atan2 of Z_c rotated by the carried start phase r0;
  3. UNWRAP: wrapped first differences + cumsum give a continuous track;
  4. SYNTHESIZE: nco[i] = cos((ramp + r0 + phi_c + slope*rel) * scale
     + phase_adjust), piecewise linear in each window.
`pll_reference` is the reference's scalar NumPy oracle of that loop.
State mapping (as the reference): the loop engines carry (integrator,
phase_acc, feedback_i, feedback_q, trig_offset), where phase_acc is the
wrapped NCO argument (wrap_phase) or the reference's phaseEst and
trig_offset its sample counter; the feedforward engines keep phase_acc =
the phase track modulo the wrap modulus, integrator = the last per-sample
slope, trig_offset = the carrier ramp's phase at the block start.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

PLL_CP = 2.666
PLL_CI = 3.555


class PLLState(NamedTuple):
    """Carried carrier-recovery state (the reference's five scalars)."""
    integrator: torch.Tensor
    phase_acc: torch.Tensor
    feedback_i: torch.Tensor
    feedback_q: torch.Tensor
    trig_offset: torch.Tensor


def pll_init(batch_shape: tuple[int, ...] = (),
             device: torch.device | str = "cuda") -> PLLState:
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


def loop_params(freq: float, fs: float, nco_scale: float = 1.0,
                phase_adjust: float = 0.0, norm_bandwidth: float = 0.01
                ) -> tuple[float, ...]:
    """The loop constants (kp, ki, w0, wmod, scale, adj) in float64, as
    the reference computes them; every engine rounds them to float32."""
    return (norm_bandwidth * PLL_CP, norm_bandwidth * norm_bandwidth * PLL_CI,
            2.0 * np.pi * (freq / fs), _wrap_modulus(nco_scale),
            float(nco_scale), float(phase_adjust))


def state_rows(x: torch.Tensor, state: PLLState):
    """x (..., n) and its state -> (lead shape, n, x as (C, n), the state
    as a (5, C) float32 stack)."""
    *lead, n = x.shape
    st = torch.stack([s.reshape(-1).float() for s in state])
    return tuple(lead), n, x.reshape(-1, n), st


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
               device: torch.device | str = "cuda") -> dict:
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
                    phase_adjust: float = 0.0, norm_bandwidth: float = 0.01,
                    window: int = 256, out_dtype=torch.float32):
    """Feedforward carrier recovery over block x (..., n): returns
    (nco (..., n), new_state).  The window shrinks to the largest divisor
    of n that is at most `window`, as in the reference.
    `norm_bandwidth` is accepted for signature compatibility and sets
    nothing, as in the reference: the estimator has no loop filter."""
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


def pll_reference(x, freq, fs, nco_scale, phase_adjust, norm_bandwidth, state):
    """Scalar NumPy oracle with the reference's exact loop
    (src/filter.cpp:136-174), a copy of the reference's: every loop engine
    is pinned to it.

    state: (integrator, phaseEst, feedbackI, feedbackQ, trigOffset)
    Returns (ncoOut, new_state). float32 arithmetic like the C++.
    """
    f32 = np.float32
    kp = f32(norm_bandwidth) * f32(PLL_CP)
    ki = f32(norm_bandwidth) * f32(norm_bandwidth) * f32(PLL_CI)
    integ, phase, fbi, fbq, trig = (f32(v) for v in state)
    out = np.zeros(len(x), dtype=np.float32)
    for i in range(len(x)):
        error_i = f32(x[i]) * fbi
        error_q = f32(x[i]) * (-fbq)
        error_d = f32(np.arctan2(error_q, error_i))
        integ = f32(integ + ki * error_d)
        phase = f32(phase + kp * error_d + integ)
        trig = f32(trig + 1)
        trig_arg = f32(f32(2 * np.pi * (freq / fs)) * trig + phase)
        fbi = f32(np.cos(trig_arg))
        fbq = f32(np.sin(trig_arg))
        out[i] = f32(np.cos(trig_arg * f32(nco_scale) + f32(phase_adjust)))
    return out, (integ, phase, fbi, fbq, trig)


def pll(x: torch.Tensor, state: PLLState, *, freq: float, fs: float,
        nco_scale: float = 1.0, phase_adjust: float = 0.0,
        norm_bandwidth: float = 0.01, wrap_phase: bool = True,
        lag_correction: bool = True, unroll: int = 8):
    """The scan engine over block x (..., n): returns (nco (..., n) float32,
    new_state).  wrap_phase=False is the reference's trigOffset counter
    (compat_pll); lag_correction emits cos((trigArg - w0) * scale + adj),
    the loop's phase estimate for sample i, instead of the reference's
    one-sample lead.  A CPU tensor runs the plain loop, a CUDA tensor the
    sequential kernel, both with the exact atan2.
    `unroll` (the reference's scan unrolling) is accepted and has no
    effect."""
    if x.is_cuda:
        from sdr_tpu_torch.ops.cuda.pll_kernel import pll_loop
        return pll_loop(x, state, freq=freq, fs=fs, nco_scale=nco_scale,
                        phase_adjust=phase_adjust,
                        norm_bandwidth=norm_bandwidth, wrap_phase=wrap_phase,
                        lag_correction=lag_correction, exact=True)
    if x.device.type != "cpu":
        raise ValueError(f"no PLL kernel for device {x.device}")
    return _pll_plain(x, state, (freq, fs, nco_scale, phase_adjust,
                                 norm_bandwidth), wrap_phase, lag_correction)


def _pll_plain(x, state, params, wrap_phase, lag_correction,
               detect=torch.atan2):
    """pll as a loop over time, vectorised over channels, every operation
    rounded in the sequential kernel's order; `detect` is the phase
    detector (the kernel's plain version also takes the polynomial)."""
    lead, n, xr, st = state_rows(x, state)
    dev = x.device
    kp, ki, w0, wmod, scale, adj = (f32_scalar(v, dev)
                                    for v in loop_params(*params))
    integ, acc, fbi, fbq, trig = st.unbind(0)
    xt = xr.float().t().contiguous()            # (n, C): one row per step
    out = torch.empty_like(xt)
    for i in range(n):
        xi = xt[i]
        e = detect(xi * -fbq, xi * fbi)
        integ = integ + ki * e
        if wrap_phase:
            acc = torch.remainder(acc + w0 + kp * e + integ, wmod)
            arg = acc
        else:
            acc = acc + kp * e + integ
            trig = trig + 1.0
            arg = w0 * trig + acc
        fbi, fbq = torch.cos(arg), torch.sin(arg)
        out[i] = torch.cos((arg - w0 if lag_correction else arg) * scale
                           + adj)
    new = PLLState(*(v.reshape(lead) for v in (integ, acc, fbi, fbq, trig)))
    return out.t().reshape(*lead, n), new


def pll_chunked(x: torch.Tensor, state: PLLState, *, freq: float,
                fs: float, nco_scale: float = 1.0, phase_adjust: float = 0.0,
                norm_bandwidth: float = 0.01, lag_correction: bool = True,
                chunk: int = 16):
    """The frozen-feedback engine over block x (..., n), n a multiple of
    chunk: returns (nco (..., n) float32, new_state).  The feedback is
    extrapolated open-loop over each chunk, and the chunk's PI updates are
    exact given its errors (an O((chunk*bw)^2) phase error).  The new
    state's feedback is (cos, sin) of the carried phase; trig_offset
    passes through.  A CUDA tensor runs the chunked kernel with the exact
    atan2."""
    n = x.shape[-1]
    if n % chunk:
        raise ValueError(f"block length {n} % chunk {chunk} != 0")
    params = (freq, fs, nco_scale, phase_adjust, norm_bandwidth)
    if x.is_cuda:
        from sdr_tpu_torch.ops.cuda.pll_kernel import pll_chunked_loop
        (nco,), (new,) = pll_chunked_loop(
            (x,), (state,), params=(params,), chunk=chunk,
            lag_correction=lag_correction, exact=True)
        return nco, new
    if x.device.type != "cpu":
        raise ValueError(f"no PLL kernel for device {x.device}")
    return _pll_chunked_plain(x, state, params, chunk, lag_correction)


def _pll_chunked_plain(x, state, params, chunk, lag_correction):
    """pll_chunked in the reference's XLA form: a loop over chunks,
    vectorised over channels and the chunk's samples."""
    lead, n, xr, st = state_rows(x, state)
    dev = x.device
    kp, ki, w0, wmod, scale, adj = (f32_scalar(v, dev)
                                    for v in loop_params(*params))
    j = torch.arange(1, chunk + 1, dtype=torch.float32, device=dev)
    xr = xr.float()
    integ, acc = st[0, :, None], st[1, :, None]
    out = torch.empty_like(xr)
    for b in range(0, n, chunk):
        xc = xr[:, b:b + chunk]
        # open-loop prediction at the current frequency estimate; e_i is
        # measured against the previous sample's phase
        pred = acc + (j - 1.0) * (w0 + integ)
        e = torch.atan2(xc * -torch.sin(pred), xc * torch.cos(pred))
        ce = torch.cumsum(e, dim=-1)
        integ_i = integ + ki * ce
        acc_i = acc + j * w0 + kp * ce + torch.cumsum(integ_i, dim=-1)
        arg = acc_i - w0 if lag_correction else acc_i
        out[:, b:b + chunk] = torch.cos(arg * scale + adj)
        integ, acc = integ_i[:, -1:], torch.remainder(acc_i[:, -1:], wmod)
    integ, acc = integ[:, 0], acc[:, 0]
    new = PLLState(integ.reshape(lead), acc.reshape(lead),
                   torch.cos(acc).reshape(lead), torch.sin(acc).reshape(lead),
                   state.trig_offset)
    return out.reshape(*lead, n), new
