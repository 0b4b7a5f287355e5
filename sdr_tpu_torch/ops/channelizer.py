"""Wideband channelizer: one wide IQ capture -> K FM station basebands.

Port of sdr_tpu/ops/channelizer.py.  One antenna stream at a wideband
rate is mixed down, low-pass filtered and decimated once per station.
Three engines, mathematically identical (selected via ``engine=``):

``"mfb"`` -- *modulated filter bank*.  The per-station mix folds into the
filter: with oscillator theta(n) = phi0 + dphi*(n+1) and LPF h,

    y[u] = e^{j theta(uD)} * sum_k (h[k] e^{-j dphi k}) * x[uD-k]

so each station is a complex band-pass filter applied to the raw wideband
stream and decimated in the same pass: one (2K x 2*D*n_shift) matrix
against the im2col of the interleaved stream, then a rotation at the
output rate from factored host-f64 phasor tables.  The product is a plain
`torch.matmul`, as the reference leaves it to XLA; this is the CPU engine.

``"pallas"`` -- the same im2col product and rotation as one hand-written
CUDA kernel (ops/cuda/channelizer_kernel.py, csrc/channelizer.cu), the
port of the reference's Pallas kernel.  The name is kept for parity.

``"mix"`` -- the v1 formulation: per-station wideband rotation (K, N)
followed by the port's polyphase decimating LPF on each rail; the oracle
of the other two.

Each engine carries the oscillator phase and a filter tail across blocks,
so block streaming is exact: mfb an interleaved float32 tail of
2*(taps-1) decoded scalars, mix the resamplers' tails, pallas the raw
(2D, 128) columns in the ingest dtype.  fs_wide must be an integer
multiple of fs_out.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.firdes import lowpass
from sdr_tpu_torch.ops.resample import PolyphaseResampler

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_TWO_PI = 2.0 * np.pi


class WidebandChannelizer:
    """Mix + LPF + decimate K stations out of one wideband complex stream.

    Args (as sdr_tpu's WidebandChannelizer):
      fs_wide: wideband sample rate (e.g. 9.6e6).
      fs_out: per-station output rate (e.g. 2.4e6, the mode-0 RF rate).
      station_freqs: center-frequency offsets (Hz, relative to the
        wideband capture center) of the stations.
      cutoff: anti-alias LPF cutoff (default 100 kHz, the FM channel).
      taps: LPF taps at the wideband rate.
      engine: "mfb" (default), "pallas" (the CUDA kernel) or "mix".
      compute_dtype: "f32" or "bf16" -- the mfb and pallas products take
        bf16-rounded samples and filters and accumulate in float32.
      ingest: "f32" | "u8", the raw-stream dtype of the pallas engine's
        carried tail (it must match the blocks fed to it).
      tile: the pallas engine's phasor-table tile (output samples).
      out_dtype: "f32" | "bf16", the pallas engine's output dtype.
      device: where the tables and the state live (default cuda).
    """

    def __init__(self, fs_wide: float, fs_out: float,
                 station_freqs: list[float], *, cutoff: float = 100e3,
                 taps: int = 101, engine: str = "mfb",
                 compute_dtype: str = "f32", ingest: str = "f32",
                 tile: int = 4096, out_dtype: str = "f32",
                 device: torch.device | str = "cuda"):
        decim = fs_wide / fs_out
        if abs(decim - round(decim)) >= 1e-9:
            raise ValueError(f"fs_wide/fs_out = {decim} must be integral")
        if engine not in ("mfb", "mix", "pallas"):
            raise ValueError(f"engine {engine!r}")
        if compute_dtype not in _DTYPES or out_dtype not in _DTYPES:
            raise ValueError("compute_dtype and out_dtype are 'f32' or "
                             "'bf16'")
        self.decim = int(round(decim))
        self.fs_wide = float(fs_wide)
        self.fs_out = float(fs_out)
        self.freqs = np.asarray(station_freqs, np.float64)
        self.k = len(station_freqs)
        self.cutoff = float(cutoff)
        self.engine = engine
        self.taps = int(taps)
        self.device = torch.device(device)
        self.compute_dtype = _DTYPES[compute_dtype]
        coeff = lowpass(fs_wide, cutoff, taps, 1)
        # per-station phase increment per wideband sample (float64 on the
        # host; the per-block ramps are reduced mod 2*pi in f64 before the
        # cast to float32)
        self._dphi = (-_TWO_PI * self.freqs / fs_wide) % _TWO_PI
        self._ramp_cache: dict = {}
        self._dev_cache: dict = {}
        self.state_len = self.taps - 1
        if engine == "mix":
            self._lpf_i = PolyphaseResampler(coeff, 1, self.decim,
                                             device=self.device)
            self._lpf_q = PolyphaseResampler(coeff, 1, self.decim,
                                             device=self.device)
        elif engine == "pallas":
            from sdr_tpu_torch.ops.cuda.channelizer_kernel import PallasMFB
            self._pl = PallasMFB(
                coeff, self._dphi, self.decim, tile=tile,
                compute_dtype=self.compute_dtype, ingest=ingest,
                out_dtype=_DTYPES[out_dtype], device=self.device)
        else:
            rhs = _modulated_bank(np.asarray(coeff, np.float64), self._dphi)
            # im2col GEMM: B[2l+r, c] = rhs[c, r, l] maps the bank onto
            # interleaved window rows, padded to a multiple of the 2D
            # phase stride (the extra rows are zeros)
            self._n_shift = -(-2 * self.taps // (2 * self.decim))
            rows = 2 * self.decim * self._n_shift
            b = np.zeros((rows, 2 * self.k), np.float32)
            for l in range(self.taps):
                b[2 * l, :] = rhs[:, 0, l]
                b[2 * l + 1, :] = rhs[:, 1, l]
            self._bmat = b
            # (2K, rows), rounded to the compute dtype, multiplied in f32
            self._bmt = torch.from_numpy(np.ascontiguousarray(b.T)).to(
                self.compute_dtype).to(device=self.device,
                                       dtype=torch.float32)

    def _phase_tables(self, n: int, stride: int, c: int | None = None):
        """`phase_tables` of this channelizer's stations, cached."""
        if c is None:
            c = min(n, 4096)
        key = (n, stride, c)
        if key not in self._ramp_cache:
            self._ramp_cache[key] = phase_tables(self._dphi, n, stride, c)
        return self._ramp_cache[key]

    def _device_tables(self, n: int, stride: int, c: int | None = None):
        """_phase_tables as float32 tensors on the device, cached: a copy
        from the host on every block would make the host wait for the
        device."""
        key = (n, stride, c)
        if key not in self._dev_cache:
            (rr, ri), (br, bi), adv = self._phase_tables(n, stride, c)
            t = lambda x: torch.from_numpy(x).to(self.device)  # noqa: E731
            self._dev_cache[key] = ((t(rr), t(ri)), (t(br), t(bi)), t(adv))
        return self._dev_cache[key]

    def init_state(self) -> dict[str, torch.Tensor]:
        if self.engine == "mix":
            return {
                "phase": torch.zeros((self.k,), dtype=torch.float32,
                                     device=self.device),
                "i_tail": self._lpf_i.init_state((self.k,)),
                "q_tail": self._lpf_q.init_state((self.k,)),
            }
        if self.engine == "pallas":
            return self._pl.init_state()
        # mfb: one carried INTERLEAVED f32 tail (last 2*(taps-1) scalars)
        return {
            "phase": torch.zeros((self.k,), dtype=torch.float32,
                                 device=self.device),
            "tail": torch.zeros((2 * self.state_len,), dtype=torch.float32,
                                device=self.device),
        }

    def __call__(self, i_wide: torch.Tensor, q_wide: torch.Tensor, state):
        """Channelize one wideband block (N,) -> per-station I/Q (K, N/D).

        Returns ((i_out, q_out), new_state).
        """
        if self.engine == "mix":
            row, base, adv = self._device_tables(i_wide.shape[-1], 1)
            return _channelize(row, base, adv, self._lpf_i, self._lpf_q,
                               i_wide, q_wide, state)
        body = torch.stack([i_wide, q_wide], dim=-1).reshape(-1)
        if self.engine == "pallas":
            return self._pl(body, state)
        return self._mfb_interleaved(body, state)

    def call_interleaved(self, wide: torch.Tensor, state):
        """Channelize directly from the raw interleaved stream (2N,),
        float32 or u8 ((x-128)/128, reference src/iofunc.cpp:62-69,
        decoded exactly inside the compute cast)."""
        if self.engine == "pallas":
            return self._pl(wide, state)
        if self.engine != "mfb":
            raise ValueError("interleaved ingest is an mfb/pallas feature")
        return self._mfb_interleaved(wide, state)

    def _mfb_interleaved(self, body: torch.Tensor, state):
        n_out = body.shape[-1] // 2 // self.decim
        # the reference's time tile doubles as the phasor factor c, so a
        # tile's rotation is one complex scalar per station times base
        tile = _largest_divisor_at_most(n_out, 16384)
        row, base, adv = self._device_tables(n_out, self.decim, tile)
        return _channelize_mfb(self._bmt, row, base, adv, self.decim,
                               self.state_len, self._n_shift,
                               self.compute_dtype, body, state)


def _modulated_bank(coeff: np.ndarray, dphi: np.ndarray) -> np.ndarray:
    """(2K, 2, taps) conv rhs of complex band-pass filters, f64 -> f32.

    Station k's filter is h~[t] = h[t] * e^{-j dphi_k t}.  Channel layout
    (correlation over xp = tail ++ x, so index l maps to filter tap
    taps-1-l):
      out 2k   (real): in0 (I) = Re h~ reversed, in1 (Q) = -Im h~ reversed
      out 2k+1 (imag): in0 (I) = Im h~ reversed, in1 (Q) =  Re h~ reversed
    """
    taps = len(coeff)
    k = len(dphi)
    t = np.arange(taps, dtype=np.float64)
    ang = (dphi[:, None] * t[None, :]) % _TWO_PI    # (K, taps)
    hr = coeff[None, :] * np.cos(ang)
    hi = coeff[None, :] * -np.sin(ang)
    rhs = np.empty((2 * k, 2, taps), np.float32)
    rhs[0::2, 0, :] = hr[:, ::-1]
    rhs[0::2, 1, :] = -hi[:, ::-1]
    rhs[1::2, 0, :] = hi[:, ::-1]
    rhs[1::2, 1, :] = hr[:, ::-1]
    return rhs


def phase_tables(dphi: np.ndarray, n: int, stride: int, c: int):
    """Factored oscillator ramp for n samples taken every `stride`
    wideband samples: theta[k, i] = dphi_k*(i*stride + 1) mod 2pi,
    with i = a*C + b, as host float64 tables cast to float32:
        row[k, a]  = dphi_k * (C*stride*a)   mod 2pi      (K, n/C)
        base[k, b] = dphi_k * (b*stride + 1) mod 2pi      (K, C)
    as (cos, sin) pairs, and the (K,) per-block phase advance
    dphi_k*n*stride mod 2pi.  c need not divide n: a is padded to
    ceil(n/c) and the composed phasor is sliced back to n."""
    a = -(-n // c)
    row = (dphi[:, None]
           * (np.arange(a, dtype=np.float64) * (c * stride))[None, :]
           ) % _TWO_PI
    base = (dphi[:, None]
            * (np.arange(c, dtype=np.float64) * stride + 1.0)[None, :]
            ) % _TWO_PI
    adv = (dphi * (n * stride)) % _TWO_PI
    j = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return ((j(np.cos(row)), j(np.sin(row))),
            (j(np.cos(base)), j(np.sin(base))), j(adv))


def _compose_phasor(phase, row, base, n):
    """(cos, sin) of theta[k, i] = phase_k + row_[k,a] + base_[k,b] with
    i = a*C + b, without per-element trig: e^{j phase} (K trig calls)
    times the outer product of the two small phasor tables (K, A) x (K, C),
    sliced to the first n."""
    (rr, ri), (br, bi) = row, base
    k, a = rr.shape
    c = br.shape[1]
    er = (rr[:, :, None] * br[:, None, :]
          - ri[:, :, None] * bi[:, None, :]).reshape(k, a * c)[:, :n]
    ei = (rr[:, :, None] * bi[:, None, :]
          + ri[:, :, None] * br[:, None, :]).reshape(k, a * c)[:, :n]
    pr, pi = torch.cos(phase)[:, None], torch.sin(phase)[:, None]
    return pr * er - pi * ei, pr * ei + pi * er


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return n


def _advance(phase: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """(phase + adv) mod 2pi in float32, the floor modulo of jnp.mod."""
    return torch.remainder(phase + adv,
                           torch.full((), _TWO_PI, dtype=torch.float32,
                                      device=phase.device))


def _channelize_mfb(bmt, row, base, adv, decim, state_len, n_shift,
                    compute_dtype, body, state):
    """MFB channelizer as an im2col GEMM with the rotation per tile.

    With window row j = 2*D*s + d, out[c, u] = sum_j B[j, c] * xb[2*D*u + j]
    over xb = tail ++ body; the tile's phasor is (phase + row[a]) times
    base.  u8 input decodes exactly in the compute dtype."""
    n2 = body.shape[-1]
    n = n2 // 2
    if n % decim or n < state_len:
        raise ValueError(f"block length {n} must be divisible by D={decim} "
                         f"and at least {state_len}")
    n_out = n // decim
    two_d = 2 * decim
    if body.dtype == torch.uint8:
        body_c = (body.to(compute_dtype) - 128.0) * (1.0 / 128.0)
        tail_new = (body[n2 - 2 * state_len:].to(torch.float32) - 128.0
                    ) / 128.0
    else:
        body_c = body.to(compute_dtype)
        tail_new = body[n2 - 2 * state_len:].to(torch.float32).clone()
    xb = torch.cat([state["tail"].to(compute_dtype), body_c])
    need = two_d * (n_out + n_shift)
    xb = (torch.nn.functional.pad(xb, (0, need - xb.shape[-1]))
          if need > xb.shape[-1] else xb[:need])
    # im2col: window u is xb[2D*u : 2D*(u + n_shift)]
    xim = xb.to(torch.float32).unfold(0, two_d * n_shift, two_d)[:n_out]
    out = torch.matmul(bmt, xim.T)                      # (2K, n_out)
    c_r, c_i = out[0::2], out[1::2]
    k = c_r.shape[0]
    (rr, ri), (br, bi) = row, base                      # (K, A), (K, tile)
    pr = torch.cos(state["phase"])[:, None]
    pi = torch.sin(state["phase"])[:, None]
    sr = (pr * rr - pi * ri)[:, :, None]                # tile start phasor
    si = (pr * ri + pi * rr)[:, :, None]
    cos_t = (sr * br[:, None, :] - si * bi[:, None, :]).reshape(k, n_out)
    sin_t = (sr * bi[:, None, :] + si * br[:, None, :]).reshape(k, n_out)
    i_out = c_r * cos_t - c_i * sin_t
    q_out = c_r * sin_t + c_i * cos_t
    return (i_out, q_out), {"phase": _advance(state["phase"], adv),
                            "tail": tail_new}


def _channelize(row, base, adv, lpf_i, lpf_q, i_wide, q_wide, state):
    """The mix engine: oscillator theta[k, t] = phase_k + dphi_k*(t+1) as
    phasors, complex rotation, then each rail's decimating LPF."""
    cos_t, sin_t = _compose_phasor(state["phase"], row, base,
                                   i_wide.shape[-1])
    x_i = i_wide[None, :]
    x_q = q_wide[None, :]
    mix_i = x_i * cos_t - x_q * sin_t
    mix_q = x_i * sin_t + x_q * cos_t
    i_out, i_tail = lpf_i(mix_i, state["i_tail"])
    q_out, q_tail = lpf_q(mix_q, state["q_tail"])
    return (i_out, q_out), {"phase": _advance(state["phase"], adv),
                            "i_tail": i_tail, "q_tail": q_tail}


def synthesize_wideband(station_captures_iq: list[np.ndarray],
                        station_freqs: list[float], fs_station: float,
                        fs_wide: float) -> tuple[np.ndarray, np.ndarray]:
    """TX-side helper: place per-station complex basebands (I+jQ float
    arrays at fs_station) at offsets in one wideband stream (numpy +
    scipy on the host, for tests and the smoke test)."""
    import scipy.signal as sps
    from fractions import Fraction
    up = Fraction(int(fs_wide), int(fs_station))
    outs = []
    for x, f in zip(station_captures_iq, station_freqs):
        xw = sps.resample_poly(x, up.numerator, up.denominator)
        t = np.arange(len(xw)) / fs_wide
        outs.append(xw * np.exp(2j * np.pi * f * t))
    wide = np.sum(outs, axis=0)
    return wide.real.astype(np.float32), wide.imag.astype(np.float32)
