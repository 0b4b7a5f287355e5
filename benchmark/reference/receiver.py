"""Plain float64 reference of the stereo (+ RDS) FM receiver with the
feedforward carrier estimator, the chain both benchmark configurations run.

Written from the reference design (COE3DY4 spec; the C++ reference's
src/project.cpp and src/filter.cpp), in straightforward PyTorch on whole
chunks of a stream, with its own taps and state:

  u8 IQ -> (x - 128)/128 -> LPF 100 kHz, /10 -> discriminator -> fm
  fm -> BPF 22-54 kHz (channel), BPF 18.5-19.5 kHz (pilot),
        BPF 54-60 kHz (RDS channel) -> squared -> BPF 113.5-114.5 kHz
  carriers: per window of 256 IF samples, Z = mean(x e^{-j ramp}) against
        the nominal carrier ramp, phi = atan2(Z), unwrapped; the NCO is
        cos((ramp + phi + slope * rel) * scale), piecewise linear in each
        window (scale 2 for the 38 kHz stereo carrier, 1/2 for 57 kHz)
  stereo: mixed = 2 channel nco38 -> LPF 16 kHz /5; mono = LPF 16 kHz /5
        of fm, delayed 5 samples; left, right = (mono +- stereo) / 2
  RDS:  2 nco57 (RDS channel delayed 25) -> LPF 3 kHz at 19/120 -> RRC

Every stage is causal and carries its inputs' tails, so chunks of any
aligned size give the same outputs as one call.  The ramps are exact:
integer sample counters, reduced modulo the carrier's period as rationals.

`precision` maps a stage to the number format it is computed in; stages
absent from it are exact.  It exists for the control: the chain computed
one format below what a configuration states (see `lower`).  Stages:
  frontend_taps  the RF LPF taps ('int8', 'int4', 'bf16', 'fp8')
  fm             the discriminator's output stream
  if_fir         the band-pass stages' operands (signal and taps)
  if_out         the band-pass stages' output streams
  mixed          the mixed streams (stereo mixed, RDS baseband)
  audio_fir      the audio resampler's operands
  rds_fir        the RDS resampler's and the RRC's operands
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import firdes
from benchmark.reference.modes import MODES

# one format below each stated one: the control's formats
LOWER = {"f64": "f32", "f32": "bf16", "bf16": "fp8", "fp16": "fp8",
         "int8": "int4", "fp8": "int4"}
# significant bits (implicit bit included) of the float formats
MANTISSA_BITS = {"f32": 24, "bf16": 8, "fp16": 11, "fp8": 4}
INT_LEVELS = {"int8": 127, "int4": 7}


def lower(precision: dict) -> dict:
    """The control's precision: each stated stage one format lower."""
    return {k: LOWER[v] for k, v in precision.items()}


def round_to(x: torch.Tensor, fmt: str | None) -> torch.Tensor:
    """x rounded to `fmt`'s significant bits (round half to even), its
    exponent unbounded: the most generous form of that format.  None or
    'f64' leaves x as it is; integer formats are for taps (`quantize`)."""
    if fmt is None or fmt == "f64":
        return x
    bits = float(1 << MANTISSA_BITS[fmt])
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * bits) / bits, e)


def quantize_taps(h: np.ndarray, fmt: str | None) -> np.ndarray:
    """Taps in `fmt`: integer formats scale to the largest tap (the
    symmetric quantization of an integer engine), float formats round."""
    h = np.asarray(h, np.float64)
    if fmt in INT_LEVELS:
        levels = INT_LEVELS[fmt]
        sc = np.abs(h).max() / levels
        return np.clip(np.round(h / sc), -levels, levels) * sc
    return round_to(torch.from_numpy(h), fmt).numpy()


def fir(x, tail, h, down: int = 1):
    """Causal FIR over chunk x (k, n) with the last len(h)-1 inputs of the
    previous chunk: y[j] = sum_i h[i] x[j*down - i].  (y, new tail)."""
    xp = torch.cat([tail, x], dim=-1)
    y = F.conv1d(xp[:, None], h.flip(0)[None, None], stride=down)[:, 0]
    return y, xp[:, xp.shape[-1] - tail.shape[-1]:]


def resample(x, tail, h, up: int, down: int):
    """Rational resampler: zero-stuff by `up`, filter with h, keep every
    `down`-th output: y[n] = sum_{k = nD mod U (mod U)} h[k] x[(nD-k)/U].
    Output n = u*U + v reads x[u*D + d_v - m] with tap r_v + m*U, where
    r_v = vD mod U and d_v = vD div U.  tail: the last ceil((T-1)/U)
    inputs.  (y, new tail)."""
    n = x.shape[-1]
    s = tail.shape[-1]
    xp = torch.cat([tail, x], dim=-1)
    outs = []
    for v in range(up):
        r, d = (v * down) % up, (v * down) // up
        g = h[r::up]                              # taps r + m U, m = 0..M-1
        start = s + d - (len(g) - 1)
        seg = xp[:, start:start + (n // down - 1) * down + len(g)]
        outs.append(F.conv1d(seg[:, None], g.flip(0)[None, None],
                             stride=down)[:, 0])
    y = torch.stack(outs, dim=-1).reshape(x.shape[0], -1)
    return y, xp[:, xp.shape[-1] - s:]


class Carrier:
    """Feedforward carrier estimate and NCO over a stream (module doc)."""

    def __init__(self, freq: float, fs: float, scale: float, window: int,
                 k: int, device):
        ratio = Fraction(int(freq), int(fs))
        period = Fraction(scale).limit_denominator(64).denominator
        self.num, self.den = ratio.numerator, ratio.denominator
        self.mod = period * self.den               # ramp period, in 1/den
        self.wmod = 2.0 * np.pi * period
        self.scale, self.window = float(scale), int(window)
        self.index = 0                             # stream samples so far
        self.acc = torch.zeros(k, dtype=torch.float64, device=device)

    def __call__(self, x):
        k, n = x.shape
        w = self.window
        i = torch.arange(self.index, self.index + n, device=x.device)
        ramp = (2.0 * np.pi / self.den) * ((self.num * i) % self.mod
                                           ).to(torch.float64)
        xw = x.reshape(k, n // w, w)
        rw = ramp.reshape(n // w, w)
        zr = (xw * torch.cos(rw)).mean(-1)
        zi = (-xw * torch.sin(rw)).mean(-1)
        phi = torch.atan2(zi, zr)
        prev = torch.cat([self.acc[:, None], phi[:, :-1]], dim=-1)
        d = phi - prev
        d = d - 2.0 * np.pi * torch.round(d / (2.0 * np.pi))
        track = self.acc[:, None] + torch.cumsum(d, dim=-1)
        rel = (torch.arange(w, device=x.device, dtype=torch.float64)
               - (w - 1) / 2.0)
        theta = rw + track[..., None] + (d / w)[..., None] * rel
        self.acc = torch.remainder(track[:, -1], self.wmod)
        self.index += n
        return torch.cos(theta * self.scale).reshape(k, n)


class RefReceiver:
    """The reference over k stations: `process(u8 (k, n))` -> outputs
    {'mono', 'left', 'right'[, 'rds_soft']} float64, carrying its state.
    n must be a whole number of 256-sample carrier windows at the IF rate,
    and of the RDS resampler's 120-sample input groups."""

    def __init__(self, mode: int, k: int, *, rds: bool = False,
                 precision: dict | None = None,
                 window: int = 256, rds_rrc_taps: int = 151,
                 device: torch.device | str = "cpu"):
        cfg = MODES[mode]
        if cfg.audio_interp != 1:
            raise ValueError(f"mode {mode}: this reference's audio path "
                             "only decimates (audio_interp 1)")
        self.cfg, self.k, self.rds = cfg, k, rds
        self.prec = dict(precision or {})
        self.device = torch.device(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        q = self.prec.get

        def taps(h, fmt=None):
            return torch.tensor(quantize_taps(h, fmt), **f64)

        fs_if = cfg.if_fs
        self.rf_h = taps(firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps),
                         q("frontend_taps"))
        bands = [(cfg.stereo_lo, cfg.stereo_hi), (cfg.pilot_lo, cfg.pilot_hi)]
        if rds:
            bands.append((cfg.rds_lo, cfg.rds_hi))
        self.bpf = [taps(firdes.bandpass(fs_if, lo, hi, cfg.bp_taps),
                         q("if_fir")) for lo, hi in bands]
        self.audio_h = taps(firdes.lowpass(fs_if * cfg.audio_interp,
                                           cfg.audio_fc, cfg.audio_taps,
                                           cfg.audio_gain), q("audio_fir"))
        z = lambda m: torch.zeros(k, m, **f64)     # noqa: E731
        self.st = {"i": z(cfg.rf_taps - 1), "q": z(cfg.rf_taps - 1),
                   "prev": z(2), "bpf": z(cfg.bp_taps - 1),
                   "mono": z(cfg.audio_taps - 1),
                   "stereo": z(cfg.audio_taps - 1),
                   "delay": z(cfg.mono_delay)}
        self.pilot = Carrier(cfg.pilot_freq, fs_if, 2.0, window, k,
                             self.device)
        if rds:
            u, d = cfg.rds_resample
            self.rds_ud = (u, d)
            self.carr_h = taps(firdes.bandpass(fs_if, cfg.rds_carrier_lo,
                                               cfg.rds_carrier_hi,
                                               cfg.bp_taps), q("if_fir"))
            self.rds_h = taps(firdes.lowpass(fs_if * u, cfg.rds_fc,
                                             cfg.bp_taps * u, u),
                              q("rds_fir"))
            self.rrc_h = taps(firdes.root_raised_cosine(
                cfg.rds_fs, rds_rrc_taps, cfg.rds_symbol_rate), q("rds_fir"))
            self.st.update(carr=z(cfg.bp_taps - 1),
                           rds_delay=z((cfg.bp_taps - 1) // 2),
                           rds_lpf=z(-(-(len(self.rds_h) - 1) // u)),
                           rrc=z(rds_rrc_taps - 1))
            self.rds_carrier = Carrier(cfg.rds_carrier_freq, fs_if, 0.5,
                                       window, k, self.device)

    def _r(self, stage, x):
        return round_to(x, self.prec.get(stage))

    def process(self, u8: torch.Tensor) -> dict[str, torch.Tensor]:
        cfg, st, r = self.cfg, self.st, self._r
        x = (u8.to(self.device, torch.float64) - 128.0) / 128.0
        i_ds, st["i"] = fir(x[:, 0::2], st["i"], self.rf_h, cfg.rf_decim)
        q_ds, st["q"] = fir(x[:, 1::2], st["q"], self.rf_h, cfg.rf_decim)
        # discriminator (I dQ - Q dI) / (I^2 + Q^2), previous sample carried
        i_prev = torch.cat([st["prev"][:, :1], i_ds[:, :-1]], dim=-1)
        q_prev = torch.cat([st["prev"][:, 1:], q_ds[:, :-1]], dim=-1)
        num = i_ds * (q_ds - q_prev) - q_ds * (i_ds - i_prev)
        den = i_ds * i_ds + q_ds * q_ds
        fm = torch.where(den == 0.0, 0.0,
                         num / torch.where(den == 0.0, 1.0, den))
        st["prev"] = torch.stack([i_ds[:, -1], q_ds[:, -1]], dim=-1)
        fm = r("fm", fm)

        # band-pass stages at the IF rate
        fm_in = r("if_fir", fm)
        xp = torch.cat([st["bpf"], fm_in], dim=-1)
        bands = [fir(fm_in, st["bpf"], h)[0] for h in self.bpf]
        st["bpf"] = xp[:, xp.shape[-1] - st["bpf"].shape[-1]:]
        channel, pilot = r("if_out", bands[0]), r("if_out", bands[1])
        mixed = r("mixed", 2.0 * channel * self.pilot(pilot))

        # audio: mono and the stereo difference through one LPF, /5
        mono, st["mono"] = fir(r("audio_fir", fm), st["mono"], self.audio_h,
                               cfg.audio_decim)
        diff, st["stereo"] = fir(r("audio_fir", mixed), st["stereo"],
                                 self.audio_h, cfg.audio_decim)
        shifted = torch.cat([st["delay"], mono], dim=-1)
        st["delay"] = shifted[:, mono.shape[-1]:]
        shifted = shifted[:, :mono.shape[-1]]
        out = {"mono": mono, "left": (shifted + diff) * 0.5,
               "right": (shifted - diff) * 0.5}
        if self.rds:
            out["rds_soft"] = self._rds(r("if_out", bands[2]))
        return out

    def _rds(self, chan):
        st, r = self.st, self._r
        square = r("if_fir", chan * chan)
        carrier_in, st["carr"] = fir(square, st["carr"], self.carr_h)
        nco = self.rds_carrier(r("if_out", carrier_in))
        delayed = torch.cat([st["rds_delay"], chan], dim=-1)
        st["rds_delay"] = delayed[:, chan.shape[-1]:]
        base = r("mixed", 2.0 * nco * delayed[:, :chan.shape[-1]])
        u, d = self.rds_ud
        res, st["rds_lpf"] = resample(r("rds_fir", base), st["rds_lpf"],
                                      self.rds_h, u, d)
        soft, st["rrc"] = fir(r("rds_fir", res), st["rrc"], self.rrc_h)
        return soft


def build(config: dict, k: int, *, precision: dict | None = None,
          device: torch.device | str = "cpu") -> RefReceiver:
    """The reference of a configuration that names `receiver` (see
    harness.py): its mode, RDS where it lists `rds_soft` among its
    outputs, computed in `precision` (exact where None)."""
    return RefReceiver(config["mode"], k,
                       rds="rds_soft" in config["outputs"],
                       precision=precision, device=device)
