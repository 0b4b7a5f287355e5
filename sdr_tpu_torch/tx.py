"""FM broadcast transmitter: synthesizes u8 IQ captures for validation.

Copy of sdr_tpu/tx.py (importing sdr_tpu pulls in jax, which the GPU
machine does not have); tests/test_torch_host_copies.py pins the two.

The reference repo's acceptance inputs (samples0-9.raw etc.) are stripped
from the mount (SURVEY §4.2), so this framework validates itself against a
spec-faithful *transmit* side: build the FM stereo multiplex (spec Figs 4-8)
plus the 57 kHz RDS subcarrier (spec Figs 9-14), frequency-modulate, and
quantize to the RTL-SDR u8 interleaved IQ format the receiver ingests.
This is the same golden-file methodology as the reference (model outputs
gate the implementation, spec p.5) with the model on the TX side.

Host-side NumPy in float64: runs once per test/bench, precision matters more
than speed here.

Multiplex composition (ITU-R BS.450 / spec p.8):
  m(t) =  a_mono * (L+R)/2
        + a_pilot * cos(2*pi*19k*t)
        + a_stereo * (L-R)/2 * cos(2*pi*38k*t)   [DSB-SC, 2x pilot phase]
        + a_rds * r(t) * cos(2*pi*57k*t)          [BPSK, 3x pilot phase]
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps

from sdr_tpu_torch.config import ModeConfig

PILOT_FREQ = 19_000.0


def fm_modulate(mpx: np.ndarray, fs: float, kf: float = 75_000.0,
                phase0: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Frequency-modulate a multiplex baseband into unit-modulus I/Q.

    The receiver discriminator then recovers 2*pi*kf*m(t)/if_fs; with the
    standard 75 kHz deviation and a |m|<=1 multiplex this lands in the same
    +-2 range the reference golden models scale by (x/2)*32767
    (model/fmMonoBlock.py:297).
    """
    phase = phase0 + 2.0 * np.pi * kf * np.cumsum(mpx) / fs
    return np.cos(phase), np.sin(phase)


def to_u8_iq(i: np.ndarray, q: np.ndarray, amplitude: float = 0.9,
             dither: np.random.Generator | None = None) -> np.ndarray:
    """Pack I/Q into interleaved u8 with the inverse of the receiver's
    (x-128)/128 normalization (src/iofunc.cpp:67)."""
    iq = np.empty(2 * len(i), dtype=np.float64)
    iq[0::2] = i
    iq[1::2] = q
    scaled = iq * amplitude * 128.0 + 128.0
    if dither is not None:
        scaled = scaled + dither.uniform(-0.5, 0.5, size=scaled.shape)
    return np.clip(np.round(scaled), 0, 255).astype(np.uint8)


def make_multiplex(fs: float, n: int, *,
                   left: np.ndarray | None = None,
                   right: np.ndarray | None = None,
                   mono: np.ndarray | None = None,
                   rds_baseband: np.ndarray | None = None,
                   a_mono: float = 0.45, a_pilot: float = 0.1,
                   a_stereo: float = 0.45, a_rds: float = 0.05,
                   pilot_phase: float = 0.0,
                   mpx_phase_noise: np.ndarray | None = None) -> np.ndarray:
    """Compose the FM stereo multiplex at sample rate fs.

    All component signals must already be at rate fs and length n.
    Pass `mono` for a mono-only broadcast (no pilot) or left/right for
    stereo (pilot + DSB-SC).  The 38 kHz and 57 kHz subcarriers are phase
    locked to the pilot (2x and 3x), as broadcast practice and the spec's
    squaring/PLL recovery assume.  `mpx_phase_noise` (radians, per sample)
    perturbs the shared reference phase — it scales 2x/3x onto the
    subcarriers exactly as a real exciter's oscillator noise does.
    """
    t = np.arange(n) / fs
    m = np.zeros(n)
    if mono is not None:
        m += a_mono * mono
    phase_noise = mpx_phase_noise if mpx_phase_noise is not None else 0.0
    if left is not None or right is not None:
        left = left if left is not None else np.zeros(n)
        right = right if right is not None else np.zeros(n)
        theta = 2 * np.pi * PILOT_FREQ * t + pilot_phase + phase_noise
        m += a_mono * (left + right) / 2
        m += a_pilot * np.cos(theta)
        m += a_stereo * ((left - right) / 2) * np.cos(2 * theta)
    if rds_baseband is not None:
        theta = 2 * np.pi * PILOT_FREQ * t + pilot_phase + phase_noise
        m += a_rds * rds_baseband * np.cos(3 * theta)
    return m


def upsample_audio(audio: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    """Polyphase-resample a baseband audio signal up to the RF rate."""
    from fractions import Fraction
    frac = Fraction(int(fs_out), int(fs_in))
    return sps.resample_poly(audio, frac.numerator, frac.denominator)


def synthesize_capture(cfg: ModeConfig, *, seconds: float = 1.0,
                       left: np.ndarray | None = None,
                       right: np.ndarray | None = None,
                       mono: np.ndarray | None = None,
                       rds_baseband: np.ndarray | None = None,
                       kf: float = 75_000.0, amplitude: float = 0.9,
                       noise_db: float | None = None,
                       cfo_hz: float = 0.0,
                       clock_ppm: float = 0.0,
                       pilot_linewidth_hz: float = 0.0,
                       seed: int = 0, **mpx_kwargs) -> np.ndarray:
    """End-to-end: multiplex -> FM -> u8 IQ capture at cfg.rf_fs.

    Component signals are given at cfg.rf_fs (use `upsample_audio` or
    generate tones directly at RF rate).  Returns interleaved u8 of length
    2*seconds*rf_fs rounded down to a whole number of receiver blocks.

    Real-capture impairments (every RTL-SDR stream has some of each):
      cfo_hz: receiver-LO carrier frequency offset — rotates I/Q by
        e^{j*2*pi*cfo*t}; appears as a DC shift after the discriminator
        and detunes every channel filter by cfo (typ. up to +-3 kHz for a
        +-30 ppm crystal at ~100 MHz).
      clock_ppm: TX/RX sample-clock rate mismatch in parts-per-million —
        the whole waveform is resampled by 1/(1+ppm*1e-6) via the exact FM
        phase (the receiver sees a stream whose symbol/pilot clocks all
        run fast or slow; typ. +-100 ppm).
      pilot_linewidth_hz: Lorentzian linewidth of the exciter's reference
        oscillator — Wiener phase noise with per-sample variance
        2*pi*linewidth/fs, scaled 2x/3x onto the 38/57 kHz subcarriers.
    """
    n = int(seconds * cfg.rf_fs)
    n -= n % (cfg.rf_decim * cfg.audio_decim)  # whole IQ-pair alignment units
    rng = np.random.default_rng(seed)
    def trim(x):
        return None if x is None else x[:n]
    if pilot_linewidth_hz > 0.0 and "mpx_phase_noise" not in mpx_kwargs:
        step_var = 2.0 * np.pi * pilot_linewidth_hz / cfg.rf_fs
        mpx_kwargs["mpx_phase_noise"] = np.cumsum(
            rng.normal(0.0, np.sqrt(step_var), n))
    m = make_multiplex(cfg.rf_fs, n, left=trim(left), right=trim(right),
                       mono=trim(mono), rds_baseband=trim(rds_baseband),
                       **mpx_kwargs)
    phase = 2.0 * np.pi * kf * np.cumsum(m) / cfg.rf_fs
    if clock_ppm != 0.0:
        # sample the continuous FM phase on the mismatched clock's grid:
        # position k of the receiver's clock falls at k*(1+ppm) of the
        # transmitter's — smooth phase, so linear interpolation is exact
        # to O(h^2) curvature (inaudible; symbol clocks shift exactly)
        pos = np.arange(n) * (1.0 + clock_ppm * 1e-6)
        np.clip(pos, 0.0, n - 1.0, out=pos)
        phase = np.interp(pos, np.arange(n), phase)
    if cfo_hz != 0.0:
        phase = phase + 2.0 * np.pi * cfo_hz * np.arange(n) / cfg.rf_fs
    i, q = np.cos(phase), np.sin(phase)
    if noise_db is not None:
        sigma = 10 ** (noise_db / 20.0)
        i = i + rng.normal(0, sigma, n)
        q = q + rng.normal(0, sigma, n)
    return to_u8_iq(i, q, amplitude, dither=rng)


def tone(fs: float, freq: float, n: int, amplitude: float = 1.0,
         phase: float = 0.0) -> np.ndarray:
    t = np.arange(n) / fs
    return amplitude * np.sin(2 * np.pi * freq * t + phase)
