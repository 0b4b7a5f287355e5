"""RDS transmit side: groups -> differential -> biphase -> RRC waveform.

Test-vector generator for the RDS receive chain (SURVEY §7 step 5: the
reference never finished RDS, so validation requires a synthesized
modulator).  Produces the 57 kHz-ready baseband at an arbitrary sample rate,
to be injected into the FM multiplex by sdr_tpu.tx.make_multiplex.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps
from fractions import Fraction

from sdr_tpu_torch.ops.firdes import root_raised_cosine
from sdr_tpu_torch.rds.decode import biphase_encode, differential_encode
from sdr_tpu_torch.rds.groups import make_group_0a, make_group_2a

SYMBOL_RATE = 2375.0


def standard_group_stream(pi: int = 0x3D44, pty: int = 5,
                          ps_name: str = "SDR-TPU ",
                          radio_text: str = "TPU NATIVE FM RECEIVER",
                          n_groups: int = 20) -> np.ndarray:
    """A representative bit stream: alternating 0A (PS) and 2A (RT) groups."""
    rt16 = (radio_text + " " * 64)[:64]
    out = []
    for g in range(n_groups):
        if g % 2 == 0:
            out.append(make_group_0a(pi, pty, ps_name, segment=(g // 2) % 4))
        else:
            out.append(make_group_2a(pi, pty, rt16, segment=(g // 2) % 8))
    return np.concatenate(out)


def bits_to_baseband(bits: np.ndarray, fs_out: float, *, sps_shape: int = 16,
                     rrc_taps: int = 151, beta: float = 0.9) -> np.ndarray:
    """Bits (1187.5 b/s) -> RRC-shaped biphase baseband at fs_out.

    Pipeline: differential encode -> biphase symbol pairs (2375 sym/s) ->
    impulse train at sps_shape samples/symbol -> RRC pulse shaping ->
    polyphase resample to fs_out.  The receiver applies its own RRC, giving
    an ISI-free raised-cosine cascade at the sampling instants.
    """
    diff = differential_encode(bits)
    symbols = biphase_encode(diff)
    fs_shape = SYMBOL_RATE * sps_shape
    train = np.zeros(len(symbols) * sps_shape)
    train[::sps_shape] = symbols
    rrc = root_raised_cosine(fs_shape, rrc_taps, SYMBOL_RATE, beta=beta)
    shaped = np.convolve(train, rrc.astype(np.float64), mode="same")
    frac = Fraction(fs_out / fs_shape).limit_denominator(10_000)
    out = sps.resample_poly(shaped, frac.numerator, frac.denominator)
    peak = np.max(np.abs(out))
    return out / peak if peak > 0 else out
