"""The receiver's operating modes (COE3DY4 project spec, the reference's
src/project.cpp:304-362), for the reference receiver and the synthesis.

Frozen copy of sdr_tpu_torch/config.py at commit c6f277a.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction


@dataclasses.dataclass(frozen=True)
class ModeConfig:
    """One operating mode of the receiver (reference: src/project.cpp:327-362)."""

    mode: int
    rf_fs: int            # RF sample rate (u8 IQ pairs/s)
    rf_decim: int         # RF -> IF decimation
    audio_interp: int     # IF -> audio rational resampler U
    audio_decim: int      # IF -> audio rational resampler D
    audio_fs: int         # audio output rate
    rds_sps: int | None   # RDS samples-per-symbol (None = RDS unsupported)

    # Shared constants (reference: src/project.cpp:304-321)
    rf_fc: float = 100_000.0
    audio_fc: float = 16_000.0
    rf_taps: int = 51
    bp_taps: int = 51
    base_audio_taps: int = 51
    mono_delay: int = 5

    # Stereo subcarrier constants (spec Figs 5-8)
    pilot_lo: float = 18_500.0
    pilot_hi: float = 19_500.0
    pilot_freq: float = 19_000.0
    stereo_lo: float = 22_000.0
    stereo_hi: float = 54_000.0

    # RDS constants (spec Figs 9-20; reference src/project.cpp:211,218,231,257)
    rds_lo: float = 54_000.0
    rds_hi: float = 60_000.0
    rds_carrier_lo: float = 113_500.0
    rds_carrier_hi: float = 114_500.0
    rds_carrier_freq: float = 114_000.0
    rds_fc: float = 3_000.0
    rds_symbol_rate: int = 2375

    # ---- derived ----
    @property
    def if_fs(self) -> int:
        """IF sample rate after RF decimation."""
        return self.rf_fs // self.rf_decim

    @property
    def audio_taps(self) -> int:
        """Audio LPF taps, scaled by interpolation (reference: project.cpp:347,356)."""
        return self.base_audio_taps * self.audio_interp

    @property
    def audio_gain(self) -> int:
        """LPF passband gain compensating zero-stuffing (reference: project.cpp:117)."""
        return self.audio_interp

    @property
    def block_size_u8(self) -> int:
        """Reference block size in u8 bytes (reference: src/project.cpp:364)."""
        return 256 * self.rf_decim * self.audio_decim

    @property
    def iq_per_block(self) -> int:
        return self.block_size_u8 // 2

    @property
    def if_per_block(self) -> int:
        return self.iq_per_block // self.rf_decim

    @property
    def audio_per_block(self) -> int:
        return self.if_per_block * self.audio_interp // self.audio_decim

    @property
    def rds_fs(self) -> int | None:
        """RDS baseband rate = SPS * 2375 (constraints PDF p.1)."""
        if self.rds_sps is None:
            return None
        return self.rds_sps * self.rds_symbol_rate

    @property
    def rds_resample(self) -> tuple[int, int] | None:
        """(U, D) taking IF rate -> SPS*2375."""
        if self.rds_sps is None:
            return None
        frac = Fraction(self.rds_fs, self.if_fs)
        return frac.numerator, frac.denominator

    def validate(self) -> None:
        assert self.rf_fs % self.rf_decim == 0, "IF rate must be integral"
        assert (self.if_fs * self.audio_interp) % self.audio_decim == 0, (
            "audio rate must be integral"
        )
        assert self.if_fs * self.audio_interp // self.audio_decim == self.audio_fs
        assert math.gcd(self.audio_interp, self.audio_decim) == 1


# The four reference modes (reference: src/project.cpp:327-362 and
# doc/3dy4-constraints-group-4.pdf p.1).  Mode 1's audio_decim follows the
# C++ (6, yielding 48 kHz) not the Python model's buggy 4 (SURVEY §2.2 P4).
MODES: dict[int, ModeConfig] = {
    0: ModeConfig(mode=0, rf_fs=2_400_000, rf_decim=10, audio_interp=1,
                  audio_decim=5, audio_fs=48_000, rds_sps=16),
    1: ModeConfig(mode=1, rf_fs=1_152_000, rf_decim=4, audio_interp=1,
                  audio_decim=6, audio_fs=48_000, rds_sps=None),
    2: ModeConfig(mode=2, rf_fs=2_400_000, rf_decim=10, audio_interp=147,
                  audio_decim=800, audio_fs=44_100, rds_sps=35),
    3: ModeConfig(mode=3, rf_fs=2_304_000, rf_decim=9, audio_interp=441,
                  audio_decim=2560, audio_fs=44_100, rds_sps=None),
}

for _m in MODES.values():
    _m.validate()


def get_mode(mode: int) -> ModeConfig:
    if mode not in MODES:
        raise ValueError(f"Invalid mode {mode}; valid modes: {sorted(MODES)}")
    return MODES[mode]
