"""RDS symbol-to-bit decode: biphase (Manchester) pairing + differential.

Per spec p.14 (SURVEY §2.5): symbol pairs HL -> 1, LH -> 0 at 2375 sym/s ->
1187.5 bit/s, then differential decode (XOR with previous bit).  Host-side
NumPy: this runs at ~1 kbit/s, far below any accelerator-worthy rate; the
heavy DSP upstream (IF-rate filtering, PLL, RRC, CDR) is all on-TPU.
"""

from __future__ import annotations

import numpy as np


def biphase_decode(symbols: np.ndarray, parity: int | None = None
                   ) -> tuple[np.ndarray, int]:
    """Symbols (+/- soft values) -> differential-encoded bit estimates.

    parity: 0 if pairs start at symbol 0, 1 if at symbol 1; None = auto
    (maximize sum |s0 - s1|).  Returns (bits, parity_used).
    """
    symbols = np.asarray(symbols, dtype=np.float64)
    if parity is None:
        n0 = len(symbols) - (len(symbols) % 2)
        s_even = np.abs(symbols[0:n0:2] - symbols[1:n0:2]).sum()
        m = (len(symbols) - 1) - ((len(symbols) - 1) % 2)
        s_odd = np.abs(symbols[1:1 + m:2] - symbols[2:2 + m:2]).sum()
        parity = 0 if s_even >= s_odd else 1
    s = symbols[parity:]
    n = len(s) - (len(s) % 2)
    first, second = s[0:n:2], s[1:n:2]
    bits = (first > second).astype(np.uint8)  # HL = 1, LH = 0
    return bits, parity


def differential_decode(bits: np.ndarray, prev_bit: int = 0) -> np.ndarray:
    """b_i = d_i XOR d_{i-1} (spec p.14); invariant to global polarity flips
    of the recovered 57 kHz carrier."""
    bits = np.asarray(bits, dtype=np.uint8)
    prev = np.concatenate([[prev_bit], bits[:-1]]).astype(np.uint8)
    return bits ^ prev


def differential_encode(bits: np.ndarray, prev_bit: int = 0) -> np.ndarray:
    """TX-side inverse of differential_decode: d_i = b_i XOR d_{i-1}."""
    bits = np.asarray(bits, dtype=np.uint8)
    out = np.empty_like(bits)
    d = prev_bit
    for i, b in enumerate(bits):
        d = b ^ d
        out[i] = d
    return out


def biphase_encode(diff_bits: np.ndarray) -> np.ndarray:
    """TX-side: bit 1 -> (+1,-1) symbols (HL), bit 0 -> (-1,+1) (LH)."""
    d = np.asarray(diff_bits, dtype=np.int8)
    sym = np.empty(2 * len(d), dtype=np.float64)
    sym[0::2] = np.where(d == 1, 1.0, -1.0)
    sym[1::2] = np.where(d == 1, -1.0, 1.0)
    return sym
