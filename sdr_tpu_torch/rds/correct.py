"""RDS burst-error correction: Meggitt-style syndrome lookup.

The RDS (26,16) shortened cyclic code corrects error bursts spanning <= 5
bits (spec p.18 / EN 50067 Annex B).  Rather than a serial Meggitt shift
register, we precompute the syndrome of every correctable burst pattern
once (367 patterns) into a lookup table: for a received block r = c + O + e
(codeword + offset word + error), linearity of the syndrome gives
    syn(r) = SYNDROMES[offset] ^ syn(e)
so syn(e) = syn(r) ^ SYNDROMES[offset]; if syn(e) is in the table, XOR the
pattern out.  Table construction asserts all 367 syndromes are distinct
(the code's designed burst-correction guarantee).

Correction is only applied when frame sync is LOCKED and the offset is
known from the group position (rds/framing.py, rds/streaming.py): during
brute-force search a random 26-bit window would be "correctable" with
probability ~367/1024 and flood the sync detector with false locks.  This
goes beyond the reference's error-free-sync-only behavior (SURVEY §2.5),
squarely within spec p.18.
"""

from __future__ import annotations

import numpy as np

from sdr_tpu_torch.rds.matrix import SYNDROMES, syndrome


def _build_burst_table() -> dict[int, np.ndarray]:
    """Map syndrome(e) -> e for every burst e of span 1..5 in 26 bits.

    A burst of span L has its first and last bit set (else it is a shorter
    burst); the L-2 interior bits are free: sum_L (27-L)*2^max(L-2,0)
    = 26 + 25 + 48 + 92 + 176 = 367 patterns.
    """
    table: dict[int, np.ndarray] = {}
    for span in range(1, 6):
        inner_bits = max(span - 2, 0)
        for start in range(27 - span):
            for inner in range(1 << inner_bits):
                e = np.zeros(26, dtype=np.uint8)
                e[start] = 1
                if span > 1:
                    e[start + span - 1] = 1
                    for j in range(inner_bits):
                        e[start + 1 + j] = (inner >> j) & 1
                s = syndrome(e)
                assert s != 0 and s not in table, (
                    f"burst-syndrome collision at span {span}")
                table[s] = e
    return table


BURST_TABLE = _build_burst_table()


def correct_block(bits26: np.ndarray, offset_name: str
                  ) -> tuple[np.ndarray, int] | None:
    """Try to correct `bits26` assuming it carries offset `offset_name`.

    Returns (corrected_bits, n_bits_flipped) — n = 0 if already error-free —
    or None if the error is not a correctable (span <= 5) burst.
    """
    bits26 = np.asarray(bits26, dtype=np.uint8)
    e_syn = syndrome(bits26) ^ SYNDROMES[offset_name]
    if e_syn == 0:
        return bits26, 0
    pattern = BURST_TABLE.get(e_syn)
    if pattern is None:
        return None
    return bits26 ^ pattern, int(pattern.sum())
