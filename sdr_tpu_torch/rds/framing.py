"""RDS frame synchronization and group extraction.

Spec p.18 (SURVEY §2.5): slide a 26-bit window over the decoded bit stream,
compute syndromes against the parity-check matrix, and lock when the
A-B-C|C'-D offset sequence appears at 26-bit spacing.  On sync loss (weak
signal), fall back to brute-force re-search — the only 'recovery' behavior
the reference family defines (SURVEY §5.3).

The syndrome computation is one vectorized GF(2) matmul over all windows
(rds/matrix.py `syndromes_sliding`); the state machine below is host-side.
Polarity ambiguity from the 57 kHz PLL is handled by trying the inverted
bit stream too.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sdr_tpu_torch.rds.matrix import SYNDROMES, syndromes_sliding

_OFFSET_SEQ = ("A", "B", "C", "D")
_SYN_A = SYNDROMES["A"]
_SYN_B = SYNDROMES["B"]
_SYN_C = SYNDROMES["C"]
_SYN_CP = SYNDROMES["C'"]
_SYN_D = SYNDROMES["D"]


@dataclasses.dataclass
class Group:
    """One synchronized group: four 16-bit info words + which C offset."""
    blocks: tuple[int, int, int, int]
    version_b: bool
    bit_offset: int  # position of block A's first bit in the input stream
    bits_corrected: int = 0  # burst-corrected bit count (rds/correct.py)


def find_sync_positions(bits: np.ndarray) -> np.ndarray:
    """Positions p where windows at p, p+26, p+52, p+78 carry syndromes
    A, B, C|C', D — fully vectorized."""
    syn = syndromes_sliding(bits)
    n = len(syn)
    if n < 79:
        return np.zeros(0, dtype=np.int64)
    a = syn[: n - 78] == _SYN_A
    b = syn[26: n - 52] == _SYN_B
    c = (syn[52: n - 26] == _SYN_C) | (syn[52: n - 26] == _SYN_CP)
    d = syn[78:] == _SYN_D
    return np.nonzero(a & b & c & d)[0]


def extract_groups(bits: np.ndarray, *, try_invert: bool = True,
                   correct_bursts: bool = False) -> tuple[list[Group], int]:
    """Brute-force sync + locked tracking over a bit stream.

    Returns (groups, polarity) with polarity 0 if bits used as-is, 1 if the
    stream had to be inverted (57 kHz carrier polarity ambiguity).
    correct_bursts enables span-<=5 burst correction (rds/correct.py) on
    groups at LOCKED positions — initial sync still requires four
    error-free blocks (correcting during search would admit false locks).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    for polarity in (0, 1) if try_invert else (0,):
        stream = bits ^ polarity
        syn = syndromes_sliding(stream)
        groups = _track(stream, syn, correct_bursts)
        if groups:
            return groups, polarity
    return [], 0


def _exact_group(syn: np.ndarray, p: int) -> bool:
    return bool(syn[p] == _SYN_A and syn[p + 26] == _SYN_B
                and syn[p + 52] in (_SYN_C, _SYN_CP) and syn[p + 78] == _SYN_D)


def _make_group(bits: np.ndarray, p: int, version_b: bool,
                corrected: int = 0) -> Group:
    blocks = tuple(
        int("".join(map(str, bits[q:q + 16])), 2)
        for q in (p, p + 26, p + 52, p + 78))
    return Group(blocks=blocks, version_b=version_b, bit_offset=p,
                 bits_corrected=corrected)


def correct_group(bits: np.ndarray, p: int) -> Group | None:
    """Burst-correct the four blocks of a group expected at bit position p.

    Used only when sync is locked and p is the expected next-group position.
    Each 26-bit block may independently carry one span-<=5 burst.  The C
    slot tries both C and C' offsets (version A/B ambiguity under errors is
    resolved toward the fewer corrected bits).
    """
    from sdr_tpu_torch.rds.correct import correct_block

    fixed = np.array(bits[p:p + 104], dtype=np.uint8, copy=True)
    total = 0
    for q, name in ((0, "A"), (26, "B"), (78, "D")):
        res = correct_block(fixed[q:q + 26], name)
        if res is None:
            return None
        fixed[q:q + 26], n = res
        total += n
    res_c = correct_block(fixed[52:78], "C")
    res_cp = correct_block(fixed[52:78], "C'")
    if res_c is None and res_cp is None:
        return None
    if res_cp is None or (res_c is not None and res_c[1] <= res_cp[1]):
        fixed[52:78], n = res_c
        version_b = False
    else:
        fixed[52:78], n = res_cp
        version_b = True
    total += n
    g = _make_group(fixed, 0, version_b, corrected=total)
    return Group(blocks=g.blocks, version_b=version_b, bit_offset=p,
                 bits_corrected=total)


def _track(bits: np.ndarray, syn: np.ndarray,
           correct_bursts: bool = False) -> list[Group]:
    groups: list[Group] = []
    n = len(syn)
    p = 0
    locked_at = -1
    while p + 78 < n:
        if _exact_group(syn, p):
            groups.append(_make_group(bits, p, syn[p + 52] == _SYN_CP))
            locked_at = p
            p += 104  # locked: jump a whole group
        elif locked_at >= 0 and p == locked_at + 104:
            g = correct_group(bits, p) if correct_bursts else None
            if g is not None:
                groups.append(g)
                locked_at = p
                p += 104
            else:
                # sync lost at the expected position: brute-force re-search
                locked_at = -1
                p += 1
        else:
            p += 1
    return groups
