"""RDS/RBDS block code: 26x10 parity-check matrix, offsets, syndromes, codec.

The RDS block is a (26,16) shortened cyclic code: 16 info bits + 10-bit
checkword, with a per-block-position 10-bit offset word added to the
checkword.  Frame sync slides a 26-bit window and multiplies by the 26x10
GF(2) parity-check matrix H; an error-free block yields the syndrome of its
offset word (spec Appendix p.21; the five syndromes below are the spec's
published values — SURVEY §2.5).

Convention note (verified numerically in tests/test_rds.py): the spec's H
equals syndrome s = rev10((rev26(block) * x^0) mod grev(x)) — i.e. the
standard RDS generator g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1 applied LSB-first.
We generate H programmatically from that identity rather than typing the
matrix, and verify the five published syndromes against it.
"""

from __future__ import annotations

import numpy as np

# generator polynomial g(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1
GENPOLY = 0b10110111001

# offset words (EN 50067 Annex A / spec Appendix)
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4}

# published error-free syndromes (spec Appendix p.21)
SYNDROMES = {"A": 0b1111011000, "B": 0b1111010100, "C": 0b1001011100,
             "C'": 0b1111001100, "D": 0b1001011000}


def _rev(v: int, n: int) -> int:
    return int(format(v, f"0{n}b")[::-1], 2)


_GREV = _rev(GENPOLY, 11)


def _polymod(v: int, g: int = _GREV) -> int:
    for i in range(max(v.bit_length() - 1, 9), 9, -1):
        if (v >> i) & 1:
            v ^= g << (i - 10)
    return v


def _syndrome_int(block26: int) -> int:
    """Syndrome of a 26-bit block (MSB = first transmitted bit)."""
    return _rev(_polymod(_rev(block26, 26)), 10)


def build_h() -> np.ndarray:
    """The 26x10 parity-check matrix: row i = syndrome of unit block e_i."""
    h = np.zeros((26, 10), dtype=np.uint8)
    for i in range(26):
        s = _syndrome_int(1 << (25 - i))
        h[i] = [(s >> (9 - j)) & 1 for j in range(10)]
    return h


H = build_h()

# 10x10 submatrix mapping checkword bits -> syndrome, and its GF(2) inverse,
# used by the encoder to solve for the checkword.
_H_CHECK = H[16:]
_H_INFO = H[:16]


def _gf2_inv(a: np.ndarray) -> np.ndarray:
    n = a.shape[0]
    aug = np.concatenate([a.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r, col])
        aug[[col, piv]] = aug[[piv, col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= aug[col]
    return aug[:, n:]


_H_CHECK_INV = _gf2_inv(_H_CHECK)


def int_to_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)


def bits_to_int(bits: np.ndarray) -> int:
    return int("".join(map(str, np.asarray(bits, dtype=int))), 2)


def encode_block(info16: int, offset: str) -> np.ndarray:
    """Encode 16 info bits + offset name -> 26-bit block (uint8 bits).

    Checkword solves H_info @ m + H_check @ (c + O) = syndrome(O),
    i.e. H_check @ c = H_info @ m (GF(2)).
    """
    m = int_to_bits(info16, 16)
    target = (m @ _H_INFO) % 2
    c = (target @ _H_CHECK_INV) % 2
    o = int_to_bits(OFFSET_WORDS[offset], 10)
    return np.concatenate([m, (c ^ o).astype(np.uint8)])


def syndrome(bits26: np.ndarray) -> int:
    """Syndrome of a 26-bit block as an integer (GF(2) matmul with H)."""
    s = (np.asarray(bits26, dtype=np.uint8) @ H) % 2
    return bits_to_int(s)


def syndromes_sliding(bits: np.ndarray) -> np.ndarray:
    """Syndromes of every 26-bit window of a bit stream, vectorized:
    windows (n-25, 26) @ H mod 2 -> (n-25, 10) -> packed ints.

    This is the GF(2)-matmul frame-sync formulation (SURVEY §2.5).  Host
    numpy is the default engine — at 1187.5 bit/s per station it is
    instantaneous; `syndromes_sliding_device` below is the jitted batched
    equivalent for fleet-scale decode (equivalence-tested in
    tests/test_rds.py).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    n = len(bits)
    if n < 26:
        return np.zeros(0, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(bits, 26)
    s = (windows @ H.astype(np.int64)) % 2
    weights = 1 << np.arange(9, -1, -1, dtype=np.int64)
    return s @ weights


def syndromes_sliding_device(bits):
    """`syndromes_sliding` where the tensor lies, batched: bits (..., n)
    uint8 -> (..., n-25) int32 packed syndromes.

    The 26-bit windows are an unfold view of the stream, and the GF(2)
    matmul runs as one float32 product against H with a mod-2 reduce.  It
    is exact: the operands are 0 and 1, a sum is at most 26 and a packed
    syndrome at most 1023 (the port keeps TF32 off, and 0/1 are exact in
    TF32 besides).  CUDA has no int32 matmul, so the product is a float
    one.
    """
    import torch
    bits = torch.as_tensor(bits)
    n = bits.shape[-1]
    if n < 26:
        return torch.zeros(bits.shape[:-1] + (0,), dtype=torch.int32,
                           device=bits.device)
    windows = bits.unfold(-1, 26, 1).to(torch.float32)  # (..., n-25, 26)
    h = torch.as_tensor(H, dtype=torch.float32, device=bits.device)
    s = torch.remainder(windows @ h, 2.0)               # (..., n-25, 10)
    weights = torch.as_tensor(1 << np.arange(9, -1, -1),
                              dtype=torch.float32, device=bits.device)
    return (s @ weights).to(torch.int32)


def decode_block(bits26: np.ndarray) -> tuple[int, str | None]:
    """Return (info16, offset_name) — offset_name None if syndrome unknown."""
    s = syndrome(bits26)
    name = next((k for k, v in SYNDROMES.items() if v == s), None)
    return bits_to_int(bits26[:16]), name
