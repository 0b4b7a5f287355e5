"""RDS group encode/decode: group 0A (PS name), 2A (radio text), 4A (clock).

Application layer per spec p.18 / EN 50067 §3.1.  Encoding is used by the
test transmitter (rds/tx.py); decoding by the receiver application layer
(rds/app.py).  A group = 4 blocks of 26 bits with offsets A, B, C|C', D.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sdr_tpu_torch.rds.matrix import encode_block


@dataclasses.dataclass
class GroupFields:
    """Decoded common header of any group (block 2)."""
    pi: int
    group_type: int
    version_b: bool
    tp: bool
    pty: int
    payload5: int  # low 5 bits of block 2


def make_group(pi: int, group_type: int, version_b: bool, tp: bool, pty: int,
               payload5: int, block3: int, block4: int) -> np.ndarray:
    """Assemble a 104-bit group (4 encoded blocks)."""
    b2 = (group_type << 12) | (int(version_b) << 11) | (int(tp) << 10) \
        | (pty << 5) | (payload5 & 0x1F)
    blocks = [
        encode_block(pi, "A"),
        encode_block(b2, "B"),
        encode_block(block3, "C'" if version_b else "C"),
        encode_block(block4, "D"),
    ]
    return np.concatenate(blocks)


def make_group_0a(pi: int, pty: int, ps_name: str, segment: int,
                  tp: bool = False, ta: bool = False, ms: bool = True,
                  di: bool = False, af: tuple[int, int] = (0xE0, 0xE0)
                  ) -> np.ndarray:
    """Group 0A: program-service name, 2 chars per group, segment in 0..3."""
    ps = (ps_name + " " * 8)[:8]
    payload5 = (int(ta) << 4) | (int(ms) << 3) | (int(di) << 2) | (segment & 3)
    block3 = (af[0] << 8) | af[1]
    c0, c1 = ps[2 * segment], ps[2 * segment + 1]
    block4 = (ord(c0) << 8) | ord(c1)
    return make_group(pi, 0, False, tp, pty, payload5, block3, block4)


def make_group_2a(pi: int, pty: int, radio_text: str, segment: int,
                  ab_flag: bool = False, tp: bool = False) -> np.ndarray:
    """Group 2A: radio text, 4 chars per group, segment in 0..15."""
    rt = (radio_text + " " * 64)[:64]
    payload5 = (int(ab_flag) << 4) | (segment & 0xF)
    chars = rt[4 * segment: 4 * segment + 4]
    block3 = (ord(chars[0]) << 8) | ord(chars[1])
    block4 = (ord(chars[2]) << 8) | ord(chars[3])
    return make_group(pi, 2, False, tp, pty, payload5, block3, block4)


def make_group_4a(pi: int, pty: int, mjd: int, hour: int, minute: int,
                  tz_half_hours: int = 0, tp: bool = False) -> np.ndarray:
    """Group 4A: clock-time/date (modified Julian day + UTC time)."""
    payload5 = (mjd >> 15) & 0x3
    block3 = ((mjd & 0x7FFF) << 1) | ((hour >> 4) & 1)
    tz_sign = 1 if tz_half_hours < 0 else 0
    block4 = ((hour & 0xF) << 12) | ((minute & 0x3F) << 6) \
        | (tz_sign << 5) | (abs(tz_half_hours) & 0x1F)
    return make_group(pi, 4, False, tp, pty, payload5, block3, block4)


def parse_header(block1: int, block2: int) -> GroupFields:
    return GroupFields(
        pi=block1,
        group_type=(block2 >> 12) & 0xF,
        version_b=bool((block2 >> 11) & 1),
        tp=bool((block2 >> 10) & 1),
        pty=(block2 >> 5) & 0x1F,
        payload5=block2 & 0x1F,
    )
