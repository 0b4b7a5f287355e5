"""RDS application layer: PI / PTY / PS name / radio text / clock-time.

Spec p.18 (SURVEY §2.5): group 0A carries the 8-char program service name
(2 chars/group), 2A the 64-char radio text (4 chars/group), 4A clock time.
Consumes synchronized groups from rds/framing.py.
"""

from __future__ import annotations

import dataclasses

from sdr_tpu_torch.rds.framing import Group
from sdr_tpu_torch.rds.groups import parse_header

PTY_NAMES_NA = [
    "None", "News", "Information", "Sports", "Talk", "Rock", "Classic Rock",
    "Adult Hits", "Soft Rock", "Top 40", "Country", "Oldies", "Soft",
    "Nostalgia", "Jazz", "Classical", "Rhythm and Blues", "Soft R&B",
    "Foreign Language", "Religious Music", "Religious Talk", "Personality",
    "Public", "College", "Spanish Talk", "Spanish Music", "Hip Hop",
    "Unassigned", "Unassigned", "Weather", "Emergency Test", "Emergency",
]


@dataclasses.dataclass
class StationInfo:
    pi: int | None = None
    pty: int | None = None
    ps_name: str = "        "
    radio_text: str = " " * 64
    clock: tuple[int, int, int] | None = None  # (mjd, hour, minute)
    groups_seen: int = 0
    ps_segments: int = 0
    rt_segments: int = 0

    @property
    def pty_name(self) -> str | None:
        return PTY_NAMES_NA[self.pty] if self.pty is not None else None


def update_info(info: StationInfo, g: Group) -> StationInfo:
    """Fold ONE synchronized group into station info (in place).

    The incremental form of decode_groups — the streaming decoder
    (rds/streaming.py) applies it as groups arrive so PI/PS/RT are live
    mid-stream instead of only at end-of-capture.
    """
    b1, b2, b3, b4 = g.blocks
    hdr = parse_header(b1, b2)
    info.pi = hdr.pi
    info.pty = hdr.pty
    info.groups_seen += 1
    if hdr.group_type == 0 and not hdr.version_b:
        seg = hdr.payload5 & 3
        ps = list(info.ps_name)
        ps[2 * seg] = chr((b4 >> 8) & 0xFF)
        ps[2 * seg + 1] = chr(b4 & 0xFF)
        info.ps_name = "".join(ps)
        info.ps_segments += 1
    elif hdr.group_type == 2 and not hdr.version_b:
        seg = hdr.payload5 & 0xF
        chars = [(b3 >> 8) & 0xFF, b3 & 0xFF, (b4 >> 8) & 0xFF, b4 & 0xFF]
        rt = list(info.radio_text)
        for j, c in enumerate(chars):
            rt[4 * seg + j] = chr(c)
        info.radio_text = "".join(rt)
        info.rt_segments += 1
    elif hdr.group_type == 4 and not hdr.version_b:
        mjd = ((hdr.payload5 & 3) << 15) | ((b3 >> 1) & 0x7FFF)
        hour = ((b3 & 1) << 4) | ((b4 >> 12) & 0xF)
        minute = (b4 >> 6) & 0x3F
        info.clock = (mjd, hour, minute)
    return info


def decode_groups(groups: list[Group]) -> StationInfo:
    """Fold a synchronized group stream into station info."""
    info = StationInfo()
    for g in groups:
        update_info(info, g)
    return info
