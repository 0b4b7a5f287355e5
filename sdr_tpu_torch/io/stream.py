"""Stream ingest/egress: u8 IQ decode, s16 audio pack, block framing.

Port of sdr_tpu/io/stream.py.  Reference semantics:
 - ingest:  u8 -> float32 in [-1, +1) via (x - 128)/128
   (reference: src/iofunc.cpp:62-69 `readStdinBlockData`).
 - egress:  float32 audio -> s16 with NaN->0 guard and x16384 gain,
   interleaved R,L for stereo (reference: src/project.cpp:183-193).

The device functions run on whatever device their tensor lives on; the
host readers hand out numpy blocks for the caller to move.
"""

from __future__ import annotations

from typing import BinaryIO, Iterator

import numpy as np
import torch


def u8_to_f32(raw: torch.Tensor) -> torch.Tensor:
    """Normalize u8 samples to float32 [-1, +1) (reference src/iofunc.cpp:67)."""
    return (raw.to(torch.float32) - 128.0) / 128.0


def decode_u8_iq(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 interleaved IQ block (..., 2N) -> (I (..., N), Q (..., N)) float32."""
    f = u8_to_f32(raw)
    return f[..., 0::2], f[..., 1::2]


def pack_s16(x: torch.Tensor) -> torch.Tensor:
    """float audio -> int16 with NaN->0 guard and x16384 gain
    (reference src/project.cpp:183-193).  C++ float->short conversion
    truncates toward zero, reproduced with torch.trunc; out-of-range values
    saturate, as the JAX reference's conversion does (a plain torch cast
    would wrap)."""
    scaled = torch.where(torch.isnan(x), 0.0, x * 16384.0)
    return torch.trunc(scaled).clamp(-32768, 32767).to(torch.int16)


def interleave_stereo_s16(left: torch.Tensor,
                          right: torch.Tensor) -> torch.Tensor:
    """Interleave as (R, L) pairs exactly like reference src/project.cpp:183-193."""
    r = pack_s16(right)
    l = pack_s16(left)
    return torch.stack([r, l], dim=-1).reshape(*r.shape[:-1], 2 * r.shape[-1])


def read_u8_blocks(stream: BinaryIO, block_size: int) -> Iterator[np.ndarray]:
    """Yield full u8 blocks from a binary stream; a short final read ends
    iteration (reference rf_thread EOF behavior, src/project.cpp:50-54)."""
    while True:
        buf = stream.read(block_size)
        if buf is None or len(buf) < block_size:
            return
        yield np.frombuffer(buf, dtype=np.uint8)


class SyncBlockReader:
    """Iterator of full u8 blocks that KEEPS the partial final block:
    `tail()` returns it after iteration ends, so the consumer can flush the
    stream end at a finer block alignment instead of dropping up to
    block_size-1 bytes (the reference drops the short block,
    src/project.cpp:51-54)."""

    def __init__(self, stream: BinaryIO, block_size: int):
        self._stream = stream
        self._bs = block_size
        self._tail = np.zeros(0, np.uint8)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        buf = self._stream.read(self._bs)
        if buf is None:
            raise StopIteration
        if len(buf) < self._bs:
            self._tail = np.frombuffer(buf, dtype=np.uint8)
            raise StopIteration
        return np.frombuffer(buf, dtype=np.uint8)

    def tail(self) -> np.ndarray:
        return self._tail
