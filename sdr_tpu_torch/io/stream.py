"""Stream ingest/egress: u8 IQ decode, s16 audio pack, block framing.

Port of sdr_tpu/io/stream.py.  Reference semantics:
 - ingest:  u8 -> float32 in [-1, +1) via (x - 128)/128
   (reference: src/iofunc.cpp:62-69 `readStdinBlockData`).
 - egress:  float32 audio -> s16 with NaN->0 guard and x16384 gain,
   interleaved R,L for stereo (reference: src/project.cpp:183-193).

The device functions run on whatever device their tensor lives on; the
host readers hand out numpy blocks, and `to_device` is the one way every
entry point moves a host block onto the device.  A host block that comes
back call after call (a reader's reused buffer) is registered as
page-locked memory once (`HostPins`), so its copy onto a CUDA device runs
at the DMA rate and not through CUDA's staging of pageable memory.
"""

from __future__ import annotations

import sys
from typing import BinaryIO, Iterator

import numpy as np
import torch

from sdr_tpu_torch.io.logger import count, stage_scope


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


def host_tensor(x) -> torch.Tensor:
    """A host block as a tensor: a tensor as it is; a writable numpy array
    as a CPU tensor on the array's memory, with no copy; a read-only one
    (np.frombuffer, a read-only memmap) copied once, because torch does
    not take read-only memory."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if not x.flags.writeable:
        x = np.array(x)
    return torch.from_numpy(x)


def _cuda_register(ptr: int, nbytes: int) -> bool:
    """cudaHostRegister(ptr, nbytes, cudaHostRegisterPortable): whether
    the range is now page-locked for every device.  A refusal is also the
    runtime's last error, which the check after torch's next kernel launch
    would raise; one small launch here reads it out and drops it."""
    cudart = torch.cuda.cudart()
    if cudart.cudaHostRegister(ptr, nbytes, 1) == cudart.cudaError.success:
        return True
    try:
        torch.zeros(1, device="cuda")
    except RuntimeError:
        pass
    return False


def _cuda_unregister(ptr: int) -> None:
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr))


class HostPins:
    """The one host block that `to_device` keeps page-locked.

    `pinned(t)` decides, from the CPU tensor alone, whether its copy onto
    a CUDA device reads page-locked memory.  A contiguous block whose
    memory (address and bytes) is the previous call's is the pattern of a
    caller that reuses its read buffer: the block's whole storage is
    registered then, once, and every later block inside that range is
    copied from it.  One range is held at a time; when another buffer
    starts repeating, the old one is unregistered.  A range registration
    refused is remembered and not tried again.  A fresh block each call
    never repeats, and costs one comparison.

    The registered storage and the previous call's are held (strong
    references), so neither is freed while it is a key: an address that
    comes back is the same live memory, never a new block the allocator
    put where a freed one was.  `register(ptr, nbytes) -> bool` and
    `unregister(ptr)` are the CUDA runtime's calls; tests pass fakes."""

    def __init__(self, register=_cuda_register, unregister=_cuda_unregister):
        self.register, self.unregister = register, unregister
        self._last = None        # (ptr, nbytes, storage) of the last block
        self._held = None        # (lo, hi, storage) of the registered range
        self._refused = set()    # (lo, hi) ranges registration refused

    def pinned(self, t: torch.Tensor) -> bool:
        if not t.is_contiguous() or t.numel() == 0:
            return False
        ptr, nbytes = t.data_ptr(), t.nbytes
        held = self._held
        if held is not None and held[0] <= ptr and ptr + nbytes <= held[1]:
            return True
        if t.is_pinned():
            return True
        last, storage = self._last, t.untyped_storage()
        self._last = (ptr, nbytes, storage)
        if last is None or last[:2] != (ptr, nbytes):
            return False
        lo = storage.data_ptr()
        key = (lo, lo + storage.nbytes())
        if key in self._refused:
            return False
        if held is not None:
            self._held = None
            self.unregister(held[0])
        if not self.register(lo, key[1] - lo):
            self._refused.add(key)
            return False
        self._held = (*key, storage)
        return True


_PINS = HostPins()


def to_device(x, device) -> torch.Tensor:
    """A host block (numpy array or tensor) on `device`, contiguous, inside
    the span receiver.h2d: the program's one copy of its input onto the
    device.  A block already there is returned as it is.  The copy is
    synchronous: on return the caller may overwrite its block.  Onto a
    CUDA device, a CPU block that `HostPins` finds page-locked (a reused
    buffer, registered the second time it comes) is read by DMA; counters
    h2d.pinned and h2d.pageable (every other call) say which way it
    went."""
    with stage_scope("receiver.h2d"):
        t = host_tensor(x)
        pinned = (t.device.type == "cpu"
                  and torch.device(device).type == "cuda"
                  and _PINS.pinned(t))
        count("h2d.pinned" if pinned else "h2d.pageable", 1)
        return t.to(device).contiguous()


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


def read_bin_f32(path: str) -> np.ndarray:
    """Read a float32 binary dump (reference src/iofunc.cpp:32-47
    `readBinData`)."""
    return np.fromfile(path, dtype=np.float32)


def write_bin_f32(path: str, data: np.ndarray) -> None:
    """Write a float32 binary dump (reference src/iofunc.cpp:49-60
    `writeBinData`)."""
    np.asarray(data, dtype=np.float32).tofile(path)


def write_s16_stream(data: np.ndarray, stream: BinaryIO | None = None) -> None:
    """Write raw S16LE samples to a binary stream (default stdout), as the
    reference's fwrite of short int (src/project.cpp:195)."""
    out = stream if stream is not None else sys.stdout.buffer
    out.write(np.asarray(data, dtype="<i2").tobytes())
