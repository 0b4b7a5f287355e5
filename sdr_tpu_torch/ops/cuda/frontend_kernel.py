"""Fused RF front end: u8 decode + deinterleave + 51-tap LPF + decimate,
optionally with the FM discriminator, as one CUDA kernel.

Port of sdr_tpu/ops/pallas/frontend_kernel.py.  The kernels are in
csrc/frontend.cu and replace the Pallas kernels `_frontend_demod_kernel`
(reached through `FusedFrontend.demod_call`) and `_frontend_kernel`
(through `FusedFrontend.__call__`).  What bounds them on an H100: per IF
sample 2D = 20 bytes of u8 in and 2-8 bytes out against 2 x 51
multiply-adds, so the bytes.  The kernels read each input byte once and
keep the decoded I/Q (and, with demod, the discriminator) out of device
memory.  The integer engines run the FIR on the tensor cores: a Toeplitz
tile of the taps (`toeplitz_tile`, built here once per taps, D and
engine and packed in the mma's A-fragment order by `pack_a_s8`) times 8
columns of the raw stream; the float engines stay on the CUDA cores (see
the source's header; times in PERF.md).

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`frontend_reference`, `frontend_demod_reference`);
there is no fallback from one to the other.  `LAUNCHES` counts kernel
launches per kernel, so a run can show that its path went through them.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build
from sdr_tpu_torch.ops.cuda.build import LAUNCHES  # noqa: F401  (re-export)
from sdr_tpu_torch.ops.demod import fm_discriminator

FIX_BITS = 14  # fixed-point fraction bits of the int8x2 coefficient limbs
ENGINES = {"f32": 0, "bf16": 1, "int8": 2, "int8x2": 3}
# the integer engines' tensor-core FIR (csrc/frontend.cu kPhase, kReach,
# kHaloWords, kMaxMmaDecim): a column of B starts MMA_PHASE samples more
# than the taps' reach before its first output, on a 16-byte boundary of
# the raw interleaved stream for any D
MMA_ROWS = 16        # consecutive outputs of an A tile
MMA_K = 32           # depth of one m16n8k32 step
MMA_PHASE = 6
HALO_WORDS = 64      # the combined integer taps at the head of the buffer
MAX_MMA_DECIM = 16


def mma_depth(decim: int, taps: int = 51) -> int:
    """K of the Toeplitz tile: the samples that 16 consecutive outputs
    reach (15 D + taps + MMA_PHASE), rounded up to a whole m16n8k32 step."""
    need = (MMA_ROWS - 1) * decim + taps + MMA_PHASE
    return -(-need // MMA_K) * MMA_K


def toeplitz_tile(taps: np.ndarray, decim: int) -> np.ndarray:
    """The (16, K) int64 Toeplitz tile of integer taps h[0..T-1]: row r,
    column kk holds h[r D + T - 1 + MMA_PHASE - kk] (0 outside the taps),
    so that tile @ x[m0 D - (T - 1 + MMA_PHASE) + kk] gives outputs
    m0 .. m0 + 15 of y[m] = sum_k h[k] x[m D - k]."""
    taps = np.asarray(taps, np.int64)
    t = len(taps)
    a = np.zeros((MMA_ROWS, mma_depth(decim, t)), np.int64)
    for r in range(MMA_ROWS):
        a[r, r * decim + MMA_PHASE:r * decim + MMA_PHASE + t] = taps[::-1]
    return a


# the A fragments' registers of m16n8k32 (row offset, and the tile columns
# of lane t's k rows within a step): the mma's k rows 4t..4t+3 and
# 16+4t..16+4t+3 are matched with samples 8t..8t+3 and 8t+4..8t+7 of the
# step, which the kernel loads in one 16-byte load a lane (the products'
# sum does not depend on the k order)
_S8_REGS = ((0, 0), (8, 0), (0, 4), (8, 4))


def pack_a_s8(tile: np.ndarray) -> np.ndarray:
    """A (16, K) int8-valued tile in the A-fragment order of
    mma.m16n8k32.s8, with the kernel's k order: (K/32, 32 lanes, 4) int32
    words, lane (g, t) = (lane // 4, lane % 4) holding rows g and g + 8 of
    tile columns 8t..8t+3 and 8t+4..8t+7 of each step, byte i of a word
    the i-th column."""
    rows, k = tile.shape
    assert rows == MMA_ROWS and k % MMA_K == 0
    assert np.abs(tile).max() <= 127
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    b = tile.astype(np.int8).view(np.uint8).astype(np.uint32)
    out = np.zeros((k // MMA_K, 32, 4), np.uint32)
    shift = (8 * np.arange(4)).astype(np.uint32)
    for s in range(k // MMA_K):
        for reg, (dr, dc) in enumerate(_S8_REGS):
            cols = MMA_K * s + dc + 8 * t[:, None] + np.arange(4)
            out[s, :, reg] = np.bitwise_or.reduce(
                b[(g + dr)[:, None], cols] << shift, axis=1)
    return out.view(np.int32)


def unpack_a_s8(words: np.ndarray) -> np.ndarray:
    """pack_a_s8's inverse: the (16, K) int64 tile."""
    ks = words.shape[0]
    b = words.view(np.uint32)[..., None] >> (8 * np.arange(4)).astype(
        np.uint32)
    b = (b & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)
    tile = np.zeros((MMA_ROWS, ks * MMA_K), np.int64)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for s in range(ks):
        for reg, (dr, dc) in enumerate(_S8_REGS):
            cols = MMA_K * s + dc + 8 * t[:, None] + np.arange(4)
            tile[(g + dr)[:, None], cols] = b[s, :, reg]
    return tile


def mma_tap_words(limbs: list[np.ndarray], combined: np.ndarray,
                  decim: int) -> np.ndarray:
    """The integer engines' tap buffer (int32 words), as csrc/frontend.cu
    `mma_taps` reads it: HALO_WORDS combined integer taps (a warp's halo
    output), then the packed A tile of each limb (int8: one; int8x2: the
    high limbs, then the low)."""
    halo = np.zeros(HALO_WORDS, np.int32)
    halo[:len(combined)] = combined
    return np.concatenate([halo] + [pack_a_s8(toeplitz_tile(l, decim))
                                    .reshape(-1) for l in limbs])


def _quantize_limbs(a: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Two int8 limbs of a 15-bit fixed-point representation:
    a ~= (a1*128 + a2) * scale (sdr_tpu's `_quantize_limbs`, verbatim).

    The reference applies it to its band matrix, which holds only copies of
    the taps; applied to the taps themselves it gives the same integers
    and scale."""
    peak = np.abs(a).max()
    s = 2.0 ** np.ceil(np.log2(peak)) if peak > 0 else 1.0
    fix = np.round(a / s * (1 << FIX_BITS)).astype(np.int32)
    hi = np.round(fix / 128.0).astype(np.int32)
    lo = fix - 128 * hi
    if np.abs(hi).max() > 127:
        # peak an exact power of two: a/s hits 1.0, fix = +-2^FIX_BITS and
        # hi = +-128 overflows int8 — give back one fixed-point bit
        s *= 2.0
        fix = np.round(a / s * (1 << FIX_BITS)).astype(np.int32)
        hi = np.round(fix / 128.0).astype(np.int32)
        lo = fix - 128 * hi
    assert np.all(np.abs(hi) <= 127) and np.all(np.abs(lo) <= 127)
    return (hi.astype(np.int8), lo.astype(np.int8),
            float(s / (1 << FIX_BITS)))


def _quantize_int8(a: np.ndarray) -> tuple[np.ndarray, float]:
    """Single-limb int8 quantization a ~= a8 * scale (sdr_tpu's
    `_quantize_int8`, verbatim; same note on taps vs band)."""
    peak = np.abs(a).max()
    sc = (peak / 127.0) if peak > 0 else 1.0
    a8 = np.clip(np.round(a / sc), -127, 127).astype(np.int8)
    return a8, float(sc)


class FusedFrontend:
    """Stateful fused channelizer over (..., n) interleaved u8 IQ blocks.

    `__call__(u8_block, tail)` -> (i_ds, q_ds, new_tail);
    `demod_call(u8_block, tail, prev_i, prev_q)`
        -> (fm_demod, new_tail, new_prev_i, new_prev_q, power_sum),
    the reference's return tuples.  The tail is the carried last 128 u8
    bytes of the stream (2*(taps-1) = 100 rounded up as the reference
    stores it, so states convert one to one).

    compute_dtype: 'f32' | 'bf16' | 'int8' | 'int8x2' (the reference's
    coefficient engines); out_dtype: dtype of fm_demod.  `out_tile`,
    `sub_tiles` and `interpret` (TPU-lowering knobs) are accepted and have
    no effect.
    """

    def __init__(self, coeff: np.ndarray, decim: int, out_tile: int = 128,
                 *, compute_dtype: str = "f32", sub_tiles: int = 1,
                 out_dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        if compute_dtype not in ENGINES:
            raise ValueError(f"compute_dtype {compute_dtype!r} not in "
                             f"{sorted(ENGINES)}")
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("fm out_dtype must be float32 or bfloat16")
        # the taps as the reference's float32 band matrix holds them
        taps = np.asarray(coeff, np.float64).astype(np.float32)
        self.taps = len(taps)
        self.decim = int(decim)
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype
        self.device = torch.device(device)
        self.tail_u8 = -(-(2 * (self.taps - 1)) // 128) * 128
        self.fix_scale = 0.0
        self._mma_words = None      # integer engines: the tap buffer's
        self._mma_dev = None        # words, and the buffer on the card
        if compute_dtype == "int8x2":
            hi, lo, self.fix_scale = _quantize_limbs(taps)
            self.int_taps = hi.astype(np.int64) * 128 + lo
            self._kernel_taps = np.concatenate([hi, lo])
            limbs = [hi, lo]
        elif compute_dtype == "int8":
            a8, self.fix_scale = _quantize_int8(taps)
            self.int_taps = a8.astype(np.int64)
            self._kernel_taps = a8
            limbs = [a8]
        else:
            # the exact /128 decode scale folded into the taps (a power of
            # two: bit-identical in f32, unchanged bf16 rounding)
            f = torch.from_numpy(taps / np.float32(128.0))
            if compute_dtype == "bf16":
                f = f.to(torch.bfloat16)
                self._kernel_taps = f.view(torch.int16).numpy().view(np.uint16)
                f = f.to(torch.float32)
            else:
                self._kernel_taps = f.numpy()
            self.float_taps = f
        self.scale = float(np.float32(self.fix_scale / 128.0))
        if compute_dtype in ("int8", "int8x2") and self.taps <= HALO_WORDS:
            self._mma_words = mma_tap_words(limbs, self.int_taps, self.decim)
        # plain version: conv1d weight (cross-correlation, so taps reversed);
        # float64 holds the integer engines' sums exactly (|sum| < 2^28)
        if compute_dtype in ("int8", "int8x2"):
            w = torch.from_numpy(self.int_taps[::-1].astype(np.float64))
        else:
            w = self.float_taps.flip(0)
        self._weight = w.reshape(1, 1, -1).to(self.device)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        # value 128 decodes to 0.0 == zero-filled float tails
        return torch.full(batch_shape + (self.tail_u8,), 128,
                          dtype=torch.uint8, device=self.device)

    # ------------------------------------------------------------ dispatch
    def __call__(self, u8_block: torch.Tensor, tail: torch.Tensor,
                 interpret: bool = False):
        if u8_block.is_cuda:
            return self._kernel(u8_block, tail)
        _require_cpu(u8_block)
        return frontend_reference(self, u8_block, tail)

    def demod_call(self, u8_block: torch.Tensor, tail: torch.Tensor,
                   prev_i: torch.Tensor, prev_q: torch.Tensor,
                   interpret: bool = False):
        """Front end + FM discriminator in one launch; power_sum is
        sum(I^2+Q^2) over the block's IF samples (for RSSI)."""
        if u8_block.is_cuda:
            return self._demod_kernel(u8_block, tail, prev_i, prev_q)
        _require_cpu(u8_block)
        return frontend_demod_reference(self, u8_block, tail, prev_i,
                                        prev_q)

    # -------------------------------------------------------------- kernels
    def _check(self, u8, tail, *floats):
        *lead, n = u8.shape
        if u8.dtype != torch.uint8 or tail.dtype != torch.uint8:
            raise TypeError("u8 block and tail must be uint8")
        if tuple(tail.shape) != (*lead, self.tail_u8):
            raise ValueError(f"tail shape {tuple(tail.shape)} != "
                             f"{(*lead, self.tail_u8)}")
        if n < 2 * self.decim:
            raise ValueError(f"block of {n} bytes is shorter than one IF "
                             f"sample ({2 * self.decim} bytes)")
        tensors = (u8, tail, *floats)
        if any(t.device != u8.device for t in tensors):
            raise ValueError("all inputs must be on one device")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA front end takes contiguous tensors")
        if any(t.dtype != torch.float32 for t in floats):
            raise TypeError("prev_i / prev_q must be float32")
        if self._mma_words is not None and self.decim > MAX_MMA_DECIM:
            raise ValueError(f"the CUDA integer front end takes decim <= "
                             f"{MAX_MMA_DECIM}, not {self.decim}")
        channels = int(np.prod(lead)) if lead else 1
        return lead, n, channels, n // (2 * self.decim)

    def _taps_ptr(self, device) -> int:
        """The kernel's taps: the host array (float engines) or the tap
        buffer on the card (integer engines), copied there once."""
        if self._mma_words is None:
            return self._kernel_taps.ctypes.data
        if self._mma_dev is None or self._mma_dev.device != device:
            self._mma_dev = torch.from_numpy(self._mma_words).to(device)
        return self._mma_dev.data_ptr()

    def _common_args(self, u8, tail, channels, n):
        return [u8.data_ptr(), tail.data_ptr(), channels, n, self.decim,
                ENGINES[self.compute_dtype], self._taps_ptr(u8.device),
                self.taps, self.scale]

    def _kernel(self, u8, tail):
        lead, n, channels, n_out = self._check(u8, tail)
        i_ds = torch.empty((*lead, n_out), dtype=torch.float32,
                           device=u8.device)
        q_ds = torch.empty_like(i_ds)
        stream = torch.cuda.current_stream(u8.device).cuda_stream
        build.check(build.library().sdr_frontend_iq(
            *self._common_args(u8, tail, channels, n), i_ds.data_ptr(),
            q_ds.data_ptr(), stream))
        LAUNCHES["frontend"] += 1
        return i_ds, q_ds, u8[..., n - self.tail_u8:].clone()

    def _demod_kernel(self, u8, tail, prev_i, prev_q):
        lead, n, channels, n_out = self._check(u8, tail, prev_i, prev_q)
        if tuple(prev_i.shape) != tuple(lead) or \
                tuple(prev_q.shape) != tuple(lead):
            raise ValueError("prev_i / prev_q must have the block's "
                             "leading shape")
        dev = u8.device
        fm = torch.empty((*lead, n_out), dtype=self.out_dtype, device=dev)
        last_i = torch.empty(tuple(lead), dtype=torch.float32, device=dev)
        last_q = torch.empty_like(last_i)
        power = torch.empty_like(last_i)
        lib = build.library()
        partials = torch.empty(channels, lib.sdr_frontend_demod_blocks(n_out),
                               dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.sdr_frontend_demod(
            *self._common_args(u8, tail, channels, n), prev_i.data_ptr(), prev_q.data_ptr(), fm.data_ptr(),
            int(self.out_dtype == torch.bfloat16), last_i.data_ptr(),
            last_q.data_ptr(), partials.data_ptr(), power.data_ptr(),
            stream))
        LAUNCHES["frontend_demod"] += 1
        return (fm, u8[..., n - self.tail_u8:].clone(), last_i, last_q,
                power)


def _require_cpu(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"no front-end kernel for device {t.device}")


# --------------------------------------------------------------- plain torch
def frontend_reference(fe: FusedFrontend, u8: torch.Tensor,
                       tail: torch.Tensor):
    """Plain PyTorch front end: (i_ds, q_ds, new_tail), as the kernel.

    The integer engines run a float64 conv of x-128 with the integer taps:
    every partial sum is an integer below 2^28, so it is exact, and the conv
    runs on the CPU and on CUDA, where integer convs do not."""
    *lead, n = u8.shape
    n_out = n // (2 * fe.decim)
    ints = fe.compute_dtype in ("int8", "int8x2")
    x = torch.cat([tail, u8], dim=-1).reshape(-1, fe.tail_u8 + n)
    x = x.to(torch.float64 if ints else torch.float32) - 128.0
    # I and Q planes; plane index tail_u8/2 + j holds IF-rate sample j
    planes = torch.stack([x[:, 0::2], x[:, 1::2]]).reshape(
        -1, 1, (fe.tail_u8 + n) // 2)
    s = fe.tail_u8 // 2 - (fe.taps - 1)
    span = (n_out - 1) * fe.decim + fe.taps
    y = torch.nn.functional.conv1d(planes[..., s:s + span],
                                   fe._weight.to(planes.device),
                                   stride=fe.decim)
    if ints:
        y = y.to(torch.float32) * fe.scale
    y = y.reshape(2, *lead, n_out)
    return y[0], y[1], u8[..., n - fe.tail_u8:].clone()


def frontend_demod_reference(fe: FusedFrontend, u8: torch.Tensor,
                             tail: torch.Tensor, prev_i: torch.Tensor,
                             prev_q: torch.Tensor):
    """Plain PyTorch front end + discriminator:
    (fm_demod, new_tail, new_prev_i, new_prev_q, power_sum)."""
    i_ds, q_ds, new_tail = frontend_reference(fe, u8, tail)
    fm, last_i, last_q = fm_discriminator(i_ds, q_ds, prev_i, prev_q)
    power = torch.sum(i_ds * i_ds + q_ds * q_ds, dim=-1)
    return fm.to(fe.out_dtype), new_tail, last_i, last_q, power
