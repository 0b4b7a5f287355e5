"""Fused IF bank (the stereo + RDS chain's band-pass stages) as one CUDA
kernel, in two variants.

Port of sdr_tpu/ops/pallas/ifbank_kernel.py `FusedIFBank` and
`FusedIFBankMix`.  The kernel is in csrc/ifbank.cu and replaces the Pallas
kernels `_ifbank_kernel` and `_ifbank_mix_kernel`.  From the demodulated
IF stream and its carried 128-sample tail it computes the stereo channel,
the pilot, the RDS channel and, from the RDS channel's square, the 114
kHz carrier:
  - `FusedIFBank.__call__` writes all four streams, for the carrier loop
    engines;
  - `FusedIFBankMix.mix_call` writes the stereo and RDS channels and, per
    estimator window, the coherent sums Z = sum x e^{-j ramp} of the pilot
    and of the carrier that `ops.pll.pll_ff_params_from_sums` turns into
    carrier phases (the pilot and carrier stay inside the kernel).
The bf16 compute engine runs its four FIRs on the tensor cores: the
Toeplitz tile of each filter's taps (`toeplitz_tile_bf16`, built here and
packed in the mma's A-fragment order by `pack_a_bf16`) times 8 columns of
the staged window; the float32 engine stays on the CUDA cores.  What
bounds it on an H100 and what its design does about it: see the source's
header; times in PERF.md.

A CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch
version beside it (`ifbank_reference`, `ifbank_mix_reference`); there is
no fallback from one to the other.  Each launch adds one to
`build.LAUNCHES["ifbank"]` or `["ifbank_mix"]`.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build
from sdr_tpu_torch.ops.pll import ramp_f64

CTX = 128      # carried fm context (raw IF samples); covers taps <= 65
KERNEL_TAPS = 51
KERNEL_WINDOW = 256
# the reference TPU kernel's output tile (its default): a block of whole
# tiles is what that kernel consumes, so the receiver aligns its steps to it
OUT_TILE = 512
# the bf16 engine's tensor-core FIRs (csrc/ifbank.cu kKs, kReach):
# m16n8k16 tiles whose columns start MMA_PHASE samples more than the taps'
# reach before their first output, on an 8-byte boundary
MMA_ROWS = 16
MMA_K = 16
MMA_PHASE = 2


def mma_depth(taps: int = KERNEL_TAPS) -> int:
    """K of the bf16 Toeplitz tile: the 15 + taps + MMA_PHASE samples that
    16 consecutive outputs reach, rounded up to a whole m16n8k16 step
    (80)."""
    return -(-(MMA_ROWS - 1 + taps + MMA_PHASE) // MMA_K) * MMA_K


def toeplitz_tile_bf16(taps: np.ndarray) -> np.ndarray:
    """The (16, K) float32 Toeplitz tile of taps h[0..T-1]: row r, column
    kk holds h[r + T - 1 + MMA_PHASE - kk] (0 outside the taps), so that
    tile @ x[m0 - (T - 1 + MMA_PHASE) + kk] gives outputs m0 .. m0 + 15 of
    y[p] = sum_k h[k] x[p - k]."""
    taps = np.asarray(taps, np.float32)
    t = len(taps)
    a = np.zeros((MMA_ROWS, mma_depth(t)), np.float32)
    for r in range(MMA_ROWS):
        a[r, r + MMA_PHASE:r + MMA_PHASE + t] = taps[::-1]
    return a


# the A fragments' registers of m16n8k16 (row offset, tile column offset):
# the mma's k rows 2t, 2t+1 and 2t+8, 2t+9 are matched with samples 4t,
# 4t+1 and 4t+2, 4t+3 of the step, which the kernel loads in one 8-byte
# load a lane (the products' sum does not depend on the k order)
_BF16_REGS = ((0, 0), (8, 0), (0, 2), (8, 2))


def pack_a_bf16(tile: np.ndarray) -> np.ndarray:
    """A (16, K) tile of bf16 values in the A-fragment order of
    mma.m16n8k16.bf16, with the kernel's k order: (K/16, 32 lanes, 4)
    int32 words, lane (g, t) = (lane // 4, lane % 4) holding rows g and
    g + 8 of tile columns 4t, 4t+1 and 4t+2, 4t+3 of each step, the lower
    column in the low half."""
    rows, k = tile.shape
    assert rows == MMA_ROWS and k % MMA_K == 0
    bits = torch.from_numpy(np.ascontiguousarray(tile, np.float32)).to(
        torch.bfloat16)
    assert torch.equal(bits.float(), torch.from_numpy(tile.astype(
        np.float32))), "the tile must hold bf16 values"
    b = bits.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((k // MMA_K, 32, 4), np.uint32)
    for s in range(k // MMA_K):
        for reg, (dr, dc) in enumerate(_BF16_REGS):
            col = MMA_K * s + dc + 4 * t
            out[s, :, reg] = b[g + dr, col] | (b[g + dr, col + 1] << 16)
    return out.view(np.int32)


def unpack_a_bf16(words: np.ndarray) -> np.ndarray:
    """pack_a_bf16's inverse: the (16, K) float32 tile."""
    w = words.view(np.uint32)
    halves = np.stack([w & 0xFFFF, w >> 16], axis=-1).astype(np.uint32)
    vals = (halves << 16).view(np.float32)        # (ks, 32, 4, 2)
    tile = np.zeros((MMA_ROWS, words.shape[0] * MMA_K), np.float32)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for s in range(words.shape[0]):
        for reg, (dr, dc) in enumerate(_BF16_REGS):
            col = MMA_K * s + dc + 4 * t
            tile[g + dr, col] = vals[s, :, reg, 0]
            tile[g + dr, col + 1] = vals[s, :, reg, 1]
    return tile


class FusedIFBank:
    """Stateful fused IF bank for the stereo + RDS chain.

    `bank(fm, tail)` -> (chan, pilot, rds_channel, carrier_in, new_tail),
    the reference's return tuple: the four streams (..., n) in out_dtype
    and the last CTX fm samples; n a multiple of OUT_TILE.

    compute_dtype float32 | bfloat16; out_dtype None (float32) | a dtype.
    `out_tile`, `sub_tiles` and `interpret` (TPU-lowering knobs) are
    accepted and have no effect.
    """

    def __init__(self, chan_coeff, pilot_coeff, rds_coeff, carr_coeff,
                 out_tile: int = 512, *,
                 compute_dtype: torch.dtype = torch.float32,
                 sub_tiles: int = 4, out_dtype: torch.dtype | None = None,
                 device: torch.device | str = "cuda"):
        coeffs = [np.asarray(c, np.float64) for c in
                  (chan_coeff, pilot_coeff, rds_coeff, carr_coeff)]
        self.taps = max(len(c) for c in coeffs)
        if 2 * (self.taps - 1) > CTX:
            raise ValueError(f"taps {self.taps} exceed the {CTX}-sample "
                             "context")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("compute_dtype must be float32 or bfloat16")
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype or torch.float32
        self.device = torch.device(device)
        self.ext = self.taps - 1
        # the taps as float32, rounded to the compute dtype; zero-padded at
        # high k to a common length (leaves each FIR unchanged)
        taps = np.stack([np.pad(c.astype(np.float32), (0, self.taps - len(c)))
                         for c in coeffs])
        t = torch.from_numpy(taps).to(compute_dtype).to(torch.float32)
        self._kernel_taps = np.ascontiguousarray(t.numpy())  # (4, taps)
        self._weight = t.flip(-1)[:, None, :].to(self.device)  # conv1d form
        # the bf16 engine's kernel takes the four Toeplitz tiles, packed,
        # from a buffer on the card (copied there at the first launch)
        self._mma_words = None
        self._mma_dev = None
        if compute_dtype == torch.bfloat16:
            self._mma_words = np.concatenate([
                pack_a_bf16(toeplitz_tile_bf16(h)).reshape(-1)
                for h in self._kernel_taps])

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return torch.zeros(batch_shape + (CTX,), dtype=self.out_dtype,
                           device=self.device)

    def __call__(self, fm: torch.Tensor, tail: torch.Tensor,
                 interpret: bool = False):
        n = fm.shape[-1]
        if n % OUT_TILE:
            raise ValueError(f"IF block {n} is not a multiple of the tile "
                             f"{OUT_TILE}")
        tail = tail.to(fm.dtype)
        if fm.is_cuda:
            return self._kernel(fm, tail)
        if fm.device.type != "cpu":
            raise ValueError(f"no IF-bank kernel for device {fm.device}")
        return ifbank_reference(self, fm, tail)

    def _check(self, fm, tail):
        """The kernel's limits; returns (lead, n, channels, fm, tail)."""
        *lead, n = fm.shape
        if self.taps != KERNEL_TAPS or self.out_dtype not in (
                torch.float32, torch.bfloat16):
            raise ValueError(f"the CUDA IF bank takes {KERNEL_TAPS} taps and "
                             "a float32 or bfloat16 output")
        if fm.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("fm must be float32 or bfloat16")
        if tuple(tail.shape) != (*lead, CTX) or tail.device != fm.device:
            raise ValueError(f"tail must be {(*lead, CTX)} on {fm.device}")
        channels = int(np.prod(lead)) if lead else 1
        # the bf16 engine stages 16-byte chunks: copy a view that starts
        # off a 16-byte boundary
        fm, tail = (x.contiguous() if x.data_ptr() % 16 == 0
                    else x.clone(memory_format=torch.contiguous_format)
                    for x in (fm, tail))
        return lead, n, channels, fm, tail

    def _taps_ptr(self, device) -> int:
        """The kernel's taps: the host float32 array (float32 engine) or
        the packed tiles on the card (bf16 engine)."""
        if self._mma_words is None:
            return self._kernel_taps.ctypes.data
        if self._mma_dev is None or self._mma_dev.device != device:
            self._mma_dev = torch.from_numpy(self._mma_words).to(device)
        return self._mma_dev.data_ptr()

    def _kernel(self, fm, tail):
        lead, n, channels, fm, tail = self._check(fm, tail)
        outs = torch.empty((4, *lead, n), dtype=self.out_dtype,
                           device=fm.device)
        bf16 = torch.bfloat16
        stream = torch.cuda.current_stream(fm.device).cuda_stream
        build.check(build.library().sdr_ifbank(
            fm.data_ptr(), tail.data_ptr(), int(fm.dtype == bf16), channels,
            n, self._taps_ptr(fm.device), self.taps,
            int(self.compute_dtype == bf16), *(o.data_ptr() for o in outs),
            int(self.out_dtype == bf16), stream))
        build.LAUNCHES["ifbank"] += 1
        return (*outs, fm[..., n - CTX:].clone())


class FusedIFBankMix(FusedIFBank):
    """Stateful fused IF bank for the feedforward stereo + RDS chain.

    `mix_call(fm, tail)` -> (chan, rds_channel, (zpr, zpi), (zrr, zri),
    new_tail), the reference's return tuple: the two streams (..., n) in
    out_dtype, the pilot's and the carrier's per-window sums
    (..., n // window) in float32, and the last CTX fm samples.
    """

    def __init__(self, chan_coeff, pilot_coeff, rds_coeff, carr_coeff, *,
                 window: int = 256, pilot_freq: float,
                 rds_carrier_freq: float, fs: float, **kw):
        super().__init__(chan_coeff, pilot_coeff, rds_coeff, carr_coeff,
                         **kw)
        self.window = int(window)
        self.pilot_freq = float(pilot_freq)
        self.rds_carrier_freq = float(rds_carrier_freq)
        self.fs = float(fs)
        self._ramp_cache: dict[tuple, tuple] = {}

    def ramps(self, n: int, device) -> tuple:
        """((cos, sin) of the pilot ramp, (cos, sin) of the carrier ramp),
        each (n,) float32: float64 host tables with the wrap modulus of
        each engine (nco_scale 2 and 0.5), as the reference's `_ramps`."""
        key = (n, torch.device(device))
        if key not in self._ramp_cache:
            tabs = []
            for freq, scale in ((self.pilot_freq, 2.0),
                                (self.rds_carrier_freq, 0.5)):
                ramp = ramp_f64(n, freq, self.fs, scale)
                tabs.append(tuple(
                    torch.from_numpy(np.asarray(f(ramp), np.float32)).to(
                        device) for f in (np.cos, np.sin)))
            self._ramp_cache[key] = tuple(tabs)
        return self._ramp_cache[key]

    # ------------------------------------------------------------ dispatch
    def mix_call(self, fm: torch.Tensor, tail: torch.Tensor,
                 interpret: bool = False):
        n = fm.shape[-1]
        if n % self.window or n < CTX:
            raise ValueError(f"IF block {n} is not a multiple of the "
                             f"window {self.window}")
        tail = tail.to(fm.dtype)
        if fm.is_cuda:
            return self._mix_kernel(fm, tail)
        if fm.device.type != "cpu":
            raise ValueError(f"no IF-bank kernel for device {fm.device}")
        return ifbank_mix_reference(self, fm, tail)

    def _mix_kernel(self, fm, tail):
        if self.window != KERNEL_WINDOW:
            raise ValueError(f"the CUDA IF bank takes window {KERNEL_WINDOW}")
        lead, n, channels, fm, tail = self._check(fm, tail)
        dev = fm.device
        chan = torch.empty((*lead, n), dtype=self.out_dtype, device=dev)
        rdsch = torch.empty_like(chan)
        z = torch.empty((4, *lead, n // self.window), dtype=torch.float32,
                        device=dev)
        (cp, sp), (cr, sr) = self.ramps(n, dev)
        bf16 = torch.bfloat16
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().sdr_ifbank_mix(
            fm.data_ptr(), tail.data_ptr(), int(fm.dtype == bf16), channels,
            n, self._taps_ptr(fm.device), self.taps,
            int(self.compute_dtype == bf16), cp.data_ptr(), sp.data_ptr(),
            cr.data_ptr(), sr.data_ptr(), chan.data_ptr(), rdsch.data_ptr(),
            int(self.out_dtype == bf16), z[0].data_ptr(), z[1].data_ptr(),
            z[2].data_ptr(), z[3].data_ptr(), stream))
        build.LAUNCHES["ifbank_mix"] += 1
        return (chan, rdsch, (z[0], z[1]), (z[2], z[3]),
                fm[..., n - CTX:].clone())


# --------------------------------------------------------------- plain torch
def _bank_streams(bank: FusedIFBank, fm: torch.Tensor, tail: torch.Tensor):
    """The four FIRs in plain PyTorch, as the kernel: float32 convs of
    compute-dtype-rounded operands, the RDS channel computed taps-1
    samples into the past so the carrier FIR needs no carried state.
    Returns float32 (chan, pilot, rds, carrier), each (C, n)."""
    n = fm.shape[-1]
    ext = bank.ext
    conv = torch.nn.functional.conv1d
    cdt = bank.compute_dtype
    x = torch.cat([tail.to(fm.dtype), fm], dim=-1).reshape(-1, 1, CTX + n)
    x = x.to(cdt).to(torch.float32)
    w = bank._weight.to(x.device)
    cp = conv(x[..., CTX - ext:], w[:2])                  # (C, 2, n)
    rds_ext = conv(x[..., CTX - 2 * ext:], w[2:3])[:, 0]  # (C, n + ext)
    sq = (rds_ext * rds_ext).to(cdt).to(torch.float32)
    carr = conv(sq[:, None], w[3:4])[:, 0]                # (C, n)
    return cp[:, 0], cp[:, 1], rds_ext[:, ext:], carr


def ifbank_reference(bank: FusedIFBank, fm: torch.Tensor,
                     tail: torch.Tensor):
    """Plain PyTorch four-stream IF bank, FusedIFBank.__call__'s return
    tuple."""
    *lead, n = fm.shape
    streams = (s.reshape(*lead, n).to(bank.out_dtype)
               for s in _bank_streams(bank, fm, tail))
    return (*streams, fm[..., n - CTX:].clone())


def ifbank_mix_reference(bank: FusedIFBankMix, fm: torch.Tensor,
                         tail: torch.Tensor):
    """Plain PyTorch IF bank + mix sums, FusedIFBankMix.mix_call's return
    tuple: the sums of the unrounded float32 pilot and carrier."""
    *lead, n = fm.shape
    chan, pilot, rds, carr = _bank_streams(bank, fm, tail)
    (cpc, sps), (crc, srs) = bank.ramps(n, fm.device)
    nw = n // bank.window

    def sums(v, cos, sin):
        v = v.reshape(-1, nw, bank.window)
        c = cos.reshape(nw, bank.window)
        s = sin.reshape(nw, bank.window)
        return ((v * c).sum(-1).reshape(*lead, nw),
                (v * -s).sum(-1).reshape(*lead, nw))
    return (chan.reshape(*lead, n).to(bank.out_dtype),
            rds.reshape(*lead, n).to(bank.out_dtype),
            sums(pilot, cpc, sps), sums(carr, crc, srs),
            fm[..., n - CTX:].clone())
