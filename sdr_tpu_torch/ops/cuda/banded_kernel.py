"""The tiled engine's resampling FIR as one CUDA launch.

The kernel is in csrc/banded.cu and replaces the reference's tiled banded
GEMM (sdr_tpu/ops/banded.py `_tiled_apply`), the `conv_engine='tiled'`
schedule of every direct-engine resampling FIR:

    y[..., o] = sum_{j < M} P[j, o % U] * xp[..., start + (o D) // U + j]

with xp = tail ++ x read through two pointers, P the polyphase bank
(`polyphase_bank`) and start = S - (M - 1).  The float32 engine sums on
the CUDA cores (`sdr_banded`).  The bf16 engine (`sdr_banded_mma`) sums
on the tensor cores: the integer-ratio FIRs with the Toeplitz tile of
the taps (`u1_tile`), any other geometry over the non-zero tiles of a
band matrix whose layout `tile_map` chooses here, on the host (a window
row of the kernel's own `group` super-blocks every `adv` samples, the
band's 16 x 8 tiles in the kernel's order, packed as mma B fragments,
and the kernel's item and ring sizes).  `tile_sum` and `u1_sum` model
the two sums in float64 for the CPU tests.  What bounds it on an H100
and what its design does about it: see the source's header; times in
PERF.md.

`banded(fir, x, tail)` takes CUDA tensors only; ops/banded.py
`TiledBandedFIR` sends a CPU tensor to its plain version
(`tiled_reference`) instead.  Each launch adds one to
`build.LAUNCHES["banded"]`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sdr_tpu_torch.ops.cuda import build
from sdr_tpu_torch.ops.cuda.ifbank_kernel import pack_a_bf16


def polyphase_bank(bank: np.ndarray, up: int, down: int, m: int
                   ) -> np.ndarray:
    """The (M, U) float32 bank P[j, v] = B[d_v + j, v], d_v = (v D) // U:
    the non-zero band of the (L, U) bank B, one column a phase."""
    d = (np.arange(up) * down) // up
    rows = d[None, :] + np.arange(m)[:, None]
    return np.ascontiguousarray(bank[rows, np.arange(up)[None, :]],
                                np.float32)


# the bf16 engine's mma.sync.m16n8k16: window rows, band columns and band
# rows (samples) of a tile; n8 tiles a warp sums at once (its 16
# accumulators)
MMA_M, MMA_N, MMA_K = 16, 8, 16
CHUNK_TILES = 4
# the kernel's blocks of 4 warps, split into workers of 1, 2 or 4 warps;
# the shared memory a block should keep under to share an SM with another
# (bytes), the most it may take, and the deepest ring
BLOCK_WARPS = 4
SMEM_SHARED = 112 * 1024
SMEM_LIMIT = 220 * 1024
MAX_RING = 3


@dataclass(frozen=True)
class TileMap:
    """What the bf16 engine's kernel (csrc/banded.cu banded_mma_kernel)
    takes from the host.

    Row r of a window is the `adv` = group * D samples from xp[start +
    r adv] on, and its product with the band gives the `cols` = group * U
    outputs r cols ... r cols + cols - 1:

        band[g D + d_v + j, g U + v] = P[j, v]   (g < group, j < M)

    `tiles` lists the band's non-zero 16 x 8 tiles (k-tile, n-tile) in
    the kernel's order: n-tiles in chunks of CHUNK_TILES, each chunk's
    k-tiles ascending, a k-tile's n-tiles ascending.  `chunks` (shifts,
    n_chunks, 12) holds, a chunk, its first and last k-tile, its first
    tile's index, 0, then each n-tile's first and last k-tile (1, 0 for
    none).  `frags` holds the tiles as B fragments: (tiles, 32 lanes, 4)
    uint16, lane (g, t) holding band rows 2t, 2t+1, 2t+8, 2t+9 of column
    g (None where the bank does not hold bf16 values: the float32
    engine's).

    Two ways to the window.  `direct` (rows already on distinct bank
    groups, pad 0): the A fragments are read straight from the ring
    stage, which holds the input as it landed (ldmatrix of bf16, or
    8-byte loads of float32 rounded to bf16), from the 16-byte boundary
    at or below the window's start; the band comes in 8 shifts
    (`shifted_band`), one for each sample the start may lie past that
    boundary, each with its own tiles and chunks, one after another.
    Else the staged window is rounded to bf16 and copied into a window
    of its own, with `pad` samples of padding after every adv, so that
    the 8 rows of an ldmatrix (adv + pad samples apart) fall on 8
    distinct 16-byte bank groups.  An item is `mw` blocks of 16 window
    rows, taken by a worker of `wk` warps through a ring of `ring`
    windows of input (0 where not one fits beside the bf16 window:
    float32 input at 441/2560, read from device memory as the window is
    converted); a block holds 4 / wk workers."""
    group: int
    adv: int
    pad: int
    cols: int
    k_tiles: int
    n_tiles: int
    band: np.ndarray
    tiles: np.ndarray
    chunks: np.ndarray
    frags: np.ndarray | None
    mw: int
    ring: int
    wk: int
    direct: bool

    @property
    def shifts(self) -> int:
        return len(self.chunks)

    def shift_tiles(self, sh: int) -> np.ndarray:
        """The tiles of shift sh (k-tile, n-tile), in the kernel's walk."""
        end = (self.chunks[sh + 1, 0, 2] if sh + 1 < self.shifts
               else len(self.tiles))
        return self.tiles[self.chunks[sh, 0, 2]:end]

    def shifted_band(self, sh: int) -> np.ndarray:
        """The band moved down sh rows: its rows k read window sample
        k - sh."""
        return np.roll(self.band, sh, axis=0)


def mma_group(up: int, down: int) -> int:
    """The kernel's own group: the fewest super-blocks a row that make its
    advance a multiple of 8 samples (each row starts on a 16-byte
    boundary for ldmatrix) and give at least 16 output columns (two
    n-tiles for U = 1)."""
    g0 = 8 // math.gcd(down, 8)
    need = -(-MMA_M // up)
    return g0 * -(-need // g0)


def mma_smem(adv: int, pad: int, k_tiles: int, mw: int, ring: int,
             in_bytes: int, wk: int, direct: bool = False) -> int:
    """Shared memory of a block (csrc/banded.cu launch_mma): the k-step
    offsets, then for each of its 4 / wk workers the bf16 window (none
    where `direct`) and `ring` stages of input in 16-byte chunks, with
    room for the chunks the window straddles."""
    win = (MMA_M * mw - 1) * adv + MMA_K * k_tiles
    phys = win - 1 + pad * ((win - 1) // adv) + 1
    epc = 16 // in_bytes
    stage = (-(-win // epc) + 4) * 16
    worker = (0 if direct else -(-phys // 8) * 16) + ring * stage
    return -(-2 * k_tiles * 4 // 16) * 16 + BLOCK_WARPS // wk * worker


def mma_layout(adv: int, pad: int, k_tiles: int, n_chunks: int,
               in_bytes: int, direct: bool = False) -> tuple[int, int, int]:
    """(wk, mw, ring): the fewest warps a worker, then the deepest ring
    (two where `direct`), with which a block fits beside another on an SM
    (each worker's warps given a unit of work: mw blocks of 16 rows times
    the chunks); else workers of 4 warps and as deep a ring as fits at
    all (two at least where `direct`: the stage being summed is not
    refilled)."""
    def rows(wk):
        mw = 1
        while mw < 8 and mw * n_chunks < wk:
            mw *= 2
        return mw
    for wk in (1, 2, 4):
        # direct: one item ahead a worker, and more workers an SM, beat
        # two ahead (19/120: 0.1355 against 0.1545 ms, PERF.md)
        for ring in ((2,) if direct else (MAX_RING, 2)):
            mw = rows(wk)
            if mma_smem(adv, pad, k_tiles, mw, ring, in_bytes,
                        wk, direct) <= SMEM_SHARED:
                return wk, mw, ring
    mw = rows(BLOCK_WARPS)
    for ring in range(MAX_RING, 1 if direct else -1, -1):
        if mma_smem(adv, pad, k_tiles, mw, ring, in_bytes,
                    BLOCK_WARPS, direct) <= SMEM_LIMIT:
            return BLOCK_WARPS, mw, ring
    raise ValueError("a window of 16 rows does not fit in shared memory")


def tile_map(bank: np.ndarray, up: int, down: int, m: int,
             in_bytes: int = 2) -> TileMap:
    """The bf16 engine's tile map of the (L, U) bank `bank` (rounded to
    bf16 already), for input of `in_bytes` a sample.  Raises where the
    band of an n-tile is not one run of k-tiles (the kernel walks a run)
    or no item fits in shared memory."""
    p = polyphase_bank(bank, up, down, m)
    group = mma_group(up, down)
    adv, cols = group * down, group * up
    pad = 8 if (adv // 8) % 2 == 0 else 0
    direct = pad == 0
    shifts = 8 if direct else 1
    d = (np.arange(up) * down) // up
    reach = (group - 1) * down + int(d[-1]) + m
    k_tiles = -(-(reach + shifts - 1) // MMA_K)
    n_tiles = -(-cols // MMA_N)
    band = np.zeros((MMA_K * k_tiles, MMA_N * n_tiles), np.float32)
    support = np.zeros(band.shape, bool)
    for g in range(group):
        for v in range(up):
            k0 = g * down + int(d[v])
            band[k0:k0 + m, g * up + v] = p[:, v]
            support[k0:k0 + m, g * up + v] = True
    n_chunks = -(-n_tiles // CHUNK_TILES)
    chunks = np.zeros((shifts, n_chunks, 12), np.int32)
    tiles, frags = [], []
    for sh in range(shifts):
        live = np.roll(support, sh, axis=0).reshape(
            k_tiles, MMA_K, n_tiles, MMA_N).any(axis=(1, 3))
        first = len(tiles)
        for cc in range(n_chunks):
            lo, hi = [1] * CHUNK_TILES, [0] * CHUNK_TILES
            for j in range(CHUNK_TILES):
                nt = cc * CHUNK_TILES + j
                if nt >= n_tiles:
                    continue
                ks = np.flatnonzero(live[:, nt])
                if len(ks) != ks[-1] - ks[0] + 1:
                    raise ValueError(f"U={up} D={down} M={m}: the band of "
                                     f"n-tile {nt} is not one run of "
                                     "k-tiles")
                lo[j], hi[j] = int(ks[0]), int(ks[-1])
            used = [j for j in range(CHUNK_TILES) if lo[j] <= hi[j]]
            klo = min(lo[j] for j in used)
            khi = max(hi[j] for j in used)
            chunks[sh, cc] = [klo, khi, len(tiles), 0, *lo, *hi]
            for kt in range(klo, khi + 1):
                for j in used:
                    if lo[j] <= kt <= hi[j]:
                        tiles.append((kt, cc * CHUNK_TILES + j))
        frags.append((np.roll(band, sh, axis=0),
                      np.asarray(tiles[first:], np.int64)))
    wk, mw, ring = mma_layout(adv, pad, k_tiles, n_chunks, in_bytes, direct)
    exact = np.array_equal(torch.from_numpy(band).to(torch.bfloat16)
                           .float().numpy(), band)
    return TileMap(group, adv, pad, cols, k_tiles, n_tiles, band,
                   np.asarray(tiles, np.int64), chunks,
                   np.concatenate([pack_b_frags(b, t) for b, t in frags])
                   if exact else None, mw, ring, wk, direct)


def pack_b_frags(band: np.ndarray, tiles: np.ndarray) -> np.ndarray:
    """The band's tiles as mma.m16n8k16 B fragments: (tiles, 32, 4)
    uint16 bf16 bits, lane (g, t) = (lane // 4, lane % 4) holding rows
    2t, 2t+1 (b0, low half first) and 2t+8, 2t+9 (b1) of column g."""
    bits = torch.from_numpy(band).to(torch.bfloat16)
    assert torch.equal(bits.float(), torch.from_numpy(band)), \
        "the band must hold bf16 values"
    b = bits.view(torch.int16).numpy().view(np.uint16)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rows = np.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], axis=1)
    out = np.zeros((len(tiles), 32, 4), np.uint16)
    for i, (kt, nt) in enumerate(tiles):
        out[i] = b[MMA_K * kt + rows, (MMA_N * nt + g)[:, None]]
    return out


def tile_sum(tm: TileMap, xp: np.ndarray, start: int, n_out: int,
             shift: int = 0) -> np.ndarray:
    """The bf16 engine's sum in float64, tile by tile as the kernel takes
    it: window rows of xp (..., q) from `start` - shift, zero outside it,
    times each listed tile of the band of that shift; the outputs (...,
    n_out)."""
    rows = -(-n_out // tm.cols)
    width = MMA_K * tm.k_tiles
    need = start + (rows - 1) * tm.adv + width
    pad = max(0, need - xp.shape[-1])
    xp = np.concatenate([np.zeros(xp.shape[:-1] + (shift,)), xp,
                         np.zeros(xp.shape[:-1] + (pad,))], axis=-1)
    idx = start + tm.adv * np.arange(rows)[:, None] + np.arange(width)
    win = xp[..., idx]                                # (..., rows, width)
    out = np.zeros(xp.shape[:-1] + (rows, MMA_N * tm.n_tiles))
    band = tm.shifted_band(shift).astype(np.float64)
    for kt, nt in tm.shift_tiles(shift):
        ks, ns = slice(MMA_K * kt, MMA_K * kt + MMA_K), slice(
            MMA_N * nt, MMA_N * nt + MMA_N)
        out[..., ns] += win[..., ks] @ band[ks, ns]
    out = out[..., :tm.cols].reshape(xp.shape[:-1] + (rows * tm.cols,))
    return out[..., :n_out]


def kernel_body(fir, x_dtype: torch.dtype) -> str:
    """The body of csrc/banded.cu that a launch on input of x_dtype runs
    (the C entry points' dispatch), with the bf16 engine's layout."""
    if fir.compute_dtype == torch.bfloat16:
        if fir.up == 1 and (fir.down, fir.M) in U1_BODIES:
            k = -(-(15 * fir.down + fir.M + U1_PHASE) // MMA_K)
            return f"banded_u1_mma_kernel ({k} k-steps of the taps' tile)"
        tm = tile_map(fir._bank, fir.up, fir.down, fir.M,
                      torch.empty((), dtype=x_dtype).element_size())
        return (f"banded_mma_kernel (group {tm.group}, "
                f"{len(tm.shift_tiles(0))} tiles, {16 * tm.mw} rows an "
                f"item, workers of {tm.wk} warps, ring {tm.ring}, "
                + ("window read from the ring)" if tm.direct
                   else "window converted)"))
    if fir.up == 1 and (fir.M, fir.down) in {(151, 1), (51, 1), (51, 5),
                                             (51, 6), (51, 10)}:
        return "banded_u1_kernel"
    if (fir.up, fir.down, fir.M) == (19, 120, 51):
        return "banded_phase_kernel"
    return "banded_poly_kernel"


# the U = 1 body (csrc/banded.cu banded_u1_mma_kernel): its (D, taps),
# and the samples a column starts before the taps' reach (so that a lane's
# 4 samples of a k-step are one aligned load)
U1_BODIES = {(1, 151), (1, 51), (5, 51), (6, 51), (10, 51)}
U1_PHASE = 2


def u1_tile(bank: np.ndarray, down: int, m: int) -> np.ndarray:
    """The U = 1 body's (16, K) float32 Toeplitz tile of the taps h[j] =
    B[j, 0]: row r, column kk holds h[kk - D r - U1_PHASE] (0 outside the
    taps), so that the tile times the window from xp[start + D o0 -
    U1_PHASE] gives outputs o0 ... o0 + 15; K = 15 D + M + U1_PHASE
    rounded up to a whole k-step."""
    h = np.asarray(bank, np.float32)[:m, 0]
    k = -(-(15 * down + m + U1_PHASE) // MMA_K) * MMA_K
    a = np.zeros((MMA_M, k), np.float32)
    for r in range(MMA_M):
        a[r, down * r + U1_PHASE:down * r + U1_PHASE + m] = h
    return a


def u1_sum(tile: np.ndarray, xp: np.ndarray, start: int, down: int,
           n_out: int) -> np.ndarray:
    """The U = 1 body's sum in float64: the tile times the window columns
    of xp (..., q), 16 outputs a column; the outputs (..., n_out)."""
    cols = -(-n_out // MMA_M)
    width = tile.shape[1]
    c0 = start - U1_PHASE + MMA_M * down * np.arange(cols)
    need = int(c0[-1]) + width
    lead = max(0, -int(c0[0]))
    xp = np.concatenate([np.zeros(xp.shape[:-1] + (lead,)), xp,
                         np.zeros(xp.shape[:-1] + (max(0, need
                                                       - xp.shape[-1]),))],
                        axis=-1)
    win = xp[..., lead + c0[:, None] + np.arange(width)]   # (..., cols, K)
    out = win @ tile.astype(np.float64).T                  # (..., cols, 16)
    return out.reshape(xp.shape[:-1] + (cols * MMA_M,))[..., :n_out]


def _kernel_bank(fir, device: torch.device) -> tuple:
    """What a launch takes on `device`, made at the first launch there and
    kept on the FIR: the float32 engine's polyphase bank on the host (the
    kernels that take their taps in their parameters read it at launch)
    and on the card; the bf16 engine's tile maps (by input bytes) and
    their fragments and chunks on the card."""
    cache = fir._kernel_banks
    if device not in cache:
        if fir.compute_dtype == torch.bfloat16:
            maps = {}
            for in_bytes in (2, 4):
                tm = tile_map(fir._bank, fir.up, fir.down, fir.M, in_bytes)
                maps[in_bytes] = (
                    tm, torch.from_numpy(tm.frags.view(np.int16)).to(device),
                    torch.from_numpy(tm.chunks.reshape(-1, 12)).to(device))
            u1 = None
            if fir.up == 1 and (fir.down, fir.M) in U1_BODIES:
                u1 = torch.from_numpy(pack_a_bf16(u1_tile(
                    fir._bank, fir.down, fir.M))).to(device)
            cache[device] = (maps, u1)
        else:
            p = polyphase_bank(fir._bank, fir.up, fir.down, fir.M)
            cache[device] = (p, torch.from_numpy(p).to(device))
    return cache[device]


def banded(fir, x: torch.Tensor, tail: torch.Tensor):
    """One launch of the banded FIR: (y float32 (..., n // D * U), new_tail
    (..., S) in fir.store_dtype)."""
    *lead, n = x.shape
    s = fir.state_len
    if not (x.is_cuda and tail.device == x.device):
        raise ValueError("the banded-FIR kernel takes x and tail on one "
                         "CUDA device")
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in (x, tail)):
        raise TypeError("x and tail must be float32 or bfloat16")
    if tuple(tail.shape) != (*lead, s):
        raise ValueError(f"tail must be {(*lead, s)}, got "
                         f"{tuple(tail.shape)}")
    rows = int(np.prod(lead)) if lead else 1
    x, tail = x.contiguous(), tail.contiguous()
    y = torch.empty((*lead, n // fir.down * fir.up), dtype=torch.float32,
                    device=x.device)
    new_tail = torch.empty((*lead, s), dtype=fir.store_dtype,
                           device=x.device)
    bf16 = torch.bfloat16
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if fir.compute_dtype == bf16:
        maps, u1 = _kernel_bank(fir, x.device)
        tm, frags, chunks = maps[x.element_size()]
        build.check(build.library().sdr_banded_mma(
            x.data_ptr(), tail.data_ptr(), int(x.dtype == bf16),
            int(tail.dtype == bf16), rows, n, fir.up, fir.down, fir.M, s,
            tm.group, tm.pad, tm.k_tiles, tm.mw, tm.chunks.shape[1], tm.ring,
            tm.wk, int(tm.direct), frags.data_ptr(), chunks.data_ptr(),
            None if u1 is None else u1.data_ptr(), y.data_ptr(),
            new_tail.data_ptr(), stream))
    else:
        taps, bank = _kernel_bank(fir, x.device)
        build.check(build.library().sdr_banded(
            x.data_ptr(), tail.data_ptr(), int(x.dtype == bf16),
            int(tail.dtype == bf16), rows, n, fir.up, fir.down, fir.M, s,
            taps.ctypes.data, bank.data_ptr(), y.data_ptr(),
            new_tail.data_ptr(), stream))
    build.LAUNCHES["banded"] += 1
    return y, new_tail
