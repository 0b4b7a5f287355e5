"""The Toeplitz tap tiles that the tensor-core kernels multiply, checked
on the CPU: each wrapper's numpy tile, times the stream windows in the
layout its kernel reads, reproduces sdr_tpu's Pallas kernel in interpret
mode.  The front end (B1/B2) exactly in int64, for int8 and int8x2 at D =
4, 9 and 10, with the A-fragment packing and the halo and guard offsets;
the IF bank with mix sums (B3) within 1e-6 in float64, with the rds^2
halo and the k-step padding; the audio pair (B5) within 1e-6 at D = 5
and 6, through the padded window of each work item."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops.pallas import ifbank_kernel as jifbank
from sdr_tpu.ops.pallas.audio_kernel import PairDecimFIR as JaxPair
from sdr_tpu.ops.pallas.frontend_kernel import FusedFrontend as JaxFrontend
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.cuda import audio_kernel as A
from sdr_tpu_torch.ops.cuda import frontend_kernel as F
from sdr_tpu_torch.ops.cuda import ifbank_kernel as B

DECIMS = (4, 9, 10)
GUARD = 80            # csrc/frontend.cu kGuard: samples in front of slot 0
TILE_OUT = 512        # csrc/frontend.cu kTileOut


def _coeff(decim):
    cfg = MODES[{4: 1, 9: 3, 10: 0}[decim]]
    assert cfg.rf_decim == decim
    return firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)


def _stream(c, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (c, n),
                                                dtype=np.uint8)


def _planes(tail, body):
    """int64 I and Q planes of tail ++ body (x - 128), and the plane index
    of the body's first sample."""
    x = np.concatenate([tail, body], axis=-1).astype(np.int64) - 128
    return x[..., 0::2], x[..., 1::2], tail.shape[-1] // 2


def _mma_outputs(tile, plane, origin, decim, n_out):
    """What the kernel's products give: per 16-output segment m0, the
    tile times the column window plane[m0 D - (taps + 1) ...], zero past
    the stream's ends (the tile weighs those samples by 0)."""
    k = tile.shape[1]
    reach = F.MMA_PHASE + 50
    pad = np.zeros(plane.shape[:-1] + (k + 16 * decim,), np.int64)
    xp = np.concatenate([plane, pad], axis=-1)
    out = np.zeros(plane.shape[:-1] + (-(-n_out // 16) * 16,), np.int64)
    for m0 in range(0, n_out, 16):
        s = origin + m0 * decim - reach
        assert s >= 0
        out[..., m0:m0 + 16] = xp[..., s:s + k] @ tile.T
    return out[..., :n_out]


@pytest.mark.parametrize("decim", DECIMS)
@pytest.mark.parametrize("engine", ["int8", "int8x2"])
def test_frontend_tile_reproduces_reference(engine, decim):
    """Each limb's packed tile, unpacked, times the raw windows, combined
    as acc_hi*128 + acc_lo, equals the plain integer conv exactly, and
    float(acc) * scale equals the Pallas kernel's I and Q bit for bit."""
    coeff = _coeff(decim)
    c, n_out = 2, 3 * 128
    n = 2 * decim * n_out
    fe = F.FusedFrontend(coeff, decim, compute_dtype=engine, device="cpu")
    jfe = JaxFrontend(coeff, decim, out_tile=128, sub_tiles=2,
                      compute_dtype=engine)
    body = _stream(c, n, decim)
    tail = _stream(c, fe.tail_u8, 100 + decim)
    words = fe._mma_words
    halo = words[:F.HALO_WORDS]
    np.testing.assert_array_equal(halo[:51], fe.int_taps)
    assert not halo[51:].any()
    ks = F.mma_depth(decim) // F.MMA_K
    limbs = words[F.HALO_WORDS:].reshape(-1, ks, 32, 4)
    assert len(limbs) == (2 if engine == "int8x2" else 1)
    pi, pq, origin = _planes(tail, body)
    accs = []
    for plane in (pi, pq):
        parts = [_mma_outputs(F.unpack_a_s8(w), plane, origin, decim, n_out)
                 for w in limbs]
        accs.append(parts[0] * 128 + parts[1] if len(parts) == 2
                    else parts[0])
    # exactly the integer conv of the plain version
    for acc, plane in zip(accs, (pi, pq)):
        for m in (0, 1, 17, n_out - 1):
            want = sum(int(fe.int_taps[k]) * plane[:, origin + m * decim - k]
                       for k in range(51))
            np.testing.assert_array_equal(acc[:, m], want)
    ji, jq, _ = jfe(jnp.asarray(body), jnp.asarray(tail), interpret=True)
    for acc, want in zip(accs, (ji, jq)):
        got = acc.astype(np.float32) * np.float32(fe.scale)
        np.testing.assert_array_equal(got, np.asarray(want))
    ti, tq, _ = F.frontend_reference(fe, torch.from_numpy(body),
                                     torch.from_numpy(tail))
    np.testing.assert_array_equal(accs[0].astype(np.float32)
                                  * np.float32(fe.scale), ti.numpy())


@pytest.mark.parametrize("decim", DECIMS)
def test_frontend_tile_depth_and_offsets(decim):
    """K covers 15 D + 57 samples, rounded up to a whole k-step, and the
    tile is zero outside its band; a column's window starts on a multiple
    of 8 samples (a 16-byte shared load) wherever the 16-output segment
    starts; slot 0's guard holds a warp's halo output and the first
    column's reach; the packing round-trips."""
    k = F.mma_depth(decim)
    assert k % 32 == 0 and k - 32 < 15 * decim + 57 <= k
    assert k == {4: 128, 9: 192, 10: 224}[decim]
    taps = np.arange(1, 52, dtype=np.int64)
    tile = F.toeplitz_tile(taps, decim)
    for r in range(16):
        band = tile[r, r * decim + 6:r * decim + 57]
        np.testing.assert_array_equal(band, taps[::-1])
        assert np.count_nonzero(tile[r]) == 51
    np.testing.assert_array_equal(F.unpack_a_s8(F.pack_a_s8(tile)), tile)
    # the ring: guard, then slots of TILE_OUT * D samples; a warp's first
    # output at guard + slot*ts + warp*128*D; column g at +16 g D - 56
    ts = TILE_OUT * decim
    for slot in range(4):
        for warp in range(4):
            for g in range(8):
                base = GUARD + slot * ts + warp * 128 * decim + 16 * g * decim
                assert (base - (50 + F.MMA_PHASE)) % 8 == 0
                assert base - (50 + F.MMA_PHASE) >= 0
                # the halo output m0 - 1 reaches D + 50 samples back
                assert base - decim - 50 >= 0
    assert GUARD - decim - 50 >= 0 and GUARD % 8 == 0


# ------------------------------------------------------------------ B3
CFG = MODES[0]
RDS_LEAD, FM_LEAD, TILE_T = 128, 192, 1024   # csrc/ifbank.cu kRdsLead, ...


def _bank_coeffs():
    bp = lambda lo, hi: firdes.bandpass(CFG.if_fs, lo, hi, CFG.bp_taps)
    return (bp(CFG.stereo_lo, CFG.stereo_hi), bp(CFG.pilot_lo, CFG.pilot_hi),
            bp(CFG.rds_lo, CFG.rds_hi),
            bp(CFG.rds_carrier_lo, CFG.rds_carrier_hi))


def _tile_fir(tile, x, x_start, out_start, n_out):
    """Outputs at samples out_start .. out_start + n_out - 1 of the FIR
    whose tile is given, over x (x[i] is sample x_start + i, float64): per
    16-output segment, the tile times the window that starts 52 samples
    before it (zero past x's end)."""
    k = tile.shape[1]
    out = np.zeros(x.shape[:-1] + (n_out,))
    xp = np.concatenate([x, np.zeros(x.shape[:-1] + (k,))], axis=-1)
    for s in range(0, n_out, 16):
        b = out_start + s - (50 + B.MMA_PHASE) - x_start
        assert b >= 0
        out[..., s:s + 16] = xp[..., b:b + k] @ tile.T.astype(np.float64)
    return out


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_ifbank_tiles_reproduce_reference(compute):
    """The bank's four Toeplitz tiles (the packed ones, unpacked, for the
    bf16 engine), times the fm windows in the kernel's layout: rds over
    [-128, n) from fm staged from -192 (zero before the carried tail), its
    square (rounded to bf16 by the bf16 engine) for the carrier, the sums
    against the ramps.  Held to sdr_tpu's FusedIFBankMix in interpret
    mode in float64: the streams and the pilot sums within 1e-6 of max
    (float32 sums in another order), the carrier sums within 1e-6 (f32)
    and 1e-4 (bf16: where the two float32 sums of rds round its square to
    bf16 on either side, a carrier input moves by a bf16 ulp)."""
    bf = compute == "bf16"
    tcomp = torch.bfloat16 if bf else torch.float32
    kw = dict(window=256, pilot_freq=float(CFG.pilot_freq),
              rds_carrier_freq=float(CFG.rds_carrier_freq),
              fs=float(CFG.if_fs))
    jbank = jifbank.FusedIFBankMix(
        *_bank_coeffs(), compute_dtype=jnp.bfloat16 if bf else jnp.float32,
        **kw)
    tbank = B.FusedIFBankMix(*_bank_coeffs(), compute_dtype=tcomp,
                             device="cpu", **kw)
    if bf:
        words = tbank._mma_words.reshape(4, -1, 32, 4)
        tiles = [B.unpack_a_bf16(w) for w in words]
    else:
        assert tbank._mma_words is None
        tiles = [B.toeplitz_tile_bf16(h) for h in tbank._kernel_taps]
    rng = np.random.default_rng(7)
    c, n = 3, 1536     # a whole time tile of the kernel and half of one
    fm = rng.normal(0, 0.3, (c, n)).astype(np.float32)
    tail = rng.normal(0, 0.3, (c, B.CTX)).astype(np.float32)
    rnd = ((lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy())
           if bf else (lambda a: a))
    # fm staged from -FM_LEAD: zeros, then the tail, then the block
    x = np.concatenate([np.zeros((c, FM_LEAD - B.CTX), np.float32),
                        rnd(tail), rnd(fm)], axis=-1).astype(np.float64)
    rds = _tile_fir(tiles[2], x, -FM_LEAD, -RDS_LEAD, RDS_LEAD + n)
    sq = rnd(rds.astype(np.float32) * rds.astype(np.float32))
    chan = _tile_fir(tiles[0], x, -FM_LEAD, 0, n)
    pilot = _tile_fir(tiles[1], x, -FM_LEAD, 0, n)
    carr = _tile_fir(tiles[3], sq.astype(np.float64), -RDS_LEAD, 0, n)
    rds = rds[:, RDS_LEAD:]
    jout = jbank.mix_call(jnp.asarray(fm), jnp.asarray(tail),
                          interpret=True)
    for got, want in ((chan, jout[0]), (rds, jout[1])):
        want = np.asarray(want, np.float64)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    (cp, sp), (cr, sr) = tbank.ramps(n, "cpu")
    nw = n // 256
    for v, (cos, sin), jz, rel in ((pilot, (cp, sp), jout[2], 1e-6),
                                   (carr, (cr, sr), jout[3],
                                    1e-4 if bf else 1e-6)):
        vv = v.reshape(c, nw, 256)
        z = ((vv * cos.double().numpy().reshape(nw, 256)).sum(-1),
             (vv * -sin.double().numpy().reshape(nw, 256)).sum(-1))
        for got, want in zip(z, jz):
            want = np.asarray(want, np.float64)
            assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_ifbank_tile_depth_and_offsets():
    """K = 80 (five k-steps over the 68 samples that 16 outputs reach
    from 52 before the first), the band of each row, the packing round
    trip, and the staged window's offsets: every column starts on 4
    samples (8-byte loads), rds covers the carrier's 50-sample reach
    before the tile, and the last columns' zero-weighted over-read stays
    inside the staged window."""
    assert B.mma_depth() == 80
    taps = (np.arange(1, 52) / 64.0).astype(np.float32)
    tile = B.toeplitz_tile_bf16(taps)
    for r in range(16):
        np.testing.assert_array_equal(tile[r, r + 2:r + 53], taps[::-1])
        assert np.count_nonzero(tile[r]) == 51
    np.testing.assert_array_equal(B.unpack_a_bf16(B.pack_a_bf16(tile)), tile)
    fm_len, sq_len = FM_LEAD + TILE_T + 16, RDS_LEAD + TILE_T + 16
    reach = 50 + B.MMA_PHASE
    rds_col, fm_col, sq_col = (FM_LEAD - RDS_LEAD - reach, FM_LEAD - reach,
                               RDS_LEAD - reach)
    assert min(rds_col, fm_col, sq_col) >= 0
    assert rds_col % 4 == fm_col % 4 == sq_col % 4 == 0
    assert RDS_LEAD >= 50 and FM_LEAD >= RDS_LEAD + 50 and FM_LEAD >= B.CTX
    tiles = TILE_T // 128
    last = 128 * (tiles - 1) + 16 * 7 + 4 * 3 + 16 * 4 + 3  # the last load
    assert fm_col + last < fm_len and sq_col + last < sq_len
    assert rds_col + 128 + last < fm_len


# ------------------------------------------------------------------ B5
def _audio_coeff():
    return firdes.lowpass(CFG.if_fs, CFG.audio_fc, CFG.audio_taps, 1)


def _staged_window(x, tail, u0, down, n):
    """One stream's window of the item that starts at output u0, as
    csrc/audio.cu stages it: samples D u0 - LEAD ... (the carried tail
    before 0, zeros past n) at their padded places (float64)."""
    q = np.arange(down * A.ITEM_OUT + A.LEAD)
    p = down * u0 - A.LEAD + q
    vals = np.where(p < 0, tail[..., np.clip(A.CTX + p, 0, A.CTX - 1)],
                    x[..., np.clip(p, 0, n - 1)])
    vals = np.where(p < n, vals, 0.0)
    win = np.zeros(x.shape[:-1] + (int(A.window_index(q[-1], down)) + 1,))
    win[..., A.window_index(q, down)] = vals
    return win


def _audio_mma_outputs(tile, x, tail, down):
    """What the kernel's products give, item by item: per 16-output column
    at u, the tile times the 4-sample groups the lanes load from the padded
    window, from the column's start D (u - u0) + LEAD - 52."""
    n = x.shape[-1]
    m = n // down
    k = tile.shape[1]
    out = np.zeros(x.shape[:-1] + (m,))
    for u0 in range(0, m, A.ITEM_OUT):
        win = _staged_window(x, tail, u0, down, n)
        win = np.concatenate([win, np.zeros(x.shape[:-1] + (k,))], axis=-1)
        for u in range(u0, min(u0 + A.ITEM_OUT, m), 16):
            q0 = down * (u - u0) + A.LEAD - 50 - A.MMA_PHASE
            idx = np.concatenate([A.window_index(q0 + 4 * g, down) + np.arange(4)
                                  for g in range(k // 4)])
            seg = win[..., idx] @ tile.T.astype(np.float64)
            out[..., u:u + 16] = seg[..., :min(16, m - u)]
    return out


@pytest.mark.parametrize("down", [5, 6])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_audio_tile_reproduces_reference(compute, down):
    """B5's Toeplitz tile (the packed one, unpacked, for the bf16 engine)
    times the padded windows of csrc/audio.cu's items (1536 outputs: a
    whole item and half of one, the first 56 samples of the first from
    the carried tail) reproduces sdr_tpu's PairDecimFIR (the Pallas
    `_pair_kernel` in interpret mode) on both streams, within 1e-6 of max
    in float64 (float32 sums in another order); bf16 rounds the inputs
    and the taps, f32 neither."""
    bf = compute == "bf16"
    coeff = _audio_coeff()
    pair = A.PairDecimFIR(coeff, down, device="cpu",
                          compute_dtype=torch.bfloat16 if bf
                          else torch.float32)
    if bf:
        tile = B.unpack_a_bf16(pair._mma_words.reshape(-1, 32, 4))
        np.testing.assert_array_equal(
            tile, A.audio_tile_bf16(pair._kernel_taps, down))
    else:
        assert pair._mma_words is None
        tile = A.audio_tile_bf16(pair._kernel_taps, down)
    rng = np.random.default_rng(down)
    c, n = 3, down * 1536
    xs = rng.normal(0, 0.5, (2, c, n)).astype(np.float32)
    tails = rng.normal(0, 0.5, (2, c, A.CTX)).astype(np.float32)
    rnd = ((lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy())
           if bf else (lambda a: a))
    jpair = JaxPair(coeff, down, compute_dtype=jnp.bfloat16 if bf
                    else jnp.float32)
    want = jpair(*(jnp.asarray(v) for v in (xs[0], xs[1], tails[0],
                                              tails[1])), interpret=True)
    for s in range(2):
        got = _audio_mma_outputs(tile, rnd(xs[s]).astype(np.float64),
                                 rnd(tails[s]).astype(np.float64), down)
        w = np.asarray(want[s], np.float64)
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("down", [5, 6])
def test_audio_tile_depth_and_offsets(down):
    """K covers 15 D + 53 samples, rounded up to a whole k-step (128 at D
    = 5, 144 at D = 6), each row's band, the packing round trip; the item's
    lead covers the taps' reach and lies in the carried tail; every
    column's 4-sample groups are contiguous in the padded window and
    start on 4 samples (8-byte loads); a half-warp's four columns fall on
    distinct banks; the last column's reach stays in the window."""
    k = A.mma_depth(down)
    assert k == {5: 128, 6: 144}[down]
    assert k - 16 < 15 * down + 51 + A.MMA_PHASE <= k
    taps = (np.arange(1, 52) / 64.0).astype(np.float32)
    tile = A.audio_tile_bf16(taps, down)
    for r in range(16):
        np.testing.assert_array_equal(
            tile[r, down * r + 2:down * r + 53], taps[::-1])
        assert np.count_nonzero(tile[r]) == 51
    np.testing.assert_array_equal(B.unpack_a_bf16(B.pack_a_bf16(tile)), tile)
    assert A.LEAD % 8 == 0 and 50 + A.MMA_PHASE <= A.LEAD <= A.CTX
    pad, seg = A.window_pad(down), 16 * down
    assert pad == {5: 0, 6: 16}[down]
    for u in range(0, A.ITEM_OUT, 16):
        q0 = down * u + A.LEAD - 50 - A.MMA_PHASE   # the column's start
        assert q0 >= 0 and q0 % 4 == 0
        groups = A.window_index(q0 + np.arange(0, k, 4), down)
        for i in range(4):
            np.testing.assert_array_equal(
                A.window_index(q0 + np.arange(0, k, 4) + i, down), groups + i)
    assert down * (A.ITEM_OUT - 16) + A.LEAD - 52 + k <= \
        down * A.ITEM_OUT + A.LEAD
    # a half-warp: columns g = 0..3, each 4 lanes of 8 bytes from its start
    starts = [2 * int(A.window_index(A.LEAD - 52 + seg * g, down))
              for g in range(4)]
    banks = {((b + 8 * t) // 4 + i) % 32 for b in starts for t in range(4)
             for i in range(2)}
    assert len(banks) == 32
