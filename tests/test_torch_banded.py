"""The port's TiledBandedFIR (ops/banded.py; on the CPU its plain version,
the reference's schedule in torch) against sdr_tpu's TiledBandedFIR, in
every geometry the tiled engine meets (RF, the four modes' audio, the RDS
resampler of modes 0 and 2, the RRC, the band-passes) and both engines,
over a two-block carry on numpy-seeded inputs; the CUDA kernel's terms
(the polyphase bank, csrc/banded.cu) against the same reference; the bf16
engine's tile map (its band tiles, group, row stride and B fragments) and
a float64 sum over its tiles against the kernel's terms and the
reference; the
`group` override and the reference's error cases; and the Receiver's
wiring of the engine.

Tolerance: y within 1e-5 of max|ref| (the sums run in another order; about
1e-7 observed), the carried tail bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops.banded import TiledBandedFIR as JaxTiled
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.banded import TiledBandedFIR, _tile_band_matrix
from sdr_tpu_torch.ops.cuda.banded_kernel import (MMA_K, MMA_N, U1_BODIES,
                                                  U1_PHASE, banded,
                                                  kernel_body, polyphase_bank,
                                                  tile_map, tile_sum, u1_sum,
                                                  u1_tile)
from sdr_tpu_torch.ops.resample import PolyphaseResampler, _build_filter_bank

REL = 1e-5
ENGINES = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}


def _geometries():
    cfg = MODES[0]
    out = [("rf", firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1), 1,
            cfg.rf_decim)]
    for m, c in MODES.items():
        out.append((f"audio{m}",
                    firdes.lowpass(c.if_fs * c.audio_interp, c.audio_fc,
                                   c.audio_taps, c.audio_gain),
                    c.audio_interp, c.audio_decim))
    for m in (0, 2):
        c = MODES[m]
        u, d = c.rds_resample
        out.append((f"rds{m}", firdes.lowpass(c.if_fs * u, c.rds_fc,
                                              c.bp_taps * u, u), u, d))
    out.append(("rrc", firdes.root_raised_cosine(cfg.rds_fs, 151,
                                                 cfg.rds_symbol_rate), 1, 1))
    out.append(("bpf", firdes.bandpass(cfg.if_fs, cfg.rds_lo, cfg.rds_hi,
                                       cfg.bp_taps), 1, 1))
    return out


GEOMETRIES = _geometries()
IDS = [g[0] for g in GEOMETRIES]
# the resampler geometries test_torch_resample.py runs (RF, audio 0-3)
RESAMPLE = GEOMETRIES[:5]


def _blocks(fir, seed, supers=None):
    """Two (2, n) float32 blocks of n = D * supers samples: 4-64
    super-blocks, and at least the carried tail."""
    if supers is None:
        supers = max(-(-fir.state_len // fir.down),
                     min(64, max(4, 640 // fir.down)))
    n = fir.down * supers
    x = np.random.default_rng(seed).normal(0, 0.5, (2, 2 * n))
    x = x.astype(np.float32)
    return [x[:, :n], x[:, n:]]


def _close(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def _kernel_terms(fir, x, tail):
    """The kernel's sum (csrc/banded.cu) in float64: y[o] = sum_j
    P[j, o % U] xp[start + (o D) // U + j] over the polyphase bank."""
    xp = np.concatenate([tail.to(fir.store_dtype).double().numpy(),
                         x.to(fir.store_dtype).double().numpy()], axis=-1)
    p = polyphase_bank(fir._bank, fir.up, fir.down, fir.M)
    o = np.arange(x.shape[-1] // fir.down * fir.up)
    idx = (fir.state_len - (fir.M - 1) + (o * fir.down) // fir.up)[:, None]
    idx = idx + np.arange(fir.M)[None, :]
    return (xp[..., idx] * p[:, o % fir.up].T).sum(-1)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_tiled_matches_reference(geom, engine):
    _, coeff, up, down = geom
    tdt, jdt = ENGINES[engine]
    port = TiledBandedFIR(coeff, up, down, compute_dtype=tdt, device="cpu")
    ref = JaxTiled(coeff, up, down, compute_dtype=jdt)
    assert (port.state_len, port.group, port.M, port.L) == (
        ref.state_len, ref.group, ref.M, ref.L)
    np.testing.assert_array_equal(
        port.band_matrix.numpy(),
        np.asarray(jnp.asarray(ref._a).astype(jdt), np.float32))
    jt, tt = ref.init_state((2,)), port.init_state((2,))
    assert tt.dtype == tdt and tt.shape == jt.shape
    for x in _blocks(port, seed=up + down + len(coeff)):
        jy, jt = ref(jnp.asarray(x), jt)
        ty, tt = port(torch.from_numpy(x), tt)
        assert ty.shape == jy.shape and ty.dtype == torch.float32
        assert tt.dtype == tdt
        _close(ty.numpy(), jy)
        np.testing.assert_array_equal(tt.float().numpy(),
                                      np.asarray(jt, np.float32))


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_kernel_terms_match_reference(geom, engine):
    """What csrc/banded.cu sums (the polyphase bank, no band-matrix zeros,
    tail and block read apart, rounded to the store dtype on load) agrees
    with the reference over a carried block."""
    _, coeff, up, down = geom
    tdt, jdt = ENGINES[engine]
    port = TiledBandedFIR(coeff, up, down, compute_dtype=tdt, device="cpu")
    ref = JaxTiled(coeff, up, down, compute_dtype=jdt)
    p = polyphase_bank(port._bank, up, down, port.M)
    b, _, _, _ = _build_filter_bank(np.asarray(coeff, np.float64), up, down)
    assert p.shape == (port.M, up)
    assert np.count_nonzero(p) == np.count_nonzero(b)
    jt, tt = ref.init_state((2,)), port.init_state((2,))
    for x in _blocks(port, seed=3 * up + down):
        jy, jt = ref(jnp.asarray(x), jt)
        _close(_kernel_terms(port, torch.from_numpy(x), tt), jy)
        tt = torch.from_numpy(x[:, -port.state_len:]).to(tdt)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_tile_map_covers_band(geom, engine):
    """The tile map the bf16 engine's kernel takes (csrc/banded.cu
    banded_mma_kernel): rows every group * D samples on a 16-byte
    boundary, padded onto distinct bank groups where the window is
    converted; for each shift of the band (8 where the rows are read
    straight from the ring, else 1) its tiles, each holding a non-zero of
    the band, cover every non-zero of the polyphase bank exactly once for
    each super-block of a row, in the order the kernel walks them; the B
    fragments unpack to those tiles; and a float64 sum over the tiles of
    each shift equals the kernel's terms and the reference over a carried
    block."""
    _, coeff, up, down = geom
    tdt, jdt = ENGINES[engine]
    port = TiledBandedFIR(coeff, up, down, compute_dtype=tdt, device="cpu")
    ref = JaxTiled(coeff, up, down, compute_dtype=jdt)
    tm = tile_map(port._bank, up, down, port.M)
    assert tm.adv == tm.group * down and tm.adv % 8 == 0
    assert tm.cols == tm.group * up >= 16 and tm.pad in (0, 8)
    assert ((tm.adv + tm.pad) // 8) % 2 == 1
    assert tm.direct == (tm.pad == 0) and tm.shifts == (8 if tm.direct else 1)
    p = polyphase_bank(port._bank, up, down, port.M)
    d = (np.arange(up) * down) // up
    support = np.zeros(tm.band.shape, bool)
    for g in range(tm.group):
        for v in range(up):
            k = g * down + d[v] + np.arange(port.M)
            support[k, g * up + v] = True
            np.testing.assert_array_equal(tm.band[k, g * up + v], p[:, v])
    assert not tm.band[~support].any()
    if engine == "bf16":
        bits = torch.from_numpy(tm.frags.view(np.int16)).view(torch.bfloat16)
        frags = bits.float().numpy()
        assert len(frags) == len(tm.tiles)
    else:
        assert tm.frags is None
    t, g = np.arange(32) % 4, np.arange(32) // 4
    start = port.state_len - (port.M - 1)
    blocks = _blocks(port, seed=5 * up + down)
    for sh in range(tm.shifts):
        band, sup = tm.shifted_band(sh), np.roll(support, sh, axis=0)
        assert not sup[:sh].any()
        cover = np.zeros(band.shape, int)
        tiles = tm.shift_tiles(sh)
        for kt, nt in tiles:
            ks = slice(MMA_K * kt, MMA_K * (kt + 1))
            ns = slice(MMA_N * nt, MMA_N * (nt + 1))
            assert sup[ks, ns].any(), (sh, kt, nt)
            cover[ks, ns] += 1
        assert cover.max() == 1 and (cover[sup] == 1).all()
        # the kernel's walk: a chunk's k-tiles ascending, its n-tiles within
        walk = []
        for cc, (klo, khi, first, _, *lohi) in enumerate(tm.chunks[sh]):
            assert first == tm.chunks[sh, 0, 2] + len(walk)
            lo, hi = lohi[:4], lohi[4:]
            walk += [(kt, 4 * cc + j) for kt in range(klo, khi + 1)
                     for j in range(4) if lo[j] <= kt <= hi[j]]
        np.testing.assert_array_equal(np.asarray(walk), tiles)
        if engine == "bf16":
            for i, (kt, nt) in enumerate(tiles):
                tile = np.zeros((MMA_K, MMA_N), np.float32)
                f = frags[tm.chunks[sh, 0, 2] + i]
                for r, rows in enumerate((2 * t, 2 * t + 1, 2 * t + 8,
                                          2 * t + 9)):
                    tile[rows, g] = f[:, r]
                np.testing.assert_array_equal(
                    tile, band[MMA_K * kt:MMA_K * (kt + 1),
                               MMA_N * nt:MMA_N * (nt + 1)])
        jt, tt = ref.init_state((2,)), port.init_state((2,))
        for x in blocks:
            jy, jt = ref(jnp.asarray(x), jt)
            xt = torch.from_numpy(x)
            xp = torch.cat([tt, xt.to(tdt)], -1).double().numpy()
            got = tile_sum(tm, xp, start, x.shape[-1] // down * up, sh)
            want = _kernel_terms(port, xt, tt)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
            _close(got, jy)
            tt = xt[:, -port.state_len:].to(tdt)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("geom", [g for g in GEOMETRIES if g[2] == 1],
                         ids=[g[0] for g in GEOMETRIES if g[2] == 1])
def test_u1_tile_terms(geom, engine):
    """The U = 1 body's Toeplitz tile of the taps (csrc/banded.cu
    banded_u1_mma_kernel, taken at the D and taps of U1_BODIES): row r
    holds the taps D r + U1_PHASE columns in, and a float64 sum of it over
    the window columns equals the kernel's terms and the reference over a
    carried block."""
    _, coeff, up, down = geom
    tdt, jdt = ENGINES[engine]
    port = TiledBandedFIR(coeff, up, down, compute_dtype=tdt, device="cpu")
    ref = JaxTiled(coeff, up, down, compute_dtype=jdt)
    assert (down, port.M) in U1_BODIES
    tile = u1_tile(port._bank, down, port.M)
    assert tile.shape == (16, -(-(15 * down + port.M + U1_PHASE) // 16) * 16)
    for r in range(16):
        row = tile[r, down * r + U1_PHASE:down * r + U1_PHASE + port.M]
        np.testing.assert_array_equal(row, port._bank[:port.M, 0])
        assert np.count_nonzero(tile[r]) == np.count_nonzero(row)
    start = port.state_len - (port.M - 1)
    jt, tt = ref.init_state((2,)), port.init_state((2,))
    for x in _blocks(port, seed=11 * down):
        jy, jt = ref(jnp.asarray(x), jt)
        xt = torch.from_numpy(x)
        xp = torch.cat([tt, xt.to(tdt)], -1).double().numpy()
        got = u1_sum(tile, xp, start, down, x.shape[-1] // down)
        np.testing.assert_allclose(got, _kernel_terms(port, xt, tt),
                                   rtol=0, atol=1e-12)
        _close(got, jy)
        tt = xt[:, -port.state_len:].to(tdt)


def test_kernel_body_dispatch():
    """Which body of csrc/banded.cu a launch runs: the bf16 engine's U = 1
    tensor-core body at the D and taps it takes, its general body
    elsewhere, the float32 engine's U = 1, phase and polyphase bodies
    where sdr_banded sends them."""
    want = {"rf": "u1", "audio0": "u1", "audio1": "u1", "audio2": "poly",
            "audio3": "poly", "rds0": "phase", "rds2": "poly", "rrc": "u1",
            "bpf": "u1"}
    for name, coeff, up, down in GEOMETRIES:
        f32 = TiledBandedFIR(coeff, up, down, device="cpu")
        assert kernel_body(f32, torch.float32) == f"banded_{want[name]}_kernel"
        bf = TiledBandedFIR(coeff, up, down, compute_dtype=torch.bfloat16,
                            device="cpu")
        body = "u1_mma" if up == 1 else "mma"
        for dt in (torch.float32, torch.bfloat16):
            assert kernel_body(bf, dt).startswith(f"banded_{body}_kernel")


@pytest.mark.parametrize("geom", RESAMPLE, ids=IDS[:5])
def test_resampler_bf16_tiled_profile(geom):
    """conv_engine='tiled' + conv_dtype='bf16': bf16 operands, f32 sums,
    tail stored at bf16."""
    _, coeff, up, down = geom
    ref = JaxTiled(coeff, up, down, compute_dtype=jnp.bfloat16)
    port = TiledBandedFIR(coeff, up, down, compute_dtype=torch.bfloat16,
                          device="cpu")
    jt, tt = ref.init_state((2,)), port.init_state((2,))
    assert tt.dtype == torch.bfloat16 and jt.dtype == jnp.bfloat16
    n = down * (64 if down <= 10 else 4)
    x = np.random.default_rng(7 * up + down).normal(0, 0.5, (2, 2 * n))
    for blk in (x[:, :n], x[:, n:]):
        blk = blk.astype(np.float32)
        jy, jt = ref(jnp.asarray(blk), jt)
        ty, tt = port(torch.from_numpy(blk), tt)
        _close(ty.numpy(), jy)
        np.testing.assert_array_equal(tt.float().numpy(),
                                      np.asarray(jt, np.float32))


@pytest.mark.parametrize("group", [1, 3, 40])
def test_group_override(group):
    """Another tile grouping is the same terms: the reference's at that
    group, and the default grouping's outputs."""
    cfg = MODES[0]
    u, d = cfg.rds_resample
    coeff = firdes.lowpass(cfg.if_fs * u, cfg.rds_fc, cfg.bp_taps * u, u)
    port = TiledBandedFIR(coeff, u, d, group=group, device="cpu")
    ref = JaxTiled(coeff, u, d, group=group)
    base = TiledBandedFIR(coeff, u, d, device="cpu")
    assert port.group == ref.group == group
    assert port.band_matrix.shape == ((group - 1) * d + port.L, group * u)
    x = np.random.default_rng(group).normal(0, 0.5, (3, 5 * d))
    x = x.astype(np.float32)
    jy, jt = ref(jnp.asarray(x), ref.init_state((3,)))
    ty, tt = port(torch.from_numpy(x), port.init_state((3,)))
    by, _ = base(torch.from_numpy(x), base.init_state((3,)))
    _close(ty.numpy(), jy)
    _close(ty.numpy(), by.numpy())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_tile_band_matrix_copy_equal():
    from sdr_tpu.ops.banded import _tile_band_matrix as jtile
    b, _, _, _ = _build_filter_bank(
        firdes.lowpass(240e3 * 19, 3e3, 51 * 19, 19), 19, 120)
    for group in (1, 7, 40):
        np.testing.assert_array_equal(_tile_band_matrix(b, 120, group),
                                      jtile(b, 120, group))


def test_leading_axes_and_f32_conv_engine_agree():
    """(2, 3, n) rows flatten as the reference's do; the f32 tiled engine
    and the conv engine compute the same terms."""
    coeff = firdes.lowpass(240e3, 16e3, 51, 1)
    tiled = TiledBandedFIR(coeff, 1, 5, device="cpu")
    conv = PolyphaseResampler(coeff, 1, 5, device="cpu")
    x = np.random.default_rng(5).normal(0, 0.5, (2, 3, 250))
    x = torch.from_numpy(x.astype(np.float32))
    ty, tt = tiled(x, tiled.init_state((2, 3)))
    cy, ct = conv(x, conv.init_state((2, 3)))
    assert ty.shape == (2, 3, 50)
    _close(ty.numpy(), cy.numpy())
    assert torch.equal(tt, ct)


@pytest.mark.parametrize("case", ["coprime", "n_mod_d", "short", "overlap"])
def test_errors(case):
    coeff = firdes.lowpass(240e3, 16e3, 51, 1)
    if case == "coprime":
        with pytest.raises(ValueError):
            TiledBandedFIR(np.ones(12), 4, 2, device="cpu")
        return
    if case == "overlap":
        # L - D = 46 > group * D = 5
        with pytest.raises(ValueError):
            TiledBandedFIR(coeff, 1, 5, group=1, device="cpu")
        return
    fir = TiledBandedFIR(coeff, 1, 5, device="cpu")
    n = 52 if case == "n_mod_d" else 45
    with pytest.raises(ValueError):
        fir(torch.zeros(1, n), fir.init_state((1,)))


def test_kernel_wrapper_takes_cuda_tensors_only():
    """The CUDA launcher refuses a CPU tensor; the FIR sends it to the
    plain version instead, and a tensor on another device to neither."""
    fir = TiledBandedFIR(firdes.lowpass(240e3, 16e3, 51, 1), 1, 5,
                         device="cpu")
    with pytest.raises(ValueError):
        banded(fir, torch.zeros(1, 100), fir.init_state((1,)))
    with pytest.raises(ValueError):
        fir(torch.zeros(1, 100, device="meta"),
            torch.zeros(1, 50, device="meta"))


_STEREO_TILED = ("rf_resampler", "audio_resampler", "stereo_audio_resampler",
                 "rds_carrier_filter", "rds_resampler", "rds_rrc")


@pytest.mark.parametrize("mode,kw,tiled", [
    (0, dict(fused_frontend="int8", conv_engine="tiled", conv_dtype="bf16"),
     ("rf_resampler", "audio_resampler")),
    (0, dict(stereo=True, rds=True, fused_frontend="int8", pll_impl="ff",
             conv_dtype="bf16", fused_ifbank="bf16", conv_engine="tiled"),
     _STEREO_TILED),
    (2, dict(stereo=True, rds=True, conv_engine="tiled"), _STEREO_TILED),
    (0, dict(stereo=True, rds=True, conv_engine="tiled",
             filter_engine="fft"), ("rds_resampler",)),
    (0, dict(stereo=True, rds=True, conv_engine="conv"), ()),
])
def test_receiver_builds_tiled_engine(mode, kw, tiled):
    """conv_engine='tiled' builds TiledBandedFIR for every direct-engine
    resampling FIR and for the RDS resampler, whatever the filter engine
    (reference receiver.py:192-199, 356-361), at the conv dtype; 'conv'
    builds none."""
    rx = Receiver(mode, device="cpu", **kw)
    cdt = torch.bfloat16 if kw.get("conv_dtype") == "bf16" else torch.float32
    built = {name: fir for name, fir in vars(rx).items()
             if isinstance(fir, TiledBandedFIR)}
    assert sorted(built) == sorted(tiled)
    assert all(fir.compute_dtype == cdt for fir in built.values())
