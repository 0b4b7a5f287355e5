"""The tiled engine's CUDA kernel (csrc/banded.cu, through ops/banded.py
TiledBandedFIR) against its plain PyTorch version, on the card: every
geometry the tiled engine meets, both engines, float32 and bf16 input, one
row and many, odd lengths and a tail that starts off an 8-byte boundary;
the bf16 engine's tensor-core body at its edges (a row's first and last
item, a ragged last item, 1 and 128 rows, input off a 16-byte boundary,
leading axes).
Gate: y within 1e-5 of max|ref| (the kernel sums only the non-zero band,
in another order), the new tail bit for bit.  Marked `cuda`; without a
CUDA device every test skips.  This file imports neither jax nor sdr_tpu,
so on the GPU machine run it without the tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_banded.py
"""

import numpy as np
import pytest
import torch

import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.banded import TiledBandedFIR
from sdr_tpu_torch.ops.cuda.build import LAUNCHES

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _geometries():
    cfg = MODES[0]
    out = {"rf": (firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1), 1,
                  cfg.rf_decim)}
    for m, c in MODES.items():
        out[f"audio{m}"] = (firdes.lowpass(c.if_fs * c.audio_interp,
                                           c.audio_fc, c.audio_taps,
                                           c.audio_gain),
                            c.audio_interp, c.audio_decim)
    for m in (0, 2):
        c = MODES[m]
        u, d = c.rds_resample
        out[f"rds{m}"] = (firdes.lowpass(c.if_fs * u, c.rds_fc,
                                         c.bp_taps * u, u), u, d)
    out["rrc"] = (firdes.root_raised_cosine(cfg.rds_fs, 151,
                                            cfg.rds_symbol_rate), 1, 1)
    out["bpf"] = (firdes.bandpass(cfg.if_fs, cfg.rds_lo, cfg.rds_hi,
                                  cfg.bp_taps), 1, 1)
    out["rrc101"] = (firdes.root_raised_cosine(cfg.rds_fs, 101,
                                               cfg.rds_symbol_rate), 1, 1)
    return out


GEOMETRIES = _geometries()


def _unaligned(a: torch.Tensor) -> torch.Tensor:
    """a's values in a contiguous tensor one element past an 8-byte
    boundary."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    return out


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("in_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("engine", [torch.float32, BF16])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_banded_kernel_matches_plain(dev, name, engine, in_dtype, rows):
    coeff, up, down = GEOMETRIES[name]
    fir = TiledBandedFIR(coeff, up, down, compute_dtype=engine, device=dev)
    supers = max(-(-fir.state_len // down), 7 if down > 100 else 1237)
    n = down * supers                               # an odd super count
    rng = np.random.default_rng(supers + rows)
    tail = torch.from_numpy(rng.normal(0, 0.5, (rows, fir.state_len)
                                       ).astype(np.float32)).to(in_dtype)
    state = _unaligned(tail.to(dev))
    for blk in range(2):
        x = torch.from_numpy(rng.normal(0, 0.5, (rows, n)).astype(
            np.float32)).to(in_dtype)
        want_y, want_t = fir(x, tail)               # CPU: the plain version
        before = LAUNCHES["banded"]
        got_y, state = fir(x.to(dev), state)
        torch.cuda.synchronize()
        assert LAUNCHES["banded"] == before + 1
        assert got_y.dtype == torch.float32 and got_y.shape == want_y.shape
        assert state.dtype == fir.store_dtype
        err = (got_y.cpu().double() - want_y.double()).abs().max()
        assert err <= 1e-5 * want_y.abs().max(), (err, blk)
        assert torch.equal(state.cpu(), want_t)
        tail = want_t


def _check(fir, x, tail, dev, x_dev=None):
    """Two carried blocks through the kernel and the plain version."""
    state = tail.to(dev)
    for blk in range(2):
        want_y, want_t = fir(x[blk], tail)
        got_y, state = fir(x[blk].to(dev) if x_dev is None else x_dev[blk],
                           state)
        torch.cuda.synchronize()
        assert got_y.shape == want_y.shape and state.dtype == fir.store_dtype
        err = (got_y.cpu().double() - want_y.double()).abs().max()
        assert err <= 1e-5 * want_y.abs().max(), (err, blk)
        assert torch.equal(state.cpu(), want_t)
        tail = want_t


@pytest.mark.parametrize("rows", [1, 128])
@pytest.mark.parametrize("in_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("items", [1, 2.5])
@pytest.mark.parametrize("name", ["rds0", "rrc", "audio0", "rf", "rds2",
                                  "audio3"])
def test_banded_mma_edges(dev, name, items, in_dtype, rows):
    """The bf16 engine's body: a row of one item (its first is its last)
    and of two and a half (a ragged last item, its outputs not a multiple
    of the item's rows), 1 and 128 rows, x one element past a 16-byte
    boundary, over two carried blocks."""
    from sdr_tpu_torch.ops.cuda.banded_kernel import tile_map
    coeff, up, down = GEOMETRIES[name]
    fir = TiledBandedFIR(coeff, up, down, compute_dtype=BF16, device=dev)
    tm = tile_map(fir._bank, up, down, fir.M, 2 if in_dtype == BF16 else 4)
    supers = max(int(items * 16 * tm.mw * tm.group) - 1,
                 -(-fir.state_len // down))
    n = down * supers
    rng = np.random.default_rng(supers + rows)
    mk = lambda: torch.from_numpy(rng.normal(0, 0.5, (rows, n)).astype(
        np.float32)).to(in_dtype)
    x = [mk(), mk()]
    tail = torch.from_numpy(rng.normal(0, 0.5, (rows, fir.state_len)).astype(
        np.float32)).to(in_dtype)
    _check(fir, x, tail, dev, [_unaligned(b.to(dev)) for b in x])


def test_banded_kernel_leading_axes(dev):
    """(2, 3, n) rows, as the receiver's stacked audio pair gives them."""
    coeff, up, down = GEOMETRIES["audio2"]
    fir = TiledBandedFIR(coeff, up, down, compute_dtype=BF16, device=dev)
    x = torch.randn(2, 3, down * 9, generator=torch.Generator().manual_seed(1))
    tail = fir.init_state((2, 3)).cpu()
    want_y, want_t = fir(x, tail)
    got_y, got_t = fir(x.to(dev), tail.to(dev))
    err = (got_y.cpu().double() - want_y.double()).abs().max()
    assert err <= 1e-5 * want_y.abs().max()
    assert torch.equal(got_t.cpu(), want_t)


def test_banded_mma_leading_axes_pair(dev):
    """The ifbank joint step's stacked audio pair, (2, rows, n) bf16, in the
    bf16 engine."""
    coeff, up, down = GEOMETRIES["audio0"]
    fir = TiledBandedFIR(coeff, up, down, compute_dtype=BF16, device=dev)
    g = torch.Generator().manual_seed(2)
    x = [(0.5 * torch.randn(2, 7, down * 1111, generator=g)).to(BF16)
         for _ in range(2)]
    _check(fir, x, fir.init_state((2, 7)).cpu(), dev)


def test_banded_kernel_rejects_bad_tail(dev):
    fir = TiledBandedFIR(*GEOMETRIES["audio0"][:1], 1, 5, device=dev)
    with pytest.raises(ValueError):
        fir(torch.zeros(2, 500, device=dev), torch.zeros(2, 7, device=dev))
    with pytest.raises(ValueError):
        fir(torch.zeros(2, 500, device=dev), fir.init_state((2,)).cpu())
