"""The CUDA channelizer kernels (B7: the bf16 engine on the tensor cores,
the float32 engine on the CUDA cores) against their plain PyTorch
version, on the card, at small odd shapes.  Marked `cuda`; without a CUDA device
every test skips.  This file imports neither jax nor sdr_tpu, so on the
GPU machine run it without the tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_channelizer.py
"""

import numpy as np
import pytest
import torch

import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
from sdr_tpu_torch.ops.cuda.build import LAUNCHES
from sdr_tpu_torch.ops.cuda.channelizer_kernel import call_cols_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_agree(got, want, bf16_out):
    """Within 2e-5 of max|plain| (another summation order), plus one bf16
    ulp where the output is bf16."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.double(), want.double()
    bound = 2e-5 * w.abs().max()
    if bf16_out:
        bound = bound + 2.0 ** -7 * w.abs()
    assert bool(((g - w).abs() <= bound).all()), (g - w).abs().max().item()


def _three_blocks(pl, dev, n_out, rng, ingest, out, offset=0):
    """Three blocks with state carry through the flat stream (starting
    `offset` elements into a larger buffer), the pre-phased layout and the
    plain version: kernel and plain agree, the two layouts give the same
    bits, and the carried tails are equal."""
    two_d = 2 * pl.decim
    s_flat = s_cols = s_plain = pl.init_state()
    for _ in range(3):
        size = two_d * n_out + offset
        if ingest == "u8":
            raw = rng.integers(0, 256, size=size, dtype=np.uint8)
        else:
            raw = rng.standard_normal(size).astype(np.float32)
        flat = torch.from_numpy(raw).to(dev)[offset:]
        xbt = flat.reshape(n_out, two_d).T.contiguous()
        (i_f, q_f), s_flat = pl(flat, s_flat)
        (i_c, q_c), s_cols = pl.call_cols(xbt, s_cols)
        (i_p, q_p), s_plain = call_cols_reference(pl, xbt, s_plain)
        torch.cuda.synchronize()
        assert torch.equal(i_f, i_c) and torch.equal(q_f, q_c)
        _assert_agree(i_c, i_p, out == "bf16")
        _assert_agree(q_c, q_p, out == "bf16")
        for key in s_plain:
            assert torch.equal(s_flat[key], s_plain[key])
            assert torch.equal(s_cols[key], s_plain[key])


@pytest.mark.parametrize("k", [5, 13])
@pytest.mark.parametrize("ingest,compute,out", [
    ("u8", "f32", "f32"), ("f32", "f32", "f32"), ("u8", "bf16", "f32"),
    ("f32", "bf16", "bf16"), ("u8", "f32", "bf16")])
def test_kernel_equals_plain(dev, k, ingest, compute, out):
    """Three carried blocks, the flat stream starting off a 16-byte
    boundary (one element into a larger buffer), tile 384: three phasor
    tiles a block."""
    chan = WidebandChannelizer(9.6e6, 2.4e6, list(np.linspace(-3e6, 3e6, k)),
                               engine="pallas", ingest=ingest,
                               compute_dtype=compute, out_dtype=out,
                               tile=384, device=dev)
    before = LAUNCHES["mfb"]
    _three_blocks(chan._pl, dev, 3 * 384, np.random.default_rng(k), ingest,
                  out, offset=1)
    assert LAUNCHES["mfb"] == before + 6


@pytest.mark.parametrize("fs_wide", [7.2e6, 12e6], ids=["D3", "D5"])
@pytest.mark.parametrize("k", [37])
@pytest.mark.parametrize("ingest,compute,out", [
    ("u8", "bf16", "f32"), ("f32", "bf16", "bf16"), ("u8", "f32", "f32"),
    ("f32", "f32", "bf16")])
def test_kernel_equals_plain_odd_decimation(dev, fs_wide, k, ingest, compute,
                                            out):
    """A decimation whose 2D is not a multiple of 8 (D = 3, 5: the B
    fragments' rows start off a 16-byte boundary and the bank's depth
    2D*n_shift = 210 pads to 14 k-steps of 16), 37 stations (two station
    groups, the second partly empty), 1152 output columns (4.5 column
    tiles), three carried blocks."""
    chan = WidebandChannelizer(fs_wide, 2.4e6,
                               list(np.linspace(-0.4 * fs_wide,
                                                0.4 * fs_wide, k)),
                               engine="pallas", ingest=ingest,
                               compute_dtype=compute, out_dtype=out,
                               tile=384, device=dev)
    assert (2 * chan._pl.decim) % 8
    _three_blocks(chan._pl, dev, 3 * 384,
                  np.random.default_rng(k + 2 * chan._pl.decim), ingest, out)


@pytest.mark.parametrize("fs_wide,taps", [(9.6e6, 501), (19.2e6, 601)],
                         ids=["D4-501", "D8-601"])
@pytest.mark.parametrize("ingest,compute,out", [
    ("u8", "f32", "f32"), ("f32", "f32", "bf16"), ("u8", "bf16", "f32"),
    ("f32", "bf16", "f32")])
def test_kernel_equals_plain_long_filter(dev, fs_wide, taps, ingest, compute,
                                         out):
    """Filters whose 32-station float32 bank overflows shared memory (2D x
    n_shift = 1008 and 1216 rows): the float32 engine runs 16 stations a
    block, and at D = 8 the bf16 engine leaves out its base-phasor cache
    (tile 512, a multiple of the 256-column tile, would use it).  37
    stations, three carried blocks."""
    k = 37
    chan = WidebandChannelizer(fs_wide, 2.4e6,
                               list(np.linspace(-0.4 * fs_wide,
                                                0.4 * fs_wide, k)),
                               taps=taps, engine="pallas", ingest=ingest,
                               compute_dtype=compute, out_dtype=out,
                               tile=512, device=dev)
    pl = chan._pl
    assert 2 * pl.decim * pl._n_shift * 32 * 2 * 4 > 227 * 1024
    _three_blocks(pl, dev, 3 * 512, np.random.default_rng(taps), ingest, out)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    chan = WidebandChannelizer(9.6e6, 2.4e6, [0.0, 1e6], engine="pallas",
                               ingest="u8", device=dev)
    pl = chan._pl
    st = pl.init_state()
    xbt = torch.full((8, 1024), 128, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        pl.call_cols(xbt, {**st, "tail": st["tail"].float()})  # dtype
    with pytest.raises(ValueError):
        pl.call_cols(xbt, {**st, "tail": st["tail"].cpu()})    # device
    with pytest.raises(TypeError):
        pl.call_cols(xbt.to(torch.int16),
                     {**st, "tail": st["tail"].to(torch.int16)})
