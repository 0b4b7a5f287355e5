"""The CUDA channelizer kernel (B7) against its plain PyTorch version, on
the card, at small odd shapes.  Marked `cuda`; without a CUDA device
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


@pytest.mark.parametrize("k", [5, 13])
@pytest.mark.parametrize("ingest,compute,out", [
    ("u8", "f32", "f32"), ("f32", "f32", "f32"), ("u8", "bf16", "f32"),
    ("f32", "bf16", "bf16"), ("u8", "f32", "bf16")])
def test_kernel_equals_plain(dev, k, ingest, compute, out):
    """Three blocks with state carry, the flat stream starting off a
    16-byte boundary (one element into a larger buffer) and the
    pre-phased layout: kernel and plain agree, the two layouts give the
    same bits, and the carried tails are equal."""
    chan = WidebandChannelizer(9.6e6, 2.4e6, list(np.linspace(-3e6, 3e6, k)),
                               engine="pallas", ingest=ingest,
                               compute_dtype=compute, out_dtype=out,
                               tile=384, device=dev)
    pl = chan._pl
    rng = np.random.default_rng(k)
    n_out = 3 * 384                # tile 384: three phasor tiles a block
    s_flat = s_cols = s_plain = pl.init_state()
    before = LAUNCHES["mfb"]
    for _ in range(3):
        if ingest == "u8":
            raw = rng.integers(0, 256, size=8 * n_out + 1, dtype=np.uint8)
        else:
            raw = rng.standard_normal(8 * n_out + 1).astype(np.float32)
        buf = torch.from_numpy(raw).to(dev)
        flat = buf[1:]                                # off 16-byte alignment
        xbt = flat.reshape(n_out, 8).T.contiguous()
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
    assert LAUNCHES["mfb"] == before + 6


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
