"""The CUDA front-end kernels against their plain PyTorch versions, on the
card.  Marked `cuda`; without a CUDA device every test skips.  This file
imports neither jax nor sdr_tpu, so on the GPU machine (which has no jax)
run it without the tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.cuda.frontend_kernel import (LAUNCHES, FusedFrontend,
                                                    frontend_demod_reference,
                                                    frontend_reference)

pytestmark = pytest.mark.cuda
ENGINES = ("f32", "bf16", "int8", "int8x2")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _blocks(stations, n, dev):
    """Two consecutive (stations, n) u8 blocks of noisy FM captures."""
    cfg = MODES[0]
    caps = [tx.synthesize_capture(cfg, seconds=(n + 100) / cfg.rf_fs,
                                  seed=s, noise_db=-20.0,
                                  mono=tx.tone(cfg.rf_fs, 900.0, n + 100))
            for s in range(stations)]
    x = torch.from_numpy(np.stack(caps)[:, :2 * n]).to(dev)
    return [x[:, :n].contiguous(), x[:, n:].contiguous()]


def _assert_agree(got, want, exact):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g, w = g.double(), w.double()
        if exact or g.dtype == torch.uint8:
            assert torch.equal(g, w)
        else:  # float engines: another summation order than the conv
            assert (g - w).abs().max() <= 1e-5 * w.abs().max()


# mode 0 (decim 10, 4-byte loads) and mode 3 (decim 9: an n that is not a
# multiple of 4 takes the kernel's byte-load path)
@pytest.mark.parametrize("mode,n", [(0, 2 * 10 * 1000), (3, 2 * 9 * 999)])
@pytest.mark.parametrize("engine", ENGINES)
def test_kernels_match_plain(dev, mode, n, engine):
    cfg = MODES[mode]
    coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
    fe = FusedFrontend(coeff, cfg.rf_decim, compute_dtype=engine,
                       device=dev)
    exact = engine in ("int8", "int8x2")
    c = 3
    tail, ptail = fe.init_state((c,)), fe.init_state((c,))
    prev = pprev = (torch.zeros(c, device=dev), torch.zeros(c, device=dev))
    dtail, dptail = tail, ptail
    before = dict(LAUNCHES)
    for blk in _blocks(c, n, dev):
        got, want = fe(blk, tail), frontend_reference(fe, blk, ptail)
        torch.cuda.synchronize()
        _assert_agree(got, want, exact)
        tail, ptail = got[2], want[2]
        got = fe.demod_call(blk, dtail, *prev)
        want = frontend_demod_reference(fe, blk, dptail, *pprev)
        torch.cuda.synchronize()
        _assert_agree(got[:4], want[:4], exact)
        torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=0)
        dtail, prev, dptail, pprev = got[1], got[2:4], want[1], want[2:4]
    assert LAUNCHES["frontend"] == before["frontend"] + 2
    assert LAUNCHES["frontend_demod"] == before["frontend_demod"] + 2


def test_unbatched_block_and_bf16_out(dev):
    cfg = MODES[0]
    coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
    fe = FusedFrontend(coeff, 10, compute_dtype="int8",
                       out_dtype=torch.bfloat16, device=dev)
    blk = _blocks(1, 2 * 10 * 512, dev)[0][0]
    args = (blk, fe.init_state(), torch.zeros((), device=dev),
            torch.zeros((), device=dev))
    got = fe.demod_call(*args)
    want = frontend_demod_reference(fe, *args)
    torch.cuda.synchronize()
    _assert_agree(got[:4], want[:4], exact=True)
    assert got[0].dtype == torch.bfloat16 and got[2].shape == ()


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    fe = FusedFrontend(firdes.lowpass(2.4e6, 100e3, 51, 1), 10,
                       compute_dtype="int8x2", device=dev)
    blk = torch.full((4, 4000), 128, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        fe(blk[:, ::2], fe.init_state((4,)))       # not contiguous
    with pytest.raises(TypeError):
        fe(blk.float(), fe.init_state((4,)))
    with pytest.raises(ValueError):
        fe(blk, fe.init_state((4,)).cpu())          # mixed devices


@pytest.mark.parametrize("kw", [
    dict(fused_frontend="int8", conv_engine="tiled", conv_dtype="bf16"),
    dict(fused_frontend="int8x2"), dict(fused_frontend="f32", demod="arctan")])
def test_receiver_on_card_matches_cpu(dev, kw):
    cfg = MODES[0]
    n = int(0.1 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.1,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    a, _ = Receiver(0, device="cpu", **kw).run(cap)
    b, _ = Receiver(0, device=dev, **kw).run(cap)
    # the front end agrees exactly for the integer engines; the audio conv
    # (cuDNN on the card, TF32 off) sums in another order than the CPU's
    torch.testing.assert_close(b["mono"].cpu(), a["mono"], rtol=0,
                               atol=1e-5)
