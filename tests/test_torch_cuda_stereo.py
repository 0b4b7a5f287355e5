"""The stereo + RDS CUDA kernels (IF bank + mix sums, carrier synthesis +
mixers, audio pair) against their plain PyTorch versions, on the card, and
the stereo + RDS receiver on the card against the same receiver on the
CPU.  Marked `cuda`; without a CUDA device every test skips.  This file
imports neither jax nor sdr_tpu, so on the GPU machine run it without the
tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_stereo.py
"""

import numpy as np
import pytest
import torch

import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.cuda.audio_kernel import PairDecimFIR
from sdr_tpu_torch.ops.cuda.build import LAUNCHES
from sdr_tpu_torch.ops.cuda.ffmix_kernel import ffmix
from sdr_tpu_torch.ops.cuda.ifbank_kernel import FusedIFBankMix
from sdr_tpu_torch.rds import tx as rds_tx

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bank(compute, out):
    cfg = MODES[0]
    bp = lambda lo, hi: firdes.bandpass(cfg.if_fs, lo, hi, cfg.bp_taps)
    return FusedIFBankMix(
        bp(cfg.stereo_lo, cfg.stereo_hi), bp(cfg.pilot_lo, cfg.pilot_hi),
        bp(cfg.rds_lo, cfg.rds_hi), bp(cfg.rds_carrier_lo, cfg.rds_carrier_hi),
        window=256, pilot_freq=cfg.pilot_freq,
        rds_carrier_freq=cfg.rds_carrier_freq, fs=cfg.if_fs,
        compute_dtype=compute, out_dtype=out)


def _close(got, want, rel, bf16):
    """|got - want| <= rel * max|want|, plus one bf16 ulp (2^-7 of the
    value) where the stream is stored at bf16."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.double().cpu(), want.double().cpu()
    bound = rel * w.abs().max()
    if bf16:
        bound = bound + 2.0 ** -7 * w.abs()
    assert bool(((g - w).abs() <= bound).all()), (g - w).abs().max()


@pytest.mark.parametrize("fm_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("compute", [torch.float32, BF16])
@pytest.mark.parametrize("n,c", [(2048, 3), (1280, 3), (1280, 1),
                                 (3328, 37)])
def test_ifbank_mix_matches_plain(dev, fm_dtype, compute, n, c):
    """n = 1280 and 3328 leave the last 1024-sample time tile one window
    full; 37 stations leave the bf16 engine's last block of 4 one station
    (the others idle).  A second launch on the same inputs gives the same
    bits (the window sums take a fixed order)."""
    bank = _bank(compute, BF16 if fm_dtype == BF16 else None)
    rng = np.random.default_rng(0)
    fm = torch.from_numpy(rng.normal(0, 0.3, (c, 2, n)).astype(
        np.float32)).to(fm_dtype)
    tail = ptail = bank.init_state((c,)).to(dev)
    before = LAUNCHES["ifbank_mix"]
    for b in range(2):
        x = fm[:, b].contiguous()
        got = bank.mix_call(x.to(dev), tail)
        again = bank.mix_call(x.to(dev), tail)
        for g, a in zip(got[:2] + got[2] + got[3], again[:2] + again[2]
                        + again[3]):
            assert torch.equal(g, a)
        want = bank.mix_call(x, ptail.cpu())
        torch.cuda.synchronize()
        stored_bf16 = bank.out_dtype == BF16
        _close(got[0], want[0], 1e-5, stored_bf16)
        _close(got[1], want[1], 1e-5, stored_bf16)
        zrel = 1e-4 if compute == BF16 else 1e-5
        for gz, wz in zip(got[2] + got[3], want[2] + want[3]):
            _close(gz, wz, zrel, False)
        assert torch.equal(got[4].cpu(), want[4])
        tail, ptail = got[4], want[4]
    assert LAUNCHES["ifbank_mix"] == before + 4


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_ffmix_matches_plain(dev, dtype):
    rng = np.random.default_rng(1)
    c, n, w = 3, 2048, 256
    f = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
    chan, rds, tail = f(c, n).to(dtype), f(c, n).to(dtype), f(c, 128)
    ps = (f(c, n // w) * 3, f(c, n // w) * 1e-3)
    pr = (f(c, n // w) * 3, f(c, n // w) * 1e-3)
    kw = dict(n=n, window=w, pilot_freq=19e3, rds_freq=114e3, fs=240e3,
              delay=25, phase_adjust=0.3, out_dtype=dtype)
    before = LAUNCHES["ffmix"]
    got = ffmix(chan.to(dev), rds.to(dev), tail.to(dev),
                tuple(p.to(dev) for p in ps), tuple(p.to(dev) for p in pr),
                **kw)
    want = ffmix(chan, rds, tail, ps, pr, **kw)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        _close(g, wnt, 1e-5, dtype == BF16)
    assert LAUNCHES["ffmix"] == before + 1


def _on_card(x, dev, offset):
    """x on the card; with offset, a contiguous view that starts `offset`
    elements past the start of its allocation (off a 16-byte boundary)."""
    if not offset:
        return x.to(dev)
    flat = torch.zeros(x.numel() + offset, dtype=x.dtype, device=dev)
    flat[offset:] = x.reshape(-1).to(dev)
    view = flat[offset:].reshape(x.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("compute", [torch.float32, BF16])
@pytest.mark.parametrize("down", [5, 6])
@pytest.mark.parametrize("c,m,offset", [(3, 600, 0), (1, 2100, 0),
                                        (37, 1100, 0), (3, 1030, 1)])
def test_audio_pair_matches_plain(dev, compute, down, c, m, offset):
    """Both engines (bf16 on the tensor cores at D = 5 and 6, f32 on the
    CUDA cores) against the plain conv over two blocks with the tails
    carried: one station and 37, m outputs off the bf16 engine's
    1024-output item (a last item of 600, 30, 76 or 52), streams that
    start off a 16-byte boundary (staged element-wise), a float32 and a
    bf16 stream in one launch; a second launch on the same inputs gives
    the same bits, and the new tails are the last 128 input columns."""
    cfg = MODES[0]
    coeff = firdes.lowpass(cfg.if_fs, cfg.audio_fc, cfg.audio_taps, 1)
    pair = PairDecimFIR(coeff, down, compute_dtype=compute, device="cpu")
    rng = np.random.default_rng(2)
    n = down * m
    xa = torch.from_numpy(rng.normal(0, 1, (2, c, n)).astype(np.float32))
    xb = xa.flip(-1).to(BF16)
    ta = pair.init_state((c,))
    tb = pair.init_state((c,), BF16)
    pta, ptb = ta, tb
    before = LAUNCHES["audio_pair"]
    for b in range(2):
        args = (_on_card(xa[b], dev, offset), _on_card(xb[b], dev, offset),
                ta.to(dev), tb.to(dev))
        got = pair(*args)
        again = pair(*args)
        want = pair(xa[b], xb[b], pta, ptb)
        torch.cuda.synchronize()
        for g, a in zip(got, again):
            assert torch.equal(g, a)
        for g, w in zip(got[:2], want[:2]):
            _close(g, w, 1e-5, False)
        for g, w in zip(got[2:], want[2:]):
            assert torch.equal(g.cpu(), w)
        ta, tb, pta, ptb = got[2], got[3], want[2], want[3]
    assert LAUNCHES["audio_pair"] == before + 4


def test_audio_pair_bf16_refuses_other_decimations(dev):
    """The bf16 engine's Toeplitz tile is built for D = 5 and 6, the
    integer modes' decimations; another D raises, the f32 engine takes
    it."""
    cfg = MODES[0]
    coeff = firdes.lowpass(cfg.if_fs, cfg.audio_fc, cfg.audio_taps, 1)
    x = torch.zeros((2, 4 * 300), device=dev)
    for compute in (BF16, torch.float32):
        pair = PairDecimFIR(coeff, 4, compute_dtype=compute, device=dev)
        tail = pair.init_state((2,))
        if compute == BF16:
            with pytest.raises(ValueError):
                pair(x, x, tail, tail)
        else:
            assert pair(x, x, tail, tail)[0].shape == (2, 300)


def test_receiver_on_card_matches_cpu(dev):
    """The bench profile (int8 front end, bf16 IF bank, fused synthesis,
    audio pair) on the card against the plain versions on the CPU: every
    stream above 45 dB SNR (the chain is bf16; a float32 last bit can flip
    a bf16 rounding), and each of the five kernels launched."""
    cfg = MODES[0]
    sec = 0.3
    n = int(sec * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="TPU FM  ",
                                        n_groups=6)
    cap = tx.synthesize_capture(
        cfg, seconds=sec, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)
    kw = dict(stereo=True, rds=True, fused_frontend="int8", pll_impl="ff",
              conv_dtype="bf16", conv_engine="tiled", fused_ifbank="bf16")
    a, _ = Receiver(0, device="cpu", **kw).run(cap)
    before = dict(LAUNCHES)
    b, _ = Receiver(0, device=dev, **kw).run(cap)
    for k in ("frontend_demod", "ifbank_mix", "ffmix", "audio_pair"):
        assert LAUNCHES[k] > before[k], k
    for k in ("mono", "left", "right", "rds_soft"):
        x = a[k].double().numpy()
        y = b[k].double().cpu().numpy()
        snr = 10 * np.log10(np.mean(x * x) / max(np.mean((x - y) ** 2),
                                                 1e-30))
        assert snr > 45.0, f"{k}: {snr:.1f} dB"
