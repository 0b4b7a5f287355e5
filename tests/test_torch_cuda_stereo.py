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
@pytest.mark.parametrize("n", [2048, 1280])
def test_ifbank_mix_matches_plain(dev, fm_dtype, compute, n):
    """n = 1280 leaves the last block of 1024 outputs one window full."""
    bank = _bank(compute, BF16 if fm_dtype == BF16 else None)
    rng = np.random.default_rng(0)
    fm = torch.from_numpy(rng.normal(0, 0.3, (3, 2, n)).astype(
        np.float32)).to(fm_dtype)
    tail = ptail = bank.init_state((3,)).to(dev)
    before = LAUNCHES["ifbank_mix"]
    for b in range(2):
        x = fm[:, b].contiguous()
        got = bank.mix_call(x.to(dev), tail)
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
    assert LAUNCHES["ifbank_mix"] == before + 2


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


@pytest.mark.parametrize("compute", [torch.float32, BF16])
@pytest.mark.parametrize("down", [5, 6])
def test_audio_pair_matches_plain(dev, compute, down):
    cfg = MODES[0]
    coeff = firdes.lowpass(cfg.if_fs, cfg.audio_fc, cfg.audio_taps, 1)
    pair = PairDecimFIR(coeff, down, compute_dtype=compute)
    rng = np.random.default_rng(2)
    n = down * 600
    xa = torch.from_numpy(rng.normal(0, 1, (2, 3, n)).astype(np.float32))
    xb = xa.flip(-1).to(BF16)
    ta = pair.init_state((3,))
    tb = pair.init_state((3,), BF16)
    pta, ptb = ta, tb
    for b in range(2):
        got = pair(xa[b].to(dev), xb[b].to(dev), ta.to(dev), tb.to(dev))
        want = pair(xa[b], xb[b], pta, ptb)
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            _close(g, w, 1e-5, False)
        ta, tb, pta, ptb = got[2], got[3], want[2], want[3]


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
