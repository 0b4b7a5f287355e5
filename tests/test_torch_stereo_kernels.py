"""The plain PyTorch versions of the stereo + RDS kernels against sdr_tpu's
Pallas kernels (interpret mode on the CPU), on the same numpy-seeded
inputs: the fused IF bank with its mix sums, the carrier synthesis +
mixers, and the audio pair."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops.pallas import audio_kernel as jaudio
from sdr_tpu.ops.pallas import ffmix_kernel as jffmix
from sdr_tpu.ops.pallas import ifbank_kernel as jifbank
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.cuda import audio_kernel, ffmix_kernel, ifbank_kernel

BF16 = torch.bfloat16
CFG = MODES[0]


def to_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def assert_close(got, want, rel, bf16=False):
    """|got - want| <= rel * max|want|, plus one bf16 ulp (2^-7 of the
    value) where the stream is stored at bf16."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape
    bound = rel * np.abs(want).max()
    if bf16:
        bound = bound + 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def bank_coeffs():
    bp = lambda lo, hi: firdes.bandpass(CFG.if_fs, lo, hi, CFG.bp_taps)
    return (bp(CFG.stereo_lo, CFG.stereo_hi), bp(CFG.pilot_lo, CFG.pilot_hi),
            bp(CFG.rds_lo, CFG.rds_hi),
            bp(CFG.rds_carrier_lo, CFG.rds_carrier_hi))


def fm_blocks(c=3, n=1024, nblocks=2, seed=0):
    """An FM-like IF stream: a pilot, a 38 kHz DSB tone, a 57 kHz RDS-like
    carrier and noise, cut into consecutive blocks."""
    rng = np.random.default_rng(seed)
    t = np.arange(nblocks * n) / CFG.if_fs
    x = (0.1 * np.cos(2 * np.pi * 19e3 * t + 0.4)
         + 0.3 * np.cos(2 * np.pi * 1e3 * t) * np.cos(2 * np.pi * 38e3 * t)
         + 0.05 * np.cos(2 * np.pi * 57e3 * t + 1.1)
         * np.sign(np.sin(2 * np.pi * 1187.5 * t)))
    x = x[None] + rng.normal(0, 0.02, (c, nblocks * n))
    return x.astype(np.float32).reshape(c, nblocks, n)


@pytest.mark.parametrize("fm_dtype,compute", [
    ("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16")])
def test_ifbank_mix_matches_reference(fm_dtype, compute):
    """FusedIFBankMix.mix_call over two blocks (the tail carries): the
    channel streams within 1e-5 max (+1 bf16 ulp stored at bf16), the mix
    sums within 1e-5 max|z| (f32 compute) or 1e-4 (bf16: an ulp of the RDS
    channel can flip a bf16 rounding of its square)."""
    bf = fm_dtype == "bf16"
    tdt, jdt = (BF16, jnp.bfloat16) if bf else (torch.float32, jnp.float32)
    tcomp = BF16 if compute == "bf16" else torch.float32
    jcomp = jnp.bfloat16 if compute == "bf16" else jnp.float32
    kw = dict(window=256, pilot_freq=float(CFG.pilot_freq),
              rds_carrier_freq=float(CFG.rds_carrier_freq),
              fs=float(CFG.if_fs))
    jbank = jifbank.FusedIFBankMix(*bank_coeffs(), compute_dtype=jcomp,
                                   out_dtype=jnp.bfloat16 if bf else None,
                                   **kw)
    tbank = ifbank_kernel.FusedIFBankMix(*bank_coeffs(), compute_dtype=tcomp,
                                         out_dtype=BF16 if bf else None, **kw,
                                         device="cpu")
    assert ifbank_kernel.OUT_TILE == jbank.out_tile
    blocks = fm_blocks()
    jtail = jbank.init_state((3,))
    ttail = tbank.init_state((3,))
    for b in range(blocks.shape[1]):
        x = torch.from_numpy(blocks[:, b])
        jx = jnp.asarray(blocks[:, b]).astype(jdt)
        jout = jbank.mix_call(jx, jtail, interpret=True)
        tout = tbank.mix_call(x.to(tdt), ttail)
        assert tout[0].dtype == tout[1].dtype == (BF16 if bf
                                                  else torch.float32)
        assert_close(tout[0], jout[0], 1e-5, bf)
        assert_close(tout[1], jout[1], 1e-5, bf)
        zrel = 1e-4 if compute == "bf16" else 1e-5
        for tz, jz in zip(tout[2] + tout[3], jout[2] + jout[3]):
            assert tz.dtype == torch.float32
            assert_close(tz, jz, zrel)
        np.testing.assert_array_equal(to_np(tout[4]), to_np(jout[4]))
        jtail, ttail = jout[4], tout[4]


def test_ifbank_ramp_tables_bit_equal():
    kw = dict(window=256, pilot_freq=float(CFG.pilot_freq),
              rds_carrier_freq=float(CFG.rds_carrier_freq),
              fs=float(CFG.if_fs))
    jbank = jifbank.FusedIFBankMix(*bank_coeffs(), **kw)
    tbank = ifbank_kernel.FusedIFBankMix(*bank_coeffs(), **kw, device="cpu")
    for n in (1024, 76800):
        for (jc, js), (tc, ts) in zip(jbank._ramps(n), tbank.ramps(n, "cpu")):
            np.testing.assert_array_equal(tc.numpy(), jc[0])
            np.testing.assert_array_equal(ts.numpy(), js[0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ffmix_matches_reference(dtype):
    """ffmix with a nonzero phase_adjust and a carried tail: 1e-5 max,
    plus one bf16 ulp where the output is bf16."""
    rng = np.random.default_rng(3)
    c, n, w = 3, 2048, 256
    tdt, jdt = ((BF16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    chan = rng.normal(0, 0.3, (c, n)).astype(np.float32)
    rds = rng.normal(0, 0.3, (c, n)).astype(np.float32)
    tail = rng.normal(0, 0.3, (c, 128)).astype(np.float32)
    # (off, slope) per window as the estimator gives them: a phase track
    # near the carried one and slopes of a few mrad per sample
    ps = (rng.uniform(-3, 3, (c, n // w)).astype(np.float32),
          rng.normal(0, 1e-3, (c, n // w)).astype(np.float32))
    pr = (rng.uniform(-6, 6, (c, n // w)).astype(np.float32),
          rng.normal(0, 1e-3, (c, n // w)).astype(np.float32))
    kw = dict(n=n, window=w, pilot_freq=float(CFG.pilot_freq),
              rds_freq=float(CFG.rds_carrier_freq), fs=float(CFG.if_fs),
              delay=25, phase_adjust=0.3)
    jms, jmr = jffmix.ffmix(
        jnp.asarray(chan).astype(jdt), jnp.asarray(rds).astype(jdt),
        jnp.asarray(tail).astype(jdt), tuple(map(jnp.asarray, ps)),
        tuple(map(jnp.asarray, pr)), out_dtype=jdt, interpret=True, **kw)
    t = lambda a: torch.from_numpy(a)
    tms, tmr = ffmix_kernel.ffmix(
        t(chan).to(tdt), t(rds).to(tdt), t(tail).to(tdt),
        tuple(map(t, ps)), tuple(map(t, pr)), out_dtype=tdt, **kw)
    assert tms.dtype == tmr.dtype == tdt
    assert_close(tms, jms, 1e-5, dtype == "bf16")
    assert_close(tmr, jmr, 1e-5, dtype == "bf16")


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_audio_pair_matches_reference(compute):
    """PairDecimFIR over two blocks with carried 128-sample tails: 1e-5
    max|ref|, the second stream at bf16 as the --fast profile stores it."""
    coeff = firdes.lowpass(CFG.if_fs, CFG.audio_fc, CFG.audio_taps, 1)
    tcomp = BF16 if compute == "bf16" else torch.float32
    jcomp = jnp.bfloat16 if compute == "bf16" else jnp.float32
    jp = jaudio.PairDecimFIR(coeff, CFG.audio_decim, compute_dtype=jcomp)
    tp = audio_kernel.PairDecimFIR(coeff, CFG.audio_decim,
                                   compute_dtype=tcomp, device="cpu")
    rng = np.random.default_rng(4)
    n = 1280
    xa = rng.normal(0, 0.5, (3, 2, n)).astype(np.float32)
    xb = rng.normal(0, 0.5, (3, 2, n)).astype(np.float32)
    jta, jtb = jp.init_state((3,)), jp.init_state((3,), jnp.bfloat16)
    tta, ttb = tp.init_state((3,)), tp.init_state((3,), BF16)
    for b in range(2):
        jout = jp(jnp.asarray(xa[:, b]),
                  jnp.asarray(xb[:, b]).astype(jnp.bfloat16), jta, jtb,
                  interpret=True)
        tout = tp(torch.from_numpy(xa[:, b]),
                  torch.from_numpy(xb[:, b]).to(BF16), tta, ttb)
        for k in range(2):
            assert tout[k].dtype == torch.float32
            assert_close(tout[k], jout[k], 1e-5)
        for k in (2, 3):
            np.testing.assert_array_equal(to_np(tout[k]), to_np(jout[k]))
        jta, jtb, tta, ttb = jout[2], jout[3], tout[2], tout[3]


def test_wrappers_refuse_what_they_do_not_take():
    coeff = firdes.lowpass(CFG.if_fs, CFG.audio_fc, CFG.audio_taps, 1)
    pair = audio_kernel.PairDecimFIR(coeff, 5, device="cpu")
    with pytest.raises(ValueError):
        pair(torch.zeros(2, 1003), torch.zeros(2, 1003), pair.init_state((2,)),
             pair.init_state((2,)))
    bank = ifbank_kernel.FusedIFBankMix(*bank_coeffs(), pilot_freq=19e3,
                                        rds_carrier_freq=114e3, fs=240e3,
                                        device="cpu")
    with pytest.raises(ValueError):
        bank.mix_call(torch.zeros(2, 1000), bank.init_state((2,)))
    with pytest.raises(ValueError):
        ffmix_kernel.ffmix(torch.zeros(2, 512), torch.zeros(2, 512),
                           torch.zeros(2, 128), (torch.zeros(2, 2),) * 2,
                           (torch.zeros(2, 2),) * 2, n=512, window=256,
                           pilot_freq=19e3, rds_freq=114e3, fs=240e3,
                           delay=200)
