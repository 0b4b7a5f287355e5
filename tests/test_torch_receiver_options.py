"""The Receiver's last options against sdr_tpu's: de-emphasis (the
one-pole IIR as a prefix scan), the shared audio state of stereo and the
fft filter engine (overlap-save on torch.fft), each over several steps
with the state carried between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.ops.iir import first_order_iir as j_iir
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.ops.iir import deemphasis_alpha, first_order_iir
from sdr_tpu_torch.utils.compare import stream_snr_db

from test_torch_stereo_receiver import (assert_close, capture,
                                       check_against_reference, jax_run,
                                       leaves)


def test_first_order_iir_matches_scipy():
    """The prefix scan equals scipy's lfilter, the state carried between
    two blocks (the reference's gate, tests/test_ops.py)."""
    alpha = deemphasis_alpha(48000.0, 75.0)
    x = np.random.default_rng(1234).standard_normal(1000).astype(np.float32)
    ref = sps.lfilter([alpha], [1.0, -(1.0 - alpha)], x)
    y1, carry = first_order_iir(torch.from_numpy(x[:500]),
                                torch.tensor(0.0), alpha=alpha)
    y2, _ = first_order_iir(torch.from_numpy(x[500:]), carry, alpha=alpha)
    got = torch.cat([y1, y2]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4097])
def test_first_order_iir_matches_reference(n):
    """Batched rows of odd lengths against the reference's associative
    scan, within 1e-5 of max|ref| (the two group the products in another
    order), the carry included."""
    alpha = deemphasis_alpha(48000.0, 50.0)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    y0 = rng.standard_normal(3).astype(np.float32)
    want, wcarry = j_iir(jnp.asarray(x), jnp.asarray(y0), alpha=alpha)
    got, carry = first_order_iir(torch.from_numpy(x), torch.from_numpy(y0),
                                 alpha=alpha)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= tol
    assert np.abs(carry.numpy() - np.asarray(wcarry)).max() <= tol


def test_deemphasis_mono_matches_reference():
    rx, out = check_against_reference(0, dict(deemphasis_us=75.0))
    plain, _ = Receiver(0, device="cpu").run(capture(0, 0.3, rds=False),
                                             blocks_per_step=2)
    assert rx.deemph_alpha is not None
    # the treble cut changes the mono output
    assert not torch.equal(out["mono"], plain["mono"])


def test_deemphasis_stereo_matches_reference_and_skips_mono():
    """In stereo, left and right are de-emphasized and mono is not (the
    reference's rule)."""
    kw = dict(stereo=True, pll_impl="ff")
    _, out = check_against_reference(0, dict(kw, deemphasis_us=75.0))
    plain, _ = Receiver(0, **kw, device="cpu").run(
        capture(0, 0.3, rds=False), blocks_per_step=2)
    assert torch.equal(out["mono"], plain["mono"])
    for k in ("left", "right"):
        assert not torch.equal(out[k], plain[k])


@pytest.mark.parametrize("rds", [False, True], ids=["stereo", "stereo_rds"])
def test_shared_audio_state_matches_reference(rds):
    """compat_shared_audio_state: the stereo resample continues the mono
    tail (and the next mono resample the stereo one's); stereo_audio_tail
    stays at its initial zeros; the output differs from the fixed
    receiver's."""
    kw = dict(stereo=True, rds=rds, pll_impl="ff")
    rx, out = check_against_reference(0, dict(kw,
                                              compat_shared_audio_state=True))
    cap = capture(0, 0.3, rds=rds)
    fixed, _ = Receiver(0, **kw, device="cpu").run(cap, blocks_per_step=2)
    _, st = rx.run(cap, blocks_per_step=2)
    assert not bool(st.stereo.stereo_audio_tail.any())
    for k in ("mono", "left"):
        assert not torch.equal(out[k], fixed[k])


def test_shared_audio_state_declines_the_audio_pair():
    """With the shared tails the mono resample is not deferred, so the
    --fast profile's audio-pair kernel is not used."""
    rx = Receiver(0, stereo=True, rds=True, fused_frontend="int8",
                  pll_impl="ff", conv_dtype="bf16", conv_engine="tiled",
                  fused_ifbank="bf16", compat_shared_audio_state=True,
                  device="cpu")
    assert rx._fused_synth and rx._audio_pair is None
    st = rx.init_state()
    assert st.mono.audio_tail.shape == (rx.audio_resampler.state_len,)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fft_engine_matches_reference(mode):
    """filter_engine='fft' (stereo, with RDS where the mode has it, on the
    feedforward carriers) against the reference's fft engine: mono, left,
    right and rds_soft within 1e-5 of max|ref|, the final state leaf for
    leaf in shape and dtype and within 1e-4 of 1+|x|.  The demodulated IF
    tap is held within 1e-5 of max|ref| or, where that is larger, within
    the reference's own spread between its fft and direct engines (mode
    1's long RF transform: 3.2e-5 of max between the two libraries' fft,
    1.2e-4 between the reference's engines).  Against the port's direct
    engine the audio stays above 70 dB."""
    cfg = MODES[mode]
    kw = dict(stereo=True, rds=cfg.rds_sps is not None, pll_impl="ff",
              emit_if=True)
    cap = capture(mode, 0.3, rds=kw["rds"])
    jrx = JaxReceiver(mode, filter_engine="fft", **kw)
    jout, jst = jax_run(jrx, cap, 2)
    jdirect, _ = jax_run(JaxReceiver(mode, **kw), cap, 2)
    rx = Receiver(mode, filter_engine="fft", **kw, device="cpu")
    assert rx.channel_filter is not None and rx.if_bpf3 is None
    assert rx.block_align_u8() == jrx.block_align_u8()
    out, st = rx.run(cap, blocks_per_step=2)
    assert set(out) == set(jout)
    for k in set(out) - {"fm_demod"}:
        assert_close(out[k].numpy(), jout[k], 1e-5)
    fm = np.abs(out["fm_demod"].numpy() - jout["fm_demod"]).max()
    assert fm <= max(1e-5 * np.abs(jout["fm_demod"]).max(),
                     np.abs(jdirect["fm_demod"] - jout["fm_demod"]).max())
    tl, jl = leaves(st), jax.tree.leaves(jst)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert np.all(np.abs(t.double().numpy() - j)
                      <= 1e-4 * (1 + np.abs(j)))
    od, _ = Receiver(mode, **kw, device="cpu").run(cap, blocks_per_step=2)
    for key in ("mono", "left", "right"):
        snr = stream_snr_db(out[key].numpy(), od[key].numpy(), skip=100)
        assert snr > 70.0, f"{key}: fft vs direct {snr:.1f} dB"


def test_fft_engine_needs_direct_for_the_fused_ifbank():
    """The fused IF bank is a direct-engine stage (reference rule)."""
    rx = Receiver(0, stereo=True, rds=True, pll_impl="ff",
                  fused_ifbank="bf16", filter_engine="fft", device="cpu")
    assert rx._ifbank is None and rx.channel_filter is not None
    with pytest.raises(ValueError, match="filter_engine"):
        Receiver(0, filter_engine="overlap", device="cpu")
