"""The port's Receiver on the carrier loop engines against sdr_tpu's
jitted step: the default profile (the scan loops, `python -m sdr_tpu 0 2
--rds`) in modes 0 and 2, stereo alone and RDS alone, and a resume from
a sdr_tpu state mid-stream (the loop states included).  On the CPU the
loops run their plain PyTorch versions, a Python loop over samples, so
the captures stay short.
Bounds: `check_against_reference` (45 dB on left, right and rds_soft for
the loops)."""

import jax
import numpy as np
import pytest

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.utils.convert import state_from_numpy

from test_torch_stereo_receiver import (assert_close, capture,
                                        check_against_reference, jax_run,
                                        leaves, snr_db, spans)

DEFAULT = dict(stereo=True, rds=True)
LOOP_PROFILES = {
    "default": DEFAULT,
    "stereo": dict(stereo=True),
    "rds": dict(rds=True),
    "chunked": dict(DEFAULT, pll_impl="chunked"),
    "pallas": dict(DEFAULT, pll_impl="pallas"),
    "pallas_chunked": dict(DEFAULT, pll_impl="pallas_chunked"),
    # tools/bench_stages.py:59-60
    "bench_stages": dict(DEFAULT, fused_frontend="bf16",
                         pll_impl="pallas_chunked", pll_chunk=32),
    "ifbank_bf16": dict(DEFAULT, fused_frontend="bf16",
                        pll_impl="pallas_chunked", pll_chunk=32,
                        fused_ifbank="bf16", conv_dtype="bf16",
                        conv_engine="tiled"),
    "ifbank_f32": dict(DEFAULT, pll_impl="pallas_chunked",
                       fused_ifbank=True),
    "compat": dict(DEFAULT, compat_pll=True),
    "compat_ifbank": dict(DEFAULT, compat_pll=True, fused_ifbank=True),
}


@pytest.mark.parametrize("mode", [0, 2])
def test_default_profile_matches_reference(mode):
    """Receiver(mode, stereo=True, rds=True) with every default: the scan
    loops ('auto'), the unfused float32 chain; mode 2 brings the rational
    147/800 audio resampler."""
    rx, out = check_against_reference(mode, DEFAULT)
    assert rx.pll_impl == "scan" and rx._ifbank is None
    assert rx.pll_wrap_phase and rx.rds_pll_bandwidth == 0.003


@pytest.mark.parametrize("profile", ["stereo", "rds"])
def test_one_carrier_profiles_match_reference(profile):
    """Stereo alone (one loop, the two-filter MultiFIR) and RDS alone
    (mode 0 mono + RDS: one loop on the 114 kHz line)."""
    rx, out = check_against_reference(0, LOOP_PROFILES[profile])
    assert ("left" in out) == (profile == "stereo")
    assert ("rds_soft" in out) == (profile == "rds")


def test_resume_from_reference_state_mid_stream():
    """The first half in sdr_tpu, its state (both loop states included)
    through state_from_numpy, the second half in the port: the output
    equals a whole sdr_tpu run (mono within 1e-5 of max, the carrier
    outputs at 45 dB)."""
    jrx, trx = JaxReceiver(0, **DEFAULT), Receiver(0, **DEFAULT, device="cpu")
    cap = capture(0, 0.3)
    whole, _ = jax_run(jrx, cap, 2)
    half = 3 * jrx.block_size_u8(2)
    a, jst = jax_run(jrx, cap[:half], 2)
    st = state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    for t, j in zip(leaves(st.stereo.pll) + leaves(st.rds.pll),
                    jax.tree.leaves(jst.stereo.pll)
                    + jax.tree.leaves(jst.rds.pll)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(st.stereo.pll.integrator) != 0.0   # a locked loop's state
    b, _ = trx.run(cap[half:], blocks_per_step=2, state=st)
    assert len(spans(trx, len(cap) - half, 2)) >= 2
    for k in ("mono", "left", "right", "rds_soft"):
        got = np.concatenate([a[k], b[k].float().numpy()], axis=-1)
        if k == "mono":
            assert_close(got, whole[k], 1e-5)
        else:
            assert snr_db(whole[k], got) > 45.0, k
