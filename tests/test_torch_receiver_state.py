"""The port's receiver state: block geometry equal to sdr_tpu's, runs that
are invariant to where a capture is split, and a state carried over from a
sdr_tpu run (utils/convert.py) that continues it."""

import jax
import numpy as np
import pytest
import torch

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.models.state import FrontEndState as JFront
from sdr_tpu.models.state import MonoState as JMono
from sdr_tpu.models.state import ReceiverState as JState
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from test_torch_receiver import PROFILES, assert_close, capture


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kw", [{}, dict(fused_frontend="int8"),
                                dict(fused_frontend="int8x2",
                                     fe_out_tile=1024, fe_sub_tiles=8)])
def test_block_geometry_and_weights_match_reference(mode, kw):
    """Same block geometry, and the same filter coefficients (the port
    designs them with its own firdes copy)."""
    j, t = JaxReceiver(mode, **kw), Receiver(mode, **kw)
    assert t.block_align_u8() == j.block_align_u8()
    for bps in (1, 3, 50):
        assert t.block_size_u8(bps) == j.block_size_u8(bps)
    for tr, jr in ((t.audio_resampler, j.audio_resampler),
                   (t.rf_resampler, j.rf_resampler)):
        assert tr.state_len == jr.state_len
        np.testing.assert_array_equal(tr._weight.numpy(), np.asarray(jr._rhs))
    if kw:
        assert t._fused_fe.fix_scale == j._fused_fe.fix_scale
        assert t._fused_fe.tail_u8 == j._fused_fe.tail_u8


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_receiver_split_invariant(mode, profile):
    """Two runs over the halves of a capture (state carried) give the
    whole run's output."""
    rx = Receiver(mode, emit_rssi=True, **PROFILES[profile])
    cap = capture(mode)
    whole, st_whole = rx.run(cap, blocks_per_step=2)
    half = (len(cap) // 2 // rx.block_align_u8()) * rx.block_align_u8()
    a, st = rx.run(cap[:half], blocks_per_step=2)
    b, st = rx.run(cap[half:], blocks_per_step=2, state=st)
    got = torch.cat([a["mono"], b["mono"]])
    assert got.shape == whole["mono"].shape
    # the integer front end is exact; the float convs may sum a
    # differently cut block in another order
    np.testing.assert_allclose(got.numpy(), whole["mono"].numpy(), rtol=0,
                               atol=1e-6)
    for u, v in zip(list(st.front) + list(st.mono),
                    list(st_whole.front) + list(st_whole.mono)):
        np.testing.assert_allclose(u.float().numpy(), v.float().numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,profile", [(0, "default"), (0, "fast"),
                                          (0, "exact_fast"), (2, "default")])
def test_state_carried_over_from_reference(mode, profile):
    """First half in sdr_tpu, state_from_numpy, second half in the port:
    the output equals a whole sdr_tpu run."""
    kw = PROFILES[profile]
    jrx, trx = JaxReceiver(mode, **kw), Receiver(mode, **kw)
    cap = capture(mode)
    whole, _ = jrx.run(cap, blocks_per_step=2)
    half = (len(cap) // 2 // jrx.block_align_u8()) * jrx.block_align_u8()
    a, jst = jrx.run(cap[:half], blocks_per_step=2)
    st = state_from_numpy(jax.tree.map(np.asarray, jst))
    for t, j in zip(list(st.front) + list(st.mono), jax.tree.leaves(jst)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    b, _ = trx.run(cap[half:], blocks_per_step=2, state=st)
    got = np.concatenate([np.asarray(a["mono"]), b["mono"].numpy()])
    want = np.asarray(whole["mono"])
    if trx._mat_bf16:
        snr = 10 * np.log10(np.mean(want ** 2)
                            / max(np.mean((got - want) ** 2), 1e-30))
        assert snr > 80.0, f"{snr:.1f} dB"
    else:
        assert_close(got, want, False, 1e-5)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_state_numpy_round_trip(profile):
    """state_to_numpy gives what the reference's step takes, and converts
    back to the same tensors."""
    rx = Receiver(0, **PROFILES[profile])
    _, st = rx.run(capture(0, 0.05))
    np_state = state_to_numpy(st)
    back = state_from_numpy(np_state)
    for x, y in zip(list(st.front) + list(st.mono),
                    list(back.front) + list(back.mono)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    jst = JState(JFront(*np_state.front), JMono(*np_state.mono))
    jrx = JaxReceiver(0, **PROFILES[profile])
    blk = capture(0, 0.05)[:jrx.block_align_u8()]
    _, out = jrx.step(jax.tree.map(jax.numpy.asarray, jst), blk)
    assert np.all(np.isfinite(np.asarray(out["mono"])))


@pytest.mark.parametrize("kw", [dict(stereo=True), dict(rds=True),
                                dict(filter_engine="fft"),
                                dict(deemphasis_us=75.0)])
def test_not_yet_ported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Receiver(0, **kw)
