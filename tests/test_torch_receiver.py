"""The port's mono Receiver.run against sdr_tpu's in modes 0-3 and the
CLI's profiles (default f32, --fast, --exact-fast) plus the fused front
end's other entries, on the same numpy-seeded captures.  The reference's
fused front end runs its Pallas kernels in interpret mode on the CPU."""

import jax
import numpy as np
import pytest
import torch

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver

PROFILES = {
    "default": {},
    "fast": dict(fused_frontend="int8", conv_engine="tiled",
                 conv_dtype="bf16"),
    "exact_fast": dict(fused_frontend="int8x2"),
}
# the fused front end's other entries (mode 0): the bf16 engine, and the
# I/Q kernel without the discriminator (unfused, or under the arctan demod)
EXTRA = {
    "bf16_tiled": dict(fused_frontend="bf16", conv_engine="tiled",
                       conv_dtype="bf16"),
    "int8_unfused": dict(fused_frontend="int8", fuse_demod=False),
    "f32_arctan": dict(fused_frontend="f32", demod="arctan"),
}
CASES = ([(m, p) for m in MODES for p in PROFILES]
         + [(0, p) for p in EXTRA])


def capture(mode, seconds=0.2):
    cfg = MODES[mode]
    n = int(seconds * cfg.rf_fs)
    return tx.synthesize_capture(cfg, seconds=seconds, noise_db=-30.0,
                                 mono=tx.tone(cfg.rf_fs, 1000.0, n))


def kwargs(profile):
    return {**PROFILES, **EXTRA}[profile]


def assert_close(got, want, bf16, rel, scale=0.0):
    """|got - want| <= rel * max(max|want|, scale), plus one bf16 ulp (2^-7
    relative) where the stream is stored at bf16: a last-bit difference in
    float32 (summation order, FMA contraction in XLA, atan2 ulps) can flip
    its rounding."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not want.size:
        return
    bound = rel * max(np.abs(want).max(), scale, 1e-30)
    if bf16:
        bound = bound + 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


@pytest.mark.parametrize("mode,profile", CASES)
def test_receiver_run_matches_reference(mode, profile):
    cap = capture(mode)
    kw = dict(emit_rssi=True, emit_if=True, **kwargs(profile))
    jrx, trx = JaxReceiver(mode, **kw), Receiver(mode, **kw, device="cpu")
    jout, jst = jrx.run(cap, blocks_per_step=2)
    tout, tst = trx.run(cap, blocks_per_step=2)
    # arctan: atan2 ulps and XLA's cumsum order move the unwrapped phase
    rel = 5e-5 if kw.get("demod") == "arctan" else 1e-5
    bf16 = trx._mat_bf16
    assert set(tout) == set(jout)
    for k in ("mono", "fm_demod", "rssi_db"):
        assert tuple(tout[k].shape) == jout[k].shape, k
    assert tout["fm_demod"].dtype == (torch.bfloat16 if bf16
                                      else torch.float32)
    assert_close(tout["fm_demod"].float(), np.asarray(jout["fm_demod"],
                                                      np.float32), bf16, rel)
    if bf16:
        a = np.asarray(jout["mono"], np.float64)
        b = tout["mono"].double().numpy()
        snr = 10 * np.log10(np.mean(a * a) / max(np.mean((a - b) ** 2),
                                                 1e-30))
        assert snr > 80.0, f"mono vs reference {snr:.1f} dB"
    else:
        assert_close(tout["mono"], jout["mono"], False, rel)
    np.testing.assert_allclose(tout["rssi_db"].numpy(),
                               np.asarray(jout["rssi_db"]), atol=1e-4)
    # final state: leaf for leaf in shape and dtype, values as the streams
    jleaves = jax.tree.leaves(jst)
    tleaves = list(tst.front) + list(tst.mono)
    assert tst.stereo is None and tst.rds is None
    assert len(tleaves) == len(jleaves)
    for idx, (t, j) in enumerate(zip(tleaves, jleaves)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        if t.dtype == torch.uint8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            # the arctan carry (prev_i) is re-wrapped from an unwrapped
            # phase of up to ~100 rad: its error scales with that, not
            # with the wrapped value
            phase = kw.get("demod") == "arctan" and idx == 2
            assert_close(t.float(), np.asarray(j, np.float32),
                         t.dtype == torch.bfloat16, rel,
                         scale=np.pi if phase else 0.0)


def test_step_iq_matches_reference():
    """step_iq: the entry for already-decoded float I/Q at the RF rate."""
    cfg = MODES[0]
    rng = np.random.default_rng(11)
    ph = np.cumsum(rng.normal(0, 0.3, (2, 2 * 12800)), axis=-1)
    i_raw = np.cos(ph).astype(np.float32)
    q_raw = np.sin(ph).astype(np.float32)
    jrx = JaxReceiver(0, emit_if=True)
    trx = Receiver(0, emit_if=True, device="cpu")
    jst, tst = jrx.init_state((2,)), trx.init_state((2,))
    for sl in (slice(0, 12800), slice(12800, 25600)):
        jst, jout = jrx.step_iq(jst, i_raw[:, sl], q_raw[:, sl])
        tst, tout = trx.step_iq(tst, torch.from_numpy(i_raw[:, sl]),
                                torch.from_numpy(q_raw[:, sl]))
        for k in ("fm_demod", "mono"):
            assert_close(tout[k], jout[k], False, 1e-5)
    assert tuple(tout["mono"].shape) == (2, 12800 // cfg.rf_decim
                                         // cfg.audio_decim)
