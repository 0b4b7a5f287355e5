"""The port's stereo + RDS receiver state: runs invariant to where a
capture is split, a state carried over from a sdr_tpu run that continues
it, state dtypes that a step keeps, the numpy round trip, and the options
that wait for later slices."""

import jax
import numpy as np
import pytest
import torch

from sdr_tpu.models import state as jstate_mod
from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.ops.pll import PLLState as JPLL
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from test_torch_stereo_receiver import (BENCH, FAST, PROFILES, assert_close,
                                        capture, jax_run, leaves, snr_db,
                                        spans)

UNFUSED_F32 = dict(stereo=True, rds=True, pll_impl="ff")
DTYPE_PROFILES = {**PROFILES, "stereo_fast": dict(FAST, stereo=True),
                  "rds_fast": dict(FAST, rds=True), "unfused_f32": UNFUSED_F32}


def jax_types(np_state):
    """The port's NamedTuples with numpy leaves -> the reference's types."""
    def conv(node, cls):
        if node is None:
            return None
        nested = {"front": jstate_mod.FrontEndState,
                  "mono": jstate_mod.MonoState,
                  "stereo": jstate_mod.StereoState,
                  "rds": jstate_mod.RdsState, "pll": JPLL}
        return cls(*(conv(getattr(node, f), nested[f]) if f in nested
                     else getattr(node, f) for f in cls._fields))
    return conv(np_state, jstate_mod.ReceiverState)


@pytest.mark.parametrize("profile", ["fast", "stereo_fast"])
def test_split_invariance(profile, rng):
    """Random aligned step sizes give one run's output: the state carry of
    every fused stage (u8 tail, fm context, rds delay context, audio
    tails, the carrier phase track) is whole.  The chain is bf16, and a
    block cut elsewhere may sum a float32 conv in another order, which can
    flip a bf16 rounding: 45 dB, the reference's bar for its own chains."""
    kw = DTYPE_PROFILES[profile]
    rx = Receiver(0, **kw)
    cap = capture(0, 0.3, rds=kw.get("rds", False))
    align = rx.block_align_u8()
    n = (len(cap) // align) * align
    whole, st_whole = rx.run(cap[:n], blocks_per_step=1)
    state, pos, chunks = rx.init_state(), 0, {}
    while pos < n:
        size = min(int(rng.integers(1, 4)) * align, n - pos)
        state, out = rx.step(state, torch.from_numpy(cap[pos:pos + size]))
        for k, v in out.items():
            chunks.setdefault(k, []).append(v)
        pos += size
    for k, v in whole.items():
        got = torch.cat(chunks[k], dim=-1)
        assert got.shape == v.shape
        assert snr_db(v.double().numpy(), got.double().numpy()) > 45.0, k
    for a, b in zip(leaves(state), leaves(st_whole)):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("kw", [BENCH, UNFUSED_F32],
                         ids=["fast", "unfused_f32"])
def test_state_carried_over_from_reference(kw):
    """The first half in sdr_tpu, state_from_numpy, the second half in the
    port: the output equals a whole sdr_tpu run (45 dB on a bf16 chain,
    1e-5 of max element-wise on the float32 one)."""
    jrx, trx = JaxReceiver(0, **kw), Receiver(0, **kw)
    cap = capture(0, 0.3)
    whole, _ = jax_run(jrx, cap, 2)
    bs = jrx.block_size_u8(2)
    half = 2 * bs
    a, jst = jax_run(jrx, cap[:half], 2)
    st = state_from_numpy(jax.tree.map(np.asarray, jst))
    for t, j in zip(leaves(st), jax.tree.leaves(jst)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    b, _ = trx.run(cap[half:], blocks_per_step=2, state=st)
    assert len(spans(trx, len(cap) - half, 2)) >= 2
    for k in ("mono", "left", "right", "rds_soft"):
        got = np.concatenate([a[k], b[k].float().numpy()], axis=-1)
        if kw.get("conv_dtype") == "bf16":
            assert snr_db(whole[k], got) > 45.0, k
        else:
            assert_close(got, whole[k], 1e-5)


@pytest.mark.parametrize("profile", sorted(DTYPE_PROFILES))
def test_step_keeps_state_dtypes(profile):
    """A step returns a state with init_state's dtypes and shapes, in every
    engine set (mixed ones too: int8x2 front end with a bf16 IF bank)."""
    rx = Receiver(0, **DTYPE_PROFILES[profile])
    st0 = rx.init_state((2,))
    blk = np.stack([capture(0)[:rx.block_size_u8()]] * 2)
    st1, _ = rx.step(st0, torch.from_numpy(blk))
    l0, l1 = leaves(st0), leaves(st1)
    assert len(l0) == len(l1)
    for a, b in zip(l0, l1):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("kw", [BENCH, dict(BENCH, fused_ifbank=False)],
                         ids=["fast", "unfused_ifbank"])
def test_state_numpy_round_trip(kw):
    """A reference stereo + RDS state crosses state_from_numpy and
    state_to_numpy leaf-equal (dtypes, shapes, bf16 bit patterns), and the
    reference's step takes it back."""
    jrx = JaxReceiver(0, **kw)
    cap = capture(0)
    _, jst = jax_run(jrx, cap[:2 * jrx.block_size_u8()], 1)
    np_state = jax.tree.map(np.asarray, jst)
    back = state_to_numpy(state_from_numpy(np_state))
    jl, bl = jax.tree.leaves(np_state), jax.tree.leaves(back)
    assert len(jl) == len(bl) > 20
    for j, b in zip(jl, bl):
        assert j.dtype == b.dtype and j.shape == b.shape
        if j.dtype.name == "bfloat16":
            np.testing.assert_array_equal(j.view(np.uint16),
                                          b.view(np.uint16))
        else:
            np.testing.assert_array_equal(j, b)
    st, out = jrx.step(jax.tree.map(jax.numpy.asarray, jax_types(back)),
                       cap[:jrx.block_size_u8()])
    assert np.isfinite(np.asarray(out["left"])).all()


@pytest.mark.parametrize("kw", [
    dict(stereo=True), dict(rds=True),
    dict(stereo=True, pll_impl="chunked"),
    dict(stereo=True, rds=True, pll_impl="ff", compat_pll=True),
    dict(stereo=True, pll_impl="ff", compat_shared_audio_state=True),
    dict(stereo=True, pll_impl="ff", deemphasis_us=75.0),
    dict(stereo=True, pll_impl="ff", filter_engine="fft")])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Receiver(0, **kw)
