"""The port's Receiver state on the carrier loop engines: a run invariant
to where the capture is split (the default profile, the scan loops) and
the state dtypes of every loop profile against the reference's."""

import jax
import numpy as np
import pytest
import torch

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu_torch.models.receiver import Receiver

from test_torch_pll_receiver import DEFAULT, LOOP_PROFILES
from test_torch_stereo_receiver import capture, leaves, snr_db


def test_split_invariance_default_profile(rng):
    """Random aligned step sizes give one run's output (45 dB: a block cut
    elsewhere may sum a float32 conv in another order, and the loops
    carry that difference through their feedback)."""
    rx = Receiver(0, **DEFAULT, device="cpu")
    cap = capture(0, 0.3)
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


@pytest.mark.parametrize("profile", sorted(LOOP_PROFILES))
def test_loop_profiles_keep_state_dtypes(profile):
    """A step returns a state with init_state's dtypes and shapes, and
    both equal the reference's init_state, leaf for leaf."""
    kw = LOOP_PROFILES[profile]
    rx = Receiver(0, **kw, device="cpu")
    st0 = rx.init_state((2,))
    jl = jax.tree.leaves(JaxReceiver(0, **kw).init_state((2,)))
    assert len(leaves(st0)) == len(jl)
    for t, j in zip(leaves(st0), jl):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    blk = np.stack([capture(0)[:rx.block_size_u8()]] * 2)
    st1, _ = rx.step(st0, torch.from_numpy(blk))
    l0, l1 = leaves(st0), leaves(st1)
    assert len(l0) == len(l1)
    for a, b in zip(l0, l1):
        assert a.dtype == b.dtype and a.shape == b.shape
