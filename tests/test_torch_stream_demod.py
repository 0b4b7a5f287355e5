"""Port of io/stream.py and ops/demod.py against sdr_tpu on the same
numpy-seeded inputs: the stream codecs bit-exact, the demodulators to
float tolerance."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.io import stream as jstream
from sdr_tpu.ops import demod as jdemod
from sdr_tpu_torch.io import stream as tstream
from sdr_tpu_torch.ops import demod as tdemod


def test_decode_u8_iq_bit_exact():
    raw = np.random.default_rng(0).integers(0, 256, (3, 1000),
                                            dtype=np.uint8)
    raw[0, :4] = [0, 128, 255, 127]
    ji, jq = jstream.decode_u8_iq(jnp.asarray(raw))
    ti, tq = tstream.decode_u8_iq(torch.from_numpy(raw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        tstream.u8_to_f32(torch.from_numpy(raw)).numpy(),
        np.asarray(jstream.u8_to_f32(jnp.asarray(raw))))


def _audio():
    x = np.random.default_rng(1).normal(0, 0.7, (2, 999)).astype(np.float32)
    # NaN guard, clipping range, exact truncation boundaries, negatives
    x[0, :8] = [np.nan, 1.99, -1.99, 0.5 / 16384, -0.5 / 16384,
                -1.0 / 16384, 2.5, -2.5]
    return x


def test_pack_s16_bit_exact():
    x = _audio()
    np.testing.assert_array_equal(
        tstream.pack_s16(torch.from_numpy(x)).numpy(),
        np.asarray(jstream.pack_s16(jnp.asarray(x))))


def test_interleave_stereo_s16_bit_exact():
    x = _audio()
    got = tstream.interleave_stereo_s16(torch.from_numpy(x[0]),
                                        torch.from_numpy(x[1])).numpy()
    want = np.asarray(jstream.interleave_stereo_s16(jnp.asarray(x[0]),
                                                    jnp.asarray(x[1])))
    np.testing.assert_array_equal(got, want)
    assert got[0] == want[0]  # R first


@pytest.mark.parametrize("n,bs", [(1000, 300), (900, 300), (50, 300)])
def test_block_readers_match(n, bs):
    data = np.arange(n, dtype=np.uint8).tobytes()
    want = list(jstream.read_u8_blocks(io.BytesIO(data), bs))
    got = list(tstream.read_u8_blocks(io.BytesIO(data), bs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jr = jstream.SyncBlockReader(io.BytesIO(data), bs)
    tr = tstream.SyncBlockReader(io.BytesIO(data), bs)
    assert [b.tobytes() for b in tr] == [b.tobytes() for b in jr]
    assert tr.tail().tobytes() == jr.tail().tobytes()


def _iq(c=3, n=512, seed=2):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(rng.normal(0, 0.4, (c, n)), axis=-1)
    amp = 0.8 + 0.1 * rng.normal(size=(c, n))
    i = (amp * np.cos(ph)).astype(np.float32)
    q = (amp * np.sin(ph)).astype(np.float32)
    return i, q


def test_fm_discriminator_matches():
    i, q = _iq()
    i[1, 7] = q[1, 7] = 0.0          # den == 0 guard
    pi = np.array([0.3, -0.2, 0.0], np.float32)
    pq = np.array([0.1, 0.5, 0.0], np.float32)
    jd, jpi, jpq = jdemod.fm_discriminator(*map(jnp.asarray, (i, q, pi, pq)))
    td, tpi, tpq = tdemod.fm_discriminator(*map(torch.from_numpy,
                                                (i, q, pi, pq)))
    assert td[1, 7].item() == 0.0 and np.asarray(jd)[1, 7] == 0.0
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
    np.testing.assert_array_equal(tpq.numpy(), np.asarray(jpq))
    # station 2 starts from a zero prev sample: its first output is 0/den
    assert td[2, 0].item() == 0.0


def test_fm_arctan_matches_over_two_blocks():
    i, q = _iq(n=1024, seed=3)
    jprev = jnp.zeros(3, jnp.float32)
    tprev = torch.zeros(3)
    for sl in (slice(0, 512), slice(512, 1024)):
        jd, jprev = jdemod.fm_arctan(jnp.asarray(i[:, sl]),
                                     jnp.asarray(q[:, sl]), jprev)
        td, tprev = tdemod.fm_arctan(torch.from_numpy(i[:, sl]),
                                     torch.from_numpy(q[:, sl]), tprev)
        # atan2 differs by an ulp between the two libraries and XLA's
        # cumsum sums in another order than torch's: both move the
        # unwrapped phase (tens of radians here) by a few float32 ulps
        # (~2e-6), and both the phase differences and the re-wrapped carry
        # keep that
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev),
                                   rtol=1e-6, atol=1e-5)
        assert np.all(np.abs(tprev.numpy()) <= np.pi)
