"""The port's feedforward carrier estimators, MultiFIR and pointwise ops
against sdr_tpu's, on the same numpy-seeded tones and streams, with the
state carried over three blocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import pll as jpll
from sdr_tpu.ops import pointwise as jpw
from sdr_tpu.ops.resample import MultiFIR as JMultiFIR
from sdr_tpu_torch.ops import firdes, pll, pointwise
from sdr_tpu_torch.ops.resample import MultiFIR

FS = 240_000.0
# (freq, nco_scale, phase_adjust): the pilot engine and the RDS carrier one
ENGINES = [(19_000.0, 2.0, 0.0), (19_000.0, 2.0, 0.4), (114_000.0, 0.5, 0.0)]


def tone(freq, n_total, seed, c=2):
    """Noisy tones with a slow phase drift, one row per channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_total)
    phase = (2 * np.pi * freq / FS * t)[None] + rng.uniform(
        -2.5, 2.5, (c, 1)) + 1e-4 * t[None]
    return (np.cos(phase) + rng.normal(0, 0.05, (c, n_total))).astype(
        np.float32)


def assert_state_close(tst, jst):
    for a, b in zip(tst, jst):
        b = np.asarray(b, np.float64)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert np.all(np.abs(a.double().numpy() - b) <= 1e-5 * (1 + np.abs(b)))


def assert_nco_close(got, want, bf16=False):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = 1e-5 + (2.0 ** -8 if bf16 else 0.0)
    assert np.abs(got - want).max() <= bound, np.abs(got - want).max()


@pytest.mark.parametrize("freq,scale,adj", ENGINES)
@pytest.mark.parametrize("n", [2048, 1000])
def test_pll_feedforward_matches_reference(freq, scale, adj, n):
    """n = 1000 takes the window-clamping quirk: the window shrinks to 250,
    the largest divisor of n below 256."""
    x = tone(freq, 3 * n, seed=int(freq) + n)
    tst, jst = pll.pll_init((2,)), jpll.pll_init((2,))
    kw = dict(freq=freq, fs=FS, nco_scale=scale, phase_adjust=adj,
              window=256)
    for b in range(3):
        blk = x[:, b * n:(b + 1) * n]
        jnco, jst = jpll.pll_feedforward(jnp.asarray(blk), jst, **kw)
        tnco, tst = pll.pll_feedforward(torch.from_numpy(blk), tst, **kw)
        assert_nco_close(tnco, jnco)
        assert_state_close(tst, jst)


@pytest.mark.parametrize("freq,scale,adj", ENGINES)
def test_estimators_from_sums_match_reference(freq, scale, adj):
    """pll_ff_params_from_sums and pll_feedforward_from_sums (float32 and
    bf16 NCO) from the same per-window sums, state carried."""
    n, w = 2048, 256
    x = tone(freq, 3 * n, seed=7)
    tabs = jpll._ff_tables(n, w, freq, FS, scale, adj)
    cos_r, sin_r = np.asarray(tabs["cos_ramp"]), np.asarray(tabs["sin_ramp"])
    sts = {k: (pll.pll_init((2,)), jpll.pll_init((2,)))
           for k in ("params", "f32", "bf16")}
    for b in range(3):
        x2 = x[:, b * n:(b + 1) * n].reshape(2, n // w, w)
        zr = (x2 * cos_r).sum(-1).astype(np.float32)
        zi = (-x2 * sin_r).sum(-1).astype(np.float32)
        tz = (torch.from_numpy(zr), torch.from_numpy(zi))
        jz = (jnp.asarray(zr), jnp.asarray(zi))
        t, j = sts["params"]
        (toff, tslope), t = pll.pll_ff_params_from_sums(
            *tz, t, freq=freq, fs=FS, n=n, nco_scale=scale, window=w)
        (joff, jslope), j = jpll.pll_ff_params_from_sums(
            *jz, j, freq=freq, fs=FS, n=n, nco_scale=scale, window=w)
        np.testing.assert_allclose(toff.numpy(), np.asarray(joff), rtol=0,
                                   atol=1e-5 * (1 + np.abs(joff).max()))
        np.testing.assert_allclose(tslope.numpy(), np.asarray(jslope),
                                   rtol=0, atol=1e-7)
        assert_state_close(t, j)
        sts["params"] = (t, j)
        for key, tdt, jdt in (("f32", torch.float32, jnp.float32),
                              ("bf16", torch.bfloat16, jnp.bfloat16)):
            t, j = sts[key]
            kw = dict(freq=freq, fs=FS, n=n, nco_scale=scale,
                      phase_adjust=adj, window=w)
            tnco, t = pll.pll_feedforward_from_sums(*tz, t, out_dtype=tdt,
                                                    **kw)
            jnco, j = jpll.pll_feedforward_from_sums(*jz, j, out_dtype=jdt,
                                                     **kw)
            assert tnco.dtype == tdt
            assert_nco_close(tnco, np.asarray(jnco, np.float32),
                             key == "bf16")
            assert_state_close(t, j)
            sts[key] = (t, j)


def test_pll_feedforward_multi_matches_reference():
    n = 1536
    params = ((19_000.0, FS, 2.0, 0.2), (114_000.0, FS, 0.5, 0.0))
    xs = [tone(p[0], 3 * n, seed=i) for i, p in enumerate(params)]
    tsts = (pll.pll_init((2,)), pll.pll_init((2,)))
    jsts = (jpll.pll_init((2,)), jpll.pll_init((2,)))
    for b in range(3):
        blk = [x[:, b * n:(b + 1) * n] for x in xs]
        jn, jsts = jpll.pll_feedforward_multi(
            [jnp.asarray(v) for v in blk], jsts, params=params, window=256)
        tn, tsts = pll.pll_feedforward_multi(
            [torch.from_numpy(v) for v in blk], tsts, params=params,
            window=256)
        for k in range(2):
            assert_nco_close(tn[k], jn[k])
            assert_state_close(tsts[k], jsts[k])


@pytest.mark.parametrize("freq,scale,adj", ENGINES)
@pytest.mark.parametrize("n,w", [(2048, 256), (76800, 256), (1000, 250)])
def test_ff_tables_bit_equal(freq, scale, adj, n, w):
    j = jpll._ff_tables(n, w, freq, FS, scale, adj)
    t = pll._ff_tables(n, w, freq, FS, scale, adj)
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == torch.float32
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_multifir_matches_reference(dtype):
    coeffs = [firdes.bandpass(FS, 22e3, 54e3, 51),
              firdes.bandpass(FS, 18.5e3, 19.5e3, 51),
              firdes.bandpass(FS, 54e3, 60e3, 41)]
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jf, tf = JMultiFIR(coeffs, compute_dtype=jdt), MultiFIR(coeffs,
                                                           compute_dtype=tdt)
    assert tf.state_len == jf.state_len == 50
    np.testing.assert_array_equal(tf._weight.numpy(),
                                  np.asarray(jf._rhs.astype(jdt), np.float32))
    x = np.random.default_rng(5).normal(0, 1, (2, 3, 700)).astype(np.float32)
    jt, tt = jf.init_state((2,)), tf.init_state((2,))
    for b in range(3):
        jouts, jt = jf(jnp.asarray(x[:, b]), jt)
        touts, tt = tf(torch.from_numpy(x[:, b]), tt)
        for t, j in zip(touts, jouts):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=1e-6 * np.abs(j).max())
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pointwise_bit_equal(dtype):
    rng = np.random.default_rng(6)
    a, b = (rng.normal(0, 1, (2, 300)).astype(np.float32) for _ in range(2))
    st = rng.normal(0, 1, (2, 25)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ta, tb, tst = (torch.from_numpy(v).to(dtype) for v in (a, b, st))
    ja, jb, jst = (jnp.asarray(v).astype(jdt) for v in (a, b, st))

    def eq(t, j):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    eq(pointwise.mixer(ta, tb), jpw.mixer(ja, jb))
    for t, j in zip(pointwise.lr_matrix(ta, tb), jpw.lr_matrix(ja, jb)):
        eq(t, j)
    for t, j in zip(pointwise.delay_line(ta, tst), jpw.delay_line(ja, jst)):
        eq(t, j)
    # delay 0 passes the block through
    t, tail = pointwise.delay_line(ta, tst[:, :0])
    assert torch.equal(t, ta) and tail.shape == (2, 0)
