"""The port's carrier loop engines (`ops.pll.pll`, the scan engine, and
`ops.pll.pll_chunked`) against sdr_tpu's on the same numpy-seeded pilot
tones.  On the CPU both engines run their plain PyTorch versions.

The bounds are the reference's own for its loop kernels
(tests/test_pallas.py:24-26): nco within 2e-4, phase_acc within 1e-3
compared modulo the wrap period.  In the trigOffset counter mode
(compat_pll) the NCO argument w0*trig + acc grows with the sample count,
and XLA on the CPU rounds it differently by an ulp of itself (it fuses
the multiply-add), so those runs stay within 2048 samples, where an ulp
times nco_scale 2 is 1.2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import pll as jpll
from sdr_tpu_torch.ops import pll as tpll

FS = 240e3


def tones(c, n, seed=0, freqs=(19e3, 19e3, 18990.0)):
    """Pilot-like tones with noise, one per row (locked loops: on noise,
    two correct loops can part at the atan2 branch cut)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = np.stack([a * np.cos(2 * np.pi * f * t + ph) for a, f, ph in zip(
        rng.uniform(0.3, 0.5, c), (freqs * c)[:c], rng.uniform(0, 6, c))])
    return (x + rng.normal(0, 0.01, x.shape)).astype(np.float32)


def torch_state(st):
    return tpll.PLLState(*(torch.from_numpy(np.array(v)) for v in st))


def wrapped_diff(a, b, period):
    d = np.remainder(np.asarray(a, np.float64) - np.asarray(b, np.float64),
                     period)
    return np.minimum(d, period - d)


def assert_loop_close(tout, tst, jout, jst, period, nco_atol=2e-4):
    """The reference's gates: nco within nco_atol, phase_acc within 1e-3
    modulo the period, the other state leaves within 1e-3 (integrator,
    feedback) and trig_offset exactly."""
    assert tout.dtype == torch.float32 and tout.shape == jout.shape
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=nco_atol)
    assert np.all(wrapped_diff(tst.phase_acc.numpy(), jst.phase_acc,
                               period) <= 1e-3)
    for f in ("integrator", "feedback_i", "feedback_q"):
        t, j = getattr(tst, f), np.asarray(getattr(jst, f))
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, atol=1e-3)
    np.testing.assert_array_equal(tst.trig_offset.numpy(),
                                  np.asarray(jst.trig_offset))


@pytest.mark.parametrize("batched", [True, False], ids=["batch3", "1d"])
@pytest.mark.parametrize("wrap,lag", [(True, True), (True, False),
                                      (False, True), (False, False)])
def test_pll_matches_reference(wrap, lag, batched):
    """Both modes of the scan engine, with and without lag correction, on
    a (3,) batch (two 19 kHz tones, one 10 Hz off) and on a 1-d block."""
    n = 3000 if wrap else 2048
    x = tones(3, n, seed=int(wrap) * 2 + int(lag))
    if not batched:
        x = x[2]
    lead = x.shape[:-1]
    kw = dict(freq=19e3, fs=FS, nco_scale=2.0, phase_adjust=0.2,
              wrap_phase=wrap, lag_correction=lag)
    jout, jst = jpll.pll(jnp.asarray(x), jpll.pll_init(lead), **kw)
    tout, tst = tpll.pll(torch.from_numpy(x),
                         tpll.pll_init(lead, device="cpu"), **kw)
    assert_loop_close(tout, tst, jout, jst, 2 * np.pi)


def test_pll_counter_mode_carries_trig_offset():
    """compat_pll's counter advances by the block length and the phase
    is not wrapped; a carried state continues it."""
    x = tones(2, 2048, seed=5)
    kw = dict(freq=19e3, fs=FS, nco_scale=2.0, wrap_phase=False,
              lag_correction=False)
    _, jst = jpll.pll(jnp.asarray(x[:, :1024]), jpll.pll_init((2,)), **kw)
    jout, jst2 = jpll.pll(jnp.asarray(x[:, 1024:]), jst, **kw)
    tout, tst2 = tpll.pll(torch.from_numpy(x[:, 1024:]), torch_state(jst),
                          **kw)
    np.testing.assert_array_equal(tst2.trig_offset.numpy(), [2048.0] * 2)
    assert_loop_close(tout, tst2, jout, jst2, 2 * np.pi)


@pytest.mark.parametrize("chunk,scale,freq", [(16, 2.0, 19e3),
                                              (32, 0.5, 114e3)])
def test_pll_chunked_matches_reference(chunk, scale, freq):
    """The frozen-feedback engine in the reference's XLA form: the pilot
    loop (scale 2, 19 kHz) and the RDS carrier loop (scale 0.5, 114 kHz,
    bandwidth 0.003, wrap period 4 pi)."""
    x = tones(3, 3200, seed=chunk, freqs=(freq,))
    kw = dict(freq=freq, fs=FS, nco_scale=scale, phase_adjust=0.1,
              norm_bandwidth=0.01 if scale == 2.0 else 0.003, chunk=chunk)
    jout, jst = jpll.pll_chunked(jnp.asarray(x), jpll.pll_init((3,)), **kw)
    tout, tst = tpll.pll_chunked(torch.from_numpy(x),
                                 tpll.pll_init((3,), device="cpu"), **kw)
    assert_loop_close(tout, tst, jout, jst, 2 * np.pi / min(scale, 1.0))


def test_pll_chunked_refuses_a_partial_chunk():
    with pytest.raises(ValueError, match="chunk"):
        tpll.pll_chunked(torch.zeros(2, 1000),
                         tpll.pll_init((2,), device="cpu"),
                         freq=19e3, fs=FS, chunk=16)


@pytest.mark.parametrize("engine", ["scan", "scan_counter", "chunked"])
def test_two_blocks_continue_one(engine):
    """Two chained calls give one call's output and state bit for bit:
    the carried state is the whole loop state."""
    x = torch.from_numpy(tones(2, 2400, seed=9))
    kw = dict(freq=19e3, fs=FS, nco_scale=2.0)
    if engine == "chunked":
        fn = lambda v, s: tpll.pll_chunked(v, s, chunk=16, **kw)
    else:
        fn = lambda v, s: tpll.pll(v, s, wrap_phase=engine == "scan", **kw)
    full, fst = fn(x, tpll.pll_init((2,), device="cpu"))
    a, st = fn(x[:, :1200], tpll.pll_init((2,), device="cpu"))
    b, st = fn(x[:, 1200:], st)
    torch.testing.assert_close(torch.cat([a, b], -1), full, rtol=0, atol=0)
    for u, v in zip(st, fst):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
