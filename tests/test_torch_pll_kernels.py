"""The plain PyTorch versions of the carrier-loop kernels against
sdr_tpu's Pallas kernels (interpret mode on the CPU, as
tests/test_pallas.py runs them), on the same numpy-seeded inputs: the
polynomial phase detector, the sequential loop (`pll_pallas`), the
chunked loop (`pll_pallas_chunked`) and the joint pilot + RDS loop
(`pll_pallas_chunked_multi`), and the chunked loop with its sums in the
CUDA kernel's order (`kernel_order_sums`: butterfly and pair scan).
Bounds: the reference's own (nco within 2e-4, phase_acc within 1e-3
modulo the wrap period)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import pll as jpll
from sdr_tpu.ops.pallas import pll_kernel as jkernel
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.ops.cuda import pll_kernel as tkernel

from test_torch_pll_loop import FS, assert_loop_close, tones

RDS_FREQ = 114e3


def test_atan2_poly_matches_reference():
    """Octant edges (|y| = |x|), the axes, x < 0 with y = +-0 (+pi in
    the polynomial, unlike libm's -pi for y = -0), (0, 0) and random
    points: within 2e-7 rad of the reference (XLA may fuse the Horner
    steps), and the signed-zero cases exactly."""
    rng = np.random.default_rng(0)
    edges = [(1.0, 1.0), (-1.0, 1.0), (1.0, -1.0), (-1.0, -1.0),
             (0.0, 1.0), (1.0, 0.0), (-1.0, 0.0), (0.0, -1.0),
             (0.0, -2.0), (-0.0, -2.0), (0.0, 0.0), (-0.0, 0.0),
             (0.0, -0.0), (-0.0, -0.0), (1e-30, -1e-30), (3.0, 3.0000002)]
    y = np.array([e[0] for e in edges] + list(rng.normal(0, 2, 500)),
                 np.float32)
    x = np.array([e[1] for e in edges] + list(rng.normal(0, 2, 500)),
                 np.float32)
    want = np.asarray(jkernel._atan2_poly(jnp.asarray(y), jnp.asarray(x)))
    got = tkernel.atan2_poly(torch.from_numpy(y), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-7)
    k = len(edges)
    np.testing.assert_array_equal(got.numpy()[:k][8:14],
                                  want[:k][8:14])
    assert got[8] == got[9] == np.float32(np.pi)   # x < 0, y = +-0
    assert got[10] == 0.0
    np.testing.assert_allclose(got.numpy()[k:], np.arctan2(y[k:], x[k:]),
                               atol=2e-5)


@pytest.mark.parametrize("batched", [True, False], ids=["batch3", "1d"])
def test_pll_pallas_plain_matches_reference(batched):
    """The sequential loop with the polynomial detector against
    pll_pallas with chunk=1000, which forces its outer scan over three
    kernel calls (test_pallas.py:37)."""
    x = tones(3, 3000, seed=11)
    if not batched:
        x = x[0]
    lead = x.shape[:-1]
    kw = dict(freq=19e3, fs=FS, nco_scale=2.0, phase_adjust=0.3)
    jout, jst = jkernel.pll_pallas(jnp.asarray(x), jpll.pll_init(lead),
                                   chunk=1000, interpret=True, **kw)
    tout, tst = tkernel.pll_pallas(torch.from_numpy(x),
                                   tpll.pll_init(lead, device="cpu"), **kw)
    assert_loop_close(tout, tst, jout, jst, 2 * np.pi)


def test_pll_pallas_ignores_the_counter_and_lag_off():
    """pll_pallas always wraps; lag_correction=False emits the
    reference's one-sample lead."""
    x = tones(2, 1600, seed=12)
    kw = dict(freq=19e3, fs=FS, nco_scale=2.0, lag_correction=False)
    jout, jst = jkernel.pll_pallas(jnp.asarray(x), jpll.pll_init((2,)),
                                   interpret=True, **kw)
    tout, tst = tkernel.pll_pallas(torch.from_numpy(x),
                                   tpll.pll_init((2,), device="cpu"), **kw)
    assert_loop_close(tout, tst, jout, jst, 2 * np.pi)


@pytest.mark.parametrize("chunk,n", [(16, 3200), (32, 3200), (64, 3000)],
                         ids=["16", "32", "clamped_60"])
def test_pll_pallas_chunked_plain_matches_reference(chunk, n):
    """The chunked loop, polynomial detector, Pallas form: chunk 16 (the
    receiver's default), 32 and 64, which clamps to 60, the largest
    divisor of 3000 below it (with bandwidth 0.003 there: 60 * 0.01 * Cp
    is past the frozen-feedback loop's stability limit)."""
    x = tones(2, n, seed=chunk)
    kw = dict(freq=19e3, fs=FS, nco_scale=2.0, phase_adjust=0.1,
              norm_bandwidth=0.01 if chunk <= 32 else 0.003, chunk=chunk)
    jout, jst = jkernel.pll_pallas_chunked(
        jnp.asarray(x), jpll.pll_init((2,)), interpret=True, **kw)
    tout, tst = tkernel.pll_pallas_chunked(torch.from_numpy(x),
                                           tpll.pll_init((2,), device="cpu"),
                                           **kw)
    assert_loop_close(tout, tst, jout, jst, 2 * np.pi)


def test_pll_pallas_chunked_multi_plain_matches_reference():
    """G = 2 instances in one launch, as the receiver's joint loop: the
    pilot (scale 2, bandwidth 0.01, 3 channels) and the RDS carrier
    (114 kHz, scale 0.5, bandwidth 0.003, 2 channels, wrap period 4 pi);
    each instance's nco and state against the reference's."""
    n = 3200
    pilot = tones(3, n, seed=21)
    carrier = tones(2, n, seed=22, freqs=(RDS_FREQ,))
    params = ((19e3, FS, 2.0, 0.25, 0.01), (RDS_FREQ, FS, 0.5, 0.0, 0.003))
    jst = (jpll.pll_init((3,)), jpll.pll_init((2,)))
    tst = (tpll.pll_init((3,), device="cpu"),
           tpll.pll_init((2,), device="cpu"))
    jouts, jnew = jkernel.pll_pallas_chunked_multi(
        (jnp.asarray(pilot), jnp.asarray(carrier)), jst, params=params,
        chunk=32, interpret=True)
    touts, tnew = tkernel.pll_pallas_chunked_multi(
        (torch.from_numpy(pilot), torch.from_numpy(carrier)), tst,
        params=params, chunk=32)
    for g, period in enumerate((2 * np.pi, 4 * np.pi)):
        assert_loop_close(touts[g], tnew[g], jouts[g], jnew[g], period)


def test_chunked_multi_equals_its_instances():
    """One launch of two instances gives each instance's lone run bit for
    bit (the lanes do not interact)."""
    pilot = torch.from_numpy(tones(2, 1600, seed=31))
    carrier = torch.from_numpy(tones(2, 1600, seed=32, freqs=(RDS_FREQ,)))
    params = ((19e3, FS, 2.0, 0.0, 0.01), (RDS_FREQ, FS, 0.5, 0.0, 0.003))
    st = tpll.pll_init((2,), device="cpu")
    outs, news = tkernel.pll_pallas_chunked_multi(
        (pilot, carrier), (st, st), params=params, chunk=16)
    for x, p, out, new in zip((pilot, carrier), params, outs, news):
        alone, anew = tkernel.pll_pallas_chunked(
            x, st, freq=p[0], fs=p[1], nco_scale=p[2], phase_adjust=p[3],
            norm_bandwidth=p[4], chunk=16)
        torch.testing.assert_close(out, alone, rtol=0, atol=0)
        for a, b in zip(new, anew):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_loop_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(ValueError):
        tkernel.pll_chunked_loop(
            (torch.zeros(2, 100),), (tpll.pll_init((2,), device="cpu"),),
            params=((19e3, FS, 2.0, 0.0, 0.01),), chunk=16)
    with pytest.raises(ValueError):
        tkernel.pll_chunked_loop((torch.zeros(2, 64), torch.zeros(2, 32)),
                                 (tpll.pll_init((2,), device="cpu"),) * 2,
                                 params=((19e3, FS, 2.0, 0.0, 0.01),) * 2,
                                 chunk=16)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_kernel_order_sums_match_reference(chunk):
    """csrc/pll.cu's order of the chunk sums (the NCO warp's pair scan a
    row with the earlier sub-blocks carried in; the chain's butterfly of
    (e_j, (K - j) e_j)) against the reference kernel's lower-triangular
    matmuls (`_pll_chunked_kernel_multi`: ce = tri e, cs = tri ce), per
    sample and at j = K, within 2e-6 of max (float32 sums in two orders)."""
    e = np.random.default_rng(chunk).normal(0, 0.5, (5, chunk)).astype(
        np.float32)
    tri = np.tril(np.ones((chunk, chunk), np.float32))
    jce = jnp.dot(jnp.asarray(tri), jnp.asarray(e.T),
                  preferred_element_type=jnp.float32)
    jcs = jnp.dot(jnp.asarray(tri), jce, preferred_element_type=jnp.float32)
    jce, jcs = np.asarray(jce).T, np.asarray(jcs).T
    ce, cs, ce_k, cs_k = tkernel.kernel_order_sums(torch.from_numpy(e), chunk)
    for got, want in ((ce, jce), (cs, jcs), (ce_k[:, 0], jce[:, -1]),
                      (cs_k[:, 0], jcs[:, -1])):
        assert got.dtype == torch.float32
        err = np.abs(got.numpy().astype(np.float64) - want).max()
        assert err <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("chunk,n", [(16, 3200), (32, 3200), (64, 3000)],
                         ids=["16", "32", "clamped_60"])
def test_kernel_order_loop_matches_reference(chunk, n):
    """The whole chunked loop with its sums in the CUDA kernel's order
    stays within the reference's gates of pll_pallas_chunked (as
    test_pll_pallas_chunked_plain_matches_reference), chunk 64 clamped to
    60 (two sub-blocks, the second 28 lanes), bandwidth 0.003 there."""
    x = tones(2, n, seed=chunk)
    kw = dict(freq=19e3, fs=FS, nco_scale=2.0, phase_adjust=0.1,
              norm_bandwidth=0.01 if chunk <= 32 else 0.003)
    jout, jst = jkernel.pll_pallas_chunked(
        jnp.asarray(x), jpll.pll_init((2,)), interpret=True, chunk=chunk,
        **kw)
    k = tpll._largest_divisor_at_most(n, chunk)
    (tout,), (tst,) = tkernel.pll_chunked_kernel_order(
        (torch.from_numpy(x),), (tpll.pll_init((2,), device="cpu"),),
        params=((kw["freq"], FS, 2.0, 0.1, kw["norm_bandwidth"]),), chunk=k)
    assert_loop_close(tout, tst, jout, jst, 2 * np.pi)


def test_kernel_order_joint_loop_matches_reference():
    """G = 2 in the kernel's order against pll_pallas_chunked_multi (the
    pilot and the RDS carrier, wrap periods 2 pi and 4 pi)."""
    n = 3200
    pilot = tones(3, n, seed=41)
    carrier = tones(2, n, seed=42, freqs=(RDS_FREQ,))
    params = ((19e3, FS, 2.0, 0.25, 0.01), (RDS_FREQ, FS, 0.5, 0.0, 0.003))
    jouts, jnew = jkernel.pll_pallas_chunked_multi(
        (jnp.asarray(pilot), jnp.asarray(carrier)),
        (jpll.pll_init((3,)), jpll.pll_init((2,))), params=params, chunk=32,
        interpret=True)
    touts, tnew = tkernel.pll_chunked_kernel_order(
        (torch.from_numpy(pilot), torch.from_numpy(carrier)),
        (tpll.pll_init((3,), device="cpu"), tpll.pll_init((2,), device="cpu")),
        params=params, chunk=32)
    for g, period in enumerate((2 * np.pi, 4 * np.pi)):
        assert_loop_close(touts[g], tnew[g], jouts[g], jnew[g], period)
