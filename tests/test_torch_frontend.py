"""The port's fused front end (plain PyTorch version of the CUDA kernels)
against sdr_tpu's Pallas FusedFrontend in interpret mode, on the same
numpy-seeded inputs, in all four coefficient engines and over two blocks
so that the tail and the discriminator carry are exercised."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops.pallas.frontend_kernel import (
    FusedFrontend as JaxFusedFrontend, _build_band_matrix)
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.cuda.frontend_kernel import (FusedFrontend,
                                                    frontend_demod_reference,
                                                    frontend_reference)

ENGINES = ("f32", "bf16", "int8", "int8x2")
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": "int8",
          "int8x2": "int8x2"}
C, BLOCK = 3, 2 * 10 * 128 * 6   # 3 stations, 768 IF samples per block


def _coeff():
    cfg = MODES[0]
    return firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)


@pytest.fixture(scope="module")
def blocks():
    """Two consecutive (C, BLOCK) u8 blocks of noisy FM captures."""
    cfg = MODES[0]
    n = BLOCK + 100    # IQ pairs: two blocks after the capture's trim
    caps = [tx.synthesize_capture(
        cfg, seconds=n / cfg.rf_fs, noise_db=-20.0, seed=s,
        mono=tx.tone(cfg.rf_fs, 700.0 + 300.0 * s, n))[:2 * BLOCK]
        for s in range(C)]
    cap = np.stack(caps)
    return [cap[:, :BLOCK], cap[:, BLOCK:]]


def _pair(engine, out_dtype=None):
    coeff = _coeff()
    jfe = JaxFusedFrontend(coeff, 10, out_tile=128, sub_tiles=2,
                           compute_dtype=JAX_DT[engine],
                           out_dtype=jnp.bfloat16 if out_dtype else None)
    tfe = FusedFrontend(coeff, 10, compute_dtype=engine,
                        out_dtype=out_dtype or torch.float32)
    return jfe, tfe


def _exact_or_fma(got, want):
    """The integer engines give identical I/Q; the discriminator on top is
    exact in the port, but XLA may contract the reference's products into
    FMAs, which moves the last bits.  Hold it to max|diff| <= 1e-5 max|fm|
    where it is not bit-equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not np.array_equal(got, want):
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("engine", ENGINES)
def test_frontend_iq_matches_reference(engine, blocks):
    jfe, tfe = _pair(engine)
    jtail, ttail = jfe.init_state((C,)), tfe.init_state((C,))
    for blk in blocks:
        ji, jq, jtail = jfe(jnp.asarray(blk), jtail, interpret=True)
        ti, tq, ttail = frontend_reference(tfe, torch.from_numpy(blk), ttail)
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
        for got, want in ((ti, ji), (tq, jq)):
            if engine in ("int8", "int8x2"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                # float engines: same terms, another summation order (the
                # bf16 taps make every product exact, so bf16 too)
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=0, atol=1e-6)


@pytest.mark.parametrize("engine,out_bf16", [(e, False) for e in ENGINES]
                         + [("int8", True), ("bf16", True)])
def test_frontend_demod_matches_reference(engine, out_bf16, blocks):
    jfe, tfe = _pair(engine, torch.bfloat16 if out_bf16 else None)
    jtail, ttail = jfe.init_state((C,)), tfe.init_state((C,))
    jpi = jpq = jnp.zeros((C,), jnp.float32)
    tpi = tpq = torch.zeros(C)
    for blk in blocks:
        jfm, jtail, jpi, jpq, jpow = jfe.demod_call(
            jnp.asarray(blk), jtail, jpi, jpq, interpret=True)
        tfm, ttail, tpi, tpq, tpow = frontend_demod_reference(
            tfe, torch.from_numpy(blk), ttail, tpi, tpq)
        assert tfm.dtype == (torch.bfloat16 if out_bf16 else torch.float32)
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
        fm = tfm.float().numpy()
        jf = np.asarray(jfm.astype(jnp.float32))
        if engine in ("int8", "int8x2"):
            np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
            np.testing.assert_array_equal(tpq.numpy(), np.asarray(jpq))
            if out_bf16:
                # the f32 bound below, plus one bf16 ulp (2^-7 relative)
                # where an FMA-moved last bit flips the bf16 rounding
                assert np.all(np.abs(fm - jf) <= 2.0 ** -7 * np.abs(jf)
                              + 1e-5 * np.max(np.abs(jf)))
            else:
                _exact_or_fma(fm, jf)
        elif engine == "f32" or not out_bf16:
            np.testing.assert_allclose(tpi.numpy(), np.asarray(jpi), atol=1e-6)
            np.testing.assert_allclose(fm, jf, rtol=0,
                                       atol=1e-6 if engine == "f32" else 1e-5)
        else:
            # bf16 fm store of bf16 I/Q: the test_pallas.py bf16 bound
            err = fm - jf
            assert np.mean(err ** 2) < 0.05 * max(np.mean(jf ** 2), 1e-9)
        # the kernel sums the power in another order than the reference
        np.testing.assert_allclose(tpow.numpy(), np.asarray(jpow), rtol=1e-5)


@pytest.mark.parametrize("engine", ENGINES)
def test_quantized_taps_are_the_reference_band(engine):
    """Quantising the 51 taps gives the integers (and scale) that the
    reference finds by quantising its whole band matrix: its band, rebuilt
    from the port's taps, equals the reference's coefficient operand."""
    jfe, tfe = _pair(engine)
    ot = jfe.out_tile // jfe.sub_tiles
    assert tfe.tail_u8 == jfe.tail_u8
    assert tfe.fix_scale == jfe.fix_scale
    a = np.asarray(jfe._a)
    if engine == "int8x2":
        hi, lo = tfe._kernel_taps[:tfe.taps], tfe._kernel_taps[tfe.taps:]
        for limb, want in ((hi, a[0]), (lo, a[1])):
            band = _build_band_matrix(limb.astype(np.float64), 10, ot,
                                      tfe.tail_u8)
            np.testing.assert_array_equal(band, want.astype(np.float32))
        np.testing.assert_array_equal(
            tfe.int_taps, hi.astype(np.int64) * 128 + lo)
    elif engine == "int8":
        band = _build_band_matrix(tfe.int_taps.astype(np.float64), 10, ot,
                                  tfe.tail_u8)
        np.testing.assert_array_equal(band, a.astype(np.float32))
    else:
        band = _build_band_matrix(tfe.float_taps.double().numpy(), 10, ot,
                                  tfe.tail_u8)
        want = jnp.asarray(a).astype(JAX_DT[engine]).astype(jnp.float32)
        np.testing.assert_array_equal(band, np.asarray(want))


def test_frontend_cpu_dispatch_and_state():
    """A CPU tensor goes to the plain version; the state is the reference's
    u8 tail of 128 filled with 128."""
    tfe = FusedFrontend(_coeff(), 10, compute_dtype="int8")
    tail = tfe.init_state((2,))
    assert tail.dtype == torch.uint8 and tuple(tail.shape) == (2, 128)
    assert bool((tail == 128).all())
    u8 = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 2560), dtype=np.uint8))
    got = tfe(u8, tail)
    want = frontend_reference(tfe, u8, tail)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        FusedFrontend(_coeff(), 10, compute_dtype="fp8")
