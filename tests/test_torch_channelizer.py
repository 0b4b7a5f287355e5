"""The port's wideband channelizer (ops/channelizer.py, ops/cuda/
channelizer_kernel.py) against sdr_tpu's on the same numpy-seeded blocks:
the host-built bank and phasor tables bit for bit, and every engine
(mfb, mix, and pallas -- the reference's Pallas kernel in interpret mode,
the port's plain version of its CUDA kernel) over three blocks with
state carry, in f32 and u8 ingest, f32 and bf16 compute and output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import channelizer as jchan
from sdr_tpu.ops.pallas import channelizer_kernel as jkernel
from sdr_tpu_torch.ops import channelizer as tchan
from sdr_tpu_torch.ops.cuda import channelizer_kernel as tkernel

FS_WIDE, FS_OUT = 9.6e6, 2.4e6


def freqs(k):
    return list(np.linspace(-3.0e6, 3.0e6, k))


@pytest.mark.parametrize("k", [5, 8])
def test_bank_and_tables_bit_equal(k):
    """_modulated_bank, _phase_tables, PallasMFB._bm and _tables: the
    port builds them from its firdes copy, equal to the reference's bit
    for bit (K = 5 pads the station rows to 8, K = 8 does not)."""
    j = jchan.WidebandChannelizer(FS_WIDE, FS_OUT, freqs(k))
    t = tchan.WidebandChannelizer(FS_WIDE, FS_OUT, freqs(k), device="cpu")
    np.testing.assert_array_equal(t._dphi, j._dphi)
    coeff = np.asarray(jchan.lowpass(FS_WIDE, 100e3, 101, 1), np.float64)
    np.testing.assert_array_equal(tchan._modulated_bank(coeff, t._dphi),
                                  jchan._modulated_bank(coeff, j._dphi))
    np.testing.assert_array_equal(t._bmat, np.asarray(j._bmat))
    for args in ((1280, 4), (5120, 4, 1024), (19200, 1), (1000, 1, 384)):
        jt, tt = j._phase_tables(*args), t._phase_tables(*args)
        for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(tt)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    jp = jchan.WidebandChannelizer(FS_WIDE, FS_OUT, freqs(k),
                                   engine="pallas")._pl
    tp = tchan.WidebandChannelizer(FS_WIDE, FS_OUT, freqs(k),
                                   engine="pallas", device="cpu")._pl
    assert (tp.kp, tp.t_cols, tp._n_shift) == (jp.kp, jp.t_cols,
                                               jp._n_shift)
    np.testing.assert_array_equal(tp._bm, np.asarray(jp._bm))
    for n_out, tile in ((5120, 2560), (2560, 2560), (102400, 4096)):
        for a, b in zip(jax.tree.leaves(jp._tables(n_out, tile)),
                        jax.tree.leaves(tp._tables(n_out, tile))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_synthesize_wideband_copy_equal():
    rng = np.random.default_rng(1)
    st = [rng.standard_normal(600) + 1j * rng.standard_normal(600)
          for _ in range(2)]
    for a, b in zip(jchan.synthesize_wideband(st, [-1e6, 2e6], 2.4e6, 9.6e6),
                    tchan.synthesize_wideband(st, [-1e6, 2e6], 2.4e6, 9.6e6)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def assert_close(got, want, bf16):
    """|got - want| <= 2e-5 * max|want| (the reference's own pallas-vs-mfb
    gate: another summation order, and XLA contracts the rotation into
    FMAs), plus one bf16 ulp (2^-7 of the value) for a bf16 output."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = 2e-5 * max(np.abs(want).max(), 1e-9)
    if bf16:
        bound = bound + 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


CASES = ([("mfb", i, c, "f32") for i in ("f32", "u8") for c in ("f32", "bf16")]
         + [("mix", "f32", "f32", "f32")]
         + [("pallas", i, c, o) for i in ("f32", "u8")
            for c in ("f32", "bf16") for o in ("f32", "bf16")])


@pytest.mark.parametrize("engine,ingest,compute,out", CASES)
def test_engine_matches_reference(engine, ingest, compute, out):
    """Three consecutive blocks with state carry, each engine against the
    same reference engine (K = 5, 20,480 wideband pairs a block): outputs
    within `assert_close`, phases equal, and the carried tails bit-equal
    (mfb: decoded f32 samples; pallas: raw columns in the ingest dtype).
    The mix engine's tails are its mixed streams, which XLA computes with
    fused multiply-adds: within 2e-5 of their max."""
    kw = dict(engine=engine, compute_dtype=compute)
    if engine == "pallas":
        kw.update(ingest=ingest, out_dtype=out)
    j = jchan.WidebandChannelizer(FS_WIDE, FS_OUT, freqs(5), **kw)
    t = tchan.WidebandChannelizer(FS_WIDE, FS_OUT, freqs(5), device="cpu",
                                  **kw)
    rng = np.random.default_rng(11)
    n = 4 * 2560 * 2
    sj, st = j.init_state(), t.init_state()
    assert set(st) == set(sj)
    for key in sj:
        assert str(st[key].dtype).removeprefix("torch.") == str(
            sj[key].dtype)
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))
    for _ in range(3):
        if ingest == "u8":
            body = rng.integers(0, 256, size=2 * n, dtype=np.uint8)
        else:
            body = rng.standard_normal(2 * n).astype(np.float32)
        if engine == "mix":
            i_w, q_w = body[0::2].copy(), body[1::2].copy()
            (ij, qj), sj = j(jnp.asarray(i_w), jnp.asarray(q_w), sj)
            (it, qt), st = t(torch.from_numpy(i_w), torch.from_numpy(q_w),
                             st)
        else:
            (ij, qj), sj = j.call_interleaved(jnp.asarray(body), sj)
            (it, qt), st = t.call_interleaved(torch.from_numpy(body), st)
        want_dtype = torch.bfloat16 if out == "bf16" else torch.float32
        assert it.dtype == qt.dtype == want_dtype
        assert_close(it.float(), np.asarray(ij, np.float32), out == "bf16")
        assert_close(qt.float(), np.asarray(qj, np.float32), out == "bf16")
        np.testing.assert_array_equal(st["phase"].numpy(),
                                      np.asarray(sj["phase"]))
        for key in set(sj) - {"phase"}:
            tv, jv = st[key].numpy(), np.asarray(sj[key])
            assert tv.dtype == jv.dtype and tv.shape == jv.shape
            if engine == "mix":
                assert np.abs(tv - jv).max() <= 2e-5 * np.abs(jv).max()
            else:
                np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("ingest", ["f32", "u8"])
def test_call_cols_equals_flat(ingest):
    """The pre-phased (2D, N/D) layout and the flat stream give the same
    bits, state included (the kernel reads either through strides)."""
    t = tchan.WidebandChannelizer(FS_WIDE, FS_OUT, freqs(3),
                                  engine="pallas", ingest=ingest,
                                  device="cpu")
    rng = np.random.default_rng(5)
    sf, sc = t.init_state(), t.init_state()
    for _ in range(2):
        body = (rng.integers(0, 256, size=2 * 4 * 1024, dtype=np.uint8)
                if ingest == "u8"
                else rng.standard_normal(2 * 4 * 1024).astype(np.float32))
        flat = torch.from_numpy(body)
        (i_f, q_f), sf = t.call_interleaved(flat, sf)
        xbt = flat.reshape(-1, 2 * t.decim).T.contiguous()
        (i_c, q_c), sc = t._pl.call_cols(xbt, sc)
        assert torch.equal(i_c, i_f) and torch.equal(q_c, q_f)
        for key in sf:
            assert torch.equal(sf[key], sc[key])
        assert sf["tail"].is_contiguous()


def test_refuses_what_the_reference_refuses():
    """A non-integral rate ratio, fewer than 128 output columns and a
    block with no 128-multiple tile raise (the reference asserts)."""
    with pytest.raises(AssertionError):
        jchan.WidebandChannelizer(10e6, 2.4e6, [0.0])
    with pytest.raises(ValueError):
        tchan.WidebandChannelizer(10e6, 2.4e6, [0.0], device="cpu")
    j = jchan.WidebandChannelizer(FS_WIDE, FS_OUT, [0.0], engine="pallas")
    t = tchan.WidebandChannelizer(FS_WIDE, FS_OUT, [0.0], engine="pallas",
                                  device="cpu")
    for n_out in (64, 200):   # too short; 200 has no 128-multiple divisor
        body = np.zeros(8 * n_out, np.float32)
        with pytest.raises(AssertionError):
            j.call_interleaved(jnp.asarray(body), j.init_state())
        with pytest.raises(ValueError):
            t.call_interleaved(torch.from_numpy(body), t.init_state())
    # the largest 128-multiple divisor, as the reference picks it
    for n, cap in ((5120, 4096), (102400, 4096), (384, 4096), (200, 4096)):
        assert tkernel._largest_tile_at_most(n, cap) == \
            jkernel._largest_divisor_at_most(n, cap)
