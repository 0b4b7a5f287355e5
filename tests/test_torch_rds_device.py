"""The port's RDS device helpers (rds/timing.py,
matrix.syndromes_sliding_device) and the offline decode_rds_soft against
sdr_tpu's on the same numpy-seeded inputs, on the CPU.  recover_symbols' phases and symbols, the syndromes
and the decoded station info must be equal; manchester_pairing_score is
held at rtol 1e-6 (a float32 sum in another order)."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.rds import decode_rds_soft as jax_decode_rds_soft
from sdr_tpu.rds import matrix as jmatrix
from sdr_tpu.rds import timing as jtiming
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.rds import decode_rds_soft, matrix, recover_symbols
from sdr_tpu_torch.rds import tx as rds_tx
from sdr_tpu_torch.rds.timing import manchester_pairing_score


def soft_wave(shape, sps, seed):
    """Seeded biphase-like soft symbols at sps samples a symbol, each row
    with its own sampling phase, plus noise, float32."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n)
    phase = rng.integers(0, sps, size=shape[:-1] + (1,))
    sym = rng.choice([-1.0, 1.0], size=shape[:-1] + (n // sps + 2,))
    pulse = np.cos(np.pi * ((t - phase) % sps) / sps - np.pi / 2)
    wave = np.take_along_axis(sym, (t + sps - phase) // sps, axis=-1)
    return (wave * np.abs(pulse)
            + 0.2 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape,sps", [((16 * 64,), 16), ((16 * 40 + 7,), 16),
                                        ((3, 16 * 31 + 5), 16),
                                        ((2, 3, 8 * 50), 8)])
def test_recover_symbols_equal(shape, sps):
    soft = soft_wave(shape, sps, seed=len(shape) + sps)
    js, jp = jtiming.recover_symbols(jnp.asarray(soft), sps)
    ts, tp = recover_symbols(torch.from_numpy(soft), sps)
    assert tp.dtype == torch.int32 and tuple(tp.shape) == shape[:-1]
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_recover_symbols_tie_takes_first_phase():
    soft = np.ones((2, 16 * 10), np.float32)
    soft[1, 3::16] = 2.0
    soft[1, 9::16] = 2.0          # phases 3 and 9 tie: the first wins
    _, tp = recover_symbols(torch.from_numpy(soft), 16)
    _, jp = jtiming.recover_symbols(jnp.asarray(soft), 16)
    np.testing.assert_array_equal(tp.numpy(), [0, 3])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("shape", [(101,), (100,), (4, 57), (2, 3, 64)])
def test_manchester_pairing_score_close(shape):
    sym = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    je, jo = jtiming.manchester_pairing_score(jnp.asarray(sym))
    te, to = manchester_pairing_score(torch.from_numpy(sym))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6)


@pytest.mark.parametrize("shape", [(0,), (10,), (25,), (26,), (27,), (300,),
                                   (3, 200), (2, 2, 90), (3, 20)])
def test_syndromes_sliding_device_equal(shape):
    bits = np.random.default_rng(sum(shape)).integers(
        0, 2, size=shape).astype(np.uint8)
    got = matrix.syndromes_sliding_device(torch.from_numpy(bits))
    want = np.asarray(jmatrix.syndromes_sliding_device(bits))
    assert got.dtype == torch.int32
    assert tuple(got.shape) == shape[:-1] + (max(shape[-1] - 25, 0),)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = int(np.prod(shape[:-1]))
    for row, w in zip(bits.reshape(rows, shape[-1]),
                      got.numpy().reshape(rows, got.shape[-1])):
        np.testing.assert_array_equal(w, matrix.syndromes_sliding(row))


def rds_capture(seconds=1.2):
    cfg = MODES[0]
    n = int(seconds * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x5A5A, ps_name="SHARDED!",
                                        radio_text="PORT RT", n_groups=18)
    return cfg, tx.synthesize_capture(
        cfg, seconds=seconds, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
        a_rds=0.1)


def synthetic_soft():
    """A soft stream at 16 x 2375 straight from the RDS modulator, noisy
    and inverted, as float64 (which both decoders take at float32)."""
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="TPU FM  ",
                                        radio_text="HELLO", n_groups=12)
    bb = rds_tx.bits_to_baseband(bits, 38_000.0)
    rng = np.random.default_rng(11)
    return -(bb + rng.normal(0, 0.3 * np.std(bb), bb.shape))


@pytest.mark.parametrize("source", ["receiver", "synthetic_f64"])
def test_decode_rds_soft_equal(source):
    """The same soft stream decodes to the same PI, PS, RT and group count
    in both packages: the port's receiver's rds_soft (the feedforward
    stereo + RDS chain on the CPU), and a float64 modulator stream."""
    cfg = MODES[0]
    if source == "receiver":
        _, cap = rds_capture()
        rx = Receiver(0, stereo=True, rds=True, pll_impl="ff", device="cpu")
        out, _ = rx.run(cap, blocks_per_step=5)
        soft = out["rds_soft"].numpy()
    else:
        soft = synthetic_soft()
    got = decode_rds_soft(soft, cfg.rds_sps, device="cpu")
    want = jax_decode_rds_soft(soft, cfg.rds_sps)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pi in (0x5A5A, 0x3D44) and got.groups_seen >= 6
    assert got.ps_name in ("SHARDED!", "TPU FM  ")
    # a tensor decodes as its array does
    again = decode_rds_soft(torch.from_numpy(np.asarray(soft)), cfg.rds_sps,
                            device="cpu")
    assert dataclasses.asdict(again) == dataclasses.asdict(got)


def test_decode_rds_soft_defaults_to_cuda():
    assert inspect.signature(decode_rds_soft).parameters[
        "device"].default == "cuda"
