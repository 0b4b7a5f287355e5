"""The port's streaming RDS CDR (sdr_tpu_torch/rds/streaming.py
`_recover_symbols`) emits a push's symbols as one array computation, and
its phase score is a column sum of the push's periods; the reference
(sdr_tpu/rds/streaming.py) walks the symbols one at a time and scores the
phases with a bincount.  Both must agree bit for bit: the same symbols and
the same carried state, push by push, over drifting clocks, every push
length from one sample to a batch step, centres before the buffer, and a
timing offset on .5 exactly (half to even).  The fleet decoder over a
(128, 30,400) batch equals one reference decoder a row."""

import dataclasses

import numpy as np
import pytest

from sdr_tpu.rds import streaming as jstreaming
from sdr_tpu_torch.io import logger
from sdr_tpu_torch.rds import streaming as tstreaming
from sdr_tpu_torch.rds import tx as rds_tx

SPS = 16


def _stretch(x: np.ndarray, ppm: float, start: float = 0.0) -> np.ndarray:
    """x seen by a receiver whose sample clock is off by ppm, from sample
    `start` on (linear interpolation of a smooth waveform)."""
    r = 1.0 + ppm * 1e-6
    pos = start + np.arange(int((len(x) - 1 - start) / r)) * r
    return np.interp(pos, np.arange(len(x)), x)


def _soft(n_groups: int, ppm: float, *, pi: int = 0x3D44, seed: int = 0,
          noise: float = 0.2, start: float = 0.0) -> np.ndarray:
    """Noisy RDS soft at 16 samples a symbol, its clock off by ppm."""
    bits = rds_tx.standard_group_stream(pi=pi, ps_name="TPU FM  ",
                                        n_groups=n_groups)
    bb = _stretch(rds_tx.bits_to_baseband(bits, 38_000.0), ppm, start)
    rng = np.random.default_rng(seed)
    return (bb + rng.normal(0, noise * np.std(bb), bb.shape)).astype(
        np.float32)


def _half_tau_soft(n: int) -> np.ndarray:
    """Symbols of random sign whose |amplitude| peaks equally at phases 4
    and 5, of opposite signs there: the parabolic measurement reads 4.5
    exactly, so every centre m*16 + 4.5 sits on .5 and rounds to the even
    16m + 4 (rounding half up would take the other sign)."""
    env = np.full(SPS, 0.25)
    env[4:6] = 1.0, -1.0
    sign = np.random.default_rng(5).choice([-1.0, 1.0], n // SPS + 1)
    return (np.repeat(sign, SPS) * np.tile(env, n // SPS + 1))[:n].astype(
        np.float32)


def _asdicts(groups):
    return [dataclasses.asdict(g) for g in groups]


def _state(dec):
    return (dec._tau, dec._next_m, dec._n0, dec._blocks_seen)


CASES = ([(block, ppm, "stream")
          for block in (1, 15, 16, 17, 777, 1216, 30400)
          for ppm in (-100.0, 0.0, 100.0)]
         + [(1216, 0.0, "centres_before_buffer"),
            (30400, 100.0, "centres_before_buffer"),
            (1216, 0.0, "tau_on_half"), (30400, 0.0, "tau_on_half"),
            (17, 0.0, "n0_off_phase"), (1216, -100.0, "n0_off_phase")])


@pytest.mark.parametrize("block,ppm,case", CASES)
def test_recover_symbols_bit_equal_to_the_loop(block, ppm, case):
    """Push by push: the symbols exactly, tau, the next symbol index, the
    carry and its absolute start, and the phase scores."""
    if case == "tau_on_half":
        soft = _half_tau_soft(40_000)
    else:
        # short pushes take a shorter stream (the reference's loop is slow)
        soft = _soft(12 if block < 777 else 40, ppm)
        if block < 777:
            soft = soft[:300 * block + 40]
    t, j = tstreaming.StreamingRdsDecoder(SPS), jstreaming.StreamingRdsDecoder(
        SPS)
    if case == "n0_off_phase":
        # the stream's first sample is absolute sample 5: every phase
        # score's columns are rolled
        t._n0 = j._n0 = 5
    emitted = 0
    for k, i in enumerate(range(0, len(soft), block)):
        x = soft[i:i + block]
        if case == "centres_before_buffer" and k == 1:
            # three symbol indices back: their centres lie before the carry
            t._next_m -= 3
            j._next_m -= 3
        n0 = t._n0
        got, want = t._recover_symbols(x), j._recover_symbols(x)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want, err_msg=f"push {k}")
        assert _state(t) == _state(j), k
        np.testing.assert_array_equal(t._soft_carry, j._soft_carry)
        np.testing.assert_array_equal(t._phase_scores, j._phase_scores)
        if case == "centres_before_buffer" and k == 1:
            assert want[0] == 0.0
        if case == "tau_on_half" and t._tau is not None:
            assert t._tau == 4.5
        if case == "n0_off_phase" and k == 0 and len(got):
            assert n0 % SPS != 0
        emitted += len(got)
    # the stream's symbols came out (1/16 of the samples, less the carry)
    assert emitted >= 0.99 * len(soft) / SPS - 3


def test_fleet_decoder_equals_one_reference_decoder_a_row():
    """A (128, 30,400) batch a push, three pushes; station s plays one of
    four broadcasts from its own seeded start, its clock off by its own
    seeded ppm in [-100, 100].  Each station's groups, StationInfo and
    counters equal a reference decoder fed that row; the program's counters
    (tracing on) total the stations'."""
    k, n, pushes = 128, 30_400, 3
    rng = np.random.default_rng(18)
    base = [rds_tx.bits_to_baseband(
        rds_tx.standard_group_stream(pi=0x3000 + b, ps_name=f"FLEET {b} ",
                                     n_groups=60), 38_000.0)
        for b in range(4)]
    soft = np.empty((k, pushes * n), np.float32)
    for s in range(k):
        x = _stretch(base[s % 4], rng.uniform(-100, 100),
                     rng.uniform(0, 8_000))[:pushes * n]
        soft[s] = x + rng.normal(0, 0.3 * np.std(x), x.shape)

    fleet = tstreaming.MultiStreamingRds(SPS, k)
    ref = [jstreaming.StreamingRdsDecoder(SPS) for _ in range(k)]
    logger.reset_stage_times()
    logger.set_tracing(True)
    try:
        synced = [fleet.push(soft[:, p * n:(p + 1) * n])
                  for p in range(pushes)]
    finally:
        logger.set_tracing(False)
    spans, counters = logger.totals()
    logger.reset_stage_times()
    for p in range(pushes):
        for s, dec in enumerate(ref):
            new = dec.push(soft[s, p * n:(p + 1) * n])
            assert _asdicts(dict(synced[p]).get(s, [])) == _asdicts(new), (
                p, s)

    for s, (got, want) in enumerate(zip(fleet.decoders, ref)):
        assert _asdicts(got.groups) == _asdicts(want.groups), s
        assert dataclasses.asdict(fleet.info(s)) == dataclasses.asdict(
            want.info), s
        for name in ("bits_corrected", "parity_switches", "polarity_repins",
                     "parity", "polarity"):
            assert getattr(got, name) == getattr(want, name), (s, name)
        assert got.info.pi == 0x3000 + s % 4, s
    assert spans["rds.push"][1] == k * pushes
    assert counters["rds.symbols_recovered"] == sum(
        d._sym_abs + len(d._sym_buf) for d in ref)
    assert counters["rds.groups"] == sum(len(d.groups) for d in ref)
    assert counters["rds.bits_corrected"] == sum(
        d.bits_corrected for d in ref) > 0
