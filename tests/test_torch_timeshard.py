"""The port's time sharding (parallel/timeshard.py) on the CPU, the
counterparts of tests/test_parallel.py's: mono in modes 0 and 2 and at a
length the mesh does not divide, against the port's serial run at the
reference's 2e-5 and against sdr_tpu's timesharded_mono on conftest's 8
virtual devices within 1e-5 of max|ref|; the stereo and the full stereo +
RDS chains by the reference's behavioural gates (stream SNR, separation,
the decoded RDS) and against the reference's sharded runs (stereo's scan
loop at 45 dB, the port's gate for the loops; the feedforward full chain
within 1e-5 of max, the same decoded RDS), at the reference's own
lengths, 1.6 s and 1.2 s (its copies are marked slow; these take ~25 s
together); and polarity_stitch's two cases."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sdr_tpu.parallel.timeshard import timesharded_full as jax_full
from sdr_tpu.parallel.timeshard import timesharded_mono as jax_mono
from sdr_tpu.parallel.timeshard import timesharded_stereo as jax_stereo
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.parallel.mesh import make_mesh
from sdr_tpu_torch.parallel.timeshard import (polarity_stitch,
                                              stereo_warmup_if,
                                              timesharded_full,
                                              timesharded_mono,
                                              timesharded_stereo)
from sdr_tpu_torch.rds import decode_rds_soft
from sdr_tpu_torch.rds import tx as rds_tx
from sdr_tpu_torch.utils.compare import stereo_separation_db, stream_snr_db

CPU = torch.device("cpu")
MIXED = [CPU, torch.device("cpu", 0)]


def near_ref(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (
        np.abs(got - want).max())


@pytest.mark.parametrize("mode,devices", [(0, "virtual"), (2, "virtual"),
                                          (0, "mixed")])
def test_timeshard_mono_exact(mode, devices):
    """Halo time sharding == the serial run, the rational-resampler mode
    included; the mixed mesh moves its halos between devices."""
    cfg = MODES[mode]
    rx = Receiver(mode, device="cpu")
    mesh = make_mesh(8, "time", devices=[CPU] * 8 if devices == "virtual"
                     else MIXED * 4)
    align = 8 * 2 * cfg.rf_decim * cfg.audio_decim
    n = ((int(0.2 * cfg.rf_fs) * 2) // align) * align
    mono = tx.tone(cfg.rf_fs, 900.0, n // 2)
    cap = tx.synthesize_capture(cfg, seconds=n / 2 / cfg.rf_fs, mono=mono)
    cap = cap[:n]
    audio_p = timesharded_mono(rx, cap, mesh)
    serial, _ = rx.run(cap)
    np.testing.assert_allclose(audio_p.numpy(), serial["mono"].numpy(),
                               atol=2e-5)
    near_ref(audio_p, jax_mono(JaxReceiver(mode), cap,
                               jax_make_mesh(8, "time")))


def test_timeshard_mono_nondivisible():
    """A length the mesh does not divide, with a ragged sub-align tail:
    trimmed and padded internally, equal to the serial run; the fused
    int8 front end (its 1024-sample tile sets the halo's grid)."""
    cfg = MODES[0]
    kw = dict(fused_frontend="int8", fe_out_tile=1024)
    rx = Receiver(0, device="cpu", **kw)
    mesh = make_mesh(8, "time", devices=[CPU] * 8)
    align = 2 * cfg.rf_decim * cfg.audio_decim
    n0 = int(0.2 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.2,
                                mono=tx.tone(cfg.rf_fs, 700.0, n0), seed=4)
    n = len(cap) - 3 * align - 17
    cap = cap[:n]
    audio_p = timesharded_mono(rx, cap, mesh).numpy()
    fe_align = 2 * cfg.rf_decim * int(np.lcm(cfg.audio_decim, 1024))
    n_valid = (n // fe_align) * fe_align
    assert audio_p.shape == (n_valid // align * cfg.audio_interp,)
    serial, _ = rx.run(cap[:n_valid])
    m = serial["mono"].shape[-1]
    np.testing.assert_allclose(audio_p[:m], serial["mono"].numpy(),
                               atol=2e-5)
    near_ref(audio_p, jax_mono(JaxReceiver(0, **kw), cap,
                               jax_make_mesh(8, "time")))


def test_timeshard_checks():
    rx = Receiver(0, device="cpu")
    with pytest.raises(ValueError, match="shorter than the minimum"):
        timesharded_mono(rx, np.full(50, 128, np.uint8),
                         make_mesh(2, devices=[CPU] * 2), axis="channels")
    with pytest.raises(ValueError, match="shorter than the halo"):
        timesharded_mono(rx, np.full(8 * 1000, 128, np.uint8),
                         make_mesh(8, devices=[CPU] * 8), axis="channels")
    with pytest.raises(ValueError, match="timesharded_full"):
        timesharded_stereo(Receiver(0, stereo=True, rds=True, device="cpu"),
                           np.full(10 ** 6, 128, np.uint8),
                           make_mesh(2, devices=[CPU] * 2), axis="channels")


def test_timeshard_stereo():
    """The warm-up halo time sharding of the stereo chain (the scan loop):
    stream SNR above 30 dB after the serial lock-in and separation within
    2 dB of the serial run's, on the reference's 1.6 s capture: 8 shards
    of 0.2 s, each longer than the warm-up halo."""
    cfg = MODES[0]
    rx = Receiver(0, stereo=True, device="cpu")
    mesh = make_mesh(8, "time", devices=[CPU] * 8)
    warm_if = stereo_warmup_if(rx)
    align = 8 * 2 * cfg.rf_decim * cfg.audio_decim
    n = ((int(1.6 * cfg.rf_fs) * 2) // align) * align
    left = tx.tone(cfg.rf_fs, 1000.0, n // 2)
    right = tx.tone(cfg.rf_fs, 2500.0, n // 2)
    cap = tx.synthesize_capture(cfg, seconds=n / 2 / cfg.rf_fs,
                                left=left, right=right)[:n]
    assert (n // 8) >= 2 * cfg.rf_decim * warm_if

    l_p, r_p = timesharded_stereo(rx, cap, mesh)
    serial, _ = rx.run(cap)
    l_s, r_s = serial["left"].numpy(), serial["right"].numpy()
    assert l_p.shape == l_s.shape and r_p.shape == r_s.shape
    skip = int(0.2 * cfg.audio_fs)
    snr_l = stream_snr_db(l_p.numpy(), l_s, skip=skip)
    snr_r = stream_snr_db(r_p.numpy(), r_s, skip=skip)
    assert snr_l > 30 and snr_r > 30, (snr_l, snr_r)
    fs = float(cfg.audio_fs)
    sep_p = stereo_separation_db(l_p.numpy(), r_p.numpy(), fs, 1000.0,
                                 skip=skip)
    sep_s = stereo_separation_db(l_s, r_s, fs, 1000.0, skip=skip)
    assert sep_s > 20
    assert sep_p > sep_s - 2.0, (sep_p, sep_s)
    # shard 0 starts cold at its chunk, as the serial run starts
    chunk = len(l_s) // 8
    np.testing.assert_allclose(l_p[:chunk].numpy(), l_s[:chunk], atol=1e-6)
    # the reference's shard 0 runs its loop over the zero halo and loses
    # the stereo (ROADMAP queue C); from shard 1 on, its run is the port's
    # within 45 dB, the port's gate for the loops (an ulp of detector
    # input moves the acquisition transient)
    jl, jr = (np.asarray(x, np.float64) for x in jax_stereo(
        JaxReceiver(0, stereo=True), cap, jax_make_mesh(8, "time")))
    assert stereo_separation_db(jl[chunk // 4:chunk],
                                jr[chunk // 4:chunk], fs, 1000.0) < 5.0
    for got, want in ((l_p, jl), (r_p, jr)):
        err = got[chunk:].double().numpy() - want[chunk:]
        assert 10 * np.log10(np.mean(want[chunk:] ** 2)
                             / np.mean(err ** 2)) > 45.0


def test_timeshard_full_stereo_rds():
    """The whole chain (stereo + RDS, feedforward carriers) time-split:
    the decoded RDS matches the serial run's and the reference's sharded
    run's, separation holds, shard 0 equals the serial run's start, and
    the rest of the audio is within 1e-5 of max of the reference's
    sharded audio."""
    cfg = MODES[0]
    sec = 1.2
    n = int(sec * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x5A5A, ps_name="SHARDED!",
                                        n_groups=18)
    cap = tx.synthesize_capture(
        cfg, seconds=sec, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)
    rx = Receiver(0, stereo=True, rds=True, pll_impl="ff", device="cpu")
    mesh = make_mesh(8, "time", devices=[CPU] * 8)
    l_p, r_p, soft_p = timesharded_full(rx, cap, mesh)
    assert isinstance(soft_p, np.ndarray)

    serial, _ = rx.run(cap)
    skip = cfg.audio_fs // 4
    sep = stereo_separation_db(l_p.numpy(), r_p.numpy(), cfg.audio_fs,
                               1000.0, skip=skip)
    assert sep > 15.0, f"sharded separation {sep:.1f} dB"

    info_p = decode_rds_soft(soft_p, cfg.rds_sps, device="cpu")
    info_s = decode_rds_soft(serial["rds_soft"], cfg.rds_sps, device="cpu")
    assert info_s.pi == 0x5A5A and info_s.groups_seen >= 6
    assert info_p.pi == info_s.pi
    assert info_p.ps_name == info_s.ps_name
    assert info_p.groups_seen >= info_s.groups_seen - 1

    # shard 0 equals the serial run's start; from shard 1 on, the audio
    # is the reference's sharded audio within 1e-5 of max
    chunk = len(l_p) // 8
    np.testing.assert_allclose(l_p[:chunk].numpy(),
                               serial["left"][:chunk].numpy(), atol=1e-6)
    jl, jr, jsoft = jax_full(JaxReceiver(0, stereo=True, rds=True,
                                         pll_impl="ff"), cap,
                             jax_make_mesh(8, "time"))
    near_ref(l_p[chunk:], np.asarray(jl)[chunk:])
    near_ref(r_p[chunk:], np.asarray(jr)[chunk:])
    from sdr_tpu.rds import decode_rds_soft as jax_decode
    assert dataclasses.asdict(info_p) == dataclasses.asdict(
        jax_decode(np.asarray(jsoft), cfg.rds_sps))


def test_polarity_stitch_silent_seam_warns():
    """A seam whose warm-up overlap carries no RDS energy warns and keeps
    the running sign; the confident seam after it still flips."""
    rng = np.random.default_rng(7)
    warm, chunk = 64, 256
    t = np.arange(warm + chunk)
    wave = np.sin(2 * np.pi * t / 16.0)
    d0 = wave.copy()
    d1 = wave.copy()
    d1[warm - warm // 2:warm] = 1e-9 * rng.standard_normal(warm // 2)
    d2 = -wave.copy()
    soft_all = np.stack([d0, d1, d2])

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = polarity_stitch(soft_all, warm, confidence=0.5)
    msgs = [str(w.message) for w in caught]
    assert any("seam 0->1" in m and "below confidence 0.5" in m
               and "keeping running sign" in m for m in msgs), msgs
    assert out.shape == (3 * chunk,)
    np.testing.assert_allclose(out[chunk:2 * chunk], d1[warm:], atol=1e-12)
    np.testing.assert_allclose(out[2 * chunk:], wave[warm:], atol=1e-12)


def test_polarity_stitch_confident_flip_no_warning():
    warm, chunk = 64, 256
    t = np.arange(warm + chunk)
    wave = np.sin(2 * np.pi * t / 16.0)
    soft_all = np.stack([wave, -wave, wave])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = polarity_stitch(soft_all, warm, confidence=0.5)
    assert not caught, [str(w.message) for w in caught]
    np.testing.assert_allclose(out, np.concatenate([wave[warm:]] * 3),
                               atol=1e-12)
