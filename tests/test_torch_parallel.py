"""The port's channel DP (parallel/channels.py) and station-sharded wideband
run (parallel/wideband.py) on the CPU, the counterparts of
tests/test_parallel.py's: against the port's serial run at the
reference's tolerances (1e-6 mono, 1e-5 stereo, 2e-5 wideband), and
against sdr_tpu's sharded run on conftest's 8 virtual devices (its Pallas
channelizer in interpret mode) within 1e-5 of max|ref|, the port's
standing float gate.  The port's meshes are virtual (one device
repeated) or mix "cpu" and "cpu:0", which torch keeps apart, so the path
of several devices runs too.  Neither path may make a torch.distributed
call: a test makes each collective raise."""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.ops.channelizer import WidebandChannelizer as JaxChannelizer
from sdr_tpu.parallel.channels import sharded_run as jax_sharded_run
from sdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sdr_tpu.parallel.wideband import \
    sharded_wideband_run as jax_sharded_wideband_run
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.models.wideband import WidebandReceiver
from sdr_tpu_torch.ops.channelizer import (WidebandChannelizer,
                                           synthesize_wideband)
from sdr_tpu_torch.parallel.channels import sharded_run
from sdr_tpu_torch.parallel.mesh import make_mesh
from sdr_tpu_torch.parallel.wideband import sharded_wideband_run
from sdr_tpu_torch.utils import convert

CPU = torch.device("cpu")
# torch keeps "cpu" and "cpu:0" apart: a mesh of both runs the path of
# several devices (one Receiver each, outputs gathered) on the CPU
MIXED = [CPU, torch.device("cpu", 0)]


@pytest.fixture(scope="module")
def captures():
    cfg = MODES[0]
    caps = []
    for c in range(8):
        n = int(0.05 * cfg.rf_fs)
        mono = tx.tone(cfg.rf_fs, 500.0 + 300.0 * c, n)
        caps.append(tx.synthesize_capture(cfg, seconds=0.05, mono=mono,
                                          seed=c))
    return np.stack(caps)


def near_ref(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (
        np.abs(got - want).max())


def assert_state_equal(a, b):
    """Two port states equal leaf for leaf, through utils/convert.py."""
    la = jax.tree.leaves(convert.state_to_numpy(a))
    lb = jax.tree.leaves(convert.state_to_numpy(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_make_mesh_wants_cuda():
    """make_mesh() is every CUDA device; where there is none it raises
    instead of building a CPU mesh."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh().devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_virtual_mesh():
    mesh = make_mesh(8, "time", devices=[CPU] * 10)
    assert mesh.shape == {"time": 8} and mesh.groups() == {CPU: list(range(8))}
    mixed = make_mesh(devices=MIXED * 2)
    assert mixed.groups() == {MIXED[0]: [0, 2], MIXED[1]: [1, 3]}


@pytest.mark.parametrize("devices", ["virtual", "mixed"])
def test_channel_dp_matches_serial(captures, devices):
    rx = Receiver(0, device="cpu")
    mesh = make_mesh(8, "channels", devices=[CPU] * 8 if devices == "virtual"
                     else MIXED * 4)
    outs, final = sharded_run(rx, captures, mesh)
    serial, s_final = rx.run(captures)
    np.testing.assert_allclose(outs["mono"].numpy(), serial["mono"].numpy(),
                               atol=1e-6)
    assert_state_equal(final, s_final)
    jouts, _ = jax_sharded_run(JaxReceiver(0), captures,
                               jax_make_mesh(8, "channels"))
    near_ref(outs["mono"], jouts["mono"])


def test_channel_dp_ragged(captures):
    """5 stations on 8 shards: padded with silent channels internally and
    sliced back, outputs and final state."""
    rx = Receiver(0, device="cpu", emit_rssi=True)
    mesh = make_mesh(8, "channels", devices=MIXED * 4)
    outs, final = sharded_run(rx, captures[:5], mesh)
    serial, s_final = rx.run(captures[:5])
    assert outs["mono"].shape[0] == 5 and outs["rssi_db"].shape[0] == 5
    for k in ("mono", "rssi_db"):
        np.testing.assert_allclose(outs[k].numpy(), serial[k].numpy(),
                                   atol=1e-6)
    assert_state_equal(final, s_final)
    jouts, _ = jax_sharded_run(JaxReceiver(0), captures[:5],
                               jax_make_mesh(8, "channels"))
    near_ref(outs["mono"], jouts["mono"])


def test_channel_dp_stereo(captures):
    """Stereo (the scan loop) 4 stations on 4 shards.  Against JAX the
    loop is gated in dB as everywhere in the port (ROADMAP queue C: an
    ulp moves the acquisition transient)."""
    rx = Receiver(0, stereo=True, device="cpu")
    mesh = make_mesh(4, "channels", devices=[CPU] * 4)
    outs, final = sharded_run(rx, captures[:4], mesh)
    serial, s_final = rx.run(captures[:4])
    np.testing.assert_allclose(outs["left"].numpy(), serial["left"].numpy(),
                               atol=1e-5)
    assert_state_equal(final, s_final)
    jouts, _ = jax_sharded_run(JaxReceiver(0, stereo=True), captures[:4],
                               jax_make_mesh(4, "channels"))
    want = np.asarray(jouts["left"], np.float64)
    err = outs["left"].double().numpy() - want
    assert 10 * np.log10(np.mean(want ** 2) / np.mean(err ** 2)) > 45.0


@functools.lru_cache(maxsize=None)
def wideband_u8(k):
    """tests/test_parallel.py's wideband stream with k stations: mono
    tones at 0.05 s, across +-3.4 MHz of a 9.6 MS/s u8 stream."""
    cfg = MODES[0]
    fs_wide = 4 * cfg.rf_fs
    n_st = int(0.05 * cfg.rf_fs)

    def station(c):
        cap = tx.synthesize_capture(
            cfg, seconds=0.05,
            mono=tx.tone(cfg.rf_fs, 600.0 + 150.0 * c, n_st), seed=c)
        f = (cap.astype(np.float32) - 128.0) / 128.0
        return f[0::2] + 1j * f[1::2]

    freqs = list(np.linspace(-3.4e6, 3.4e6, k))
    iw, qw = synthesize_wideband([station(c) for c in range(k)], freqs,
                                 cfg.rf_fs, fs_wide)
    wide = np.stack([iw, qw], axis=-1).reshape(-1)
    u8 = np.clip(np.round(wide * 32.0) + 128.0, 0, 255).astype(np.uint8)
    return fs_wide, freqs, u8


@pytest.mark.parametrize("devices", ["virtual", "mixed"])
def test_station_sharded_wideband_matches_serial(devices):
    """One antenna stream -> 16 stations over 2 shards of 8 == the serial
    WidebandReceiver, and within 1e-5 of max of the reference's sharded
    run of the same stations on 2 devices."""
    fs_wide, freqs, u8 = wideband_u8(16)
    chan = WidebandChannelizer(fs_wide, 2.4e6, freqs, engine="pallas",
                               ingest="u8", device="cpu")
    rx = Receiver(0, device="cpu")
    serial, s_final = WidebandReceiver(chan, rx).run(u8)
    mesh = make_mesh(2, "stations", devices=[CPU] * 2
                     if devices == "virtual" else MIXED)
    out, final = sharded_wideband_run(chan, rx, u8, mesh)
    np.testing.assert_allclose(out["mono"].numpy(), serial["mono"].numpy(),
                               atol=2e-5)
    assert out["mono"].device == CPU
    np.testing.assert_allclose(final.mono.audio_tail.numpy(),
                               s_final[1].mono.audio_tail.numpy(), atol=2e-5)
    jchan = JaxChannelizer(fs_wide, 2.4e6, freqs, engine="pallas",
                           ingest="u8")
    jout, _ = jax_sharded_wideband_run(jchan, JaxReceiver(0), u8,
                                       jax_make_mesh(2, "stations"))
    near_ref(out["mono"], jout["mono"])


@pytest.mark.parametrize("devices", ["virtual", "alternating"])
def test_station_sharded_wideband_batches_a_device(devices, monkeypatch):
    """The shards that share a device run as one channelizer call a step
    over their station slices in shard order (the calls are counted at the
    channelizer's wrapper, whose CUDA path launches B7 once a call).  On a
    one-device virtual mesh of 4 shards the device's channelizer is the
    serial one and the run is bit-equal to the serial WidebandReceiver.run,
    outputs and final state; on 4 shards that alternate between two
    devices the outputs are within the reference's 2e-5 and in shard
    order."""
    from sdr_tpu_torch.ops.cuda.channelizer_kernel import PallasMFB
    calls = []
    call_cols = PallasMFB.call_cols

    def counted(self, xbt, state, interpret=None):
        calls.append(self.k)
        return call_cols(self, xbt, state)
    monkeypatch.setattr(PallasMFB, "call_cols", counted)
    fs_wide, freqs, u8 = wideband_u8(32)
    chan = WidebandChannelizer(fs_wide, 2.4e6, freqs, engine="pallas",
                               ingest="u8", device="cpu")
    rx = Receiver(0, device="cpu")
    serial, s_final = WidebandReceiver(chan, rx).run(u8)
    nsteps = len(calls)
    calls.clear()
    mesh = make_mesh(4, "stations", devices=[CPU] * 4
                     if devices == "virtual" else MIXED * 2)
    out, final = sharded_wideband_run(chan, rx, u8, mesh)
    if devices == "virtual":
        assert calls == [32] * nsteps
        for key in serial:
            assert torch.equal(out[key], serial[key]), key
        assert_state_equal(final, s_final[1])
    else:
        assert calls == [16] * (2 * nsteps)
        np.testing.assert_allclose(out["mono"].numpy(),
                                   serial["mono"].numpy(), atol=2e-5)
        np.testing.assert_allclose(final.mono.audio_tail.numpy(),
                                   s_final[1].mono.audio_tail.numpy(),
                                   atol=2e-5)


def test_station_sharded_wideband_checks():
    """The reference's own checks (the pallas engine, K divisible by the
    shards) and its documented one: each slice a multiple of 8."""
    fs_wide, freqs, u8 = wideband_u8(16)
    rx = Receiver(0, device="cpu")
    pal = WidebandChannelizer(fs_wide, 2.4e6, freqs, engine="pallas",
                              ingest="u8", device="cpu")
    for chan, mesh, what in (
            (WidebandChannelizer(fs_wide, 2.4e6, freqs, device="cpu"),
             make_mesh(2, devices=[CPU] * 2), "pallas engine"),
            (pal, make_mesh(3, devices=[CPU] * 3), "not divisible"),
            (pal, make_mesh(8, devices=[CPU] * 8), "multiple of 8")):
        with pytest.raises(ValueError, match=what):
            sharded_wideband_run(chan, rx, u8, mesh, axis="channels")


def test_no_collectives(captures, monkeypatch):
    """Channel DP and the station-sharded wideband run make no
    torch.distributed call: every collective and point-to-point call is
    made to raise, and both still match their serial runs."""
    def boom(*args, **kwargs):
        raise AssertionError("a torch.distributed call ran")

    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "all_to_all", "all_to_all_single", "broadcast", "reduce",
                 "reduce_scatter", "reduce_scatter_tensor", "gather",
                 "scatter", "barrier", "send", "recv", "isend", "irecv",
                 "batch_isend_irecv", "all_gather_object",
                 "broadcast_object_list"):
        monkeypatch.setattr(dist, name, boom)
    rx = Receiver(0, device="cpu")
    outs, _ = sharded_run(rx, captures[:4], make_mesh(
        4, devices=MIXED * 2))
    serial, _ = rx.run(captures[:4])
    np.testing.assert_allclose(outs["mono"].numpy(), serial["mono"].numpy(),
                               atol=1e-6)
    fs_wide, freqs, u8 = wideband_u8(16)
    chan = WidebandChannelizer(fs_wide, 2.4e6, freqs, engine="pallas",
                               ingest="u8", device="cpu")
    out, _ = sharded_wideband_run(chan, rx, u8, make_mesh(
        axis="stations", devices=MIXED))
    want, _ = WidebandReceiver(chan, rx).run(u8)
    np.testing.assert_allclose(out["mono"].numpy(), want["mono"].numpy(),
                               atol=2e-5)
