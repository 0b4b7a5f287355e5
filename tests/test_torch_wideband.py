"""The port's WidebandReceiver (models/wideband.py) against sdr_tpu's on
the two-station capture of tests/test_channelizer.py: run in f32 and u8
ingest, the mono default profile and the CLI's --fast stereo + RDS
receiver profile, a resume from a converted sdr_tpu state, and the
port's own invariants (stream = run, step = channelize then step_iq,
pallas engine = mfb engine).  The device defaults of the public classes
are checked here too.

Bounds: the earlier slices' for the same receiver profile, with the
channelizer's (2e-5 of max, tests/test_torch_channelizer.py) at its
input: the f32 chain element-wise within 1e-5 of max|ref|; the --fast
profile (a bf16 channelizer) at 45 dB on left, right and rds_soft and
80 dB on mono, the bar of the bf16 chains in
tests/test_torch_stereo_receiver.py."""

import functools
import inspect

import jax
import numpy as np
import pytest
import torch

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.models.wideband import WidebandReceiver as JaxWideband
from sdr_tpu.ops.channelizer import WidebandChannelizer as JaxChannelizer
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.models.wideband import WidebandReceiver
from sdr_tpu_torch.ops.channelizer import (WidebandChannelizer,
                                           synthesize_wideband)
from sdr_tpu_torch.ops.spectrum import find_stations
from sdr_tpu_torch.utils import convert
from sdr_tpu_torch.utils.compare import tone_snr_db

FAST_RX = dict(stereo=True, rds=True, fused_frontend=False, pll_impl="ff")


@functools.lru_cache(maxsize=None)
def two_station_wide(secs=0.15, a_scale=0.5):
    """tests/test_channelizer.py:212-227: two mono FM stations (900 and
    1700 Hz) at -1.5 and +1.8 MHz in a 9.6 MS/s interleaved f32 stream."""
    cfg = MODES[0]
    fs_st = float(cfg.rf_fs)
    fs_wide = 4 * fs_st
    freqs = [-1.5e6, +1.8e6]
    tones = [900.0, 1700.0]
    n = int(secs * fs_st)
    stations = []
    for tone_f in tones:
        m = tx.make_multiplex(fs_st, n, mono=tx.tone(fs_st, tone_f, n))
        i, q = tx.fm_modulate(m, fs_st)
        stations.append((i + 1j * q) * a_scale)
    iw, qw = synthesize_wideband(stations, freqs, fs_st, fs_wide)
    wide = np.empty(2 * len(iw), np.float32)
    wide[0::2], wide[1::2] = iw, qw
    return cfg, fs_wide, freqs, tones, wide


def to_u8(wide):
    return np.clip(np.round(wide * 128.0 + 128.0), 0, 255).astype(np.uint8)


def snr_db(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.mean(want * want)
                         / max(np.mean((want - got) ** 2), 1e-30))


def build(fs_wide, freqs, chan_kw=None, rx_kw=None):
    """The same wideband receiver in both packages (the port's on the
    CPU)."""
    chan_kw, rx_kw = chan_kw or {}, rx_kw or {}
    j = JaxWideband(JaxChannelizer(fs_wide, 2.4e6, freqs, **chan_kw),
                    JaxReceiver(0, **rx_kw))
    t = WidebandReceiver(WidebandChannelizer(fs_wide, 2.4e6, freqs,
                                             device="cpu", **chan_kw),
                         Receiver(0, device="cpu", **rx_kw))
    return j, t


def assert_outputs(tout, jout, fast):
    assert set(tout) == set(jout)
    for k, v in jout.items():
        want = np.asarray(v, np.float64)
        got = tout[k].double().numpy()
        assert got.shape == want.shape, k
        if fast:
            assert snr_db(want, got) > (80.0 if k == "mono" else 45.0), k
        else:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k


@pytest.mark.parametrize("ingest", ["f32", "u8"])
@pytest.mark.parametrize("profile", ["default", "fast"])
def test_run_matches_reference(ingest, profile):
    """The mono default profile (mfb f32 channelizer) and the CLI's --fast
    profile (bf16 channelizer, stereo + RDS on the feedforward carriers);
    the mono profile's tones come through on both stations."""
    cfg, fs_wide, freqs, tones, wide = two_station_wide(
        a_scale=0.35 if ingest == "u8" else 0.5)
    data = to_u8(wide) if ingest == "u8" else wide
    fast = profile == "fast"
    j, t = build(fs_wide, freqs, dict(compute_dtype="bf16") if fast else {},
                 FAST_RX if fast else {})
    assert t.block_pairs == j.block_pairs
    assert t.block_wide(2) == j.block_wide(2)
    jout, _ = j.run(data, blocks_per_step=2)
    tout, _ = t.run(data, blocks_per_step=2)
    assert_outputs(tout, jout, fast)
    if not fast:
        audio = tout["mono"].double().numpy()
        for k, tone_f in enumerate(tones):
            assert tone_snr_db(audio[k], cfg.audio_fs, tone_f,
                               skip=cfg.audio_fs // 10) > 20.0


@pytest.mark.parametrize("engine,ingest", [("mfb", "f32"), ("pallas", "u8"),
                                           ("mix", "f32")])
def test_resume_from_reference_state_mid_stream(engine, ingest):
    """The first half in sdr_tpu, its (channelizer, receiver) state
    through wideband_state_from_numpy (the pallas engine's u8 tail
    included), the second half in the port: equal to the second half of
    a whole sdr_tpu run within 1e-5 of max; the state crosses back."""
    cfg, fs_wide, freqs, tones, wide = two_station_wide(a_scale=0.35)
    data = to_u8(wide) if ingest == "u8" else wide
    kw = dict(engine=engine, ingest=ingest) if engine == "pallas" else dict(
        engine=engine)
    j, t = build(fs_wide, freqs, kw)
    whole, _ = j.run(data, blocks_per_step=1)
    half = 3 * j.block_wide(1)
    first, jst = j.run(data[:half], blocks_per_step=1)
    st = convert.wideband_state_from_numpy(jax.tree.map(np.asarray, jst),
                                           device="cpu")
    assert st[0]["phase"].dtype == torch.float32
    if engine == "pallas":
        assert st[0]["tail"].dtype == torch.uint8
    back = convert.wideband_state_to_numpy(st)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(a, np.asarray(b))
    second, _ = t.run(data[half:], blocks_per_step=1, state=st)
    n = first["mono"].shape[-1]
    want = np.asarray(whole["mono"], np.float64)[:, n:]
    got = second["mono"].double().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_stream_chunked_equals_run():
    """stream() re-framing arbitrary reader chunk sizes == run(): the same
    steps, so the same bits; the leftover whole blocks step one at a
    time."""
    cfg, fs_wide, freqs, tones, wide = two_station_wide()
    _, wrx = build(fs_wide, freqs)
    whole, _ = wrx.run(wide, blocks_per_step=1)

    def awkward_chunks():
        sizes = [100001, 37, 4 * wrx.block_wide(), 999999]
        i = k = 0
        while i < len(wide):
            sz = sizes[k % len(sizes)]
            yield wide[i:i + sz]
            i += sz
            k += 1

    parts = [out["mono"] for out, _ in wrx.stream(awkward_chunks(),
                                                   scan_steps=3)]
    streamed = torch.cat(parts, dim=-1)
    assert torch.equal(streamed, whole["mono"][:, :streamed.shape[-1]])
    assert streamed.shape[-1] == whole["mono"].shape[-1]
    nb = len(wide) // wrx.block_wide()
    assert len(parts) == nb // 3 + nb % 3   # chunks, then single steps


def test_step_equals_channelize_then_step_iq():
    """WidebandReceiver.step is the channelizer's __call__ on the rails
    followed by Receiver.step_iq, bit for bit."""
    cfg, fs_wide, freqs, tones, wide = two_station_wide()
    _, wrx = build(fs_wide, freqs)
    fused, _ = wrx.run(wide, blocks_per_step=2)
    chan = WidebandChannelizer(fs_wide, 2.4e6, freqs, device="cpu")
    rx = wrx.rx
    cstate, rstate = chan.init_state(), rx.init_state((len(freqs),))
    bw = wrx.block_wide(2)
    audio = []
    for b in range(len(wide) // bw):
        blk = torch.from_numpy(wide[b * bw:(b + 1) * bw])
        (i_st, q_st), cstate = chan(blk[0::2], blk[1::2], cstate)
        rstate, out = rx.step_iq(rstate, i_st, q_st)
        audio.append(out["mono"])
    assert torch.equal(torch.cat(audio, dim=-1), fused["mono"])


def test_pallas_engine_matches_mfb():
    """tests/test_channelizer.py:427-456: the pallas engine (its plain
    version here) composes with the receiver on a u8 stream at D = 2 and
    matches the mfb engine within 1e-4."""
    cfg = MODES[0]
    fs_wide = 2 * cfg.rf_fs
    n_st = int(0.1 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.1,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n_st))
    f = (cap.astype(np.float32) - 128.0) / 128.0
    iq = f[0::2] + 1j * f[1::2]
    freqs = [-0.5e6, 0.8e6]
    iw, qw = synthesize_wideband([iq, iq], freqs, cfg.rf_fs, fs_wide)
    wide = np.stack([iw, qw], axis=-1).reshape(-1)
    u8 = np.clip(np.round(wide * 64.0) + 128.0, 0, 255).astype(np.uint8)
    outs = {}
    for eng in ("mfb", "pallas"):
        chan = WidebandChannelizer(fs_wide, cfg.rf_fs, freqs, engine=eng,
                                   ingest="u8", device="cpu")
        wrx = WidebandReceiver(chan, Receiver(0, device="cpu"))
        out, _ = wrx.run(u8, blocks_per_step=1)
        outs[eng] = out["mono"].numpy()
    np.testing.assert_allclose(outs["pallas"], outs["mfb"], atol=1e-4)
    assert tone_snr_db(outs["pallas"][0], cfg.audio_fs, 1000.0,
                       skip=1000) > 20.0


def test_device_defaults_to_cuda():
    """The public entry points run on the card unless the caller asks for
    the CPU: Receiver, WidebandChannelizer (and so WidebandReceiver, which
    runs where its parts do), find_stations and the state conversions
    default to cuda.  Without a card, building on the default raises
    PyTorch's own error; nothing moves to the CPU on its own."""
    for fn in (Receiver, WidebandChannelizer, find_stations,
               convert.state_from_numpy, convert.chan_state_from_numpy,
               convert.wideband_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        rx = Receiver(0)
        wrx = WidebandReceiver(WidebandChannelizer(9.6e6, 2.4e6, [0.0]), rx)
        assert rx.device.type == wrx.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            Receiver(0)
        with pytest.raises((AssertionError, RuntimeError)):
            WidebandChannelizer(9.6e6, 2.4e6, [0.0])
    cpu = WidebandReceiver(WidebandChannelizer(9.6e6, 2.4e6, [0.0],
                                               device="cpu"),
                           Receiver(0, device="cpu"))
    assert cpu.device.type == "cpu"
    if not torch.cuda.is_available():
        return
    with pytest.raises(ValueError):
        WidebandReceiver(WidebandChannelizer(9.6e6, 2.4e6, [0.0]),
                         Receiver(0, device="cpu"))
