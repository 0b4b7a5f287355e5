"""The port's copies of sdr_tpu's host-only modules (config, firdes, tx,
wav, compare and the RDS host decoder) equal their originals, and
importing the port pulls in neither jax nor sdr_tpu (the GPU machine has
no jax)."""

import dataclasses
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

from sdr_tpu import config as jcfg
from sdr_tpu import tx as jtx
from sdr_tpu.io import wav as jwav
from sdr_tpu.ops import firdes as jfirdes
from sdr_tpu.rds import streaming as jstreaming
from sdr_tpu.rds import tx as jrds_tx
from sdr_tpu.utils import compare as jcompare
from sdr_tpu_torch import config as tcfg
from sdr_tpu_torch import tx as ttx
from sdr_tpu_torch.io import wav as twav
from sdr_tpu_torch.ops import firdes as tfirdes
from sdr_tpu_torch.rds import streaming as tstreaming
from sdr_tpu_torch.rds import tx as trds_tx
from sdr_tpu_torch.utils import compare as tcompare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_modes_copy_equal():
    assert sorted(tcfg.MODES) == sorted(jcfg.MODES)
    for m in jcfg.MODES:
        a, b = dataclasses.asdict(jcfg.MODES[m]), dataclasses.asdict(
            tcfg.MODES[m])
        assert a == b
        for prop in ("if_fs", "audio_taps", "audio_gain", "block_size_u8",
                     "if_per_block", "audio_per_block", "rds_fs",
                     "rds_resample"):
            assert getattr(jcfg.MODES[m], prop) == getattr(tcfg.MODES[m], prop)
    with pytest.raises(ValueError):
        tcfg.get_mode(7)


@pytest.mark.parametrize("fn,args", [
    ("lowpass", (2.4e6, 100e3, 51, 1)),
    ("lowpass", (240e3 * 147, 16e3, 51 * 147, 147)),
    ("bandpass", (240e3, 22e3, 54e3, 51)),
    ("root_raised_cosine", (38000.0, 151, 2375.0)),
    ("allpass_delay", (51,)),
])
def test_firdes_copy_equal(fn, args):
    want = getattr(jfirdes, fn)(*args)
    got = getattr(tfirdes, fn)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,kw", [
    (0, dict(mono=True)),
    (0, dict(stereo=True, noise_db=-25.0, cfo_hz=500.0)),
    (2, dict(mono=True, clock_ppm=50.0, pilot_linewidth_hz=2.0)),
])
def test_tx_copy_equal(mode, kw):
    cfg = jcfg.MODES[mode]
    n = int(0.02 * cfg.rf_fs)
    sig = {}
    if kw.pop("mono", False):
        sig["mono"] = jtx.tone(cfg.rf_fs, 1000.0, n)
    if kw.pop("stereo", False):
        sig["left"] = jtx.tone(cfg.rf_fs, 1000.0, n)
        sig["right"] = jtx.tone(cfg.rf_fs, 2500.0, n)
    want = jtx.synthesize_capture(cfg, seconds=0.02, seed=3, **sig, **kw)
    got = ttx.synthesize_capture(tcfg.MODES[mode], seconds=0.02, seed=3,
                                 **sig, **kw)
    np.testing.assert_array_equal(got, want)


def test_wav_and_compare_copies_equal(tmp_path):
    x = (np.sin(np.arange(4800) * 2 * np.pi * 1000 / 48000) * 8000
         ).astype(np.int16)
    pa, pb = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    jwav.write_wav(pa, 48000, x)
    twav.write_wav(pb, 48000, x)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()
    assert twav.read_wav(pa)[0] == 48000
    np.testing.assert_array_equal(twav.read_wav(pa)[1], jwav.read_wav(pa)[1])
    with wave.open(pb) as w:
        assert w.getnchannels() == 1
    np.testing.assert_array_equal(twav.float_to_wav_s16(x / 8000.0),
                                  jwav.float_to_wav_s16(x / 8000.0))
    noisy = x + np.random.default_rng(1).normal(0, 100, x.shape)
    for name, args in (("tone_snr_db", (noisy, 48000, 1000.0)),
                       ("band_power_db", (noisy, 48000, 1000.0)),
                       ("stereo_separation_db", (noisy, x * 0.01, 48000,
                                                 1000.0)),
                       ("stream_snr_db", (noisy, x))):
        assert getattr(tcompare, name)(*args) == getattr(jcompare, name)(*args)


@pytest.mark.parametrize("kw", [
    dict(pi=0x3D44, ps_name="TPU FM  ", n_groups=10),
    dict(pi=0x1234, pty=10, ps_name="MODE2   ", radio_text="HELLO",
         n_groups=6)])
def test_rds_tx_copy_equal(kw):
    bits = trds_tx.standard_group_stream(**kw)
    np.testing.assert_array_equal(bits, jrds_tx.standard_group_stream(**kw))
    for fs in (38_000.0, 2_400_000.0):
        got = trds_tx.bits_to_baseband(bits, fs)
        want = jrds_tx.bits_to_baseband(bits, fs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("polarity,noise", [(1.0, 0.1), (-1.0, 0.4)])
def test_streaming_rds_decoder_copy_equal(polarity, noise):
    """The same soft stream, pushed in uneven blocks, gives the same
    groups and StationInfo in both packages (the inverted stream takes the
    polarity search, the noisier one the burst correction)."""
    bits = trds_tx.standard_group_stream(pi=0x3D44, ps_name="TPU FM  ",
                                         n_groups=10)
    bb = trds_tx.bits_to_baseband(bits, 38_000.0)
    rng = np.random.default_rng(2)
    soft = (polarity * (bb + rng.normal(0, noise * np.std(bb), bb.shape))
            ).astype(np.float32)
    decoders = (tstreaming.StreamingRdsDecoder(16),
                jstreaming.StreamingRdsDecoder(16))
    groups = ([], [])
    for i in range(0, len(soft), 777):
        for g, d in zip(groups, decoders):
            g.extend(d.push(soft[i:i + 777]))
    tg, jg = groups
    assert len(tg) == len(jg) >= 3
    for a, b in zip(tg, jg):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for k, v in dataclasses.asdict(b).items():
            np.testing.assert_array_equal(dataclasses.asdict(a)[k], v)
    ti, ji = decoders[0].info, decoders[1].info
    assert dataclasses.asdict(ti) == dataclasses.asdict(ji)
    assert ti.pi == 0x3D44 and ti.ps_name == "TPU FM  "
    assert decoders[0].bits_corrected == decoders[1].bits_corrected


def test_port_imports_no_jax():
    """A fresh interpreter in which jax and sdr_tpu cannot be imported
    loads the port's package, receiver, CUDA wrapper and CLI."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'sdr_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sdr_tpu_torch, sdr_tpu_torch.models.receiver\n"
        "import sdr_tpu_torch.cli, sdr_tpu_torch.ops.cuda.frontend_kernel\n"
        "import sdr_tpu_torch.ops.cuda.ifbank_kernel\n"
        "import sdr_tpu_torch.ops.cuda.ffmix_kernel\n"
        "import sdr_tpu_torch.ops.cuda.audio_kernel\n"
        "import sdr_tpu_torch.ops.cuda.build, sdr_tpu_torch.utils.convert\n"
        "import sdr_tpu_torch.ops.pll, sdr_tpu_torch.ops.pointwise\n"
        "import sdr_tpu_torch.rds, sdr_tpu_torch.rds.streaming\n"
        "import sdr_tpu_torch.rds.tx, sdr_tpu_torch.rds.correct\n"
        "import sdr_tpu_torch.tx, sdr_tpu_torch.utils.compare\n"
        "from sdr_tpu_torch.models.receiver import Receiver\n"
        "Receiver(0, stereo=True, rds=True, fused_frontend='int8',\n"
        "         pll_impl='ff', conv_dtype='bf16', conv_engine='tiled',\n"
        "         fused_ifbank='bf16').init_state((2,))\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'sdr_tpu']\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
