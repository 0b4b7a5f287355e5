"""The port's copies of sdr_tpu's host-only modules (config, firdes, tx,
wav, compare, the RDS host decoder and rds/matrix.py beside its torch
function, io/gen, the logger's NumPy functions, the native stream runtime
and timeshard's polarity_stitch) and host functions (io/stream.py's
read_bin_f32, write_bin_f32 and write_s16_stream; ops/resample.py's
fir_filter and resample_reference; ops/pll.py's pll_reference) equal their
originals, the native ring works, and importing the port, the parallel
layer and the RDS device helpers included, pulls in neither jax nor
sdr_tpu (the GPU machine has no jax)."""

import dataclasses
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from sdr_tpu import config as jcfg
from sdr_tpu.io import gen as jgen
from sdr_tpu.io import logger as jlogger
from sdr_tpu import tx as jtx
from sdr_tpu.io import wav as jwav
from sdr_tpu.ops import firdes as jfirdes
from sdr_tpu.rds import streaming as jstreaming
from sdr_tpu.rds import tx as jrds_tx
from sdr_tpu.utils import compare as jcompare
from sdr_tpu_torch import config as tcfg
from sdr_tpu_torch import native
from sdr_tpu_torch.io import gen as tgen
from sdr_tpu_torch.io import logger as tlogger
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
    loads the port's package, receivers, CUDA wrappers and CLI."""
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
        "import sdr_tpu_torch.ops.banded\n"
        "import sdr_tpu_torch.ops.cuda.banded_kernel\n"
        "import sdr_tpu_torch.ops.cuda.build, sdr_tpu_torch.utils.convert\n"
        "import sdr_tpu_torch.ops.pll, sdr_tpu_torch.ops.pointwise\n"
        "import sdr_tpu_torch.rds, sdr_tpu_torch.rds.streaming\n"
        "import sdr_tpu_torch.rds.tx, sdr_tpu_torch.rds.correct\n"
        "import sdr_tpu_torch.tx, sdr_tpu_torch.utils.compare\n"
        "import sdr_tpu_torch.ops.cuda.channelizer_kernel\n"
        "import sdr_tpu_torch.ops.spectrum\n"
        "import sdr_tpu_torch.utils.checkpoint, sdr_tpu_torch.io.logger\n"
        "import sdr_tpu_torch.io.gen, sdr_tpu_torch.ops.fourier\n"
        "import sdr_tpu_torch.ops.fft_conv, sdr_tpu_torch.ops.iir\n"
        "import sdr_tpu_torch.native, sdr_tpu_torch.rds.timing\n"
        "import sdr_tpu_torch.parallel.mesh, sdr_tpu_torch.parallel.channels\n"
        "import sdr_tpu_torch.parallel.distributed\n"
        "import sdr_tpu_torch.parallel.timeshard\n"
        "import sdr_tpu_torch.parallel.wideband\n"
        "from sdr_tpu_torch.rds import decode_rds_soft, recover_symbols\n"
        "from sdr_tpu_torch.rds.matrix import syndromes_sliding_device\n"
        "from sdr_tpu_torch.rds.timing import manchester_pairing_score\n"
        "from sdr_tpu_torch.parallel.mesh import make_mesh\n"
        "make_mesh(2, devices=['cpu'] * 2)\n"
        "from sdr_tpu_torch.models.receiver import Receiver\n"
        "from sdr_tpu_torch.models.wideband import WidebandReceiver\n"
        "from sdr_tpu_torch.ops.channelizer import WidebandChannelizer\n"
        "Receiver(0, stereo=True, filter_engine='fft', deemphasis_us=75,\n"
        "         compat_shared_audio_state=True, device='cpu')\n"
        "Receiver(0, stereo=True, rds=True, fused_frontend='int8',\n"
        "         pll_impl='ff', conv_dtype='bf16', conv_engine='tiled',\n"
        "         fused_ifbank='bf16', device='cpu').init_state((2,))\n"
        "WidebandReceiver(WidebandChannelizer(\n"
        "    9.6e6, 2.4e6, [0.0], engine='pallas', device='cpu'),\n"
        "    Receiver(0, device='cpu')).init_state()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'sdr_tpu']\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _without(path, name):
    """The source at `path` without the top-level function `name`, the
    package's name taken out of its imports."""
    src = Path(path).read_text().replace("sdr_tpu_torch", "sdr_tpu")
    start = src.index(f"\ndef {name}(")
    return src[:start] + src[src.index("\ndef ", start + 1):]


def test_rds_matrix_copy_equal():
    """rds/matrix.py is the reference's but for syndromes_sliding_device,
    which runs in torch here (tests/test_torch_rds_device.py)."""
    from sdr_tpu.rds import matrix as jmatrix
    from sdr_tpu_torch.rds import matrix as tmatrix
    name = "syndromes_sliding_device"
    assert (_without(tmatrix.__file__, name)
            == _without(jmatrix.__file__, name))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polarity_stitch_copy_equal(seed):
    """The port's NumPy polarity_stitch gives the reference's output and
    warnings on seeded soft segments: random per-device signs, noise, and
    one seam whose overlap is silent."""
    import warnings
    from sdr_tpu.parallel.timeshard import polarity_stitch as jstitch
    from sdr_tpu_torch.parallel.timeshard import polarity_stitch as tstitch
    rng = np.random.default_rng(seed)
    warm, chunk, n_dev = 96, 320, 6
    wave = np.sin(2 * np.pi * np.arange(warm + chunk) / 16.0)
    soft = (rng.choice([-1.0, 1.0], size=(n_dev, 1)) * wave
            + 0.2 * rng.standard_normal((n_dev, warm + chunk)))
    soft[1 + seed, warm // 2:warm] = 0.0
    soft = soft.astype(np.float32)
    results = []
    for fn in (tstitch, jstitch):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn(soft, warm)
        results.append((out, [str(w.message) for w in caught]))
    (got, got_w), (want, want_w) = results
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got_w == want_w and len(got_w) == 1


def test_stream_host_functions_copy_equal(tmp_path):
    """read_bin_f32 / write_bin_f32 / write_s16_stream write the
    reference's bytes and read them back alike."""
    import io
    from sdr_tpu.io import stream as jstream
    from sdr_tpu_torch.io import stream as tstream
    rng = np.random.default_rng(3)
    data = rng.normal(0, 1, 1001)                       # float64 in
    paths = [tmp_path / "t.bin", tmp_path / "j.bin"]
    for mod, path in zip((tstream, jstream), paths):
        mod.write_bin_f32(str(path), data)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    got, want = (mod.read_bin_f32(str(paths[0]))
                 for mod in (tstream, jstream))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    pcm = rng.integers(-32768, 32768, 777).astype(np.int32)
    outs = []
    for mod in (tstream, jstream):
        buf = io.BytesIO()
        mod.write_s16_stream(pcm, buf)
        mod.write_s16_stream(pcm[:5].astype(np.int16), buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0]) == 2 * 782


@pytest.mark.parametrize("up,down,taps", [(1, 1, 51), (1, 5, 51),
                                          (3, 7, 40), (19, 120, 969)])
def test_resample_reference_copy_equal(up, down, taps):
    """The scalar oracle gives the reference's outputs and state, and the
    port's conv engine agrees with it."""
    import torch
    from sdr_tpu.ops.resample import resample_reference as jref
    from sdr_tpu_torch.ops.resample import (PolyphaseResampler,
                                            resample_reference as tref)
    rng = np.random.default_rng(up + down)
    coeff = rng.normal(0, 0.1, taps)
    n = down * max(4, -(-taps // down))
    x = rng.normal(0, 0.5, n).astype(np.float32)
    state = rng.normal(0, 0.5, taps - 1).astype(np.float32)
    (got, got_st), (want, want_st) = (fn(x, state, coeff, up, down)
                                      for fn in (tref, jref))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_st, want_st)
    fir = PolyphaseResampler(coeff, up, down, device="cpu")
    tail = torch.from_numpy(state[len(state) - fir.state_len:])
    y, _ = fir(torch.from_numpy(x), tail)
    np.testing.assert_allclose(y.double().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_fir_filter_copy_equal():
    """fir_filter is the reference's plain FIR (U = D = 1): the same
    state and the same outputs."""
    import jax.numpy as jnp
    import torch
    from sdr_tpu.ops.resample import fir_filter as jfir
    from sdr_tpu_torch.ops.resample import fir_filter as tfir
    coeff = jfirdes.bandpass(240e3, 54e3, 60e3, 51)
    port, ref = tfir(coeff, device="cpu"), jfir(coeff)
    assert (port.up, port.down, port.state_len) == (1, 1, ref.state_len)
    x = np.random.default_rng(4).normal(0, 0.5, (2, 300)).astype(np.float32)
    jy, jt = ref(jnp.asarray(x), ref.init_state((2,)))
    ty, tt = port(torch.from_numpy(x), port.init_state((2,)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("adjust,bw", [(0.0, 0.01), (0.3, 0.003)])
def test_pll_reference_copy_equal(adjust, bw):
    """The scalar loop oracle gives the reference's NCO and state bit for
    bit on a seeded noisy 19 kHz pilot."""
    from sdr_tpu.ops.pll import pll_reference as jref
    from sdr_tpu_torch.ops.pll import pll_reference as tref
    rng = np.random.default_rng(int(bw * 1e3))
    t = np.arange(2000) / 240e3
    x = (np.cos(2 * np.pi * 19e3 * t + 0.4)
         + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    state = (0.0, 0.1, 1.0, 0.0, 0.0)
    (got, got_st), (want, want_st) = (
        fn(x, 19e3, 240e3, 2.0, adjust, bw, state) for fn in (tref, jref))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert [np.float32(v) for v in got_st] == [np.float32(v)
                                               for v in want_st]


def test_gen_copy_equal():
    with open(jgen.__file__, "rb") as a, open(tgen.__file__, "rb") as b:
        assert a.read() == b.read()
    for fn, args in (("generate_sin", (48000.0, 1000.0, 480, 0.5, 0.3)),
                     ("generate_random_samples", (100, 5.0, 3, 7))):
        np.testing.assert_array_equal(getattr(tgen, fn)(*args),
                                      getattr(jgen, fn)(*args))
    sig = [jgen.generate_sin(48000.0, f, 64) for f in (100.0, 300.0)]
    np.testing.assert_array_equal(tgen.add_sin(sig), jgen.add_sin(sig))


def test_logger_copies_equal(tmp_path):
    """gen_index_vector, log_vector, PsdAnimWriter and the print helpers
    write and return what the reference's do."""
    x = np.linspace(0.0, 1.0, 7)
    y = np.sin(x * 5).astype(np.float32)
    np.testing.assert_array_equal(tlogger.gen_index_vector(9),
                                  jlogger.gen_index_vector(9))
    for mod, tag in ((jlogger, "j"), (tlogger, "t")):
        mod.log_vector(str(tmp_path / f"{tag}_v"), x, y)
        w = mod.PsdAnimWriter(str(tmp_path / f"{tag}_a"), x)
        w.append(y, label="block 0")
        w.append(2 * y)
        w.close()
        assert w.frames == 2
    for name in ("v", "a"):
        assert ((tmp_path / f"t_{name}.dat").read_text()
                == (tmp_path / f"j_{name}.dat").read_text())
    z = y + 1j * y[::-1]
    for fn, arg in (("print_real_vector", y), ("print_complex_vector", z)):
        assert getattr(tlogger, fn)(arg, 4) == getattr(jlogger, fn)(arg, 4)


def test_stage_scope_records_wall_time():
    """The span records while tracing is on (set_tracing, as --stats)."""
    tlogger.reset_stage_times()
    tlogger.set_tracing(True)
    try:
        with tlogger.stage_scope("demod"):
            sum(range(1000))
    finally:
        tlogger.set_tracing(False)
    assert set(tlogger.stage_times()) == {"demod"}
    assert tlogger.stage_times()["demod"] >= 0.0
    tlogger.reset_stage_times()


def test_stream_runtime_copy_equal():
    src = os.path.join(ROOT, "sdr_tpu", "native", "stream_runtime.cpp")
    with open(src, "rb") as a, open(native.SOURCE, "rb") as b:
        assert a.read() == b.read()


def test_native_builds_outside_the_package():
    """The library lands under build/native/ at the root of the checkout
    (listed in .gitignore), never in the package directory."""
    assert native.available(), "the tests' host has g++: the build must work"
    lib = native.library_path()
    assert lib.exists()
    assert lib.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT == Path(ROOT) / "build" / "native"
    pkg = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


# the reference's native ring tests (tests/test_io.py), on the port's copy
def test_native_ring_roundtrip():
    r, w = os.pipe()
    payload = np.arange(256, dtype=np.uint8).tobytes() * 8
    os.write(w, payload)
    os.close(w)
    reader = native.BlockReader(r, 512, capacity=2)
    blocks = list(reader)
    reader.close()
    os.close(r)
    assert b"".join(b.tobytes() for b in blocks) == payload
    assert reader.tail().size == 0


def test_native_reader_keeps_partial_tail():
    """The partial final block at EOF is kept for the consumer's aligned
    flush (tail()), not dropped."""
    r, w = os.pipe()
    payload = bytes(range(256)) * 3  # 768 bytes = 1 full 512-block + 256
    os.write(w, payload)
    os.close(w)
    reader = native.BlockReader(r, 512, capacity=2)
    blocks = list(reader)
    tail = reader.tail()
    assert reader.blocks_read == 1
    reader.close()
    os.close(r)
    assert len(blocks) == 1 and blocks[0].tobytes() == payload[:512]
    assert tail.tobytes() == payload[512:]


def test_native_writer_drains_on_close(tmp_path):
    """BlockWriter (the CLI's audio sink) flushes every queued block before
    close returns, in order."""
    dst = tmp_path / "audio.bin"
    payload = [bytes([i]) * 1024 for i in range(32)]
    with open(dst, "wb") as f:
        w = native.BlockWriter(f.fileno(), capacity=4)
        for p in payload:
            w.push(p)
        w.push(np.frombuffer(b"end", np.uint8))
        w.close()  # joins after draining
    assert dst.read_bytes() == b"".join(payload) + b"end"
