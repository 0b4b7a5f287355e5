"""The port's CLI in wideband mode (`--wideband FS --freqs=...` or
`--scan`) against sdr_tpu's CLI, in-process on the captures of
tests/test_channelizer.py:139-208; the port runs with --device cpu (the
plain mfb channelizer, as the reference runs its XLA engine on the CPU).

Checks: the same station WAVs (the mono float32 chain within 1 LSB, a
float32 last bit can move a truncation; the --fast chain, a bf16
channelizer, at 40 dB as in tests/test_torch_cli.py), the tones at
> 18 dB, each station's RDS PI and the same stderr station lines."""

import functools
import os

import numpy as np
import pytest

from sdr_tpu import cli as jcli
from sdr_tpu_torch import cli as tcli
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.io.wav import read_wav
from sdr_tpu_torch.ops.channelizer import synthesize_wideband
from sdr_tpu_torch.rds import tx as rds_tx
from sdr_tpu_torch.utils.compare import tone_snr_db

FREQS = [-1.2e6, 1.5e6]
TONES = [800.0, 1300.0]
FS_WIDE = 4 * 2.4e6


@functools.lru_cache(maxsize=None)
def wideband_capture(secs, rds, amps):
    """Two mono FM stations (800 and 1300 Hz; with rds, PI 0x2000 and
    0x2001) at -1.2 and +1.5 MHz, interleaved f32 at 9.6 MS/s."""
    cfg = MODES[0]
    fs_st = float(cfg.rf_fs)
    n = int(secs * fs_st)
    stations = []
    for k in range(2):
        kw = {}
        if rds:
            bits = rds_tx.standard_group_stream(pi=0x2000 + k, n_groups=8)
            kw = dict(rds_baseband=rds_tx.bits_to_baseband(bits, fs_st)[:n],
                      a_rds=0.1)
        m = tx.make_multiplex(fs_st, n, mono=tx.tone(fs_st, TONES[k], n),
                              **kw)
        i, q = tx.fm_modulate(m, fs_st)
        stations.append((i + 1j * q) * amps[k])
    iw, qw = synthesize_wideband(stations, FREQS, fs_st, FS_WIDE)
    wide = np.empty(2 * len(iw), np.float32)
    wide[0::2], wide[1::2] = iw, qw
    return wide


def station_lines(err, wav_dir):
    """The stderr lines about the stations, with the output directory
    named alike."""
    return [ln.replace(wav_dir, "<dir>") for ln in err.splitlines()
            if ln.startswith(("Channelizing", "scan found"))
            or (ln.startswith("  ") and "MHz" in ln)]


def run_both(tmp_path, capsys, argv, data):
    inp = tmp_path / "wide.raw"
    data.tofile(inp)
    outs = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", tcli.main, ["--device", "cpu"])):
        wav_dir = str(tmp_path / name)
        assert main([*argv, "--in", str(inp), "--wav-dir", wav_dir,
                     "--blocks-per-step", "4", *extra]) == 0
        err = capsys.readouterr().err
        wavs = []
        for k in range(2):
            rate, pcm = read_wav(os.path.join(wav_dir, f"station{k}.wav"))
            assert rate == 48000
            wavs.append(pcm.astype(np.float64))
        outs[name] = (wavs, station_lines(err, wav_dir))
    return outs["j"], outs["t"]


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_cli_wideband_rds(tmp_path, capsys, u8):
    """`0 1 --rds --wideband 9.6e6 --freqs=...` (the default profile: the
    RDS carrier on the scan loop), f32 and --wideband-u8."""
    wide = wideband_capture(0.6, True, (0.35, 0.35) if u8 else (0.5, 0.5))
    data = (np.clip(np.round(wide * 128.0 + 128.0), 0, 255).astype(np.uint8)
            if u8 else wide)
    argv = ["0", "1", "--rds", "--wideband", str(FS_WIDE),
            "--freqs=" + ",".join(str(f) for f in FREQS)]
    if u8:
        argv.append("--wideband-u8")
    (jw, jl), (tw, tl) = run_both(tmp_path, capsys, argv, data)
    assert tl == jl
    assert tl[0] == ("Channelizing 2 stations from 9.6 MS/s wideband "
                     f"({'uint8' if u8 else 'float32'} stream)")
    for k in range(2):
        assert len(tw[k]) == len(jw[k]) > 20000
        assert np.abs(tw[k] - jw[k]).max() <= 1
        assert tone_snr_db(tw[k], 48000, TONES[k], skip=2000) > 18.0
        final = [ln for ln in tl if "RDS final" in ln
                 and f"{FREQS[k] / 1e6:+.2f} MHz" in ln]
        assert len(final) == 1 and f"PI={0x2000 + k:#06x}" in final[0]


def test_cli_wideband_scan(tmp_path, capsys):
    """`--scan`: the stations come from the capture's spectrum, strongest
    first (-1.2 MHz), then decode as with --freqs."""
    wide = wideband_capture(0.3, False, (0.5, 0.35))
    (jw, jl), (tw, tl) = run_both(
        tmp_path, capsys, ["0", "1", "--wideband", str(FS_WIDE), "--scan"],
        wide)
    assert tl == jl
    assert tl[0] == "scan found stations at -1.20 MHz, +1.50 MHz"
    for k in range(2):
        assert len(tw[k]) == len(jw[k]) > 10000
        assert np.abs(tw[k] - jw[k]).max() <= 1
        assert tone_snr_db(tw[k], 48000, TONES[k], skip=2000) > 18.0


def test_cli_wideband_stereo_rds_fast(tmp_path, capsys):
    """`0 2 --rds --fast --wideband ...`: a bf16 channelizer, the stereo +
    RDS receiver on the feedforward carriers; stereo station WAVs (the
    stations are mono, so both sides carry the tone)."""
    wide = wideband_capture(0.6, True, (0.5, 0.5))
    argv = ["0", "2", "--rds", "--fast", "--wideband", str(FS_WIDE),
            "--freqs=" + ",".join(str(f) for f in FREQS)]
    (jw, jl), (tw, tl) = run_both(tmp_path, capsys, argv, wide)
    assert [ln for ln in tl if "RDS final" in ln] == \
        [ln for ln in jl if "RDS final" in ln]
    assert [ln for ln in tl if "RDS:" not in ln] == \
        [ln for ln in jl if "RDS:" not in ln]
    for k in range(2):
        a, b = jw[k], tw[k]
        assert a.shape == b.shape and b.shape[1] == 2 and len(b) > 20000
        snr = 10 * np.log10(np.mean(a * a)
                            / max(np.mean((a - b) ** 2), 1e-30))
        assert snr > 40.0, f"{snr:.1f} dB"
        for side in range(2):
            assert tone_snr_db(b[:, side], 48000, TONES[k],
                               skip=2000) > 18.0
        final = [ln for ln in tl if "RDS final" in ln
                 and f"{FREQS[k] / 1e6:+.2f} MHz" in ln]
        assert len(final) == 1 and f"PI={0x2000 + k:#06x}" in final[0]
