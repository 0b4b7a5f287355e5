"""The port's `--stations` against sdr_tpu's, in-process on the same
captures (the port with --device cpu): each station's WAV and the RDS
lines on stderr."""

import numpy as np
import pytest

from sdr_tpu import cli as jcli
from sdr_tpu_torch import cli as tcli
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.io.wav import read_wav
from sdr_tpu_torch.rds import tx as rds_tx
from sdr_tpu_torch.utils.compare import stereo_separation_db, tone_snr_db

SECONDS = 0.3
# station i: left tone, right tone, PI
STATIONS = [(1000.0, 2500.0, 0x3D44), (700.0, 1900.0, 0x2001),
            (1300.0, 3100.0, 0x2002)]


def station_capture(i, stereo=True):
    cfg = MODES[0]
    n = int(SECONDS * cfg.rf_fs)
    left, right, pi = STATIONS[i]
    if not stereo:
        return tx.synthesize_capture(cfg, seconds=SECONDS, seed=i,
                                     mono=tx.tone(cfg.rf_fs, left, n))
    bits = rds_tx.standard_group_stream(pi=pi, ps_name=f"STAT {i}  ",
                                        n_groups=8)
    return tx.synthesize_capture(
        cfg, seconds=SECONDS, seed=i, left=tx.tone(cfg.rf_fs, left, n),
        right=tx.tone(cfg.rf_fs, right, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("stations")
    out = {}
    for stereo in (False, True):
        ps = []
        for i in range(len(STATIONS)):
            p = d / f"{'st' if stereo else 'mono'}{i}.u8"
            cap = station_capture(i, stereo)
            # captures of different lengths: the batch takes the shortest
            cap[: len(cap) - 2048 * i].tofile(p)
            ps.append(str(p))
        out[stereo] = ",".join(ps)
    return out


def run_both(paths, tmp_path, capsys, argv):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    assert jcli.main([*argv, "--wav-dir", str(jdir)]) == 0
    jerr = capsys.readouterr().err
    assert tcli.main([*argv, "--wav-dir", str(tdir), "--device", "cpu"]) == 0
    terr = capsys.readouterr().err
    wavs = []
    for i in range(len(STATIONS)):
        jr, jw = read_wav(str(jdir / f"station{i}.wav"))
        tr, tw = read_wav(str(tdir / f"station{i}.wav"))
        assert jr == tr == 48000 and jw.shape == tw.shape and len(tw) > 4800
        wavs.append((jw.astype(np.int64), tw.astype(np.int64)))
    return wavs, jerr, terr


def rds_lines(err):
    return [ln for ln in err.splitlines() if "RDS" in ln]


def snr_db(want, got):
    want, got = want.astype(np.float64), got.astype(np.float64)
    return 10 * np.log10(np.mean(want * want)
                         / max(np.mean((want - got) ** 2), 1e-30))


def test_stations_mono_within_one_lsb(paths, tmp_path, capsys):
    """The default mono profile is float32 throughout: each station's
    samples agree within one LSB (a float32 last bit can move a
    truncation boundary)."""
    wavs, jerr, terr = run_both(paths, tmp_path, capsys,
                                ["0", "1", "--stations", paths[False],
                                 "--blocks-per-step", "2"])
    for i, (jw, tw) in enumerate(wavs):
        assert np.abs(jw - tw).max() <= 1, i
        assert tone_snr_db(tw, 48000, STATIONS[i][0], skip=2400) > 20.0
    assert "Decoding 3 stations" in terr
    assert [ln.split("->")[0] for ln in terr.splitlines() if "->" in ln] == [
        ln.split("->")[0] for ln in jerr.splitlines() if "->" in ln]


@pytest.mark.parametrize("fast", [False, True], ids=["default", "fast"])
def test_stations_stereo_rds(paths, tmp_path, capsys, fast):
    """Stereo + RDS: the same RDS lines (live and final) as the reference,
    each station's tones on their sides; the WAVs agree with the
    reference's at 45 dB, the port's bound for chains with a carrier loop
    or bf16 streams (test_torch_stereo_receiver.py; observed 74-83 dB in
    the default profile, whose loops carry an ulp of detector input into
    the acquisition transient, 90-111 dB with --fast), and every station
    decodes its own PI."""
    argv = ["0", "2", "--rds", "--stations", paths[True],
            "--blocks-per-step", "2"] + (["--fast"] if fast else [])
    wavs, jerr, terr = run_both(paths, tmp_path, capsys, argv)
    assert rds_lines(terr) == rds_lines(jerr)
    for i, (jw, tw) in enumerate(wavs):
        left, right, pi = STATIONS[i]
        assert f"station {i} RDS final: PI={pi:#06x}" in terr
        for side in range(2):
            assert snr_db(jw[:, side], tw[:, side]) > 45.0, (i, side)
        l, r = tw[:, 0].astype(float), tw[:, 1].astype(float)
        assert tone_snr_db(l, 48000, left, skip=12000) > 20.0
        assert tone_snr_db(r, 48000, right, skip=12000) > 20.0
        assert stereo_separation_db(l, r, 48000, left, skip=12000) > 20.0


def test_stations_needs_wav_dir(paths, capsys):
    assert tcli.main(["0", "1", "--stations", paths[False],
                      "--device", "cpu"]) == 1
    assert "--stations requires --wav-dir" in capsys.readouterr().err


def test_stations_pcm_wraps_as_numpy_does(tmp_path, monkeypatch, capsys):
    """The station PCM is the reference's numpy expression: NaN -> 0 and
    x * 16384 cast to int16 with no clip."""
    from sdr_tpu_torch.models.receiver import Receiver
    p = tmp_path / "s.u8"
    station_capture(0, stereo=False).tofile(p)
    real_step = Receiver.step

    def step(self, state, iq):
        state, out = real_step(self, state, iq)
        mono = out["mono"].clone()
        mono[..., 0] = float("nan")
        mono[..., 1] = 2.5          # 40960: past int16
        mono[..., 2] = -0.75
        out["mono"] = mono
        return state, out
    monkeypatch.setattr(Receiver, "step", step)
    assert tcli.main(["0", "1", "--stations", str(p), "--wav-dir",
                      str(tmp_path / "w"), "--device", "cpu"]) == 0
    _, w = read_wav(str(tmp_path / "w" / "station0.wav"))
    x = np.array([np.nan, 2.5, -0.75], np.float32)
    want = np.where(np.isnan(x), 0.0, x * 16384.0).astype(np.int16)
    np.testing.assert_array_equal(w[:3], want)
