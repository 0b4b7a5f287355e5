"""The port's CLI against sdr_tpu's, in-process on the same short
captures (mono, and stereo + RDS with --fast); the port runs with
--device cpu."""

import numpy as np
import pytest
import torch

from sdr_tpu import cli as jcli
from sdr_tpu_torch import cli as tcli
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.io.wav import read_wav
from sdr_tpu_torch.rds import tx as rds_tx
from sdr_tpu_torch.utils.compare import stereo_separation_db, tone_snr_db


@pytest.fixture(scope="module")
def cap_path(tmp_path_factory):
    cfg = MODES[0]
    n = int(0.2 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.2,
                                mono=tx.tone(cfg.rf_fs, 1000.0, n))
    path = tmp_path_factory.mktemp("cli") / "cap.raw"
    cap.tofile(path)
    return str(path)


def _run_both(cap_path, tmp_path, flags):
    common = ["0", "1", "--in", cap_path, "--blocks-per-step", "2", *flags]
    j, t = tmp_path / "j.raw", tmp_path / "t.raw"
    wav = tmp_path / "t.wav"
    assert jcli.main([*common, "--out", str(j)]) == 0
    assert tcli.main([*common, "--out", str(t), "--wav", str(wav),
                      "--device", "cpu"]) == 0
    a = np.fromfile(j, dtype="<i2").astype(np.int64)
    b = np.fromfile(t, dtype="<i2").astype(np.int64)
    rate, w = read_wav(str(wav))
    assert rate == 48000
    np.testing.assert_array_equal(w, b)
    return a, b


@pytest.mark.parametrize("flags", [[], ["--exact-fast"]])
def test_cli_exact_profiles_match_within_one_lsb(cap_path, tmp_path, flags):
    """f32 (default) and the exact-integer front end run f32 everywhere
    after the front end: the s16 stream agrees to +-1 LSB (a float32 last
    bit can move a truncation boundary)."""
    a, b = _run_both(cap_path, tmp_path, flags)
    assert len(a) == len(b) == 9600
    assert np.max(np.abs(a - b)) <= 1


def test_cli_fast_profile_agrees(cap_path, tmp_path):
    """--fast stores fm at bf16: a one-ulp bf16 flip can move a sample by
    several LSB, so the decoded audio is held to 40 dB SNR."""
    a, b = _run_both(cap_path, tmp_path, ["--fast"])
    assert len(a) == len(b)
    snr = 10 * np.log10(np.mean(a.astype(float) ** 2)
                        / max(np.mean((a - b).astype(float) ** 2), 1e-30))
    assert snr > 40.0, f"{snr:.1f} dB"
    assert tone_snr_db(b, 48000, 1000.0, skip=2400) > 20.0


def test_cli_invalid_mode(capsys):
    assert tcli.main(["7", "1"]) == 1
    assert "Invalid mode: 7!" in capsys.readouterr().err


def test_cli_short_input(tmp_path, capsys):
    """Less than one block: no audio, exit 0 (sdr_tpu's behaviour)."""
    src, out = tmp_path / "short.raw", tmp_path / "out.raw"
    np.full(1000, 128, np.uint8).tofile(src)
    assert tcli.main(["0", "1", "--in", str(src), "--out", str(out),
                      "--device", "cpu"]) == 0
    assert "End of input stream reached!" in capsys.readouterr().err
    assert out.stat().st_size == 0


@pytest.mark.parametrize("argv", [["0", "2"], ["0", "1", "--rds"]])
def test_cli_stereo_and_rds_not_yet_ported(argv, capsys):
    """Without --fast, stereo and RDS need the sequential PLL: exit 2 with
    the ROADMAP.md pointer to the PLL slice."""
    assert tcli.main([*argv, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and "ROADMAP.md" in err
    assert "PLL slice" in err


@pytest.fixture(scope="module")
def stereo_cap_path(tmp_path_factory):
    """0.6 s: L 1 kHz, R 2.5 kHz, RDS PI 0x3d44 'TPU FM  '."""
    cfg = MODES[0]
    n = int(0.6 * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="TPU FM  ",
                                        n_groups=8)
    cap = tx.synthesize_capture(
        cfg, seconds=0.6, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)
    path = tmp_path_factory.mktemp("cli_stereo") / "cap.raw"
    cap.tofile(path)
    return str(path)


def test_cli_stereo_rds_fast(stereo_cap_path, tmp_path, capsys):
    """`0 2 --rds --fast`: interleaved (R, L) s16 that agrees with the
    reference's at 40 dB (the chain is bf16), a WAV in (L, R) order with
    the tones on their sides, and the reference's RDS lines on stderr."""
    common = ["0", "2", "--rds", "--fast", "--in", stereo_cap_path,
              "--blocks-per-step", "2"]
    j, t, wav = tmp_path / "j.raw", tmp_path / "t.raw", tmp_path / "t.wav"
    assert jcli.main([*common, "--out", str(j)]) == 0
    jerr = capsys.readouterr().err
    assert tcli.main([*common, "--out", str(t), "--wav", str(wav),
                      "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    a = np.fromfile(j, dtype="<i2").astype(np.float64)
    b = np.fromfile(t, dtype="<i2").astype(np.float64)
    assert len(a) == len(b) and len(b) % 2 == 0 and len(b) > 40000
    snr = 10 * np.log10(np.mean(a * a) / max(np.mean((a - b) ** 2), 1e-30))
    assert snr > 40.0, f"{snr:.1f} dB"
    right, left = b[0::2], b[1::2]
    rate, frames = read_wav(str(wav))
    assert rate == 48000 and frames.shape == (len(b) // 2, 2)
    np.testing.assert_array_equal(frames[:, 0], left)
    np.testing.assert_array_equal(frames[:, 1], right)
    skip = rate // 4
    assert tone_snr_db(left, rate, 1000.0, skip=skip) > 20.0
    assert tone_snr_db(right, rate, 2500.0, skip=skip) > 20.0
    assert stereo_separation_db(left, right, rate, 1000.0, skip=skip) > 20.0
    assert "Operating in mode 0, stereo + RDS" in err
    final = [ln for ln in err.splitlines() if ln.startswith("RDS final:")]
    assert len(final) == 1 and "PI=0x3d44" in final[0]
    assert "PS='TPU FM  '" in final[0]
    jfinal = [ln for ln in jerr.splitlines() if ln.startswith("RDS final:")]
    assert jfinal == final
    live = [ln for ln in err.splitlines() if ln.startswith("RDS: PI=")]
    assert live == [ln for ln in jerr.splitlines()
                    if ln.startswith("RDS: PI=")]


def test_cli_rds_on_mode_without_rds_runs_mono(tmp_path, capsys):
    """`--rds` on mode 1 (no RDS there) runs the mono receiver, as the
    reference does."""
    cfg = MODES[1]
    n = int(0.1 * cfg.rf_fs)
    src = tmp_path / "cap.raw"
    tx.synthesize_capture(cfg, seconds=0.1,
                          mono=tx.tone(cfg.rf_fs, 1000.0, n)).tofile(src)
    outs = []
    for flags in ([], ["--rds"]):
        out = tmp_path / f"out{len(flags)}.raw"
        assert tcli.main(["1", "1", *flags, "--in", str(src), "--out",
                          str(out), "--device", "cpu"]) == 0
        outs.append(np.fromfile(out, dtype="<i2"))
        err = capsys.readouterr().err
        assert "Operating in mode 1, mono\n" in err and "RDS" not in err
    assert len(outs[0]) > 0
    np.testing.assert_array_equal(outs[0], outs[1])


def test_cli_refuses_missing_cuda(monkeypatch, capsys):
    """--device cuda (the default) without a card fails; it never moves to
    the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["0", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
