"""The port's CLI (mono) against sdr_tpu's, in-process on the same short
capture; the port runs with --device cpu."""

import numpy as np
import pytest
import torch

from sdr_tpu import cli as jcli
from sdr_tpu_torch import cli as tcli
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.io.wav import read_wav
from sdr_tpu_torch.utils.compare import tone_snr_db


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
    assert tcli.main([*argv, "--device", "cpu"]) == 2
    assert "not yet ported" in capsys.readouterr().err


def test_cli_refuses_missing_cuda(monkeypatch, capsys):
    """--device cuda (the default) without a card fails; it never moves to
    the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["0", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
