"""The operating envelope on the port: tests/test_impairments.py's four
impaired captures (CFO, clock ppm, pilot phase noise and all of them at
a reduced RF SNR; 0.9 s, PI 0x3D44, PS "IMPAIR  ") through the full
stereo + RDS chain with the `--fast` engine set, in modes 0 and 2 (mode
2's RDS path is resampled to 35 samples a symbol, where clock ppm
stresses the fractional timing; tests/test_torch_envelope_mode2.py,
kept apart for tier-1 time).  The four rows run stacked as one
batched Receiver.run in each package, sdr_tpu's with its Pallas kernels
in interpret mode as its own tests run them.  Per row the port's stereo
separation and 1 kHz L SNR are within 0.1 dB of the reference's, the
streaming RDS decoder finds the same PI, PS and group count, and left,
right and rds_soft are within the `--fast` chain's 45 dB of the
reference's (tests/test_torch_stereo_receiver.py); in mode 0 the port
also meets the reference's own gates (tests/test_impairments.py:117-126).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

from sdr_tpu.config import MODES as JAX_MODES
from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.rds.streaming import StreamingRdsDecoder as JaxDecoder
from sdr_tpu.utils.compare import stereo_separation_db, tone_snr_db

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import bench_envelope_torch as env  # noqa: E402

ROWS = sorted(env.IMPAIRMENTS)


@functools.lru_cache(maxsize=None)
def runs(mode):
    """Both packages over the four rows of `mode`, one batched run each:
    (port outputs, port metrics, reference outputs, reference metrics)."""
    caps = env.captures(mode, [env.IMPAIRMENTS[r] for r in ROWS], 0.9,
                        env.IMPAIR_PS, env.IMPAIR_GROUPS)
    got = env.run(mode, caps, env.FAST, "cpu")
    rx = JaxReceiver(mode, stereo=True, rds=True, **env.FAST)
    jout, _ = rx.run(caps, blocks_per_step=8)
    want = {k: np.asarray(jout[k], np.float32)
            for k in ("left", "right", "rds_soft")}
    cfg = JAX_MODES[mode]
    skip = cfg.audio_fs // 4
    ref = []
    for r in range(len(ROWS)):
        left, right = want["left"][r], want["right"][r]
        dec = JaxDecoder(cfg.rds_sps)
        for i in range(0, want["rds_soft"].shape[-1], 2048):
            dec.push(want["rds_soft"][r, i:i + 2048])
        ref.append(dict(
            separation_db=float(stereo_separation_db(
                left, right, cfg.audio_fs, 1000.0, skip=skip)),
            snr_db=float(tone_snr_db(left[skip:], cfg.audio_fs, 1000.0)),
            pi=dec.info.pi, ps=dec.info.ps_name,
            groups=int(dec.info.groups_seen)))
    mets = [env.metrics(got["left"][r], got["right"][r],
                        got["rds_soft"][r], mode) for r in range(len(ROWS))]
    return got, mets, want, ref


def snr_db(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.mean(want * want)
                         / max(np.mean((want - got) ** 2), 1e-30))


def check_row(mode, row):
    """One row of `mode` held to the reference's run of it."""
    got, mets, want, ref = runs(mode)
    r = ROWS.index(row)
    m, j = mets[r], ref[r]
    assert abs(m["separation_db"] - j["separation_db"]) <= 0.1, (m, j)
    assert abs(m["snr_db"] - j["snr_db"]) <= 0.1, (m, j)
    assert (m["pi"], m["ps"], m["groups"]) == (j["pi"], j["ps"],
                                               j["groups"]), (m, j)
    for k in ("left", "right", "rds_soft"):
        assert got[k][r].shape == want[k][r].shape
        assert snr_db(want[k][r], got[k][r]) > 45.0, k


@pytest.mark.parametrize("row", ROWS)
def test_mode0_row_matches_reference(row):
    check_row(0, row)


@pytest.mark.parametrize("row", ROWS)
def test_mode0_meets_reference_gates(row):
    """tests/test_impairments.py's gates on the port's mode-0 rows."""
    m = runs(0)[1][ROWS.index(row)]
    assert m["separation_db"] > env.GATES["separation_db"], m
    assert m["snr_db"] > env.GATES["snr_db"], m
    assert m["pi"] == env.IMPAIR_PI, m
    assert m["groups"] >= env.GATES["groups"], m
    assert m["ps"] == env.IMPAIR_PS, m
