"""The port's stereo-only and RDS-only receivers and the all-float32
feedforward chain against sdr_tpu's, across the modes: the plain torch
around MultiFIR, the feedforward estimators and the stacked audio
resampler."""

import numpy as np
import pytest

from sdr_tpu_torch.config import MODES

from test_torch_stereo_receiver import FAST, check_against_reference


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stereo_fast_matches_reference(mode):
    """Stereo without RDS on --fast: MultiFIR([chan, pilot]) + the
    feedforward engine + the stacked audio resample."""
    rx, out = check_against_reference(mode, dict(FAST, stereo=True))
    assert rx.stereo_bpf is not None and rx._audio_pair is None
    assert "rds_soft" not in out


def test_rds_fast_matches_reference():
    """RDS without stereo on the feedforward engine (mode 0)."""
    rx, out = check_against_reference(0, dict(FAST, rds=True))
    assert rx.rds_channel_filter is not None and "left" not in out


@pytest.mark.parametrize("mode", [0, 2])
def test_stereo_rds_ff_float32_matches_reference(mode):
    """The unfused feedforward chain in float32 throughout (MultiFIR x3,
    square + carrier BPF, pll_feedforward_multi): element-wise."""
    rx, out = check_against_reference(mode, dict(stereo=True, rds=True,
                                                 pll_impl="ff"))
    assert rx.if_bpf3 is not None and rx._ifbank is None
    assert np.isfinite(out["rds_soft"].numpy()).all()
