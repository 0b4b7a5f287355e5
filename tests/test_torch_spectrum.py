"""The port's spectrum survey (ops/spectrum.py) against sdr_tpu's: the
Bartlett PSD on the same capture, and the station list of find_stations
on the synthesized three-station capture of tests/test_channelizer.py
and on noise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import spectrum as jspec
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.ops import spectrum as tspec
from sdr_tpu_torch.ops.channelizer import synthesize_wideband


def three_stations():
    """tests/test_channelizer.py:106-136: three FM stations at -2.0, 0.5
    and 3.1 MHz with amplitudes 0.5, 0.25, 0.4, plus noise."""
    cfg = MODES[0]
    fs_st = float(cfg.rf_fs)
    fs_wide = 4 * fs_st
    freqs = [-2.0e6, 0.5e6, 3.1e6]
    amps = [0.5, 0.25, 0.4]
    n = int(0.08 * fs_st)
    stations = []
    for a, f in zip(amps, freqs):
        m = tx.make_multiplex(fs_st, n, mono=tx.tone(fs_st, 1000.0, n))
        i, q = tx.fm_modulate(m, fs_st)
        stations.append((i + 1j * q) * a)
    iw, qw = synthesize_wideband(stations, freqs, fs_st, fs_wide)
    rng = np.random.default_rng(3)
    iw = iw + 0.01 * rng.standard_normal(len(iw)).astype(np.float32)
    qw = qw + 0.01 * rng.standard_normal(len(qw)).astype(np.float32)
    return fs_wide, freqs, iw, qw


@pytest.mark.parametrize("nfft", [4096, 1024])
def test_psd_matches_reference(nfft):
    """Within 1e-3 dB on the bins above the noise floor (the median bin),
    where float32 FFTs in two libraries agree to a few ulps of the
    power; below it the floor's own rounding noise dominates."""
    fs_wide, freqs, iw, qw = three_stations()
    want = np.asarray(jspec.psd_complex(jnp.asarray(iw), jnp.asarray(qw),
                                        nfft=nfft))
    got = tspec.psd_complex(torch.from_numpy(iw), torch.from_numpy(qw),
                            nfft=nfft)
    assert got.dtype == torch.float32 and got.shape == want.shape
    above = want > np.median(want)
    assert above.sum() >= nfft // 4
    np.testing.assert_allclose(got.numpy()[above], want[above], rtol=0,
                               atol=1e-3)
    with pytest.raises(ValueError):
        tspec.psd_complex(torch.zeros(100), torch.zeros(100), nfft=nfft)


def test_find_stations_matches_reference():
    """The same list, strongest first, on the 100 kHz raster; with
    max_stations the strongest ones."""
    fs_wide, freqs, iw, qw = three_stations()
    want = jspec.find_stations(iw, qw, fs_wide)
    got = tspec.find_stations(iw, qw, fs_wide, device="cpu")
    assert got == want
    assert sorted(got) == sorted(freqs) and got[0] == -2.0e6
    assert tspec.find_stations(iw, qw, fs_wide, max_stations=2,
                               device="cpu") == want[:2]


def test_find_stations_empty_on_noise():
    rng = np.random.default_rng(4)
    iw = rng.standard_normal(1 << 19).astype(np.float32)
    qw = rng.standard_normal(1 << 19).astype(np.float32)
    assert jspec.find_stations(iw, qw, 9.6e6) == []
    assert tspec.find_stations(iw, qw, 9.6e6, device="cpu") == []
