"""The port's PolyphaseResampler (the conv engine) against sdr_tpu's
PolyphaseResampler and TiledBandedFIR, in the RF and the four modes' audio
geometries, over a two-block carry, on numpy-seeded inputs.  The tiled
engine's own tests, the bf16 profile among them, are in
test_torch_banded.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops.banded import TiledBandedFIR as JaxTiled
from sdr_tpu.ops.resample import PolyphaseResampler as JaxResampler
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.resample import PolyphaseResampler


def _geometries():
    cfg = MODES[0]
    out = [("rf", firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1), 1,
            cfg.rf_decim)]
    for m, cfg in MODES.items():
        coeff = firdes.lowpass(cfg.if_fs * cfg.audio_interp, cfg.audio_fc,
                               cfg.audio_taps, cfg.audio_gain)
        out.append((f"audio{m}", coeff, cfg.audio_interp, cfg.audio_decim))
    return out


GEOMETRIES = _geometries()
IDS = [g[0] for g in GEOMETRIES]


def _blocks(down, seed):
    n = down * (64 if down <= 10 else 4)
    x = np.random.default_rng(seed).normal(0, 0.5, (2, 2 * n))
    x = x.astype(np.float32)
    return [x[:, :n], x[:, n:]]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_resampler_f32_matches_both_engines(geom):
    _, coeff, up, down = geom
    port = PolyphaseResampler(coeff, up, down, device="cpu")
    for ref in (JaxResampler(coeff, up, down), JaxTiled(coeff, up, down)):
        assert port.state_len == ref.state_len
        jt, tt = ref.init_state((2,)), port.init_state((2,))
        assert tt.dtype == torch.float32 and tt.shape == jt.shape
        for x in _blocks(down, seed=up + down):
            jy, jt = ref(jnp.asarray(x), jt)
            ty, tt = port(torch.from_numpy(x), tt)
            assert ty.shape == jy.shape and ty.dtype == torch.float32
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_resampler_rejects_bad_block():
    port = PolyphaseResampler(firdes.lowpass(240e3, 16e3, 51, 1), 1, 5,
                              device="cpu")
    with pytest.raises(ValueError):
        port(torch.zeros(1, 12), port.init_state((1,)))
    with pytest.raises(ValueError):
        PolyphaseResampler(np.ones(5), 4, 2, device="cpu")
