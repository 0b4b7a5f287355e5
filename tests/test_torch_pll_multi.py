"""`pll_loop_multi`, the sequential loops of one receiver step in one
launch, on the CPU: each instance equals its own single-loop call bit for
bit, and sdr_tpu's `pll` within the reference's loop gates; and the
receiver's sequential engines run both carrier loops through it, one call
a step.  On the CPU it runs the plain loop once per instance; the card's
tests hold the joint launch against two single launches
(tests/test_torch_cuda_pll.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops import pll as jpll
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.ops.cuda import pll_kernel as K
from test_torch_pll_loop import FS, assert_loop_close, tones

# the receiver's two loops: the pilot (19 kHz, scale 2) and the RDS
# carrier (114 kHz, scale 0.5, bandwidth 0.003)
PARAMS = ((19e3, FS, 2.0, 0.2, 0.01), (114e3, FS, 0.5, 0.0, 0.003))
VARIANTS = {"wrap": (True, True), "wrap_nolag": (True, False),
            "counter": (False, False), "counter_lag": (False, True)}


def inputs(n, seed):
    return (torch.from_numpy(tones(3, n, seed=seed)),
            torch.from_numpy(tones(2, n, seed=seed + 1, freqs=(114e3,))))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "poly"])
def test_multi_equals_single_calls(variant, exact):
    wrap, lag = VARIANTS[variant]
    xs = inputs(1500, seed=3)
    sts = tuple(tpll.pll_init(x.shape[:-1], device="cpu") for x in xs)
    flags = dict(wrap_phase=wrap, lag_correction=lag, exact=exact)
    ncos, news = K.pll_loop_multi(xs, sts, params=PARAMS, **flags)
    for x, st, (freq, fs, scale, adj, bw), nco, new in zip(
            xs, sts, PARAMS, ncos, news):
        want, wst = K.pll_loop(x, st, freq=freq, fs=fs, nco_scale=scale,
                               phase_adjust=adj, norm_bandwidth=bw, **flags)
        torch.testing.assert_close(nco, want, rtol=0, atol=0)
        for a, b in zip(new, wst):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        if exact:   # the scan engine itself
            want, wst = tpll.pll(x, st, freq=freq, fs=fs, nco_scale=scale,
                                 phase_adjust=adj, norm_bandwidth=bw,
                                 wrap_phase=wrap, lag_correction=lag)
            torch.testing.assert_close(nco, want, rtol=0, atol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_multi_matches_reference_per_instance(variant):
    """Each instance against sdr_tpu's scan `pll` with its parameters:
    nco within 2e-4, the state within 1e-3 (the reference's loop gates).
    In the counter mode XLA rounds the growing argument w0*trig + acc by
    an ulp of itself apart from the port (tests/test_torch_pll_loop.py);
    the RDS carrier's w0 is 6x the pilot's, so those runs stay within 320
    samples, where the argument is below 1000 rad."""
    wrap, lag = VARIANTS[variant]
    xs = inputs(3000 if wrap else 320, seed=11)
    sts = tuple(tpll.pll_init(x.shape[:-1], device="cpu") for x in xs)
    ncos, news = K.pll_loop_multi(xs, sts, params=PARAMS, wrap_phase=wrap,
                                  lag_correction=lag)
    for x, (freq, fs, scale, adj, bw), nco, new in zip(xs, PARAMS, ncos,
                                                       news):
        jout, jst = jpll.pll(jnp.asarray(x.numpy()),
                             jpll.pll_init(x.shape[:-1]), freq=freq, fs=fs,
                             nco_scale=scale, phase_adjust=adj,
                             norm_bandwidth=bw, wrap_phase=wrap,
                             lag_correction=lag)
        assert_loop_close(nco, new, jout, jst, 2 * np.pi / min(scale, 1.0))


def test_multi_refuses_mismatched_inputs():
    xs = inputs(64, seed=0)
    sts = tuple(tpll.pll_init(x.shape[:-1], device="cpu") for x in xs)
    with pytest.raises(ValueError, match="one entry each"):
        K.pll_loop_multi(xs, sts[:1], params=PARAMS)
    with pytest.raises(ValueError, match="share n"):
        K.pll_loop_multi((xs[0], xs[1][:, :32]), sts, params=PARAMS)


@pytest.mark.parametrize("kw", [dict(), dict(pll_impl="pallas"),
                                dict(compat_pll=True)],
                         ids=["scan", "pallas", "compat"])
def test_receiver_runs_both_loops_in_one_call(monkeypatch, kw):
    """The default profile, the 'pallas' engine and compat_pll call
    pll_loop_multi once a step for the pilot and RDS loops, with each
    engine's flags."""
    calls = []
    real = K.pll_loop_multi

    def spy(xs, states, **flags):
        calls.append(flags)
        return real(xs, states, **flags)
    monkeypatch.setattr(K, "pll_loop_multi", spy)
    rx = Receiver(0, stereo=True, rds=True, device="cpu", **kw)
    st = rx.init_state((1,))
    blk = torch.full((1, rx.block_size_u8()), 128, dtype=torch.uint8)
    for _ in range(2):
        st, _ = rx.step(st, blk)
    assert len(calls) == 2
    flags = calls[0]
    assert flags["exact"] == (kw.get("pll_impl") != "pallas")
    assert flags["wrap_phase"] == (not kw.get("compat_pll", False))
    assert flags["lag_correction"] == (not kw.get("compat_pll", False))
    assert [p[0] for p in flags["params"]] == [19e3, 114e3]
