"""The carrier-loop kernels (the sequential loop, the chunked loop for one
and two instances, the four-stream IF bank) against their plain PyTorch
versions on the card, and the default-profile receiver on the card
against the same receiver on the CPU.  Marked `cuda`; without a CUDA
device every test skips.  This file imports neither jax nor sdr_tpu, so
on the GPU machine run it without the tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pll.py
"""

import numpy as np
import pytest
import torch

import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.cuda import pll_kernel as K
from sdr_tpu_torch.ops.cuda.build import LAUNCHES
from sdr_tpu_torch.ops.cuda.ifbank_kernel import FusedIFBank, ifbank_reference
from sdr_tpu_torch.ops.pll import pll_init

pytestmark = pytest.mark.cuda
FS = 240e3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tones(c, n, freq, dev, seed=0):
    """Locked-loop inputs: tones with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = (0.3 * np.cos(2 * np.pi * freq * t + rng.uniform(0, 6, (c, 1)))
         + rng.normal(0, 0.02, (c, n)))
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def same(got, want, nco_atol):
    """nco within nco_atol, the state within 1e-3 (the reference's gates
    for its loop kernels)."""
    (gn, gs), (wn, ws) = got, want
    torch.cuda.synchronize()
    assert gn.dtype == wn.dtype == torch.float32 and gn.shape == wn.shape
    assert (gn - wn).abs().max().item() <= nco_atol
    for a, b in zip(gs, ws):
        assert (a - b).abs().max().item() <= 1e-3


@pytest.mark.parametrize("n", [2048, 2047, 3])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("wrap,lag", [(True, True), (False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequential_loop_equals_plain(dev, n, exact, wrap, lag, dtype):
    """Every operation rounds as in the plain loop, and both call libm or
    the same polynomial: the kernel equals it bit for bit.  Rows of a
    length that is not a multiple of 4 start off a vector boundary, and
    n = 3 is shorter than one ring tile.  The input is a contiguous view 1
    element past the start of its allocation."""
    c = 37
    flat = tones(1, c * n + 1, 19e3, dev).to(dtype).reshape(-1)
    x = flat[1:].reshape(c, n)
    assert x.is_contiguous() and x.data_ptr() % 16
    kw = dict(freq=19e3, fs=FS, nco_scale=2.0, phase_adjust=0.2,
              wrap_phase=wrap, lag_correction=lag, exact=exact)
    before = LAUNCHES["pll"]
    got = K.pll_loop(x, pll_init((c,), dev), **kw)
    assert LAUNCHES["pll"] == before + 1
    same(got, K.pll_kernel_reference(x, pll_init((c,), dev), **kw), 0.0)


@pytest.mark.parametrize("n", [2048, 2047, 33])
@pytest.mark.parametrize("exact,wrap,lag", [(True, True, True),
                                            (False, True, True),
                                            (True, False, False),
                                            (True, True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_joint_launch_equals_single_launches(dev, n, exact, wrap, lag,
                                             dtype):
    """pll_loop_multi: two instances with different parameters and channel
    counts (the pilot loop, 37 channels; the RDS carrier loop, 20) in one
    launch equal their own single launches bit for bit, nco and state, for
    n on and off a vector boundary and n = 33, one ring tile and a sample."""
    xs = (tones(37, n, 19e3, dev).to(dtype),
          tones(20, n, 114e3, dev, seed=1).to(dtype))
    sts = (pll_init((37,), dev), pll_init((20,), dev))
    params = ((19e3, FS, 2.0, 0.2, 0.01), (114e3, FS, 0.5, 0.0, 0.003))
    flags = dict(wrap_phase=wrap, lag_correction=lag, exact=exact)
    before = LAUNCHES["pll"]
    ncos, news = K.pll_loop_multi(xs, sts, params=params, **flags)
    assert LAUNCHES["pll"] == before + 1
    for x, st, (freq, fs, scale, adj, bw), nco, new in zip(
            xs, sts, params, ncos, news):
        want, wst = K.pll_loop(x, st, freq=freq, fs=fs, nco_scale=scale,
                               phase_adjust=adj, norm_bandwidth=bw, **flags)
        torch.cuda.synchronize()
        assert torch.equal(nco, want)
        for a, b in zip(new, wst):
            assert torch.equal(a, b)


def test_chain_floor_runs_the_loop(dev):
    """The chain-floor microbenchmark runs the same recurrence: its final
    state equals the plain loop's bit for bit, and it counts cycles and
    nanoseconds."""
    x = tones(1, 4096, 19e3, dev)[0]
    st = pll_init((), dev)
    params = (19e3, FS, 2.0, 0.0, 0.01)
    cps, nps, fin = K.chain_floor(x, st, params=params)
    _, want = K.pll_kernel_reference(x, st, freq=19e3, fs=FS, nco_scale=2.0)
    assert cps > 0 and nps > 0
    assert torch.equal(fin, torch.stack(list(want)))


@pytest.mark.parametrize("chunk,exact,groups", [(16, True, 1),
                                                (32, False, 1),
                                                (32, False, 2)])
def test_chunk_floor_runs_the_loop(dev, chunk, exact, groups):
    """The chunked loop's chain-floor microbenchmark runs the same chain:
    its final state (integ, acc, cos acc, sin acc) equals the chunked
    kernel's bit for bit, and the plain chunked loop's within 1e-3 (the
    butterfly sums in another order than cumsum); it counts cycles and
    nanoseconds."""
    n = 4096
    params = ((19e3, FS, 2.0, 0.0, 0.01), (114e3, FS, 0.5, 0.0, 0.003))
    params = params[:groups]
    xs = tuple(tones(1, n, p[0], dev, seed=g)[0]
               for g, p in enumerate(params))
    sts = tuple(pll_init((), dev) for _ in params)
    cps, nps, fin = K.chunk_floor(xs, sts, params=params, chunk=chunk,
                                  exact=exact)
    assert cps > 0 and nps > 0 and fin.shape == (groups, 4)
    before = dict(LAUNCHES)
    _, news = K.pll_chunked_loop(tuple(x[None] for x in xs),
                                 tuple(pll_init((1,), dev) for _ in params),
                                 params=params, chunk=chunk, exact=exact)
    _, plain = K.pll_chunked_kernel_reference(
        tuple(x[None] for x in xs), tuple(pll_init((1,), dev) for _ in params),
        params=params, chunk=chunk, exact=exact)
    torch.cuda.synchronize()
    key = "pll_chunked" if groups == 1 else "pll_chunked_multi"
    assert LAUNCHES[key] == before[key] + 1
    for g in range(groups):
        assert torch.equal(fin[g], torch.stack([s[0] for s in news[g][:4]]))
        want = torch.stack([s[0] for s in plain[g][:4]])
        assert (fin[g] - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("lag", [True, False])
def test_chunked_loop_matches_plain(dev, chunk, groups, dtype, exact, lag):
    """The chunked kernel (its sums in the butterfly and pair-scan order,
    not cumsum's: 2e-4) for one instance (64 channels) and two (the pilot
    loop and the RDS carrier loop, 20 channels: a chain warp's segments
    across both instances at chunk 16), float32 and bf16 inputs, libm
    atan2f and the polynomial, lag correction on and off; chunk 64 runs
    two sub-blocks a chunk (bandwidth 0.003, below the chaotic range)."""
    bw = 0.01 if chunk <= 32 else 0.003
    params = ((19e3, FS, 2.0, 0.1, bw), (114e3, FS, 0.5, 0.0, 0.003))
    xs = (tones(64, 3200, 19e3, dev).to(dtype),
          tones(20, 3200, 114e3, dev, seed=1).to(dtype))[:groups]
    sts = (pll_init((64,), dev), pll_init((20,), dev))[:groups]
    args = dict(params=params[:groups], chunk=chunk, exact=exact,
                lag_correction=lag)
    key = "pll_chunked" if groups == 1 else "pll_chunked_multi"
    before = LAUNCHES[key]
    got = K.pll_chunked_loop(xs, sts, **args)
    assert LAUNCHES[key] == before + 1
    want = K.pll_chunked_kernel_reference(xs, sts, **args)
    for g in range(groups):
        same((got[0][g], got[1][g]), (want[0][g], want[1][g]), 2e-4)


def test_joint_loop_matches_plain(dev):
    xs = (tones(32, 3200, 19e3, dev), tones(16, 3200, 114e3, dev, seed=1))
    sts = (pll_init((32,), dev), pll_init((16,), dev))
    params = ((19e3, FS, 2.0, 0.0, 0.01), (114e3, FS, 0.5, 0.0, 0.003))
    before = LAUNCHES["pll_chunked_multi"]
    got = K.pll_pallas_chunked_multi(xs, sts, params=params, chunk=32)
    assert LAUNCHES["pll_chunked_multi"] == before + 1
    want = K.pll_chunked_kernel_reference(xs, sts, params=params, chunk=32)
    for g in range(2):
        same((got[0][g], got[1][g]), (want[0][g], want[1][g]), 2e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_four_stream_ifbank_matches_plain(dev, bf16):
    cfg = MODES[0]
    bp = lambda lo, hi: firdes.bandpass(cfg.if_fs, lo, hi, cfg.bp_taps)
    dt = torch.bfloat16 if bf16 else torch.float32
    bank = FusedIFBank(
        bp(cfg.stereo_lo, cfg.stereo_hi), bp(cfg.pilot_lo, cfg.pilot_hi),
        bp(cfg.rds_lo, cfg.rds_hi), bp(cfg.rds_carrier_lo, cfg.rds_carrier_hi),
        compute_dtype=dt, out_dtype=dt if bf16 else None, device=dev)
    fm = tones(8, 4096, 38e3, dev).to(dt)
    tail = bank.init_state((8,))
    got, want = bank(fm, tail), ifbank_reference(bank, fm, tail)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        d = (g.double() - w.double()).abs()
        bound = (1e-3 if bf16 and k == 3 else 1e-5) * w.double().abs().max()
        if bf16:
            bound = bound + 2.0 ** -7 * w.double().abs()
        assert bool((d <= bound).all()), k


def test_default_profile_receiver_card_vs_cpu(dev):
    """Receiver(0, stereo=True, rds=True) on one station of a 0.3 s stereo
    capture: the card (the sequential kernel) against the CPU (the plain
    loop) at 45 dB on left, right and rds_soft."""
    cfg = MODES[0]
    n = int(0.3 * cfg.rf_fs)
    cap = tx.synthesize_capture(cfg, seconds=0.3,
                                left=tx.tone(cfg.rf_fs, 1000.0, n),
                                right=tx.tone(cfg.rf_fs, 2500.0, n))
    rx = Receiver(0, stereo=True, rds=True, device=dev)
    before = LAUNCHES["pll"]
    gout, _ = rx.run(torch.from_numpy(cap), blocks_per_step=4)
    # one joint launch of both loops a step
    bs = rx.block_size_u8(4)
    steps = len(cap) // bs + int(len(cap) % bs >= rx.block_align_u8())
    assert LAUNCHES["pll"] == before + steps
    wout, _ = Receiver(0, stereo=True, rds=True, device="cpu").run(
        torch.from_numpy(cap), blocks_per_step=4)
    for k in ("left", "right", "rds_soft"):
        g = gout[k].double().cpu().numpy()
        w = wout[k].double().numpy()
        snr = 10 * np.log10(np.mean(w * w) / max(np.mean((g - w) ** 2),
                                                  1e-30))
        assert snr > 45.0, (k, snr)
