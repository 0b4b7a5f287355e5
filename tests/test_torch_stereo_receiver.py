"""The port's stereo + RDS Receiver.run against sdr_tpu's on the same
stereo tone + RDS capture, in the fused `--fast` profiles (IF bank + mix
sums, carrier synthesis + mixers and audio pair, which the reference runs
as Pallas kernels in interpret mode) and with each fused stage unfused."""

import functools

import jax
import numpy as np
import pytest
import torch

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.rds import tx as rds_tx

FAST = dict(fused_frontend="int8", pll_impl="ff", conv_dtype="bf16",
            conv_engine="tiled")
BENCH = dict(FAST, stereo=True, rds=True, fused_ifbank="bf16")
PROFILES = {
    # the CLI's `0 2 --rds --fast`, bench.py's stereo + RDS chain
    "fast": BENCH,
    # `--fast --exact-fast`: int8x2 front end, fm at f32, bf16 IF bank
    "fast_exact": dict(BENCH, fused_frontend="int8x2"),
    # every fused kernel in float32: exact front end, f32 IF bank and convs
    "fused_f32": dict(stereo=True, rds=True, pll_impl="ff",
                      fused_frontend="int8x2", fused_ifbank=True,
                      conv_engine="tiled"),
    # the unfused feedforward chains
    "unfused_synth": dict(BENCH, fused_synth=False),
    "unfused_ifbank": dict(BENCH, fused_ifbank=False),
}


@functools.lru_cache(maxsize=None)
def capture(mode, seconds=0.3, rds=True):
    """A stereo capture (L 1 kHz, R 2.5 kHz) with RDS (PI 0x3d44) where the
    mode has it."""
    cfg = MODES[mode]
    n = int(seconds * cfg.rf_fs)
    kw = dict(left=tx.tone(cfg.rf_fs, 1000.0, n),
              right=tx.tone(cfg.rf_fs, 2500.0, n))
    if rds and cfg.rds_sps is not None:
        bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="TPU FM  ",
                                            n_groups=8)
        kw.update(rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
                  a_rds=0.1)
    return tx.synthesize_capture(cfg, seconds=seconds, **kw)


def spans(rx, n, blocks_per_step):
    """The (offset, size) steps of Receiver.run, its EOF flush included."""
    bs, align = rx.block_size_u8(blocks_per_step), rx.block_align_u8()
    nb = n // bs
    tail = ((n - nb * bs) // align) * align
    return [(b * bs, bs) for b in range(nb)] + ([(nb * bs, tail)]
                                               if tail else [])


def jax_run(rx, cap, blocks_per_step, state=None):
    """The reference's run as a loop of jitted steps over run's spans.
    Its own run() scans, and the scan refuses the stereo-only and unfused
    fast profiles, whose band-pass tail starts at float32 and becomes bf16
    (ROADMAP.md queue C); the steps are the same."""
    step = jax.jit(rx.step)
    st = rx.init_state() if state is None else state
    outs: dict[str, list] = {}
    for off, size in spans(rx, len(cap), blocks_per_step):
        st, out = step(st, cap[off:off + size])
        for k, v in out.items():
            outs.setdefault(k, []).append(np.asarray(v, np.float32))
    return {k: np.concatenate(v, axis=-1) for k, v in outs.items()}, st


def snr_db(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.mean(want * want)
                         / max(np.mean((want - got) ** 2), 1e-30))


def assert_close(got, want, rel, bf16=False):
    """|got - want| <= rel * max|want|, plus one bf16 ulp (2^-7 of the
    value) where the stream is stored at bf16."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = rel * max(np.abs(want).max(), 1e-30)
    if bf16:
        bound = bound + 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def leaves(state):
    return jax.tree.leaves(state,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))


def check_against_reference(mode, kw, blocks_per_step=2, seconds=0.3):
    """Run both packages on one capture and hold the port to the bounds of
    the chain: bf16 chains to 45 dB SNR on left / right / rds_soft (the
    reference's own bar for its fused vs unfused chains; a float32 last
    bit can flip a bf16 rounding) and mono to the bound that
    test_torch_receiver.py holds the --fast mono profile to (80 dB, fm
    within 1e-5 plus one bf16 ulp); float32 chains
    element-wise within 1e-5 of max|ref|.  With a carrier loop engine
    (pll_impl other than 'ff', or compat_pll) left / right / rds_soft are
    held to 45 dB in every chain: the loops feed their error back, so an
    ulp of difference in a detector input moves the acquisition transient
    by more than 1e-5 (it settles to the same lock).  The final states
    agree leaf for leaf in shape and dtype, and in value within 1e-5
    (float32 chains) or 1e-4 (bf16 chains) of 1+|x|, plus one bf16 ulp on
    bf16 leaves; a loop's phase_acc is compared modulo its wrap period.
    With compat_pll the NCO argument w0*trig grows to w0*n rad and XLA
    rounds it differently by an ulp of itself (it fuses the multiply-add),
    so the leaves downstream of the carriers (the loops' states and the
    tails after the mixers, `POST_CARRIER`) may also move by two ulps of
    the largest such argument; the front-end, mono and band-pass leaves
    keep their bound."""
    cap = capture(mode, seconds, rds=kw.get("rds", False))
    kw = dict(emit_if=True, **kw)
    jrx, trx = JaxReceiver(mode, **kw), Receiver(mode, **kw, device="cpu")
    assert trx.block_align_u8() == jrx.block_align_u8()
    assert trx.block_size_u8(blocks_per_step) == jrx.block_size_u8(
        blocks_per_step)
    jout, jst = jax_run(jrx, cap, blocks_per_step)
    tout, tst = trx.run(cap, blocks_per_step=blocks_per_step)
    assert set(tout) == set(jout)
    bf16_chain = kw.get("conv_dtype") == "bf16"
    loop = trx.compat_pll or trx.pll_impl != "ff"
    assert_close(tout["fm_demod"].float(), jout["fm_demod"], 1e-5,
                 trx._mat_bf16)
    for k in set(tout) - {"fm_demod"}:
        got = tout[k].float().numpy()
        assert got.shape == jout[k].shape, k
        if not bf16_chain and not (loop and k != "mono"):
            assert_close(got, jout[k], 1e-5)
        else:
            floor = 80.0 if k == "mono" else 45.0
            assert snr_db(jout[k], got) > floor, (k, snr_db(jout[k], got))
    extra = 0.0
    if loop:
        tst, jst = wrap_loop_phases(tst, jst)
    if trx.compat_pll:
        cfg = trx.cfg
        freq = cfg.rds_carrier_freq if trx.rds else cfg.pilot_freq
        arg = 2 * np.pi * freq / cfg.if_fs * (len(cap) // (2 * cfg.rf_decim))
        extra = 2 * float(np.spacing(np.float32(arg)))
    tl, jl = leaves(tst), jax.tree.leaves(jst)
    assert len(tl) == len(jl)
    post = list(post_carrier_flags(tst))
    assert len(post) == len(tl)
    rel = 1e-4 if bf16_chain else 1e-5
    for t, j, downstream in zip(tl, jl, post):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        if t.dtype == torch.uint8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            continue
        b = np.asarray(j, np.float64)
        bound = rel * (1 + np.abs(b)) + (extra if downstream else 0.0)
        if t.dtype == torch.bfloat16:
            bound = bound + 2.0 ** -7 * np.abs(b)
        assert np.all(np.abs(t.double().numpy() - b) <= bound)
    return trx, tout


# state fields computed from a carrier loop: its state, and the tails of
# the streams after the mixers
POST_CARRIER = {"pll", "stereo_audio_tail", "deemph_l", "deemph_r",
                "lpf_resamp_tail", "rrc_tail"}


def post_carrier_flags(state, downstream=False):
    """For each leaf of the port's state, in `leaves` order: whether it is
    computed from a carrier loop's NCO."""
    for name, v in zip(state._fields, state):
        if v is None:
            continue
        inner = downstream or name in POST_CARRIER
        if isinstance(v, tuple):
            yield from post_carrier_flags(v, inner)
        else:
            yield inner


def wrap_loop_phases(tst, jst):
    """The port's state with each carrier loop's phase_acc moved by whole
    wrap periods (2 pi for the pilot, 4 pi for the RDS carrier) to the
    reference's value nearest it: a phase at the wrap edge can land on
    either side."""
    def near(t, j, period):
        j = torch.from_numpy(np.array(j, np.float32))
        return t - period * torch.round((t - j) / period)
    parts = {}
    for name, period in (("stereo", 2 * np.pi), ("rds", 4 * np.pi)):
        t, j = getattr(tst, name), getattr(jst, name)
        if t is not None:
            pll = t.pll._replace(phase_acc=near(t.pll.phase_acc,
                                                j.pll.phase_acc, period))
            parts[name] = t._replace(pll=pll)
    return tst._replace(**parts), jst


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_stereo_rds_fast_profiles_match_reference(profile):
    rx, _ = check_against_reference(0, PROFILES[profile])
    fused = profile not in ("unfused_synth", "unfused_ifbank")
    assert rx._fused_synth == fused
    assert (rx._audio_pair is not None) == fused
    assert rx._ifbank_mix == (profile != "unfused_ifbank")


def test_mode2_fast_stereo_rds_matches_reference():
    """Mode 2: the fused IF bank and synthesis run, and the audio pair
    declines the rational 147/800 ratio (the stacked resampler runs)."""
    rx, _ = check_against_reference(2, BENCH)
    assert rx._fused_synth and rx._audio_pair is None
