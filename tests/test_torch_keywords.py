"""The keywords the port takes from the reference's signatures and that
set nothing on the card: pll_feedforward's `norm_bandwidth` (the
reference's own "for signature compatibility"), the scan's `unroll`, and
the TPU-lowering knobs `tile`, `out_tile`, `sub_tiles`, pll_pallas's
`chunk` and `interpret`, with demod_call's input under the reference's
name `u8_block`.  Each call with them is bit-equal to the call without
them on the CPU (tests/test_torch_coverage.py checks that every
reference parameter is taken); on the card, interpret=True still
launches the kernel (marked `cuda`, skipped without a card)."""

import numpy as np
import pytest
import torch

from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops import pll as tpll
from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
from sdr_tpu_torch.ops.cuda import (audio_kernel, ffmix_kernel,
                                    frontend_kernel, ifbank_kernel,
                                    pll_kernel)
from sdr_tpu_torch.parallel.mesh import make_mesh
from sdr_tpu_torch.parallel.wideband import sharded_wideband_run

CFG = MODES[0]
CPU = torch.device("cpu")


def assert_same(a, b):
    """Two results equal bit for bit, through tuples, NamedTuples and
    dicts."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    else:
        assert a == b


def tones(c=3, n=2048, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / CFG.if_fs
    x = 0.4 * np.cos(2 * np.pi * 19e3 * t[None] + rng.uniform(0, 6, (c, 1)))
    return torch.from_numpy((x + rng.normal(0, 0.01, x.shape))
                            .astype(np.float32))


def state(c=3):
    return tpll.pll_init((c,), device=CPU)


LOOP = dict(freq=19e3, fs=float(CFG.if_fs), nco_scale=2.0,
            phase_adjust=0.1)


def case_pll_feedforward():
    x = tones()
    return (lambda **kw: tpll.pll_feedforward(x, state(), **LOOP, **kw),
            dict(norm_bandwidth=0.02))


def case_pll():
    x = tones(n=512)
    return (lambda **kw: tpll.pll(x, state(), **LOOP, **kw), dict(unroll=2))


def case_pll_pallas():
    x = tones(n=512)
    return (lambda **kw: pll_kernel.pll_pallas(x, state(), **LOOP, **kw),
            dict(chunk=64, interpret=True))


def case_pll_pallas_chunked():
    x = tones(n=512)
    return (lambda **kw: pll_kernel.pll_pallas_chunked(
        x, state(), chunk=32, **LOOP, **kw), dict(interpret=True))


def case_pll_pallas_chunked_multi():
    xs = (tones(n=512), tones(n=512, seed=1))
    prm = ((19e3, float(CFG.if_fs), 2.0, 0.0, 0.01),
           (114e3, float(CFG.if_fs), 0.5, 0.0, 0.0025))
    return (lambda **kw: pll_kernel.pll_pallas_chunked_multi(
        xs, (state(), state()), params=prm, **kw), dict(interpret=True))


def case_ffmix():
    rng = np.random.default_rng(3)
    c, n, w = 3, 2048, 256
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(0, 0.3, s).astype(np.float32))
    args = (t(c, n), t(c, n), t(c, 128), (t(c, n // w), t(c, n // w)),
            (t(c, n // w), t(c, n // w)))
    kw0 = dict(n=n, window=w, pilot_freq=float(CFG.pilot_freq),
               rds_freq=float(CFG.rds_carrier_freq), fs=float(CFG.if_fs),
               delay=25)
    return (lambda **kw: ffmix_kernel.ffmix(*args, **kw0, **kw),
            dict(tile=512, interpret=True))


def case_pair_decim_fir():
    coeff = firdes.lowpass(CFG.if_fs, CFG.audio_fc, CFG.audio_taps, 1)
    rng = np.random.default_rng(4)
    xa, xb = (torch.from_numpy(rng.normal(0, 0.5, (3, 1280))
                               .astype(np.float32)) for _ in range(2))

    def call(tile=None, interpret=None):
        extra = {} if tile is None else dict(tile=tile)
        p = audio_kernel.PairDecimFIR(coeff, CFG.audio_decim, device="cpu",
                                      **extra)
        ta, tb = p.init_state((3,)), p.init_state((3,))
        if interpret is None:
            return p(xa, xb, ta, tb)
        return p(xa, xb, ta, tb, interpret=interpret)
    return call, dict(tile=1024, interpret=True)


def u8_blocks(c=2, n=2 * 10 * 512):
    caps = [tx.synthesize_capture(CFG, seconds=(n // 2 + 64) / CFG.rf_fs,
                                  seed=s, noise_db=-20.0,
                                  mono=tx.tone(CFG.rf_fs, 900.0, n // 2 + 64))
            [:n] for s in range(c)]
    return torch.from_numpy(np.stack(caps))


def case_frontend_call():
    coeff = firdes.lowpass(CFG.rf_fs, CFG.rf_fc, CFG.rf_taps, 1)
    u8 = u8_blocks()

    def call(out_tile=None, sub_tiles=None, interpret=None):
        if out_tile is None:
            fe = frontend_kernel.FusedFrontend(coeff, CFG.rf_decim,
                                               compute_dtype="int8",
                                               device="cpu")
            return fe(u8, fe.init_state((2,)))
        fe = frontend_kernel.FusedFrontend(
            coeff, CFG.rf_decim, out_tile, compute_dtype="int8",
            sub_tiles=sub_tiles, device="cpu")
        return fe(u8_block=u8, tail=fe.init_state((2,)),
                  interpret=interpret)
    return call, dict(out_tile=1024, sub_tiles=8, interpret=True)


def case_frontend_demod_call():
    coeff = firdes.lowpass(CFG.rf_fs, CFG.rf_fc, CFG.rf_taps, 1)
    u8 = u8_blocks()
    fe = frontend_kernel.FusedFrontend(coeff, CFG.rf_decim,
                                       compute_dtype="int8x2", device="cpu")
    prev = (torch.zeros(2), torch.zeros(2))

    def call(interpret=None):
        if interpret is None:
            return fe.demod_call(u8, fe.init_state((2,)), *prev)
        return fe.demod_call(u8_block=u8, tail=fe.init_state((2,)),
                             prev_i=prev[0], prev_q=prev[1],
                             interpret=interpret)
    return call, dict(interpret=True)


def bank_coeffs():
    bp = lambda lo, hi: firdes.bandpass(CFG.if_fs, lo, hi,  # noqa: E731
                                        CFG.bp_taps)
    return (bp(CFG.stereo_lo, CFG.stereo_hi), bp(CFG.pilot_lo, CFG.pilot_hi),
            bp(CFG.rds_lo, CFG.rds_hi),
            bp(CFG.rds_carrier_lo, CFG.rds_carrier_hi))


def case_ifbank_call():
    fm = tones(n=1024)

    def call(**kw):
        call_kw = {"interpret": kw.pop("interpret")} if kw else {}
        bank = ifbank_kernel.FusedIFBank(*bank_coeffs(),
                                         compute_dtype=torch.bfloat16,
                                         device="cpu", **kw)
        return bank(fm, bank.init_state((3,)), **call_kw)
    return call, dict(out_tile=1024, sub_tiles=2, interpret=True)


def case_ifbank_mix_call():
    fm = tones(n=1024)

    def call(**kw):
        call_kw = {"interpret": kw.pop("interpret")} if kw else {}
        bank = ifbank_kernel.FusedIFBankMix(
            *bank_coeffs(), window=256, pilot_freq=float(CFG.pilot_freq),
            rds_carrier_freq=float(CFG.rds_carrier_freq),
            fs=float(CFG.if_fs), compute_dtype=torch.bfloat16,
            device="cpu", **kw)
        return bank.mix_call(fm, bank.init_state((3,)), **call_kw)
    return call, dict(out_tile=256, sub_tiles=1, interpret=True)


def channelizer(k=8):
    return WidebandChannelizer(4 * CFG.rf_fs, CFG.rf_fs,
                               list(np.linspace(-3e6, 3e6, k)),
                               engine="pallas", ingest="u8", device="cpu")


def case_channelizer():
    chan = channelizer()
    rng = np.random.default_rng(5)
    body = torch.from_numpy(rng.integers(0, 256, 2 * 4 * 1024,
                                         dtype=np.uint8))
    xbt = body.reshape(-1, 2 * chan.decim).T.contiguous()

    def call(**kw):
        st = chan.init_state()
        return chan._pl(body, st, **kw), chan._pl.call_cols(xbt, st, **kw)
    return call, dict(interpret=True)


def case_receiver_run():
    cap = tx.synthesize_capture(CFG, seconds=0.05, seed=1,
                                mono=tx.tone(CFG.rf_fs, 700.0,
                                             int(0.05 * CFG.rf_fs)))
    rx = Receiver(0, device="cpu", fused_frontend="int8",
                  conv_engine="tiled", conv_dtype="bf16")
    return lambda **kw: rx.run(cap, **kw), dict(unroll=4)


def case_sharded_wideband_run():
    chan = channelizer(16)
    rx = Receiver(0, device="cpu")
    rng = np.random.default_rng(6)
    bw = 2 * (rx.block_size_u8() // 2) * chan.decim
    wide = rng.integers(100, 156, bw, dtype=np.uint8)
    mesh = make_mesh(2, "stations", devices=[CPU] * 2)
    return (lambda **kw: sharded_wideband_run(chan, rx, wide, mesh, **kw),
            dict(interpret=True))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_keyword_changes_nothing(name):
    """The call with the reference's keywords equals the call without
    them, bit for bit."""
    call, kw = CASES[name]()
    assert_same(call(**kw), call())


def test_pll_feedforward_ignores_any_bandwidth():
    """norm_bandwidth sets nothing at any value, and the Receiver passes
    its carriers' bandwidths to the feedforward engine as to the loops."""
    x = tones()
    want = tpll.pll_feedforward(x, state(), **LOOP)
    for bw in (1e-4, 0.02, 0.3):
        assert_same(tpll.pll_feedforward(x, state(), **LOOP,
                                         norm_bandwidth=bw), want)


@pytest.mark.cuda
def test_interpret_still_launches_on_the_card():
    """interpret=True does not switch a CUDA tensor to the plain version:
    the sequential loop and the channelizer launch their kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    x = tones(n=512).cuda()
    before = dict(LAUNCHES)
    pll_kernel.pll_pallas(x, tpll.pll_init((3,)), **LOOP, interpret=True)
    assert LAUNCHES["pll"] == before["pll"] + 1
    chan = WidebandChannelizer(4 * CFG.rf_fs, CFG.rf_fs,
                               list(np.linspace(-3e6, 3e6, 8)),
                               engine="pallas", ingest="u8")
    body = torch.full((2 * 4 * 1024,), 128, dtype=torch.uint8,
                      device="cuda")
    chan._pl(body, chan.init_state(), interpret=True)
    assert LAUNCHES["mfb"] == before["mfb"] + 1
