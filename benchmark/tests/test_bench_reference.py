"""The reference (benchmark/reference/) against the port's CPU path on the
same seeded bytes, and the synthesis against the port's transmitter."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark.reference.receiver import RefReceiver, lower, resample
from benchmark.traffic import synth

SIG = json.loads((ROOT / "benchmark/traffic/live1.json").read_text())["signal"]
CONFIGS = ("fm0_stereo_rds_fast", "fm0_stations_stereo_fast")


def capture(seed: int, n_pairs: int = 38400 * 44) -> np.ndarray:
    p = synth.synthesize(n_pairs, 2_400_000, np.random.default_rng(seed), SIG,
                         torch.Generator().manual_seed(seed), "cpu")
    return p.u8.numpy()


def streams(run_step, u8: np.ndarray, step: int, keys) -> dict:
    """Outputs over the capture, one step at a time, joined."""
    outs = {k: [] for k in keys}
    for off in range(0, u8.shape[-1] - step + 1, step):
        o = run_step(torch.from_numpy(u8[:, off:off + step]))
        for k in keys:
            outs[k].append(o[k].double().numpy())
    return {k: np.concatenate(v, axis=-1) for k, v in outs.items()}


def gap(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def port_stepper(rx):
    state = None

    def step(u8):
        nonlocal state
        out, state = rx.run(u8, state=state)
        return out
    return step


@pytest.mark.parametrize("rds", [True, False])
def test_reference_is_the_port_float32_chain(rds):
    """The port's float32 chain (conv engine, no fused kernel) is the
    reference's arithmetic to float32 rounding."""
    from sdr_tpu_torch.models.receiver import Receiver
    rx = Receiver(0, stereo=True, rds=rds, pll_impl="ff", device="cpu")
    u8 = np.stack([capture(3), capture(4)])
    keys = ["left", "right"] + (["rds_soft"] if rds else [])
    step = rx.block_size_u8(1)
    got = streams(port_stepper(rx), u8, step, keys)
    ref = streams(RefReceiver(0, 2, rds=rds).process, u8, step, keys)
    for k in keys:
        assert gap(got[k], ref[k]) < 1e-5, k


@pytest.mark.parametrize("name", CONFIGS)
def test_port_within_limits_and_control_outside(name):
    """At the configuration's stated precision the port's CPU path (the
    kernels' plain versions) stays within the limits; the control, the
    reference one format lower, falls outside one of them."""
    from sdr_tpu_torch.models.receiver import Receiver
    conf = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    rds = conf["receiver"]["rds"]
    rx = Receiver(conf["mode"], device="cpu", **conf["receiver"])
    u8 = capture(5)[None]
    keys = ["left", "right"] + (["rds_soft"] if rds else [])
    step = rx.block_size_u8(2)
    ref = streams(RefReceiver(0, 1, rds=rds).process, u8, step, keys)
    got = streams(port_stepper(rx), u8, step, keys)
    ctl = streams(RefReceiver(0, 1, rds=rds,
                              precision=lower(conf["precision"])).process,
                  u8, step, keys)
    lim = conf["limits"]
    assert max(gap(got[k], ref[k]) for k in ("left", "right")) \
        < lim["audio_gap"]
    assert max(gap(ctl[k], ref[k]) for k in ("left", "right")) \
        > lim["audio_gap"]
    if rds:
        assert gap(got["rds_soft"], ref["rds_soft"]) < lim["rds_soft_gap"]


def test_resample_is_the_loop_oracle():
    from sdr_tpu_torch.ops.resample import resample_reference
    from benchmark.reference import firdes
    h = firdes.lowpass(240_000 * 19, 3000, 51 * 19, 19).astype(np.float64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2 * 1200)
    tail = torch.zeros(1, -(-(len(h) - 1) // 19), dtype=torch.float64)
    y = []
    for blk in (x[:1200], x[1200:]):
        o, tail = resample(torch.from_numpy(blk)[None], tail,
                           torch.from_numpy(h), 19, 120)
        y.append(o[0].numpy())
    want, _ = resample_reference(x, np.zeros(len(h) - 1), h, 19, 120)
    np.testing.assert_allclose(np.concatenate(y), want, atol=1e-12)


def test_group_stream_is_the_port_transmitter():
    from sdr_tpu_torch.rds import tx
    bits = np.concatenate([synth.group_bits(g) for g in synth.group_stream(
        0x3D44, 5, "SDR-TPU ", "TPU NATIVE FM RECEIVER".ljust(32), 20)])
    want = tx.standard_group_stream(0x3D44, 5, "SDR-TPU ",
                                    "TPU NATIVE FM RECEIVER", 20)
    assert np.array_equal(bits, want)


@pytest.mark.parametrize("layout", ["rows", "antenna"])
def test_buffer_loops_without_a_seam(layout):
    """Two loops of a buffer through the reference: the discriminator's
    output at the seam is no larger than anywhere else, and the RDS
    decoder syncs through it without a wrong group.  `antenna`: the
    programme is one of two stations on a 4.8 MS/s antenna stream
    (synth.antenna_stream), channelized by the plain mixer and low-pass
    before the reference."""
    from sdr_tpu_torch.rds.streaming import StreamingRdsDecoder
    n = 38400 * 44
    if layout == "rows":
        p = synth.synthesize(n, 2_400_000, np.random.default_rng(8), SIG,
                             torch.Generator().manual_seed(8), "cpu")
        u8, step, process = p.u8.numpy(), 153_600 // 2, RefReceiver(
            0, 1, rds=True).process
    else:
        from benchmark import harness
        fs, offs = 4_800_000, [-600_000, 400_000]
        rng = np.random.default_rng(8)
        made = [synth.baseband(2 * n, fs, rng, SIG, "cpu") for _ in offs]
        p = made[0][0]
        u8 = synth.antenna_stream(
            [z for _, z in made], [0, 1], [0, 2 * 12345],
            harness.antenna_turns({"offsets_hz": offs}, 2, 2 * n, fs),
            [1.0, 0.7], 10 ** (-30 / 20), 0.9,
            torch.Generator().manual_seed(8)).numpy()
        wideband = harness._load(ROOT / "benchmark/tests/antenna_cell/"
                                 "reference/wideband.py")
        step, process = 153_600, wideband.RefWideband(
            0, {"fs": fs, "offsets_hz": offs}, [0], rds=True).process
    out = streams(process, np.tile(u8, 3)[None], step, ["mono", "rds_soft"])
    mono = out["mono"][0]
    seam = n // 50
    near = np.abs(mono[seam - 40:seam + 40]).max()
    assert near <= np.abs(mono[2 * seam // 3:seam - 40]).max() * 1.05
    dec = StreamingRdsDecoder(16)
    dec.push(out["rds_soft"][0])
    sent = set(p.groups)
    assert dec.groups and all(tuple(g.blocks) in sent for g in dec.groups)
    assert len(dec.groups) >= 2 * len(p.groups)
