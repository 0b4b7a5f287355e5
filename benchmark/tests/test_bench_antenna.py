"""The antenna layout (harness.py): a cell whose stations share one antenna
stream, made of new files only, runs through the harness; the stream is
the stations' programmes at their offsets; a layout that would not loop
as one broadcast is refused.

`antenna_cell/` holds the files such a cell adds, laid out as under
benchmark/: a configuration, a system that wraps the port's
`WidebandReceiver` (the plain `mfb` engine on the CPU), a plain float64
reference (an exact oscillator per checked offset, the 101-tap 100 kHz
low-pass at the stream's rate, decimation to the RF rate, then
reference/receiver.py's chain), a work file and a traffic file of 3
stations 400 kHz apart at 9.6 MS/s."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import firdes
from benchmark.tools.size_antenna import CELL_FILES, add_antenna_cell
from benchmark.traffic import synth

CELL = "antenna3.batch"


def plain_channelizer():
    """The reference's channelizer (antenna_cell/reference/wideband.py)."""
    return harness._load(CELL_FILES / "reference" / "wideband.py")


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_antenna_cell_from_new_files(tiny_root):
    """The program reads correct with every RDS count 0, the control
    reads not correct, decode_rate counts K station-seconds a step, and
    no file the benchmark had changed."""
    before = _hashes(tiny_root)
    add_antenna_cell(tiny_root)
    cell = harness.load_cell(tiny_root, CELL)
    assert cell.traffic["antenna"]["fs"] == 9_600_000
    r = harness.run_cell(tiny_root, CELL, 2 ** 31 + 4242, 0.4, False,
                         t_start=0.0, device="cpu")
    assert r["correct"], r["compared"]
    assert r["compared"]["rds_groups_missed"]["value"] == 0
    notes, k = r["notes"], cell.traffic["stations"]
    step_s = 8 * 0.016                 # 8 blocks of 16 ms at the RF rate
    assert r["attempted"] == notes["steps"] * k
    assert r["metrics"]["decode_rate"]["value"] == pytest.approx(
        notes["steps"] * k * step_s / notes["window_s"])
    c = harness.run_cell(tiny_root, CELL, 2 ** 31 + 4243, 0.4, False,
                         t_start=0.0, device="cpu", system="control")
    assert not c["correct"], c["compared"]
    after = _hashes(tiny_root)
    assert {p: h for p, h in after.items() if p in before} == before


def compose(seed: int, offsets_hz, fs: int, n: int, sigma: float):
    """A stream of len(offsets_hz) stations, one programme each, by
    synth.antenna_stream; returns (u8, basebands, shifts, turns, gains)."""
    sig = json.loads((CELL_FILES / "traffic" / "antenna3.json"
                      ).read_text())["signal"]
    rng = np.random.default_rng(seed)
    bb = [synth.baseband(n, fs, rng, sig, "cpu")[1] for _ in offsets_hz]
    shifts = rng.integers(0, n, len(offsets_hz))
    turns = [f * n // fs for f in offsets_hz]
    gains = 10 ** (rng.uniform(-6, 0, len(offsets_hz)) / 20)
    u8 = synth.antenna_stream(bb, list(range(len(offsets_hz))), shifts,
                              turns, gains, sigma, 0.9,
                              torch.Generator().manual_seed(seed))
    return u8, bb, shifts, turns, gains


def test_antenna_stream_is_the_stations_programmes():
    """Channelized at each offset by the plain mixer and low-pass, the
    stream is that station's programme (through the same low-pass), in u8
    steps: amplitude x 128 x gain / the sum's peak.  What remains is the
    u8 rounding with its dither and the noise, white, through the low-pass
    (sigma_out^2 = (1/6 + (128 0.9 sigma)^2) sum h^2 a rail; bound 7
    sigma_out: Gaussian to the central limit over 101 taps, exceeded with
    odds of ~1e-11 a sample), and the neighbours' leakage: each
    neighbour's amplitude times the low-pass's largest gain at or beyond
    its distance less twice its Carson half-width (75 kHz deviation + the
    60 kHz multiplex + 2 kHz CFO), where its spectrum lies."""
    fs, rf_fs, n = 4_800_000, 2_400_000, 3_686_400    # 0.768 s
    offs = [-1_600_000, 0, 1_600_000]
    sigma = 10 ** (-60 / 20)
    u8, bb, shifts, turns, gains = compose(5, offs, fs, n, sigma)
    i = np.arange(n)
    total = sum(g * np.roll(z.numpy(), -int(o))
                * np.exp(2j * np.pi * (t * i % n) / n)
                for z, o, t, g in zip(bb, shifts, turns, gains))
    peak = max(np.abs(total.real).max(), np.abs(total.imag).max())
    scale = 0.9 * 128 * np.asarray(gains) / peak       # u8 steps
    h = firdes.lowpass(fs, 100e3, 101).astype(np.float64)
    sigma_out = np.sqrt((1 / 6 + (0.9 * 128 * sigma) ** 2) * np.sum(h * h))
    grid = np.linspace(0, fs / 2, 20001)
    resp = np.abs(np.exp(-2j * np.pi * np.outer(grid / fs, np.arange(101)))
                  @ h)
    carson = 75e3 + 60e3 + 2e3
    ref = plain_channelizer()
    antenna = {"fs": fs, "offsets_hz": offs}
    for s, f in enumerate(offs):
        chan = ref.RefWideband(0, antenna, [s], rds=False)
        got = chan.channelize(u8[None])[0].numpy() * 128.0
        # the station alone, at 0 Hz, through the same low-pass
        z = np.roll(bb[s].numpy(), -int(shifts[s]))
        x = torch.from_numpy(np.stack([z.real, z.imag]))
        want = torch.nn.functional.conv1d(
            torch.nn.functional.pad(x, (100, 0))[:, None],
            torch.from_numpy(h[::-1].copy())[None, None],
            stride=fs // rf_fs)[:, 0].numpy() * scale[s]
        # a neighbour's distance from this station, on the stream's circle
        dist = [abs((g - f + fs // 2) % fs - fs // 2) for g in offs]
        leak = sum(scale[j] * resp[grid >= dist[j] - 2 * carson].max()
                   for j in range(len(offs)) if j != s)
        # from the first output whose taps all lie in the stream: before
        # it, a neighbour's onset passes the truncated filter
        on = 101 // (fs // rf_fs) + 1
        err = max(np.abs(got[0::2] - want[0])[on:].max(),
                  np.abs(got[1::2] - want[1])[on:].max())
        assert err <= 7 * sigma_out + leak, (s, err, sigma_out, leak)
        assert err > 2 * sigma_out            # the rounding is there
        assert np.abs(want).max() > 40 * (7 * sigma_out + leak)


def test_antenna_offsets_must_loop():
    """An offset that does not close a whole number of turns over the
    buffer, a count of offsets other than of stations, or a rate that is
    no whole multiple of the RF rate is refused."""
    n, fs = 3_686_400, 4_800_000
    assert harness.antenna_turns({"offsets_hz": [-1_600_000, 0, 250]}, 3,
                                 n, fs) == [-1_228_800, 0, 192]
    with pytest.raises(ValueError, match="turns"):
        harness.antenna_turns({"offsets_hz": [0, 201]}, 2, n, fs)
    with pytest.raises(ValueError, match="turns"):
        harness.antenna_turns({"offsets_hz": [0.5]}, 1, n, fs)
    with pytest.raises(ValueError, match="offsets"):
        harness.antenna_turns({"offsets_hz": [0, 200_000]}, 3, n, fs)
    cell = harness.Cell("x", "c", {"mode": 0}, {
        "stations": 1, "antenna": {"fs": 3_000_000, "offsets_hz": [0]}},
        [], [], Path("."))
    with pytest.raises(ValueError, match="multiple"):
        harness.make_traffic(cell, 614_400, 1, torch.device("cpu"))
