"""The port's spans and counters (sdr_tpu_torch/io/logger.py): off, a span
is one shared null context that records nothing; on (a profiler records,
or set_tracing), a record_function range and a total and count per name.
The receiver's and the RDS decoder's spans and counters, every entry
path's copy onto the device (io/stream.py to_device and host_tensor), the
CLI's --stats table, the names' declaration, and tools/trace_gaps.py."""

import ast
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sdr_tpu_torch import cli as tcli
from sdr_tpu_torch import tx as ttx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.io import logger
from sdr_tpu_torch.io.stream import host_tensor, to_device
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.models.wideband import WidebandReceiver
from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
from sdr_tpu_torch.parallel.channels import sharded_run
from sdr_tpu_torch.parallel.mesh import make_mesh
from sdr_tpu_torch.rds import tx as rds_tx
from sdr_tpu_torch.rds.streaming import StreamingRdsDecoder

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import trace_gaps  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_store():
    logger.reset_stage_times()
    yield
    logger.set_tracing(False)
    logger.reset_stage_times()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_is_one_null_context_and_records_nothing():
    a, b = logger.stage_scope("demod"), logger.stage_scope("rf_frontend")
    assert a is b and not isinstance(a, record_function)
    with a:
        with b:
            pass
    logger.count("rds.windows", 3)
    assert logger.totals() == ({}, {})
    assert logger.stage_times() == {}


@pytest.mark.parametrize("switch", ["profiler", "set_tracing"])
def test_span_on_records_total_count_and_self_time(switch):
    """On under a CPU profiler (with a range in the trace) or after
    set_tracing (no range); the parent's self time leaves out its child."""
    if switch == "set_tracing":
        logger.set_tracing(True)
        prof = None
    else:
        prof = _cpu_profile().__enter__()
    try:
        for _ in range(2):
            with logger.stage_scope("receiver.run"):
                with logger.stage_scope("receiver.step"):
                    torch.zeros(64).sum()
        logger.count("rds.windows", 3)
        logger.count("rds.windows", 4)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    spans, counters = logger.totals()
    assert set(spans) == {"receiver.run", "receiver.step"}
    assert spans["receiver.run"][1] == spans["receiver.step"][1] == 2
    assert spans["receiver.run"][0] >= spans["receiver.step"][0] > 0
    assert counters == {"rds.windows": 7}
    own = logger.self_times()
    assert own["receiver.run"] == pytest.approx(
        spans["receiver.run"][0] - spans["receiver.step"][0])
    assert own["receiver.step"] == spans["receiver.step"][0]
    assert logger.stage_times()["receiver.run"] == pytest.approx(
        spans["receiver.run"][0] / 2)
    if prof is not None:
        keys = {e.key for e in prof.key_averages()}
        assert {"receiver.run", "receiver.step"} <= keys
    logger.reset_stage_times()
    assert logger.totals() == ({}, {})


def test_receiver_run_spans_one_per_call():
    """Receiver.run records receiver.run, receiver.h2d and receiver.step
    once a one-step call under the profiler, nothing without it, and the
    outputs are bit-equal either way."""
    rx = Receiver(0, device="cpu")
    u8 = np.random.default_rng(3).integers(
        0, 256, rx.block_size_u8(1), dtype=np.uint8)
    plain, st = rx.run(u8)
    plain2, _ = rx.run(u8, state=st)
    assert logger.totals() == ({}, {})
    with _cpu_profile() as prof:
        traced, st = rx.run(u8)
        traced2, _ = rx.run(u8, state=st)
    spans, _ = logger.totals()
    for name in ("receiver.run", "receiver.h2d", "receiver.step"):
        assert spans[name][1] == 2, name
    assert {"receiver.run", "receiver.h2d", "receiver.step",
            "rf_frontend"} <= {e.key for e in prof.key_averages()}
    for a, b in ((plain, traced), (plain2, traced2)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _noise_u8(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _wideband():
    """A two-station mono WidebandReceiver on the CPU (mfb engine, f32
    ingest) and f32 noise for five of its one-block steps."""
    wrx = WidebandReceiver(
        WidebandChannelizer(9.6e6, 2.4e6, [-1.5e6, 1.8e6], device="cpu"),
        Receiver(0, device="cpu"))
    noise = np.random.default_rng(1).standard_normal(5 * wrx.block_wide(1))
    return wrx, (0.3 * noise).astype(np.float32)


def _copies_run(tmp_path):
    rx = Receiver(0, device="cpu")
    rx.run(_noise_u8(2 * rx.block_size_u8(1)))
    return 2


def _copies_cli(tmp_path):
    """Two full one-block steps, then the EOF flush of one aligned tail."""
    rx = Receiver(0, device="cpu")
    path = tmp_path / "cap.u8"
    _noise_u8(2 * rx.block_size_u8(1) + rx.block_align_u8() + 7).tofile(path)
    assert tcli.main(["0", "1", "--in", str(path), "--out",
                      str(tmp_path / "o.raw"), "--blocks-per-step", "1",
                      "--device", "cpu"]) == 0
    return 3


def _copies_stations(tmp_path):
    rx = Receiver(0, device="cpu")
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"s{i}.u8"))
        _noise_u8(2 * rx.block_size_u8(1) + 100, seed=i).tofile(paths[-1])
    assert tcli.main(["0", "1", "--stations", ",".join(paths), "--wav-dir",
                      str(tmp_path / "wav"), "--blocks-per-step", "1",
                      "--device", "cpu"]) == 0
    return 2


def _copies_wideband_run(tmp_path):
    """One copy of the whole capture, stepped as five rows."""
    wrx, wide = _wideband()
    wrx.run(wide)
    return 1


def _copies_wideband_stream(tmp_path):
    """Two chunks of two steps, then the one whole block left over."""
    wrx, wide = _wideband()
    pieces = np.array_split(wide, 7)
    assert len(list(wrx.stream(iter(pieces), scan_steps=2))) == 3
    return 3


def _copies_sharded_run(tmp_path):
    """Two devices' shards (cpu and cpu:0), two steps each."""
    rx = Receiver(0, device="cpu")
    mesh = make_mesh(2, "channels", devices=[torch.device("cpu"),
                                             torch.device("cpu", 0)])
    sharded_run(rx, np.stack([_noise_u8(2 * rx.block_size_u8(1), seed=s)
                              for s in range(2)]), mesh)
    return 4


ENTRY_PATHS = {"Receiver.run": _copies_run, "cli.main": _copies_cli,
               "cli --stations": _copies_stations,
               "WidebandReceiver.run": _copies_wideband_run,
               "WidebandReceiver.stream": _copies_wideband_stream,
               "sharded_run": _copies_sharded_run}


@pytest.mark.parametrize("path", list(ENTRY_PATHS))
def test_every_entry_path_copies_through_receiver_h2d(path, tmp_path):
    """Each entry path moves its host blocks onto the device through
    io/stream.py's to_device: one receiver.h2d a copy, counted once as
    h2d.pinned or h2d.pageable, and, where each copy is one Receiver.step,
    as many as the steps."""
    logger.set_tracing(True)
    copies = ENTRY_PATHS[path](tmp_path)
    logger.set_tracing(False)
    spans, counters = logger.totals()
    assert spans["receiver.h2d"][1] == copies
    assert (counters.get("h2d.pinned", 0) + counters.get("h2d.pageable", 0)
            == copies)
    if not path.startswith("Wideband"):
        assert spans["receiver.step"][1] == copies


def test_host_tensor_shares_writable_memory_and_copies_read_only(tmp_path):
    """A writable array becomes a tensor on its memory; a read-only
    np.frombuffer block and a read-only memmap slice are copied once, with
    no warning; a tensor, and a tensor already on the device, pass
    through as the same object."""
    a = _noise_u8(64)
    assert np.shares_memory(host_tensor(a).numpy(), a)
    path = tmp_path / "cap.u8"
    a.tofile(path)
    for ro in (np.frombuffer(a.tobytes(), dtype=np.uint8),
               np.memmap(path, dtype=np.uint8, mode="r")[8:40]):
        assert not ro.flags.writeable
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = host_tensor(ro)
            on_dev = to_device(ro, "cpu")
        for x in (t, on_dev):
            assert not np.shares_memory(x.numpy(), ro)
            np.testing.assert_array_equal(x.numpy(), ro)
    t = torch.from_numpy(a)
    assert host_tensor(t) is t and to_device(t, "cpu") is t


def _rds_soft(splice_after: int | None = None):
    """RDS soft at 16 samples a symbol from rds/tx.py's groups; with
    splice_after, 56 zero bits follow that many groups."""
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="TPU FM  ",
                                        n_groups=12)
    if splice_after is not None:
        cut = 104 * splice_after
        bits = np.concatenate([bits[:cut], np.zeros(56, bits.dtype),
                               bits[cut:]])
    return rds_tx.bits_to_baseband(bits, 38_000.0).astype(np.float32)


def _decode(soft, block=777):
    """Push soft in blocks with tracing on; dec.returned counts the
    symbols its CDR returned, dec.skipped_synced the windows frame sync's
    walk passed over after the push of the first group."""
    dec = StreamingRdsDecoder(16)
    recover, dec.returned = dec._recover_symbols, 0
    dec.skipped_synced = 0

    def counted(x):
        out = recover(x)
        dec.returned += len(out)
        return out

    dec._recover_symbols = counted
    groups = []
    logger.set_tracing(True)
    for i in range(0, len(soft), block):
        synced, skipped = bool(dec.groups), dec.windows_skipped
        groups += dec.push(soft[i:i + block])
        if synced:
            dec.skipped_synced += dec.windows_skipped - skipped
    logger.set_tracing(False)
    return dec, groups, logger.totals()


def test_rds_counters_on_a_clean_stream():
    dec, groups, (spans, counters) = _decode(_rds_soft())
    assert len(groups) >= 8
    assert counters["rds.groups"] == len(groups) == len(dec.groups)
    assert counters["rds.windows"] == dec.windows >= counters["rds.groups"]
    assert counters["rds.sync_losses"] == dec.sync_losses == 0
    assert counters["rds.bits_corrected"] == dec.bits_corrected
    assert counters["rds.symbols_recovered"] == dec.returned == (
        dec._sym_abs + len(dec._sym_buf)) > 16 * 104
    # locked on a seamless stream, the walk steps from group to group
    assert counters.get("rds.windows_skipped", 0) == dec.windows_skipped \
        <= counters["rds.windows"]
    assert dec.skipped_synced == 0 and dec._locked_at >= 0
    pushes = spans["rds.push"][1]
    assert spans["rds.symbols"][1] == spans["rds.framing"][1] == pushes
    assert spans["rds.push"][0] >= spans["rds.symbols"][0]


def test_rds_counters_at_a_seam_of_56_zero_bits():
    """56 zero bits spliced after a group: one lock lost at the expected
    position and at least 56 more windows tested; no group lost."""
    _, clean, (_, c0) = _decode(_rds_soft())
    logger.reset_stage_times()
    dec, groups, (_, c1) = _decode(_rds_soft(splice_after=6))
    assert c1["rds.sync_losses"] == dec.sync_losses == 1
    assert c1["rds.windows"] - c0["rds.windows"] >= 56
    # the search after the seam passes over the windows that cannot hit
    assert 0 < dec.skipped_synced <= c1["rds.windows_skipped"] == (
        dec.windows_skipped) <= c1["rds.windows"]
    assert c1["rds.groups"] == len(groups) == len(clean)
    assert c1["rds.bits_corrected"] == dec.bits_corrected
    # 56 more bits: 112 more symbols
    assert c1["rds.symbols_recovered"] == dec.returned
    assert abs(c1["rds.symbols_recovered"] - c0["rds.symbols_recovered"]
               - 112) <= 2


def test_rds_counters_count_corrected_bits():
    """On a noisy stream the burst correction fixes bits: the counter
    equals the decoder's own total."""
    soft = _rds_soft()
    rng = np.random.default_rng(2)
    noisy = (soft + rng.normal(0, 0.6 * np.std(soft), soft.shape)
             ).astype(np.float32)
    dec, _, (_, counters) = _decode(noisy)
    assert dec.bits_corrected > 0
    assert counters["rds.bits_corrected"] == dec.bits_corrected
    assert counters["rds.symbols_recovered"] == dec.returned


def _called_names(tree):
    """String names passed to stage_scope / scope / count, and the
    f-string prefixes among them."""
    names, prefixes = set(), set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        fn = node.func
        fname = fn.id if isinstance(fn, ast.Name) else getattr(
            fn, "attr", None)
        if fname not in ("scope", "stage_scope", "count"):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            names.add(arg.value)
        elif isinstance(arg, ast.JoinedStr):
            prefixes.add(arg.values[0].value)
    return names, prefixes


def test_every_span_and_counter_is_declared():
    """Each name the package passes to a span or a counter is in NAMES;
    an f-string name (pll_<impl>) has every engine's name there."""
    names, prefixes = set(), set()
    for path in (ROOT / "sdr_tpu_torch").rglob("*.py"):
        n, p = _called_names(ast.parse(path.read_text()))
        names |= n
        prefixes |= p
    assert names - set(logger.NAMES) == set()
    assert {"receiver.run", "receiver.h2d", "receiver.step", "rds.push",
            "rds.symbols", "rds.framing", "cli.read", "cli.drain",
            "rds.windows", "rds.groups", "rds.sync_losses",
            "rds.bits_corrected", "rds.windows_skipped"} <= names
    assert prefixes == {"pll_"}
    for impl in ("scan", "pallas", "chunked", "pallas_chunked", "ff"):
        assert f"pll_{impl}" in logger.NAMES
    assert len(set(logger.NAMES)) == len(logger.NAMES)


@pytest.fixture(scope="module")
def stereo_capture(tmp_path_factory):
    cfg = MODES[0]
    n = int(0.3 * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=0x3D44, ps_name="TPU FM  ",
                                        n_groups=6)
    cap = ttx.synthesize_capture(
        cfg, seconds=0.3, left=ttx.tone(cfg.rf_fs, 1000.0, n),
        right=ttx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
        a_rds=0.1)
    path = tmp_path_factory.mktemp("tracing") / "stereo.u8"
    cap.tofile(path)
    return str(path)


@pytest.mark.parametrize("flags", [["0", "1"], ["0", "2", "--rds", "--fast"]])
def test_stats_prints_the_span_table(stereo_capture, tmp_path, capsys,
                                     flags):
    """--stats: the span table over the steps (count, mean and self ms a
    step, total s), the copies by way (all pageable onto the CPU), the RDS
    counters with --rds, launches a step; no step
    latency line; tracing is off again afterwards."""
    assert tcli.main(flags + ["--in", stereo_capture, "--out",
                              str(tmp_path / "o.raw"), "--stats",
                              "--blocks-per-step", "4", "--device",
                              "cpu"]) == 0
    err = capsys.readouterr().err
    assert "step latency" not in err
    assert "processed " in err and "host I/O: " in err
    head = next(ln for ln in err.splitlines() if ln.startswith("spans over"))
    steps = int(head.split()[2])
    rows = {ln.split()[0]: ln.split()[1:] for ln in err.splitlines()
            if ln.startswith("  ") and ln.split()[0] in logger.NAMES}
    for name in ("receiver.h2d", "receiver.step", "rf_frontend",
                 "cli.read", "cli.drain"):
        assert name in rows, name
    assert int(rows["receiver.step"][0]) == steps
    _, mean, own, _ = rows["receiver.step"]
    assert float(own) <= float(mean)
    assert "kernel launches a step: " in err
    h2d = int(rows["receiver.h2d"][0])
    assert (f"h2d: 0 copies from page-locked memory, {h2d} pageable"
            in err)
    assert ("rds: " in err) == ("--rds" in flags)
    if "--rds" in flags:
        assert int(rows["rds.push"][0]) == steps
        line = next(ln for ln in err.splitlines()
                    if ln.endswith("us a symbol in rds.symbols"))
        assert int(line.split()[1]) > 0
        windows = int(next(ln for ln in err.splitlines()
                           if ln.startswith("rds: ")).split()[1])
        line = next(ln for ln in err.splitlines()
                    if " windows skipped by frame sync's walk" in ln)
        skipped = int(line.split()[1])
        assert 0 <= skipped <= windows
        if windows:
            assert line.endswith(f"({100.0 * skipped / windows:.1f}% of "
                                 "windows)")
    assert logger.stage_scope("demod") is logger.stage_scope("x")


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_gaps_names_each_gap_by_the_innermost_span(tmp_path, capsys):
    events = [_x("user_annotation", "cli.read", 0, 10),
              _x("user_annotation", "receiver.step", 10, 20),
              _x("user_annotation", "rf_frontend", 12, 4),
              _x("user_annotation", "harness_span", 0, 100),
              _x("kernel", "k", 14, 4),
              _x("gpu_memcpy", "Memcpy HtoD", 20, 5),
              _x("user_annotation", "cli.drain", 30, 30),
              _x("user_annotation", "rds.push", 40, 15),
              _x("kernel", "late", 58, 10)]
    window, busy, gaps = trace_gaps.idle_gaps(events)
    assert (window, busy) == (60, 4 + 5 + 2)
    assert [(a, d, n) for a, d, n in gaps] == [
        (0, 14, "cli.read"), (18, 2, "receiver.step"),
        (25, 33, "rds.push")]
    assert trace_gaps.by_span(gaps, min_us=3) == [
        ("rds.push", 1, 33, 33), ("cli.read", 1, 14, 14)]
    # --skip-steps: the window starts at the later step
    later = events + [_x("user_annotation", "receiver.step", 62, 10)]
    assert trace_gaps.idle_gaps(later, skip_steps=1) == (
        10, 6, [(68, 4, "receiver.step")])
    assert trace_gaps.idle_gaps(events, skip_steps=1) == (0.0, 0.0, [])
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_gaps.main([str(path), "--skip-steps", "0"]) == 0
    out = capsys.readouterr().out
    assert "rds.push" in out and "cli.read" in out
    assert trace_gaps.main([str(path)]) == 1
