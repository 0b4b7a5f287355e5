"""The harness on the CPU at tiny sizes: cells, synthesis, the window
loops, the trace's arithmetic and the result line's schema; and the
measurement path, which refuses to run without a card."""

import json
import time

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark import harness

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import benchmark.run as run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearses_on_cpu(run_tiny, cell, trace):
    r = run_tiny(cell, seconds=1.0, trace=trace)
    assert list(r)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["device"]["platform"] == "cpu"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "end_to_end" if not trace else "per_layer"
    want = {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        # no card: no device event, so no device metric and no breakdown
        assert "breakdown" not in r
        assert all(json.loads(json.dumps(m))["unit"]
                   for m in r["metrics"].values())
    assert r["correct"], r["compared"]
    json.dumps(r)


def test_same_seed_same_inputs(tiny_root):
    cell = harness.load_cell(tiny_root, "stereo_rds.batch128")
    a = harness.make_traffic(cell, 614400, 2 ** 33 + 1, torch.device("cpu"))
    b = harness.make_traffic(cell, 614400, 2 ** 33 + 1, torch.device("cpu"))
    c = harness.make_traffic(cell, 614400, 2 ** 33 + 2, torch.device("cpu"))
    assert np.array_equal(a.buf, b.buf) and a.checked == b.checked
    assert not np.array_equal(a.buf, c.buf)
    assert a.buf.shape[1] % 614400 == 0


def test_checked_stations_cover_every_half():
    rng = np.random.default_rng(0)
    for _ in range(50):
        s = harness.draw_checked(rng, 128, 4)
        for half in (range(64), range(64, 128)):
            assert any(x in half for x in s)
        assert any(x % 2 == 0 for x in s) and any(x % 2 for x in s)


class Sleeper:
    """A system that takes `dt` seconds a step."""

    def __init__(self, dt):
        self.dt = dt

    def step(self, u8):
        time.sleep(self.dt)
        return {"left": torch.zeros(u8.shape[0], 4)}


def _traffic(step_s):
    return harness.Traffic(np.zeros((1, 64), np.uint8), [], [0], [0], 16,
                           step_s)


def test_realtime_lags_count_the_backlog():
    """A system slower than the block rate: lags grow block by block, and
    the blocks left at the window's end count their lag at that end."""
    spans = harness.Spans()
    sink = harness.Sink(["left"], [0], None, spans)
    lags, t0, t1 = harness.realtime_window(Sleeper(0.03), _traffic(0.02),
                                           0, 0.2, spans, sink)
    assert len(lags) == 10                       # every block due in 0.2 s
    assert lags[4] > lags[0] + 0.03
    assert lags[-1] == pytest.approx(0.0, abs=1e-9)   # due at the end
    assert max(lags) <= 0.2 and t1 - t0 > 0.25


def test_closed_rate_counts_the_last_drain():
    spans = harness.Spans()
    sink = harness.Sink(["left"], [0], None, spans)
    steps, t0, t1 = harness.closed_window(Sleeper(0.01), _traffic(0.02), 0,
                                          0.1, spans, sink)
    assert 5 <= steps <= 11 and len(sink.kept["left"]) == steps
    assert spans.count["enqueue"] == steps == spans.count["d2h"]


def test_trace_reduction():
    dev = [("kernel", "a", 100.0, 10.0), ("kernel", "b", 105.0, 10.0),
           ("gpu_memcpy", "Memcpy HtoD", 150.0, 20.0)]
    host = [("enqueue", 90.0, 30.0), ("rds_push", 120.0, 25.0),
            ("d2h", 170.0, 30.0)]
    busy, traced, gaps = harness.busy_and_gaps(dev, host)
    assert busy == pytest.approx(35e-6) and traced == pytest.approx(110e-6)
    assert sorted((round(d), n) for _, d, n in gaps) == [
        (10, "enqueue"), (30, "d2h"), (35, "rds_push")]
    b = harness.breakdown(dev, gaps)
    assert b["device_ops"][0] == ["Memcpy HtoD", pytest.approx(20e-6)]
    assert b["idle_gaps"][0][0] == "rds_push"
    run = harness.Run(None, 2, 1, 16, harness.Spans(), dev, busy, traced)
    assert run.per_step_ms(run.device_s()) == pytest.approx(0.01)
    assert run.idle_pct() == pytest.approx(100 * (1 - 35 / 110))


@pytest.mark.parametrize("config", ["fm0_stereo_rds_fast",
                                    "fm0_stations_stereo_fast"])
def test_step_roofline_bound(tiny_root, config):
    """The work files' bound at a full step: the bytes bound it (the
    FIRs are cheap at the tensor cores' rates), within a few milliseconds."""
    cell = harness.load_cell(tiny_root, "stereo_rds.batch128")
    cell.config_name = config
    run = harness.Run(cell, 1, 128, 3_840_000, harness.Spans())
    nbytes, ops = run.work()
    assert nbytes > 128 * 3_840_000
    assert 1e-4 < run.roofline_s() < 1e-3
    metric = harness._load(ROOT / "benchmark/metrics/step_roofline.batch.py")
    run.device_events = [("kernel", "k", 0.0, 2000.0)]
    assert metric.read(run) == pytest.approx(
        100 * run.roofline_s() / 2e-3)


def test_conv_engine_reader():
    metric = harness._load(ROOT / "benchmark/metrics/conv_engine_ms.batch.py")
    dev = [("kernel", "fm_kernel", 0.0, 5.0),
           ("kernel", "CatArrayBatchedCopy<float>", 10.0, 2.0),
           ("kernel", "cudnn::conv1d_fprop", 20.0, 7.0),
           ("kernel", "elementwise_mul", 30.0, 1.0),
           ("kernel", "CatArrayBatchedCopy<float>", 40.0, 3.0)]
    run = harness.Run(None, 1, 1, 16, harness.Spans(), dev)
    assert metric.read(run) == pytest.approx(9e-3)
    run.device_events = dev[:1]
    assert metric.read(run) is None
