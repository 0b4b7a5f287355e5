"""A configuration (with the system and the reference it names), a traffic
mix and a per-layer metric added as new files (and entries in
BENCHMARK.json) are found by name and run; no file the benchmark already
has is touched."""

import hashlib
import json

from benchmark import harness


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(tiny_root):
    before = _hashes(tiny_root)
    bench_dir = tiny_root / "benchmark"
    conf = json.loads((bench_dir / "configs" /
                       "fm0_stations_stereo_fast.json").read_text())
    conf["receiver"]["conv_engine"] = "tiled"
    conf["system"] = conf["reference"] = "receiver_tiled"
    (bench_dir / "configs" / "fm0_stations_tiled.json").write_text(
        json.dumps(conf))
    # copies of the existing system and reference that, when loaded, leave
    # a mark: the run loads the modules its configuration names
    marks = []
    for kind in ("systems", "reference"):
        mark = tiny_root / f"loaded_{kind}"
        (bench_dir / kind / "receiver_tiled.py").write_text(
            (bench_dir / kind / "receiver.py").read_text()
            + f"\n\nopen({str(mark)!r}, 'a').close()\n")
        marks.append(mark)
    (bench_dir / "work" / "fm0_stations_tiled.py").write_text(
        (bench_dir / "work" / "fm0_stations_stereo_fast.py").read_text())
    traffic = json.loads((bench_dir / "traffic" / "batch128.json"
                          ).read_text())
    traffic.update(stations=2, check_stations=2, programmes=1)
    (bench_dir / "traffic" / "pair.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "gather_ms.batch.py").write_text(
        "def read(run):\n    return run.span_ms('gather')\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "fm0_stations_tiled", "source": "a test",
        "file": "benchmark/configs/fm0_stations_tiled.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "stations_tiled.pair", "config": "fm0_stations_tiled",
        "traffic": "pair", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "gather_ms.batch", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "transfer", "moves": "decode_rate",
        "workloads": ["stations_tiled.pair"]})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_rate":
            m["workloads"].append("stations_tiled.pair")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(tiny_root, "stations_tiled.pair")
    assert cell.config["receiver"]["conv_engine"] == "tiled"
    assert cell.traffic["stations"] == 2
    run = harness.run_cell(tiny_root, "stations_tiled.pair", 12345, 0.4,
                           True, t_start=0.0, device="cpu")
    assert run["metrics"]["gather_ms.batch"]["value"] > 0
    assert run["correct"], run["compared"]
    assert all(m.exists() for m in marks)
    r = harness.run_cell(tiny_root, "stations_tiled.pair", 12345, 0.4,
                         False, t_start=0.0, device="cpu")
    assert set(r["metrics"]) == {"decode_rate", "setup_s"}
    after = _hashes(tiny_root)
    assert {p: h for p, h in after.items() if p in before} == before
