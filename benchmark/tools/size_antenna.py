"""Size a wideband deployment for the benchmark: one 9.6 MS/s u8 antenna
stream of K stations on the 200 kHz FM raster across +-4 MHz, through
the CLI's `--wideband --fast` path, by the harness's own run.

    python3 benchmark/tools/size_antenna.py --stations 41 21 \
        --seed <n> --seconds 20 [--control]

from the root of a checkout, on a card.  For each K (41: every channel,
-4.0 to +4.0 MHz; 21: every other one) it writes an antenna cell built
from benchmark/tests/antenna_cell/'s files (`add_antenna_cell`: the
`wideband` system and reference, 16 blocks a step) into a copy of the
benchmark under build/size_antenna/, runs `harness.run_cell` on it, and
prints one JSON line: the synthesis' seconds and peak device memory, the
result (correct, the compared numbers, RDS counts, decode_rate, setup_s,
the run's memory peak), and the WidebandReceiver's step alone (CUDA
events, the mean of 10 steps after 2).  With --control the reference one
format lower runs in the program's place as well.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL_FILES = ROOT / "benchmark" / "tests" / "antenna_cell"
CONFIG = "fm0_antenna3_stereo_rds_fast"
RASTER_HZ = 200_000


def add_antenna_cell(root: Path, name: str = "antenna3.batch",
                     traffic: dict | None = None) -> str:
    """antenna_cell/'s files as new files under root/benchmark (and the
    traffic `traffic` as traffic/<name's mix>.json where given), the
    cell `name`'s entries in root/BENCHMARK.json; returns the name."""
    for src in sorted(CELL_FILES.rglob("*")):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = root / "benchmark" / src.relative_to(CELL_FILES)
            if dst.exists():
                raise FileExistsError(dst)
            shutil.copy(src, dst)
    mix = name.split(".")[0] if traffic is not None else "antenna3"
    if traffic is not None:
        (root / "benchmark" / "traffic" / f"{mix}.json").write_text(
            json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": CONFIG, "source": "antenna_cell",
        "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
        "why": "the antenna layout"})
    bench["workloads"].append({"name": name, "config": CONFIG,
                               "traffic": mix, "chips": 1,
                               "why": "the antenna layout"})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_rate":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def plan_traffic(k: int) -> dict:
    """K stations on the raster across +-4 MHz (every channel for 41,
    every other for 21), the batch cells' broadcasts, 16 blocks a step."""
    step = 8_000_000 // (k - 1)
    if step % RASTER_HZ:
        raise ValueError(f"{k} stations across 8 MHz are off the raster")
    t = json.loads((ROOT / "benchmark/traffic/batch128.json").read_text())
    t.update(about=f"{k} stations {step // 1000} kHz apart on one 9.6 MS/s "
             "u8 stream", stations=k, blocks_per_step=16, programmes=4,
             check_stations=4, warmup={"min_steps": 4, "max_steps": 4},
             antenna={"fs": 9_600_000,
                      "offsets_hz": [-4_000_000 + step * s
                                     for s in range(k)],
                      "level_db": [-10, 0], "amplitude": 0.9})
    return t


def step_ms(root: Path, name: str, device) -> float:
    """The WidebandReceiver's step alone at the cell's size: CUDA events
    over 10 steps after 2, on the stream's first steps (zeros are no
    broadcast, so the synthesis runs again)."""
    import torch
    from benchmark import harness
    cell = harness.load_cell(root, name)
    conf, t = cell.config, cell.traffic
    sysm = cell.module("systems", conf["system"])
    ant = t["antenna"]
    nbytes = sysm.step_bytes(conf, t["blocks_per_step"], antenna=ant)
    traffic = harness.make_traffic(cell, nbytes, 1, device)
    prog = sysm.build(conf, t["blocks_per_step"], device, antenna=ant)
    blocks = [torch.from_numpy(traffic.step(j)).to(device)
              for j in range(traffic.buffer_steps)]
    for j in range(2):
        prog.step(blocks[j])
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for j in range(10):
        prog.step(blocks[(2 + j) % len(blocks)])
    b.record()
    torch.cuda.synchronize()
    prog.free()
    return a.elapsed_time(b) / 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stations", type=int, nargs="+", default=[41, 21])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 19)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("size_antenna needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    made = {}
    synth_traffic = harness.make_traffic

    def timed(cell, nbytes, seed, dev):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = synth_traffic(cell, nbytes, seed, dev)
        torch.cuda.synchronize()
        made.update(synth_s=time.perf_counter() - t0,
                    synth_peak_bytes=torch.cuda.max_memory_allocated(),
                    buffer_bytes=out.buf.nbytes)
        return out
    harness.make_traffic = timed
    for k in args.stations:
        root = ROOT / "build" / "size_antenna" / f"k{k}"
        shutil.rmtree(root, ignore_errors=True)
        (root / "benchmark").mkdir(parents=True)
        shutil.copy(ROOT / "BENCHMARK.json", root)
        shutil.copytree(ROOT / "benchmark", root / "benchmark",
                        dirs_exist_ok=True, ignore=shutil.ignore_patterns(
                            "__pycache__", "tests", "tools"))
        name = add_antenna_cell(root, f"wideband{k}.batch", plan_traffic(k))
        for system in ["program"] + (["control"] if args.control else []):
            made.clear()
            r = harness.run_cell(root, name, args.seed, args.seconds, False,
                                 t_start=time.perf_counter(), device=device,
                                 system=system)
            line = {"stations": k, "system": system, **made,
                    "correct": r["correct"],
                    "compared": {n: v["value"] for n, v in
                                 r["compared"].items()},
                    "metrics": {n: v["value"] for n, v in
                                r["metrics"].items()},
                    "device": r["device"], "notes": r["notes"]}
            if system == "program":
                line["step_ms_alone"] = step_ms(root, name, device)
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
