#!/usr/bin/env python3
"""Step times of the port's receivers in two checkouts, on one card.

    python3 tools/time_steps.py [--cells NAME,...] CHECKOUT [CHECKOUT ...]

Each CHECKOUT (a directory holding sdr_tpu_torch/ and chip_smoke.py, e.g.
the parent commit unpacked with `git archive <commit> | tar -x -C
build/parent`, and `.`) is timed in a process of its own, in the order
given (list them as parent, change, change, parent).  The cells are
chip_smoke.py's, built with that checkout's own helpers and profiles:
  - mono --fast, 128 stations x 5.12 MB a step;
  - stereo + RDS --fast, 128 stations x 15.36 MB;
  - --stations --fast (the bf16 front end, unfused feedforward chain), the
    same shape;
  - ifbank joint (B1 bf16, the four-stream IF bank, one chunked launch
    for both loops, the tiled engine), the same shape;
  - wideband mono and stereo + RDS --fast, 64 stations of one 9.6 MS/s u8
    stream, 16 blocks a step (host-paced: the spread shows there);
  - the wideband mono --fast run over two such steps, serial
    (WidebandReceiver.run) and station-sharded on chip_smoke.py's virtual
    mesh of 8 shards (parallel/wideband.py, phase 5e's call).
Each step cell: two warm-up steps, then 7 repetitions of 10 steps between
CUDA events; each run cell: one warm-up run, then 7 runs between CUDA
events.  The line gives the median ms a step and the min..max.  The input
is resident on the card.  --cells keeps the cells whose names start with
the comma-separated NAMEs (e.g. `--cells "mono --fast,stereo+RDS
--fast,ifbank"`).  Imports nothing of jax or sdr_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def time_cell(step, state, blocks, reps: int = 7, steps: int = 10):
    import torch
    for i in range(2):
        state = step(state, blocks[i % len(blocks)])
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(steps):
            state = step(state, blocks[i % len(blocks)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / steps)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def time_runs(run, nsteps: int, reps: int = 7):
    """(median, min, max) ms a step of run(), a whole run of nsteps
    steps, between CUDA events after one warm-up run."""
    import torch
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / nsteps)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def child(root: Path, cells: list[str]) -> None:
    """Times the cells with root's package and helpers (those whose names
    start with one of `cells`, all where it is empty); prints one JSON
    line."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.models.wideband import WidebandReceiver
    from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
    dev = "cuda"
    out = {}

    def want(name):
        return not cells or any(name.startswith(c) for c in cells)

    def rx_step(rx):
        def step(state, blk):
            return rx.step(state, blk)[0]
        return step

    mono_kw = cs.REAL_PROFILES["fast_int8"]
    bs = Receiver(0, device=dev, **mono_kw).block_size_u8(50)
    blocks = cs.station_blocks(cs.capture(2 * bs / 2 / 2.4e6 + 0.01), 128,
                               bs, 2, dev)
    if want("mono --fast"):
        rx = Receiver(0, device=dev, **mono_kw)
        out["mono --fast"] = time_cell(rx_step(rx), rx.init_state((128,)),
                                       blocks)
        del rx
    del blocks
    stations_fast = dict(stereo=True, rds=True, fused_frontend="bf16",
                         pll_impl="ff", conv_dtype="bf16")
    sbs = Receiver(0, device=dev, **cs.STEREO_PROFILE).block_size_u8(50)
    sblocks = cs.station_blocks(cs.stereo_capture(2 * sbs / 2 / 2.4e6 + 0.01),
                                128, sbs, 2, dev)
    for name, kw in (("stereo+RDS --fast", cs.STEREO_PROFILE),
                     ("--stations --fast", stations_fast),
                     ("ifbank joint", cs.IFBANK_JOINT_PROFILE)):
        if not want(name):
            continue
        rx = Receiver(0, device=dev, **kw)
        out[name] = time_cell(rx_step(rx), rx.init_state((128,)), sblocks)
        del rx
        torch.cuda.empty_cache()
    del sblocks
    torch.cuda.empty_cache()
    for name, kw in (("wideband mono --fast", cs.WIDE_FAST),
                     ("wideband stereo+RDS --fast",
                      dict(cs.WIDE_FAST, stereo=True, rds=True))):
        if not want(name):
            continue
        chan = WidebandChannelizer(cs.FS_WIDE, 2.4e6, cs.WIDE_FREQS,
                                   engine="pallas", ingest="u8",
                                   compute_dtype="bf16", device=dev)
        wrx = WidebandReceiver(chan, Receiver(0, device=dev, **kw))
        bw = wrx.block_wide(cs.WIDE_BLOCKS_PER_STEP)
        wide = cs.wideband_stations_u8(dev, bw)   # 2 * bw scalars
        blocks = [wide[b * bw:(b + 1) * bw] for b in range(2)]

        def step(state, blk, wrx=wrx):
            return wrx.step(state, blk)[0]
        out[name] = time_cell(step, wrx.init_state(), blocks)
        if kw is cs.WIDE_FAST:
            from sdr_tpu_torch.parallel.wideband import sharded_wideband_run
            mesh = cs.virtual_mesh("stations")
            out["wideband mono --fast, serial run"] = time_runs(
                lambda: wrx.run(wide, blocks_per_step=cs.WIDE_BLOCKS_PER_STEP),
                2)
            out["wideband mono --fast, 8 virtual shards"] = time_runs(
                lambda: sharded_wideband_run(
                    chan, wrx.rx, wide, mesh,
                    blocks_per_step=cs.WIDE_BLOCKS_PER_STEP), 2)
        del wrx, wide, blocks
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]).resolve(),
              [c for c in sys.argv[3].split(",") if c])
        return 0
    args = sys.argv[1:]
    cells = ""
    if args[:1] == ["--cells"] and len(args) >= 2:
        cells, args = args[1], args[2:]
    roots = [Path(r).resolve() for r in args]
    if not roots:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    for root in roots:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(root), cells], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], flush=True)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for name, (med, lo, hi) in times.items():
            print(f"{root.name or root}: {name}: {med:.3f} ms/step "
                  f"(median of 7, {lo:.3f}..{hi:.3f})", flush=True)
        print(f"{root}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
