#!/usr/bin/env python3
"""The device's idle gaps in a CLI trace, by the program span over each.

    python3 tools/trace_gaps.py DIR/trace.json [--skip-steps 1] [--min-us 0]

DIR/trace.json is the Chrome trace that `python -m sdr_tpu_torch ...
--profile DIR` writes.  The window runs from the start of the first
`receiver.step` after the skipped ones (default 1: a process's first step
builds or loads the kernels) to the end of the last of the program's
spans (sdr_tpu_torch/io/logger.py NAMES); a gap is a stretch of it with
no kernel, copy or fill on the device, and it is named by the innermost
program span over its middle ('host' where none is).  Prints,
for each name, the gaps, their total and longest ms and their share of
the window, the longest first.  The host's spans and the device's events
share the trace's clock.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sdr_tpu_torch.io.logger import NAMES  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def idle_gaps(events: list, skip_steps: int = 0
              ) -> tuple[float, float, list]:
    """(window_us, busy_us, [(start_us, dur_us, span name)]) of a trace's
    complete events, from the start of receiver.step number skip_steps
    (counted from 0; with 0, from the first program span)."""
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((ts, ts + dur))
        elif e.get("cat") == "user_annotation" and e.get("name") in NAMES:
            spans.append((ts, ts + dur, e["name"]))
    steps = sorted(a for a, _, n in spans if n == "receiver.step")
    if not spans or skip_steps >= max(len(steps), 1):
        return 0.0, 0.0, []
    lo = steps[skip_steps] if skip_steps else min(a for a, _, _ in spans)
    hi = max(b for _, b, _ in spans)
    merged: list = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in dev
                       if b > lo and a < hi):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            over = [(e - s, n) for s, e, n in spans if s <= mid <= e]
            gaps.append((a, b - a, min(over)[1] if over else "host"))
    return hi - lo, sum(b - a for a, b in merged), gaps


def by_span(gaps: list, min_us: float = 0.0) -> list:
    """[(name, gaps, total_us, longest_us)], the largest total first."""
    rows: dict = {}
    for _, d, n in gaps:
        if d >= min_us:
            k, t, m = rows.get(n, (0, 0.0, 0.0))
            rows[n] = (k + 1, t + d, max(m, d))
    return sorted(((n, *v) for n, v in rows.items()), key=lambda r: -r[2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--skip-steps", type=int, default=1,
                    help="leave out the first steps (kernel build, loads)")
    ap.add_argument("--min-us", type=float, default=0.0,
                    help="leave out gaps shorter than this")
    args = ap.parse_args(argv)
    data = json.loads(Path(args.trace).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    window, busy, gaps = idle_gaps(events, args.skip_steps)
    if window <= 0:
        print("no program span in the trace after the skipped steps",
              file=sys.stderr)
        return 1
    print(f"window {window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / window:.2f}%), {len(gaps)} idle gaps")
    print(f"{'span':<20} {'gaps':>6} {'idle ms':>10} {'longest ms':>10} "
          f"{'% window':>9}")
    for name, k, total, longest in by_span(gaps, args.min_us):
        print(f"{name:<20} {k:>6} {total / 1e3:>10.3f} {longest / 1e3:>10.3f}"
              f" {100 * total / window:>9.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
