"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `sdr_tpu_torch`, on a machine with
at least the cards the cell asks for.  The last line of standard output is
one JSON object (correct, attempted, failed, metrics, device[, breakdown],
compared); the last lines of standard error give each compared number
beside its limit.  With --trace 0 the metrics are the cell's end-to-end
metrics, with --trace 1 its per-layer metrics from a torch.profiler trace
of the window.  Exits non-zero without a result when the cards are
missing or when jax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches at fixed paths inside the checkout (the port's own CUDA
# build lands in build/kernels/ there already)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def _plain(v):
    """A compared number as JSON takes it: one that is not finite as its
    name ('inf', 'nan'), since strict JSON has no such number."""
    return v if not isinstance(v, float) or math.isfinite(v) else repr(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    chips = next(w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
        print(f"card: {limit}", file=sys.stderr)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"card: nvidia-smi not read ({e})", file=sys.stderr)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"notes: {json.dumps(result.pop('notes'))}", file=sys.stderr)
    for name, row in result["compared"].items():
        row["value"] = _plain(row["value"])
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
