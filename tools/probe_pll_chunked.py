#!/usr/bin/env python3
"""Kernel-only probes of the chunked carrier loop (B9/B10) on the card.
Each probe builds a copy of a pll.cu with one part of the chunk's chain
swapped for another candidate, and measures `chunk_floor_kernel` (one warp
an instance alone over 4096 samples in shared memory, clock64 cycles) at
phase 2c's floor shapes: exact chunk 16, polynomial chunk 32, and the
joint launch's two instances at chunk 32.  For each source as it is it
also times the chunked kernel itself at 128 stations x 768,000 samples,
float32 and bf16 inputs (CUDA events, mean of 3 after a warm-up):

    python3 tools/probe_pll_chunked.py [SOURCE ...]

SOURCE is a pll.cu (default: the checkout's); another commit's source,
e.g. `git show <commit>:sdr_tpu_torch/csrc/pll.cu > build/parent/pll.cu`,
is measured as it is.  The candidates, each against the source's chain:
  - sinf + cosf: the prediction's pair by two libm calls, not one sincosf;
  - pair scan: the carried sums by one inclusive scan of the pair
    (cumsum(e), cumsum(cumsum(e))) and a broadcast of the last lane, not
    the xor butterfly;
  - two scans: the two inclusive scans one after the other and the
    broadcast (the chain before the redesign);
  - fmodf wrap / FAST wrap: the wrap by fmodf plus the sign fix, or by
    mod_floor's (-b, 2b) shortcut, not the quotient shortcut.
The scan candidates take the lane's sums as its one sample's e, so they
hold for chunks of at most 32.  A probe's state is meaningless.  Imports
nothing of jax or sdr_tpu; builds under build/probes/ (build_variants of
tools/probe_frontend.py).
"""

from __future__ import annotations

import ctypes
import itertools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from probe_frontend import build_variants  # noqa: E402

FLOOR_N, STATIONS, N, FS = 4096, 128, 768_000, 240e3
PILOT = (19e3, FS, 2.0, 0.0, 0.01)
CARRIER = (114e3, FS, 0.5, 0.0, 0.003)
BUTTERFLY = (r"#pragma unroll\n  for \(int d = 1; d < 32; d <<= 1\) \{\n"
             r"    if \(d < width\) \{\n"
             r"      se = __fadd_rn\(se, __shfl_xor_sync\(0xffffffffu, se, d\)\);"
             r"\n      sw = __fadd_rn\(sw, __shfl_xor_sync\(0xffffffffu, sw, d\)\);"
             r"\n    \}\n  \}")
PAIR_SCAN = """{
    float ce = se, cs = se;
    const int sl = threadIdx.x & (width - 1);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d < width) {
        const float ca = __shfl_up_sync(0xffffffffu, ce, d, width);
        const float sa = __shfl_up_sync(0xffffffffu, cs, d, width);
        if (sl >= d) {
          cs = __fadd_rn(__fadd_rn(sa, cs), __fmul_rn((float)d, ca));
          ce = __fadd_rn(ca, ce);
        }
      }
    }
    se = __shfl_sync(0xffffffffu, ce, width - 1, width);
    sw = __shfl_sync(0xffffffffu, cs, width - 1, width);
  }"""
TWO_SCANS = """{
    const int sl = threadIdx.x & (width - 1);
    float ce = se;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d < width) {
        const float u = __shfl_up_sync(0xffffffffu, ce, d, width);
        if (sl >= d) ce = __fadd_rn(u, ce);
      }
    }
    float cs = ce;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d < width) {
        const float u = __shfl_up_sync(0xffffffffu, cs, d, width);
        if (sl >= d) cs = __fadd_rn(u, cs);
      }
    }
    se = __shfl_sync(0xffffffffu, ce, width - 1, width);
    sw = __shfl_sync(0xffffffffu, cs, width - 1, width);
  }"""
WRAP = r"acc = mod_floor_q\(acc_last, p\.wmod, inv_wmod\);"
CANDIDATES = {
    "sinf + cosf": [(r"sincosf\(pred, &sn, &cs\);",
                     "sn = sinf(pred);\n  cs = cosf(pred);")],
    "pair scan": [(BUTTERFLY, PAIR_SCAN)],
    "two scans": [(BUTTERFLY, TWO_SCANS)],
    "fmodf wrap": [(WRAP, "acc = mod_floor<false>(acc_last, p.wmod);")],
    "FAST wrap": [(WRAP, "acc = mod_floor<true>(acc_last, p.wmod);")],
}
# (name, chunk, exact, instances)
FLOORS = (("exact16", 16, True, (PILOT,)), ("poly32", 32, False, (PILOT,)),
          ("joint32", 32, False, (PILOT, CARRIER)))


def variants(src: str) -> dict[str, str]:
    """{name: source}: the source as it is and, where it has the
    butterfly chain, each candidate; raises where an anchor is missing."""
    out = {"as it is": src}
    if "chunk_update" not in src:
        return out
    for name, subs in CANDIDATES.items():
        text = src
        for pat, rep in subs:
            text, n = re.subn(pat, lambda _: rep, text)
            if n == 0:
                raise SystemExit(f"probe {name!r}: anchor {pat!r} not found")
        out[name] = text
    return out


def tones(c: int, n: int, freq: float, seed: int) -> np.ndarray:
    """Locked-loop inputs: tones with a little noise (float32)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = (0.3 * np.cos(2 * np.pi * freq * t + rng.uniform(0, 6, (c, 1)))
         + rng.normal(0, 0.02, (c, n)))
    return x.astype(np.float32)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes run on the GPU")
    from sdr_tpu_torch.ops.cuda import build
    from sdr_tpu_torch.ops.pll import loop_params
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    dev = "cuda"
    xf = {g: torch.from_numpy(tones(1, FLOOR_N, p[0], g)[0]).to(dev)
          for g, p in enumerate((PILOT, CARRIER))}
    pilot = torch.from_numpy(tones(STATIONS, N, PILOT[0], 10)).to(dev)
    carrier = torch.from_numpy(tones(STATIONS, N, CARRIER[0], 11)).to(dev)
    inputs = {"f32": (pilot, carrier),
              "bf16": (pilot.to(torch.bfloat16), carrier.to(torch.bfloat16))}
    st = torch.zeros((5, STATIONS), device=dev)
    st[2] = 1.0
    ncos = [torch.empty_like(pilot), torch.empty_like(carrier)]
    outs = [torch.empty((4, STATIONS), device=dev) for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream
    sources = [Path(a) for a in sys.argv[1:]] or [
        ROOT / "sdr_tpu_torch" / "csrc" / "pll.cu"]
    todo = [(src, name, text) for src in sources
            for name, text in variants(src.read_text()).items()]
    libs = build_variants([text for *_, text in todo])
    for (src, name, _), lib_path in zip(todo, libs):
        lib = ctypes.CDLL(str(lib_path))
        for fn in ("sdr_pll_chunk_floor", "sdr_pll_chunked"):
            restype, argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes

        def check(err):
            if err:
                raise RuntimeError(f"{src} {name}: CUDA error {err}")
        for label, chunk, exact, params in FLOORS:
            g = len(params)
            x = torch.stack([xf[i] for i in range(g)]).contiguous()
            sti = torch.tensor([[0.0, 0.0]] * g, device=dev)
            fin = torch.empty((g, 4), device=dev)
            timing = torch.zeros((g, 2), dtype=torch.int64, device=dev)
            prm = np.asarray([loop_params(*p) for p in params], np.float32)
            cycles = []
            for _ in range(3):
                check(lib.sdr_pll_chunk_floor(
                    x.data_ptr(), FLOOR_N, g, chunk, sti.data_ptr(),
                    fin.data_ptr(), timing.data_ptr(), prm.ctypes.data,
                    int(exact), stream))
                torch.cuda.synchronize()
                cycles.append(timing[:, 0].max().item() / FLOOR_N)
            cps = sorted(cycles)[1]
            print(f"probe chunked floor {src.parent.name}/{src.name}: "
                  f"{name:12s} {label:8s} {cps:.2f} cycles a sample, "
                  f"{cps * chunk:.0f} a chunk (median of 3, {g} warp(s) "
                  f"over {FLOOR_N} samples)", flush=True)
        if name != "as it is":
            continue
        for (label, chunk, exact, params), dtype in itertools.product(
                FLOORS, inputs):
            g = len(params)
            xs = inputs[dtype][:g]
            ptrs = []
            for i in range(g):
                ptrs += [xs[i].data_ptr(), st.data_ptr(), ncos[i].data_ptr(),
                         outs[i].data_ptr()]
            ptrs = (ctypes.c_longlong * (4 * g))(*ptrs)
            chans = (ctypes.c_int * g)(*([STATIONS] * g))
            prm = np.asarray([loop_params(*p) for p in params], np.float32)

            def launch():
                check(lib.sdr_pll_chunked(g, ptrs, chans, prm.ctypes.data,
                                          int(dtype == "bf16"), N, chunk,
                                          int(exact), 1, stream))
            launch()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                launch()
            end.record()
            torch.cuda.synchronize()
            print(f"probe chunked kernel {src.parent.name}/{src.name}: "
                  f"{label:8s} {start.elapsed_time(end) / 3:.4f} ms "
                  f"({g} x {STATIONS} x {N}, {dtype}, mean of 3)",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
