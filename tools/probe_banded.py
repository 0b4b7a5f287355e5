#!/usr/bin/env python3
"""Kernel-only probes of the tiled engine's FIR (csrc/banded.cu) on the
card.  Each probe builds a copy of a checkout's banded.cu with one phase
knocked out, and times TiledBandedFIR's launch in every geometry of
chip_smoke.py's `banded_cases` (the main path's shapes) and both engines,
beside the source as it is:

    python3 tools/probe_banded.py [CHECKOUT ...]

Each CHECKOUT (default: the one holding this script) is a directory with
sdr_tpu_torch/, e.g. the parent commit unpacked with `git archive
<commit> | tar -x -C build/parent`; each is probed in a process of its
own, with that checkout's wrapper, and its TiledBandedFIR launching the
variant's library.  The phases knocked out:
  - staging: no sample is copied from device memory into shared memory
    (the sums read what is there);
  - sums: the multiply-adds are dropped (the CUDA-core bodies: each
    walk keeps its shared loads and adds the samples; the tensor-core
    bodies: no mma and no operand loads);
  - stores: y is not written (its value is still computed);
  - convert (the tensor-core design's general body): the staged window
    is not rounded and copied into the bf16 window the mma reads.
A probe's time against the full kernel's says what that phase costs where
the others overlap it; its outputs are meaningless.  Time: the profiler's
device time of the `banded_` kernels, mean of 10 launches after a warm-up.
Imports nothing of jax or sdr_tpu; builds under build/probes/
(build_variants of tools/probe_frontend.py).
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 10

# knock-outs per design: name -> [(regex, replacement), ...]
SIMT = {   # staged window, CUDA-core walks (every body of a source
    # without banded_mma_kernel; the float32 engine's bodies otherwise)
    "no staging": [(r"(  const long long qend = \(long long\)a\.s \+ a\.n;"
                    r"\n  if \(q0 >= a\.s)", r"  if (count > 0) return;\n\1")],
    "no sums": [(r"if \(k >= 0 && k < T\) acc\[r\] = fmaf\(h\.h\[k\], xv, "
                 r"acc\[r\]\);", "if (k == 0) acc[r] += xv;"),
                (r"if \(j >= 0 && j < M\) acc\[k\] = fmaf\(h\.p\[\(kV0 \+ k\)"
                 r" \* M \+ j\], xv, acc\[k\]\);", "if (j == 0) acc[k] += xv;"),
                (r"acc = fmaf\(__ldg\(bv \+ \(size_t\)j \* up\), wo\[j\], "
                 r"acc\);", "acc += wo[j];")],
    "no stores": [(r"if \(o < a\.n_out\) y\[o\] = w\[p\];",
                   "if (o < 0) y[o] = w[p];"),
                  (r"\n    y\[p\] = wo\[p\];",
                   "\n    if (p < 0) y[p] = wo[p];"),
                  (r"\n    y\[i\] = acc;", "\n    if (acc == 1234.5f) y[i] = "
                   "acc;")],
}
MMA = {   # copy rings, bf16 sums on the tensor cores; the float32
    # engine's bodies keep SIMT's anchors
    "no staging": SIMT["no staging"] + [
        (r"(\n  for \(long long c = sp\.cl \+ w\.t;)",
         r"\n  if (it >= 0) return;\1"),
        (r"for \(int q = threadIdx\.x; q < kChunks;",
         "for (int q = threadIdx.x; q < 0;")],
    "no convert": [(r"for \(int p8 = 8 \* wr\.t; !a\.direct && p8 < a\.win;",
                    "for (int p8 = 8 * wr.t; p8 < 0;"),
                   (r"(\n    for \(int p = "
                    r"(?:wr\.t - sp\.b0|sp\.phi \+ wr\.t);)",
                    r"\n    if (st == nullptr)\1")],
    "no sums": SIMT["no sums"] + [
        (r"for \(int kt = klo; kt <= khi; \+\+kt\) \{",
         "for (int kt = klo; kt < 0; ++kt) {"),
        (r"for \(int kk = 0; kk < KS; \+\+kk\) \{\n        uint2 b;",
         "for (int kk = 0; kk < 0; ++kk) {\n        uint2 b;")],
    "no stores": SIMT["no stores"] + [
        (r"(\n        if \(col < a\.cols)", r"\n        if (col < 0)\1"),
        (r"\n      u1_store\(", "\n      if (row < 0) u1_store(")],
}


def variants(src: str) -> dict[str, str]:
    """{name: source}: the source as it is and each knock-out of its
    design; raises where a knock-out's anchor is missing."""
    table = MMA if "banded_mma_kernel" in src else SIMT
    out = {"full": src}
    for name, subs in table.items():
        text = src
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text)
            if n == 0:
                raise SystemExit(f"probe {name!r}: anchor {pat!r} not found")
        out[name] = text
    return out


def child(root: Path) -> None:
    """Probes root's banded.cu with root's package; prints one JSON line
    {variant: {case/engine: ms}}."""
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(ROOT / "tools"))
    import torch
    import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
    from probe_frontend import build_variants
    from sdr_tpu_torch.ops.banded import TiledBandedFIR
    from sdr_tpu_torch.ops.cuda import build
    if not str(Path(sdr_tpu_torch.__file__)).startswith(str(root)):
        raise SystemExit(f"sdr_tpu_torch was not imported from {root}")
    spec = importlib.util.spec_from_file_location("probe_cs",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src = (root / "sdr_tpu_torch" / "csrc" / "banded.cu").read_text()
    todo = list(variants(src).items())
    libs = build_variants([text for _, text in todo])
    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = cs.banded_cases()
    out = {}
    for (name, _), lib_path in zip(todo, libs):
        lib = ctypes.CDLL(str(lib_path))
        for fn, (restype, argtypes) in build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
        build.library = lambda lib=lib: lib
        res = out[name] = {}
        for case, (coeff, up, down, rows, n, in_dt) in cases.items():
            x = (0.5 * torch.randn(rows, n, generator=gen, device="cuda")
                 ).to(in_dt)
            for engine in (torch.float32, torch.bfloat16):
                fir = TiledBandedFIR(coeff, up, down, compute_dtype=engine,
                                     device="cuda")
                tail = fir.init_state((rows,)).to(in_dt)
                ms = cs.kernel_device_ms(lambda: fir(x, tail), REPS,
                                         "banded_")
                eng = "bf16" if engine == torch.bfloat16 else "f32"
                res[f"{case}/{eng}"] = ms
                del fir, tail
            del x
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]).resolve())
        return 0
    roots = [Path(r).resolve() for r in sys.argv[1:]] or [ROOT]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(root)], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], flush=True)
            return proc.returncode
        table = json.loads(proc.stdout.strip().splitlines()[-1])
        names = list(table)
        print(f"probe banded: {root}: ms by variant (" + ", ".join(names)
              + ")", flush=True)
        for key in table["full"]:
            print(f"  {key:12s} " + "  ".join(
                f"{table[v][key]:.4f}" for v in names), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
