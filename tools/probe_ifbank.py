#!/usr/bin/env python3
"""Kernel-only probes of the IF bank with mix sums (B3) on the card: each
probe builds a copy of csrc/ifbank.cu with one phase of the bf16 engine's
kernel knocked out, and times sdr_ifbank_mix at the stereo + RDS --fast
shape (128 stations x 768,000 IF samples, bf16 fm, compute and streams;
CUDA events over 20 launches after a warm-up), beside the source as it is
and beside the four-stream variant (B6) of the same source:

    python3 tools/probe_ifbank.py [SOURCE]

SOURCE is an ifbank.cu of the same design (default: the checkout's).

The phases knocked out: the staging (no window or ramp rows are copied),
the RDS channel (its FIR and square), the window sums, the stores of chan
and rds.  A probe's outputs are meaningless.  Imports nothing of jax or
sdr_tpu; builds under build/probes/ (build_variants of
tools/probe_frontend.py).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from probe_frontend import build_variants  # noqa: E402

STATIONS, N, REPS = 128, 768_000, 20
KNOCKOUTS = {
    "no staging": [(r"(\n  const int c0 = \(int\)\(it / tiles\) \* kMmaWarps;"
                    r"\n  const long long t0 = \(it % tiles\) \* kTileT;\n"
                    r"  __nv_bfloat16\* fmb)", r"\n  return;\1")],
    "no RDS channel": [(r"for \(int j = 0; j <= kWarpTiles; \+\+j\) \{",
                        "for (int j = 0; j < 0; ++j) {")],
    "no sums": [(r"      if constexpr \(MIX\) \{\n        // the lane's",
                 "      if constexpr (false) {\n        // the lane's")],
    "no stores": [(r"(store_stream<OUT_BF16>\(a\.(chan|rdsch), )",
                   r"if (c < 0) \1")],
}


def variants(src: str) -> dict[str, str]:
    out = {"full": src}
    for name, subs in KNOCKOUTS.items():
        text = src
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text)
            if n == 0:
                raise SystemExit(f"probe {name!r}: anchor {pat!r} not found")
        out[name] = text
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes run on the GPU")
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.ops import firdes
    from sdr_tpu_torch.ops.cuda import build
    from sdr_tpu_torch.ops.cuda.ifbank_kernel import FusedIFBankMix
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    cfg = MODES[0]
    bp = lambda lo, hi: firdes.bandpass(cfg.if_fs, lo, hi, cfg.bp_taps)
    bf16 = torch.bfloat16
    bank = FusedIFBankMix(
        bp(cfg.stereo_lo, cfg.stereo_hi), bp(cfg.pilot_lo, cfg.pilot_hi),
        bp(cfg.rds_lo, cfg.rds_hi), bp(cfg.rds_carrier_lo, cfg.rds_carrier_hi),
        window=256, pilot_freq=cfg.pilot_freq,
        rds_carrier_freq=cfg.rds_carrier_freq, fs=cfg.if_fs,
        compute_dtype=bf16, out_dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fm = (0.3 * torch.randn((STATIONS, N), device="cuda",
                            generator=gen)).to(bf16)
    tail = bank.init_state((STATIONS,)).to(bf16)
    (cp, sp), (cr, sr) = bank.ramps(N, fm.device)
    outs = torch.empty((4, STATIONS, N), dtype=bf16, device="cuda")
    z = torch.empty((4, STATIONS, N // 256), device="cuda")
    taps = bank._taps_ptr(fm.device)
    stream = torch.cuda.current_stream().cuda_stream
    src = Path(sys.argv[1] if len(sys.argv) > 1 else
               ROOT / "sdr_tpu_torch" / "csrc" / "ifbank.cu").read_text()
    todo = list(variants(src).items())
    libs = build_variants([text for _, text in todo])
    for (name, _), lib_path in zip(todo, libs):
        lib = ctypes.CDLL(str(lib_path))
        for fn in ("sdr_ifbank_mix", "sdr_ifbank"):
            restype, argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        calls = {name: lambda: lib.sdr_ifbank_mix(
            fm.data_ptr(), tail.data_ptr(), 1, STATIONS, N, taps, 51, 1,
            cp.data_ptr(), sp.data_ptr(), cr.data_ptr(), sr.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), 1, *(
                zz.data_ptr() for zz in z), stream)}
        if name == "full":
            calls["four streams (B6)"] = lambda: lib.sdr_ifbank(
                fm.data_ptr(), tail.data_ptr(), 1, STATIONS, N, taps, 51, 1,
                *(o.data_ptr() for o in outs), 1, stream)
        for label, call in calls.items():
            for _ in range(2):
                if err := call():
                    raise RuntimeError(f"{label}: CUDA error {err}")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                call()
            end.record()
            torch.cuda.synchronize()
            print(f"probe ifbank: {label:17s} "
                  f"{start.elapsed_time(end) / REPS:.4f} ms (bf16, "
                  f"{STATIONS} x {N}, mean of {REPS})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
