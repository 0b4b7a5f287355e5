#!/usr/bin/env python3
"""Kernel-only probes of the fused front end's int8 demod kernel (B1) on
the card.  Each probe builds a copy of a frontend.cu with one phase
knocked out, and times the demod entry point at the mono --fast shape
(128 stations x 5.12 MB of u8, int8 taps, bf16 fm; CUDA events over 20
launches after a warm-up), beside the source as it is:

    python3 tools/probe_frontend.py [SOURCE ...]

SOURCE is a frontend.cu (default: the checkout's), of either design the
port has had: the dp4a kernel over I/Q planes, or the tensor-core
kernel.  The phases knocked out:
  - staging: no bytes are copied into shared memory (the FIR reads what
    is there);
  - FIR: the products are replaced by one read of the staged window;
  - discriminator: the division and the products around it are dropped;
  - stores: fm is not written (its value is still computed).
A probe's time against the full kernel's says what that phase costs where
the others overlap it.  The outputs of a probe are meaningless.  Imports
nothing of jax or sdr_tpu; builds under build/probes/.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STATIONS, NBYTES, REPS = 128, 5_120_000, 20

# knock-outs per design: name -> [(regex, replacement), ...]
DP4A = {
    "no staging": [(r"\n  stage\(g, c, ws, we, pi, pq\);", "\n")],
    "no FIR": [(r"fir<E>\(pi, pq,[^;]*;",
                "{ I = pi[threadIdx.x]; Q = pq[threadIdx.x]; }")],
    "no discriminator": [(r"const float fm = den == 0\.f \? 0\.f : "
                          r"__fdiv_rn\(num, den\);",
                          "const float fm = num + den;")],
    "no stores": [(r"(static_cast<__nv_bfloat16\*>\(o\.fm\)\[row \+ m\] = "
                   r"__float2bfloat16_rn\(fm\);)",
                   r"{ if (fm == 1234.5f) \1 }")],
}
MMA = {
    "no staging": [(r"(  const bool guard = slot == 0;)", r"  return;\n\1")],
    "no FIR": [(r"mma_s8\((\w+), a_\w+\[k\], (\w+), (\w+)\);",
                r"\1[0] ^= \2 ^ \3;")],
    "no discriminator": [(r"const float fm = discriminate\(I\[j\], Q\[j\], "
                          r"pi\[j\], pq\[j\], den\);",
                          "den = I[j]; "
                          "const float fm = Q[j] + pi[j] + pq[j];")],
    "no stores": [(r"(\*reinterpret_cast<uint4\*>\(gdst \+ p \* es\) =)",
                   r"if (n_valid == 1) \1")],
}


def variants(src: str) -> dict[str, str]:
    """{name: source}: the source as it is and each knock-out of its
    design; raises where a knock-out's anchor is missing."""
    table = MMA if "frontend_mma_kernel" in src else DP4A
    out = {"full": src}
    for name, subs in table.items():
        text = src
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text)
            if n == 0:
                raise SystemExit(f"probe {name!r}: anchor {pat!r} not found")
        out[name] = text
    return out


def build_variants(texts: list[str]) -> list[Path]:
    """One shared library per source text, one nvcc each, all started
    together; a library already built is reused."""
    from sdr_tpu_torch.ops.cuda import build
    outs, jobs = [], []
    for text in texts:
        h = hashlib.sha256(text.encode() + " ".join(build.NVCC_FLAGS).encode())
        out = ROOT / "build" / "probes" / h.hexdigest()[:16] / "libprobe.so"
        outs.append(out)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        cu = out.with_name("frontend.cu")
        cu.write_text(text)
        jobs.append((out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    for out, proc in jobs:
        stdout, stderr = proc.communicate()
        (out.parent / "build.log").write_text(stdout + stderr)
        if proc.returncode:
            raise SystemExit(f"nvcc failed:\n{stderr[-3000:]}")
    return outs


def time_variant(lib_path: Path, mma: bool, fe, blk, tail) -> float:
    import torch
    from sdr_tpu_torch.ops.cuda import build
    lib = ctypes.CDLL(str(lib_path))
    for name in ("sdr_frontend_demod", "sdr_frontend_demod_blocks",
                 "sdr_error_string"):
        restype, argtypes = build.SIGNATURES[name]
        getattr(lib, name).restype = restype
        getattr(lib, name).argtypes = argtypes
    taps = (fe._taps_ptr(blk.device) if mma
            else fe._kernel_taps.ctypes.data)
    c, n = blk.shape
    n_out = n // (2 * fe.decim)
    dev = blk.device
    fm = torch.empty((c, n_out), dtype=torch.bfloat16, device=dev)
    prev = torch.zeros(c, device=dev)
    last_i, last_q, power = (torch.empty(c, device=dev) for _ in range(3))
    partials = torch.empty(c, lib.sdr_frontend_demod_blocks(n_out),
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.sdr_frontend_demod(
            blk.data_ptr(), tail.data_ptr(), c, n, fe.decim, 2, taps,
            fe.taps, fe.scale, prev.data_ptr(), prev.data_ptr(),
            fm.data_ptr(), 1, last_i.data_ptr(), last_q.data_ptr(),
            partials.data_ptr(), power.data_ptr(), stream)
        if err:
            raise RuntimeError(lib.sdr_error_string(err).decode())
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes run on the GPU")
    sys.path.insert(0, str(ROOT))
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.ops import firdes
    from sdr_tpu_torch.ops.cuda.frontend_kernel import FusedFrontend
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    cfg = MODES[0]
    fe = FusedFrontend(firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1),
                       cfg.rf_decim, compute_dtype="int8",
                       out_dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    blk = torch.randint(0, 256, (STATIONS, NBYTES), dtype=torch.uint8,
                        device="cuda", generator=gen)
    tail = fe.init_state((STATIONS,))
    sources = [Path(a) for a in sys.argv[1:]] or [
        ROOT / "sdr_tpu_torch" / "csrc" / "frontend.cu"]
    todo = [(src, "frontend_mma_kernel" in src.read_text(), name, text)
            for src in sources
            for name, text in variants(src.read_text()).items()]
    libs = build_variants([text for *_, text in todo])
    for (src, mma, name, _), lib in zip(todo, libs):
        ms = time_variant(lib, mma, fe, blk, tail)
        print(f"probe {src}: {name:17s} {ms:.4f} ms (int8 -> bf16 fm, "
              f"{STATIONS} x {NBYTES} B, mean of {REPS})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
