#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (sdr_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/, holds each kernel against its plain
PyTorch version on the card, drives the mono receiver through its entry
points (the CLI with --fast and --exact-fast, and Receiver at 128 stations),
and checks the audio.  Every phase raises on failure, so a failure exits
non-zero and prints no result.  The last line of stdout is
{"ok": true, "device": {...}}; the line before it lists every kernel with
its launches on the main path, its error against the plain version and
both times.  Imports nothing of jax or sdr_tpu.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MODE = 0
STATIONS = 128
BLOCKS_PER_STEP = 50       # 50 x 102400 B = 5.12 MB of u8 per station/step
REAL_PROFILES = {          # Receiver kwargs of the 128-station runs
    "fast_int8": dict(fused_frontend="int8", fe_out_tile=1024,
                      fe_sub_tiles=8, conv_engine="tiled", conv_dtype="bf16"),
    "exact_int8x2": dict(fused_frontend="int8x2", fe_out_tile=1024,
                         fe_sub_tiles=8),
    "arctan_int8": dict(fused_frontend="int8", fe_out_tile=1024,
                        fe_sub_tiles=8, demod="arctan"),
}
KERNELS = {   # LAUNCHES key -> (source, TPU kernel it replaces)
    "frontend_demod": ("sdr_tpu_torch/csrc/frontend.cu",
                       "sdr_tpu/ops/pallas/frontend_kernel.py:194"),
    "frontend": ("sdr_tpu_torch/csrc/frontend.cu",
                 "sdr_tpu/ops/pallas/frontend_kernel.py:97"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture(seconds: float, seed: int = 0):
    """Mode-0 mono FM capture of a 1 kHz tone (numpy u8)."""
    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    cfg = MODES[MODE]
    n = int(seconds * cfg.rf_fs)
    return tx.synthesize_capture(cfg, seconds=seconds, seed=seed,
                                 mono=tx.tone(cfg.rf_fs, 1000.0, n))


def station_blocks(base, stations: int, block: int, nblocks: int, device):
    """(nblocks, stations, block) u8 on the device: station s is the base
    capture advanced by s*4099 IQ pairs (wrapped), so stations differ."""
    import torch
    src = torch.from_numpy(base[:nblocks * block]).to(device)
    rows = [torch.roll(src, -2 * 4099 * s) for s in range(stations)]
    data = torch.stack(rows).reshape(stations, nblocks, block)
    return data.transpose(0, 1).contiguous()


# ------------------------------------------------------------------ phase 2
def check_kernels(blocks, device, reps: int = 10) -> dict:
    """Each kernel and engine against its plain version, over two
    consecutive blocks; returns {(kernel, engine): (max_abs_err, ms,
    plain_ms)}.  Integer engines must agree bit for bit; the float engines
    sum in another order than the plain conv (max |err| <= 1e-5 max |ref|)."""
    import torch
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.ops import firdes
    from sdr_tpu_torch.ops.cuda.frontend_kernel import (
        FusedFrontend, frontend_demod_reference, frontend_reference)
    cfg = MODES[MODE]
    coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
    c = blocks.shape[1]
    results = {}
    variants = [("frontend", e, torch.float32)
                for e in ("f32", "bf16", "int8", "int8x2")]
    variants += [("frontend_demod", e, torch.float32)
                 for e in ("f32", "bf16", "int8", "int8x2")]
    variants += [("frontend_demod", "int8", torch.bfloat16)]
    for kernel, engine, out_dtype in variants:
        fe = FusedFrontend(coeff, cfg.rf_decim, compute_dtype=engine,
                           out_dtype=out_dtype, device=device)
        exact = engine in ("int8", "int8x2")
        tail = fe.init_state((c,))
        ptail = tail.clone()
        prev = (torch.zeros(c, device=device), torch.zeros(c, device=device))
        pprev = tuple(p.clone() for p in prev)
        err = 0.0
        for blk in blocks:
            if kernel == "frontend":
                got = fe(blk, tail)
                want = frontend_reference(fe, blk, ptail)
                names = ("i", "q", "tail")
                tail, ptail = got[2], want[2]
            else:
                got = fe.demod_call(blk, tail, *prev)
                want = frontend_demod_reference(fe, blk, ptail, *pprev)
                names = ("fm", "tail", "prev_i", "prev_q", "power")
                tail, prev = got[1], got[2:4]
                ptail, pprev = want[1], want[2:4]
            torch.cuda.synchronize()
            for name, g, w in zip(names, got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"{kernel}/{engine} {name}: "
                                         f"{g.dtype}{tuple(g.shape)} vs "
                                         f"{w.dtype}{tuple(w.shape)}")
                g, w = g.double(), w.double()
                d = (g - w).abs().max().item()
                ref = w.abs().max().item()
                if name == "power":
                    ok = d <= 1e-5 * ref
                elif exact or name == "tail":
                    ok = d == 0.0
                else:
                    ok = d <= 1e-5 * ref
                if not ok:
                    raise AssertionError(f"{kernel}/{engine} {name}: max "
                                         f"|kernel - plain| {d} (ref {ref})")
                if name != "power":
                    err = max(err, d)
        blk = blocks[0]
        if kernel == "frontend":
            ms = cuda_ms(lambda: fe(blk, tail), reps)
            plain_ms = cuda_ms(lambda: frontend_reference(fe, blk, tail), 3)
        else:
            ms = cuda_ms(lambda: fe.demod_call(blk, tail, *prev), reps)
            plain_ms = cuda_ms(
                lambda: frontend_demod_reference(fe, blk, tail, *prev), 3)
        key = (kernel, engine + ("->bf16" if out_dtype != torch.float32
                                 else ""))
        results[key] = (err, ms, plain_ms)
        log(f"kernel {kernel}/{key[1]}: (C={c}, n={blk.shape[-1]}) max|err| "
            f"{err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        del fe
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 3
def run_cli(device: str, seconds: float = 1.23) -> None:
    """The CLI's mono path with --fast and --exact-fast, in-process, and the
    fused front end without its discriminator through Receiver.run.  The
    capture is not a whole number of steps, so the EOF flush runs too."""
    import torch
    from sdr_tpu_torch import cli
    from sdr_tpu_torch.io.wav import read_wav
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.ops.cuda.frontend_kernel import LAUNCHES
    from sdr_tpu_torch.utils.compare import tone_snr_db
    cap = capture(seconds)
    profiles = {"--fast": dict(fused_frontend="int8", conv_engine="tiled",
                               conv_dtype="bf16"),
                "--exact-fast": dict(fused_frontend="int8x2")}
    with tempfile.TemporaryDirectory() as tmp:
        cap_path = os.path.join(tmp, "cap.raw")
        cap.tofile(cap_path)
        for flag, kw in profiles.items():
            pcm, wav = os.path.join(tmp, "a.raw"), os.path.join(tmp, "a.wav")
            before = LAUNCHES["frontend_demod"]
            t0 = time.perf_counter()
            argv = [str(MODE), "1", flag, "--in", cap_path, "--out", pcm,
                    "--wav", wav, "--stats"]
            if device != "cuda":
                argv += ["--device", device]
            rc = cli.main(argv)
            if rc != 0:
                raise AssertionError(f"cli {flag} exited {rc}")
            secs = time.perf_counter() - t0
            if LAUNCHES["frontend_demod"] <= before:
                raise AssertionError(f"cli {flag} did not launch the kernel")
            rx = Receiver(MODE, device=device, **kw)
            want = expected_samples(rx, len(cap), 25)
            got = os.path.getsize(pcm) // 2
            if got != want:
                raise AssertionError(f"cli {flag}: {got} samples, "
                                     f"expected {want}")
            rate, audio = read_wav(wav)
            snr = tone_snr_db(audio.astype("f8"), rate, 1000.0,
                              skip=rate // 4)
            if not snr > 20.0:
                raise AssertionError(f"cli {flag}: 1 kHz SNR {snr:.1f} dB")
            log(f"cli {flag}: {got} samples, 1 kHz SNR {snr:.1f} dB, "
                f"{secs:.2f} s wall incl. set-up")
    before = LAUNCHES["frontend"]
    rx = Receiver(MODE, fused_frontend="int8", demod="arctan", device=device)
    out, _ = rx.run(torch.from_numpy(cap), blocks_per_step=25)
    if LAUNCHES["frontend"] <= before:
        raise AssertionError("Receiver(demod='arctan') did not launch the "
                             "front-end kernel")
    mono = out["mono"].float().cpu().numpy()
    snr = tone_snr_db(mono, rx.cfg.audio_fs, 1000.0,
                      skip=rx.cfg.audio_fs // 4)
    if not (mono.size == expected_samples(rx, len(cap), 25) and snr > 20.0):
        raise AssertionError(f"arctan run: {mono.size} samples, "
                             f"SNR {snr:.1f} dB")
    log(f"Receiver(int8, demod='arctan').run: {mono.size} samples, "
        f"1 kHz SNR {snr:.1f} dB")


def expected_samples(rx, n: int, blocks_per_step: int) -> int:
    """Audio samples a run of n bytes yields: whole steps, then the EOF
    flush at the finest aligned size."""
    bs, align = rx.block_size_u8(blocks_per_step), rx.block_align_u8()
    used = (n // bs) * bs
    used += ((n - used) // align) * align
    cfg = rx.cfg
    return used // (2 * cfg.rf_decim) * cfg.audio_interp // cfg.audio_decim


# ------------------------------------------------------------------ phase 4
def run_real_size(blocks, device, steps: int = 5,
                  stations_checked: int = 4) -> dict:
    """Receiver at 128 stations x 5.12 MB per step with the input resident
    on the device: IQ MS/s per profile from CUDA events, and one step's fm
    held against the plain front end on a few stations."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.ops.cuda.frontend_kernel import (
        frontend_demod_reference, frontend_reference)
    from sdr_tpu_torch.ops.demod import fm_arctan
    c, bs = blocks.shape[1], blocks.shape[2]
    rates = {}
    for name, kw in REAL_PROFILES.items():
        rx = Receiver(MODE, emit_if=True, device=device, **kw)
        if rx.block_size_u8(BLOCKS_PER_STEP) != bs:
            raise AssertionError(f"{name}: step is "
                                 f"{rx.block_size_u8(BLOCKS_PER_STEP)} B")
        st0 = rx.init_state((c,))
        st, out = rx.step(st0, blocks[0])
        fe, k = rx._fused_fe, stations_checked
        sub = blocks[0][:k]
        if rx.demod == "arctan":
            i_ds, q_ds, _ = frontend_reference(fe, sub, st0.front.i_tail[:k])
            want, _ = fm_arctan(i_ds, q_ds, st0.front.prev_i[:k])
        else:
            want = frontend_demod_reference(
                fe, sub, st0.front.i_tail[:k], st0.front.prev_i[:k],
                st0.front.prev_q[:k])[0]
        got = out["fm_demod"][:k]
        d = (got.double() - want.double()).abs().max().item()
        # the integer front end is exact and so is the discriminator; the
        # arctan demod's cumsum may sum in another order for 4 rows than
        # for 128
        tol = 1e-5 * want.abs().max().item() if rx.demod == "arctan" else 0
        if got.dtype != want.dtype or d > tol:
            raise AssertionError(f"{name}: fm vs plain max|err| {d}")
        mono = out["mono"]
        if not bool(torch.isfinite(mono).all()) or \
                mono.shape != (c, bs // (2 * rx.cfg.rf_decim)
                               // rx.cfg.audio_decim):
            raise AssertionError(f"{name}: mono {tuple(mono.shape)}")
        state, feed = st, itertools.cycle(blocks)

        def one_step():
            nonlocal state
            state, _ = rx.step(state, next(feed))
        ms = cuda_ms(one_step, steps)
        rate = c * bs / 2 / (ms * 1e-3) / 1e6
        rates[name] = (ms, rate)
        log(f"real size {name}: {c} stations x {bs} B/step, {ms:.3f} ms/step"
            f" = {rate:.1f} MS/s IQ (mean of {steps} steps, CUDA events)")
        del rx, state, st, st0, out
        torch.cuda.empty_cache()
    return rates


def main() -> int:
    if not (ROOT / "sdr_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py runs from a checkout of the repo "
                         "(sdr_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the GPU")
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    log(f"nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    device = "cuda"
    import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
    from sdr_tpu_torch.ops.cuda import build
    from sdr_tpu_torch.ops.cuda.frontend_kernel import LAUNCHES

    t0 = time.perf_counter()
    build.library()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({build.library_path()})")
    for line in (build.library_path().parent / "build.log").read_text(
            ).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    from sdr_tpu_torch.models.receiver import Receiver
    bs = Receiver(MODE, **REAL_PROFILES["fast_int8"]).block_size_u8(
        BLOCKS_PER_STEP)
    base = capture(2 * bs / 2 / 2.4e6 + 0.01)
    blocks = station_blocks(base, STATIONS, bs, 2, device)
    kern = check_kernels(blocks, device)
    log("phase 2: every kernel agrees with its plain version")

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    run_cli(device)
    log("phase 3: CLI --fast / --exact-fast decode the tone")
    rates = run_real_size(blocks, device)
    launches = dict(LAUNCHES)
    log("phase 4: 128-station steps agree with the plain front end")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"main path")
    log(f"IQ throughput on {card}: " + ", ".join(
        f"{name} {r:.1f} MS/s ({ms:.3f} ms/step)"
        for name, (ms, r) in rates.items()))
    entries = []
    for name, (source, replaces) in KERNELS.items():
        # the main path's engine: int8 (--fast), fm stored at bf16 there
        err, ms, plain_ms = kern[(name, "int8->bf16"
                                  if name == "frontend_demod" else "int8")]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
