#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (sdr_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/, holds each kernel against its plain
PyTorch version on the card, drives the receiver through its entry points
(the CLI: mono with --fast and --exact-fast, and stereo + RDS with --fast in
modes 0 and 2; Receiver at 128 stations, mono and stereo + RDS), and checks
the audio and the RDS decode.  Every phase raises on failure, so a failure
exits non-zero and prints no result.  The last line of stdout is
{"ok": true, "device": {...}}; the line before it lists every kernel with
its launches on the path that runs it, its error against the plain
version and both times.  Imports nothing of jax or sdr_tpu.  It also
prints a torch.profiler breakdown of the 128-station stereo + RDS step
(device time by kernel, busy time, host enqueue time per step).
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import re
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
# bench.py's stereo + RDS chain (the CLI's `0 2 --rds --fast` engines at the
# bench's tiling): 50 x 307200 B = 15.36 MB of u8 per station and step
STEREO_PROFILE = dict(stereo=True, rds=True, fused_frontend="int8",
                      fe_out_tile=1024, fe_sub_tiles=8, pll_impl="ff",
                      conv_dtype="bf16", fused_ifbank="bf16",
                      conv_engine="tiled")
KERNELS = {   # LAUNCHES key -> (source, TPU kernel it replaces)
    "frontend_demod": ("sdr_tpu_torch/csrc/frontend.cu",
                       "sdr_tpu/ops/pallas/frontend_kernel.py:194"),
    "frontend": ("sdr_tpu_torch/csrc/frontend.cu",
                 "sdr_tpu/ops/pallas/frontend_kernel.py:97"),
    "ifbank_mix": ("sdr_tpu_torch/csrc/ifbank.cu",
                   "sdr_tpu/ops/pallas/ifbank_kernel.py:259"),
    "ffmix": ("sdr_tpu_torch/csrc/ffmix.cu",
              "sdr_tpu/ops/pallas/ffmix_kernel.py:47"),
    "audio_pair": ("sdr_tpu_torch/csrc/audio.cu",
                   "sdr_tpu/ops/pallas/audio_kernel.py:53"),
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


def stereo_capture(seconds: float, mode: int = 0, seed: int = 0):
    """The verify recipe's capture (numpy u8): L 1 kHz, R 2.5 kHz and RDS
    groups of PI 0x3d44, PS 'TPU FM  ' at 0.1 of the deviation."""
    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.rds import tx as rds_tx
    cfg = MODES[mode]
    n = int(seconds * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(
        pi=0x3D44, ps_name="TPU FM  ", n_groups=int(seconds * 1187.5 / 104)
        + 3)
    return tx.synthesize_capture(
        cfg, seconds=seconds, seed=seed, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)


def snr_db(want, got) -> float:
    import numpy as np
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(10 * np.log10(np.mean(want * want)
                               / max(np.mean((want - got) ** 2), 1e-30)))


def max_err(got, want, rel: float, bf16: bool, what: str) -> float:
    """max |got - want|, after checking |got - want| <= rel * max|want|,
    plus one bf16 ulp (2^-7 of the value) where the stream is stored at
    bf16: the kernel sums in another order than the plain conv, and a
    float32 last bit can flip a bf16 rounding."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.double(), want.double()
    d = (g - w).abs()
    bound = rel * w.abs().max()
    if bf16:
        bound = bound + 2.0 ** -7 * w.abs()
    if not bool((d <= bound).all()):
        raise AssertionError(f"{what}: max |kernel - plain| "
                             f"{d.max().item()} (ref {w.abs().max().item()})")
    return d.max().item()


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


def check_stereo_kernels(blocks, device, reps: int = 10) -> dict:
    """The stereo + RDS kernels against their plain versions at the main
    path's full width (C stations x 768,000 IF samples), over two
    consecutive blocks whose inputs come from the previous stage as on the
    main path: the IF bank (bf16 compute as on the path, and f32), the
    carrier synthesis + mixers, the audio pair.  Returns {kernel: (max_abs_
    err, ms, plain_ms)} for the main path's variant."""
    import torch
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.ops import firdes
    from sdr_tpu_torch.ops.cuda.audio_kernel import pair_reference
    from sdr_tpu_torch.ops.cuda.ffmix_kernel import ffmix, ffmix_reference
    from sdr_tpu_torch.ops.cuda.frontend_kernel import FusedFrontend
    from sdr_tpu_torch.ops.cuda.ifbank_kernel import (FusedIFBankMix,
                                                      ifbank_mix_reference)
    from sdr_tpu_torch.ops.pll import pll_ff_params_from_sums, pll_init
    cfg = MODES[0]
    rx = Receiver(0, device=device, **STEREO_PROFILE)
    c = blocks.shape[1]
    bf16 = torch.bfloat16
    results = {}

    def fm_stream(out_dtype):
        fe = FusedFrontend(firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps,
                                          1), cfg.rf_decim,
                           compute_dtype="int8", out_dtype=out_dtype,
                           device=device)
        tail = fe.init_state((c,))
        prev = (torch.zeros(c, device=device), torch.zeros(c, device=device))
        fms = []
        for blk in blocks:
            fm, tail, *prev, _ = fe.demod_call(blk, tail, *prev)
            fms.append(fm)
        return fms

    def timed(kernel, plain):
        return cuda_ms(kernel, reps), cuda_ms(plain, 3)

    # --- B3, the f32 engine then the path's bf16 engine
    coeffs = [firdes.bandpass(cfg.if_fs, lo, hi, cfg.bp_taps) for lo, hi in (
        (cfg.stereo_lo, cfg.stereo_hi), (cfg.pilot_lo, cfg.pilot_hi),
        (cfg.rds_lo, cfg.rds_hi), (cfg.rds_carrier_lo, cfg.rds_carrier_hi))]
    bank_outs = None
    for compute, out in ((torch.float32, None), (bf16, bf16)):
        bank = (rx._ifbank if compute == bf16 else FusedIFBankMix(
            *coeffs, window=rx.pll_window, pilot_freq=cfg.pilot_freq,
            rds_carrier_freq=cfg.rds_carrier_freq, fs=cfg.if_fs,
            compute_dtype=compute, out_dtype=out, device=device))
        fms = fm_stream(bf16 if compute == bf16 else torch.float32)
        tail = ptail = bank.init_state((c,)).to(fms[0].dtype)
        err, outs = 0.0, []
        for b, fm in enumerate(fms):
            got = bank.mix_call(fm, tail)
            want = ifbank_mix_reference(bank, fm, ptail)
            torch.cuda.synchronize()
            stored_bf16 = bank.out_dtype == bf16
            for k, what in ((0, "chan"), (1, "rds_channel")):
                err = max(err, max_err(got[k], want[k], 1e-5, stored_bf16,
                                       f"ifbank_mix/{what} block {b}"))
            # the pilot's sums see no rounding the two versions could
            # place apart: 1e-5.  The bf16 engine rounds rds^2 to bf16,
            # after float32 sums in two orders; where that rounding flips,
            # one carrier input moves by a bf16 ulp, and across 384,000
            # windows a few such moves land in one window's sum: 1e-3.
            zrel = 1e-3 if compute == bf16 else 1e-5
            zerr = max([max_err(g, w, 1e-5, False, f"ifbank_mix/pilot sums "
                                                   f"block {b}")
                        for g, w in zip(got[2], want[2])]
                       + [max_err(g, w, zrel, False, f"ifbank_mix/carrier "
                                                     f"sums block {b}")
                          for g, w in zip(got[3], want[3])])
            if not torch.equal(got[4], want[4]):
                raise AssertionError("ifbank_mix: new tail differs")
            outs.append(got)
            tail, ptail = got[4], want[4]
        fm0, tail0 = fms[0], bank.init_state((c,)).to(fms[0].dtype)
        ms, plain_ms = timed(lambda: bank.mix_call(fm0, tail0),
                             lambda: ifbank_mix_reference(bank, fm0, tail0))
        key = "bf16" if compute == bf16 else "f32"
        log(f"kernel ifbank_mix/{key}: (C={c}, n={fm0.shape[-1]}) max|err| "
            f"{err:.3g} (window sums {zerr:.3g}), kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if compute == bf16:
            results["ifbank_mix"] = (err, ms, plain_ms)
            bank_outs, fm_bf16 = outs, fms
        del bank, fms, outs
        torch.cuda.empty_cache()

    # --- B4 on the path's B3 outputs and estimates
    kw = dict(n=fm_bf16[0].shape[-1], window=rx.pll_window,
              pilot_freq=float(cfg.pilot_freq),
              rds_freq=float(cfg.rds_carrier_freq), fs=float(cfg.if_fs),
              delay=rx.rds_delay, out_dtype=bf16)
    pll_s = pll_r = pll_init((c,), device)
    rtail = ptail = torch.zeros((c, 128), dtype=bf16, device=device)
    err, mixed = 0.0, []
    for b, (chan, rdsch, zp, zr, _) in enumerate(bank_outs):
        params_s, pll_s = pll_ff_params_from_sums(
            *zp, pll_s, freq=cfg.pilot_freq, fs=cfg.if_fs, n=kw["n"],
            nco_scale=2.0, window=rx.pll_window)
        params_r, pll_r = pll_ff_params_from_sums(
            *zr, pll_r, freq=cfg.rds_carrier_freq, fs=cfg.if_fs, n=kw["n"],
            nco_scale=0.5, window=rx.pll_window)
        args = (chan, rdsch)
        got = ffmix(*args, rtail, params_s, params_r, **kw)
        want = ffmix_reference(*args, ptail, params_s, params_r, **kw)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("mixed", "baseband")):
            err = max(err, max_err(g, w, 1e-5, True, f"ffmix/{what} "
                                                     f"block {b}"))
        mixed.append(got[0])
        rtail = ptail = rdsch[..., -128:].clone()
    args0 = (bank_outs[0][0], bank_outs[0][1],
             torch.zeros((c, 128), dtype=bf16, device=device),
             params_s, params_r)
    ms, plain_ms = timed(lambda: ffmix(*args0, **kw),
                         lambda: ffmix_reference(*args0, **kw))
    results["ffmix"] = (err, ms, plain_ms)
    log(f"kernel ffmix/bf16: (C={c}, n={kw['n']}) max|err| {err:.3g}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # --- B5 on the path's fm and mixed streams
    pair = rx._audio_pair
    ta = pta = pair.init_state((c,), bf16)
    tb = ptb = pair.init_state((c,), bf16)
    err = 0.0
    for b, (fm, mx) in enumerate(zip(fm_bf16, mixed)):
        got = pair(fm, mx, ta, tb)
        want = pair_reference(pair, fm, mx, pta, ptb)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("mono", "stereo")):
            err = max(err, max_err(g, w, 1e-5, False, f"audio_pair/{what} "
                                                      f"block {b}"))
        ta, tb, pta, ptb = got[2], got[3], got[2], got[3]
    t0 = pair.init_state((c,), bf16)
    ms, plain_ms = timed(
        lambda: pair(fm_bf16[0], mixed[0], t0, t0),
        lambda: pair_reference(pair, fm_bf16[0], mixed[0], t0, t0))
    results["audio_pair"] = (err, ms, plain_ms)
    log(f"kernel audio_pair/bf16: (C={c}, n={fm_bf16[0].shape[-1]}) max|err| "
        f"{err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    del rx, bank_outs, fm_bf16, mixed
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


def run_cli_stereo(device: str, mode: int, seconds: float = 1.2) -> None:
    """The CLI's stereo + RDS path with --fast, in-process, on the verify
    recipe's capture: mode 0 (every fused kernel) or mode 2 (the audio
    pair declines the 147/800 ratio).  The tones, the separation and the
    RDS decode on stderr are checked."""
    from sdr_tpu_torch import cli
    from sdr_tpu_torch.io.wav import read_wav
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.utils.compare import stereo_separation_db, tone_snr_db
    final = re.compile(r"RDS final: PI=(0x[0-9a-f]+) .*PS='(.*)' RT=.*"
                       r"\((\d+) groups\)")
    min_sep = 20.0 if mode == 0 else 15.0
    with tempfile.TemporaryDirectory() as tmp:
        cap_path = os.path.join(tmp, f"cap{mode}.raw")
        cap = stereo_capture(seconds, mode)
        cap.tofile(cap_path)
        pcm = os.path.join(tmp, "a.raw")
        wav = os.path.join(tmp, "a.wav")
        argv = [str(mode), "2", "--rds", "--fast", "--in", cap_path,
                "--out", pcm, "--wav", wav, "--stats"]
        if device != "cuda":
            argv += ["--device", device]
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        secs = time.perf_counter() - t0
        text = err.getvalue()
        if rc != 0:
            raise AssertionError(f"cli {mode} 2 --rds --fast exited {rc}:"
                                 f"\n{text}")
        rx = Receiver(mode, device=device, **{
            k: v for k, v in STEREO_PROFILE.items()
            if not k.startswith("fe_")})
        want = 2 * expected_samples(rx, len(cap), 25)
        got = os.path.getsize(pcm) // 2
        if got != want:
            raise AssertionError(f"cli mode {mode}: {got} samples, "
                                 f"expected {want}")
        rate, frames = read_wav(wav)
        left = frames[:, 0].astype("f8")
        right = frames[:, 1].astype("f8")
        skip = rate // 4
        snr_l = tone_snr_db(left, rate, 1000.0, skip=skip)
        snr_r = tone_snr_db(right, rate, 2500.0, skip=skip)
        sep = stereo_separation_db(left, right, rate, 1000.0, skip=skip)
        m = final.search(text)
        if not m:
            raise AssertionError(f"cli mode {mode}: no RDS final line:"
                                 f"\n{text}")
        pi, ps, groups = m.group(1), m.group(2), int(m.group(3))
        ok = sep > min_sep and pi == "0x3d44" and groups >= 3
        if mode == 0:
            ok = ok and snr_l > 20.0 and snr_r > 20.0 and ps == "TPU FM  "
        if not ok:
            raise AssertionError(
                f"cli mode {mode}: L {snr_l:.1f} dB, R {snr_r:.1f} dB, "
                f"separation {sep:.1f} dB, PI {pi}, PS {ps!r}, "
                f"{groups} groups\n{text}")
        log(f"cli {mode} 2 --rds --fast: {got // 2} frames, L 1 kHz "
            f"{snr_l:.1f} dB, R 2.5 kHz {snr_r:.1f} dB, separation "
            f"{sep:.1f} dB, RDS PI={pi} PS={ps!r} ({groups} groups), "
            f"{secs:.2f} s wall incl. set-up")
        for line in text.splitlines():
            if line.startswith(("processed", "step latency")):
                log(f"  {line}")


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


def run_real_size_stereo(blocks, device, steps: int = 5,
                         stations_checked: int = 4) -> tuple:
    """The bench's stereo + RDS profile at C stations x 15.36 MB per step,
    input resident on the device: two steps whose left, right and rds_soft
    are held, for a few stations, to 45 dB SNR against the same steps on
    the CPU (where the plain versions run; the chain is bf16, so a float32
    last bit can flip a bf16 rounding), then ms/step and IQ MS/s from CUDA
    events, and the step's torch.profiler breakdown."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    c, bs = blocks.shape[1], blocks.shape[2]
    rx = Receiver(0, device=device, **STEREO_PROFILE)
    if rx.block_size_u8(BLOCKS_PER_STEP) != bs:
        raise AssertionError(f"stereo step is "
                             f"{rx.block_size_u8(BLOCKS_PER_STEP)} B")
    k = stations_checked
    crx = Receiver(0, device="cpu", **STEREO_PROFILE)
    st, cst = rx.init_state((c,)), crx.init_state((k,))
    n_if = bs // (2 * rx.cfg.rf_decim)
    for b, blk in enumerate(blocks):
        st, out = rx.step(st, blk)
        cst, cout = crx.step(cst, blk[:k].cpu())
        for key, n in (("left", n_if // rx.cfg.audio_decim),
                       ("right", n_if // rx.cfg.audio_decim),
                       ("rds_soft", None)):
            v = out[key]
            if not bool(torch.isfinite(v).all()) or v.shape[0] != c or (
                    n is not None and v.shape[-1] != n):
                raise AssertionError(f"stereo {key}: {tuple(v.shape)}")
            snr = snr_db(cout[key].double().numpy(),
                         v[:k].double().cpu().numpy())
            if not snr >= 45.0:
                raise AssertionError(f"stereo step {b} {key}: card vs CPU "
                                     f"{snr:.1f} dB")
        log(f"real size stereo+RDS step {b}: stations 0-{k - 1} agree with "
            f"the CPU (left/right/rds_soft >= 45 dB)")
    state, feed = st, itertools.cycle(blocks)

    def one_step():
        nonlocal state
        state, _ = rx.step(state, next(feed))
    ms = cuda_ms(one_step, steps)
    rate = c * bs / 2 / (ms * 1e-3) / 1e6
    log(f"real size stereo+RDS: {c} stations x {bs} B/step, {ms:.3f} ms/step"
        f" = {rate:.1f} MS/s IQ (mean of {steps} steps, CUDA events)")
    state = profile_steps(rx, state, blocks, ms)
    del rx, state, st, out
    torch.cuda.empty_cache()
    return ms, rate


def profile_steps(rx, state, blocks, step_ms: float, steps: int = 10):
    """torch.profiler breakdown of rx.step: device time per kernel (mean
    of `steps` steps, after one warm-up profiler cycle that sets CUPTI
    up), the device's busy time and its idle share of step_ms (the step
    by CUDA events, without the profiler), and the host's enqueue time
    per step without the profiler.  A measurement, not a gate: where the
    profiler sees no device time it says so.  Returns the advanced
    state."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        state, _ = rx.step(state, blocks[0])
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for i in range(steps):
            state, _ = rx.step(state, blocks[i % len(blocks)])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    rows, busy = [], 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0 and not e.key.startswith(("aten::", "cuda")):
            rows.append((t / steps / 1e3, e.count // steps, e.key))
            busy += t / steps / 1e3
    if busy == 0.0:
        log("profile: torch.profiler recorded no device time: not measured")
    log(f"profile: wall under the profiler {wall:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step (mean of {steps} steps), idle share "
        f"{1 - busy / step_ms:.3f} of the {step_ms:.3f} ms step")
    for t, n, key in sorted(rows, reverse=True)[:25]:
        log(f"profile: {t:9.4f} ms  x{n:3d}  {key[:100]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, _ = rx.step(state, blocks[i % len(blocks)])
    host = (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.synchronize()
    log(f"profile: host enqueue {host:.3f} ms/step (no sync)")
    return state


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
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES

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
    sbs = Receiver(MODE, **STEREO_PROFILE).block_size_u8(BLOCKS_PER_STEP)
    sblocks = station_blocks(stereo_capture(2 * sbs / 2 / 2.4e6 + 0.01),
                             STATIONS, sbs, 2, device)
    skern = check_stereo_kernels(sblocks, device)
    log("phase 2b: the stereo + RDS kernels agree with their plain versions")

    # each path runs with the counts at 0 and is read right after it; a
    # path lists the kernels it must launch and those it must not
    paths = {"mono": (("frontend_demod", "frontend"), ()),
             "stereo+RDS": (("frontend_demod", "ifbank_mix", "ffmix",
                             "audio_pair"), ()),
             "stereo+RDS mode 2": (("frontend_demod", "ifbank_mix", "ffmix"),
                                   ("audio_pair",))}
    launches = {}

    def counted(path, fn):
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        out = fn()
        launches[path] = dict(LAUNCHES)
        return out

    def mono_path():
        run_cli(device)
        log("phase 3: CLI --fast / --exact-fast decode the tone")
        out = run_real_size(blocks, device)
        log("phase 4: 128-station steps agree with the plain front end")
        return out

    def stereo_path():
        run_cli_stereo(device, 0)
        log("phase 3b: CLI 0 2 --rds --fast decodes the tones and the RDS "
            "groups")
        out = run_real_size_stereo(sblocks, device)
        log("phase 4b: 128-station stereo + RDS steps agree with the CPU")
        return out

    def mode2_path():
        run_cli_stereo(device, 2)
        log("phase 3c: CLI 2 2 --rds --fast decodes the tones and the RDS "
            "groups")

    rates = counted("mono", mono_path)
    del blocks
    rates["stereo_rds_int8"] = counted("stereo+RDS", stereo_path)
    counted("stereo+RDS mode 2", mode2_path)
    for path, (ran, skipped) in paths.items():
        log(f"launches on the {path} path: " + ", ".join(
            f"{k} {launches[path][k]}" for k in (*ran, *skipped)))
        for k in ran:
            if launches[path][k] == 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"{path} path")
        for k in skipped:
            if launches[path][k] != 0:
                raise AssertionError(f"kernel {k} was launched on the "
                                     f"{path} path, which declines it")
    log(f"IQ throughput on {card}: " + ", ".join(
        f"{name} {r:.1f} MS/s ({ms:.3f} ms/step)"
        for name, (ms, r) in rates.items()))
    entries = []
    for name, (source, replaces) in KERNELS.items():
        if name in skern:
            # the stereo + RDS path's engines: bf16 IF bank, bf16 streams
            err, ms, plain_ms = skern[name]
            count = launches["stereo+RDS"][name]
        else:
            # the mono path's engine: int8 (--fast), fm stored at bf16 there
            err, ms, plain_ms = kern[(name, "int8->bf16"
                                      if name == "frontend_demod"
                                      else "int8")]
            count = launches["mono"][name]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": count,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
