#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (sdr_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ (logging registers, spills and the
tensor-core instructions of the front end's integer engines, the IF
bank's, the audio pair's and the channelizer's bf16 engines: a kernel
without them fails), holds each kernel against its plain PyTorch version on the
card (phases 2, 2b, 2c and 2d: the front end, the feedforward stereo +
RDS kernels, the IF bank's four-stream variant and the carrier loops with
the chain floors of the sequential and the chunked loops and the
sequential loop's joint launch against two single ones, then the
wideband channelizer; phase 2e: the tiled engine's resampling FIR in
every geometry it meets, both engines), drives the receivers through their
entry points, and checks the audio and the RDS decode.
Each path runs with the launch counts set to 0 and names the kernels it
must launch and those it must not:
  - mono: the CLI with --fast and --exact-fast, 128-station steps;
  - stereo + RDS (--fast): the CLI `0 2 --rds --fast`, 128-station steps
    held to the CPU; mode 2: the CLI `2 2 --rds --fast`;
  - stereo + RDS default: the CLI `0 2 --rds` (the scan loops), 128-
    station steps gated on every station's separation; mode 2 default:
    the CLI `2 2 --rds`;
  - stereo + RDS joint: 128-station steps of tools/bench_stages.py's
    profile (both loops in one chunked launch), held to the CPU; the same
    with the four-stream bf16 IF bank;
  - loop engines, one station: 'pallas', 'pallas_chunked' and 'chunked'
    on the 1.2 s capture, decoding the tones and the RDS groups;
  - wideband: the CLI's `--wideband` with --fast (two stations, and
    `--scan`) and 64-station WidebandReceiver steps of the --fast
    profiles held to the CPU; wideband default: the CLI without --fast
    (the scan loops on the channelized stations) and the default
    profile's 64-station steps;
  - stations --fast (phases 3h, 4f, 3i): the CLI's --stations --fast on
    four 1.2 s stereo + RDS captures (tones, separation, PI), B1 bf16
    held to its plain version at the full-width step's shape, 128-station
    steps of that profile held to the CPU and profiled, and a 128-station
    state saved, loaded and continued (bytes, save and load times);
    stations default: the same CLI without --fast (B8);
  - resume (phase 3i): `0 2 --rds --fast` and `0 2 --rds` cut into
    --save-state and --resume halves, joined against one run;
  - taps (phase 3j): --psd-dump (the pilot's peak), --trace-iq, --profile
    (the receiver's ranges and the kernels in its trace, and the cost of
    a range) and the native ring named by --stats;
  - options (phase 3j): de-emphasis, the shared audio state and the fft
    engine, one station in the default profile, held to the CPU;
  - the parallel layer (phases 5a-5f, sdr_tpu_torch/parallel/, meshes of
    8 shards on the one card): channel DP of phase 4's mono --fast input
    on make_mesh() and 8 shards, bit-equal to the serial run (5a); time
    sharding of one station: 30 s mono in the int8 --fast and f32
    engines (5b), 10 s stereo in the default profile, B8 on 8 rows (5c),
    10 s stereo + RDS --fast decoded by decode_rds_soft (5d); the
    station-sharded wideband run, 64 stations in 8 shards of one card,
    bit-equal to the serial run with one B7 launch a step (5e); two
    processes over gloo, each its 64 stations (5f); each against its
    serial run, timed beside it;
  - RDS helpers (phase 5g): recover_symbols, syndromes_sliding_device
    and decode_rds_soft on phase 4b's rds_soft, held to the CPU and the
    live decoder;
  - envelope (phase 6a, tools/bench_envelope_torch.py): 16 impaired
    0.9 s stereo + RDS captures (CFO, clock ppm, pilot phase noise, RF
    noise, combinations) repeated to 128 stations, one Receiver.run per
    mode (0, 2) and engine set (--fast, default): every copy of a row
    bit-equal to the first, each row held to the CPU's run of it (45 dB,
    the same PI, PS and RDS group count), mode 0's rows of
    tests/test_impairments.py held to its gates; the table printed;
  - demo (phase 6b): examples/demo_torch.py in-process, 8 stations of
    1.2 s, DEMO PASSED and every station's PI.
Every phase raises on failure, so a failure exits non-zero and prints no
result.  The last line of stdout is {"ok": true, "device": {...}}; the
line before it lists every kernel with its launches on the path that runs
it (and, apart, in that path's full-width steps: 128 stations, 64 on the
wideband paths; and its launches on the paths of the later slices:
stations, resume, taps, options, the parallel layer, the envelope and
the demo), its error against the plain version, both times, its
bound on the card from this run's shapes (`roofline`) and, where one
PyTorch call computes the same function, that call's time (phase 2c's
entries name the lengths compared).
Imports nothing of jax or sdr_tpu.  It also prints torch.profiler
breakdowns of the 128-station and wideband steps (device time by kernel,
busy time, host enqueue time per step), each trace's kernel events held
against the launch counts; a step of the tiled engine (--fast, ifbank
joint) must run no convolution, and --stations --fast (the conv engine)
some.
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
# the reference CLI's default profile (`0 2 --rds`): scan loops, f32 chain
DEFAULT_PROFILE = dict(stereo=True, rds=True)
# tools/bench_stages.py:59-60: both loops in one chunked launch
JOINT_PROFILE = dict(stereo=True, rds=True, fused_frontend="bf16",
                     pll_impl="pallas_chunked", pll_chunk=32)
# the same with the four-stream bf16 IF bank
IFBANK_JOINT_PROFILE = dict(JOINT_PROFILE, fused_ifbank="bf16",
                            conv_dtype="bf16", conv_engine="tiled")
# the sequential loop's counter and polynomial modes are held against
# their plain loop over the first END_N samples and the last END_N - 1 (odd,
# so that rows start off a vector boundary); every other loop over the
# whole block
END_N = 16384
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
    "ifbank": ("sdr_tpu_torch/csrc/ifbank.cu",
               "sdr_tpu/ops/pallas/ifbank_kernel.py:66"),
    "pll": ("sdr_tpu_torch/csrc/pll.cu",
            "sdr_tpu/ops/pallas/pll_kernel.py:63"),
    "pll_chunked": ("sdr_tpu_torch/csrc/pll.cu",
                    "sdr_tpu/ops/pallas/pll_kernel.py:90"),
    "pll_chunked_multi": ("sdr_tpu_torch/csrc/pll.cu",
                          "sdr_tpu/ops/pallas/pll_kernel.py:199"),
    "mfb": ("sdr_tpu_torch/csrc/channelizer.cu",
            "sdr_tpu/ops/pallas/channelizer_kernel.py:57 _mfb_kernel"),
    # an XLA-level stage of the reference (no pallas_call): its tiled
    # banded GEMM, the --fast engine of the resampling FIRs
    "banded": ("sdr_tpu_torch/csrc/banded.cu",
               "sdr_tpu/ops/banded.py:102 _tiled_apply"),
}
# the path whose launch counts each kernel's entry reports
KERNEL_PATH = {"frontend_demod": "mono", "frontend": "mono",
               "ifbank_mix": "stereo+RDS", "ffmix": "stereo+RDS",
               "audio_pair": "stereo+RDS",
               "ifbank": "stereo+RDS ifbank joint",
               "pll": "stereo+RDS default",
               "pll_chunked": "loop engines, one station",
               "pll_chunked_multi": "stereo+RDS joint", "mfb": "wideband",
               "banded": "stereo+RDS"}
# path -> {kernel: launches in that path's full-width steps}: the 128-
# station (64-station wideband) Receiver steps, apart from the CLI's and
# the one-station runs; the kernels line's `full_width_launches`
FULL_WIDTH: dict = {}
_RUNNING = [None]   # the path being counted


def count_full_width(before: dict) -> None:
    """Add the launches since `before` to the running path's full-width
    counts."""
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    counts = FULL_WIDTH.setdefault(_RUNNING[0], {})
    for k, v in LAUNCHES.items():
        counts[k] = counts.get(k, 0) + v - before[k]


# the wideband configuration (bench.py:171-204, BASELINE.md:219-229): one
# 9.6 MS/s u8 antenna stream, 64 stations across +-4 MHz
FS_WIDE = 9.6e6
WIDE_FREQS = [-4.0e6 + 8.0e6 * i / 63 for i in range(64)]
WIDE_BLOCKS_PER_STEP = 16
# the wideband CLI's receiver profiles (sdr_tpu/cli.py:316-318)
WIDE_FAST = dict(fused_frontend=False, pll_impl="ff")
WIDE_DEFAULT = dict(fused_frontend=False, pll_impl="auto")
# B7's (ingest, compute, out) dtype variants in phase 2d
MFB_VARIANTS = (("u8", "f32", "f32"), ("u8", "bf16", "f32"),
                ("u8", "bf16", "bf16"), ("f32", "f32", "f32"),
                ("f32", "bf16", "f32"))
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def roofline(nbytes: float, ops: dict) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over the HBM rate and the operations over the
    peak rate of their type (summed over the types)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS_S[t] for t, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_work(name: str, c: int, n: int) -> tuple[float, dict]:
    """Bytes each kernel must move (each input read once, each output
    written once) and the operations it does, by type, at its checked
    shape: c channels of n input bytes (B1/B2) or n IF samples (the rest).
    Operation counts: a FIR tap is a multiply and an add; the
    discriminator 9 a sample, the carrier synthesis 10, a carrier-loop
    sample ~50 (detector, PI update, phase, NCO)."""
    tail = 128
    if name in ("frontend_demod", "frontend"):
        m = n // 20                                  # IF samples, D = 10
        out = c * m * 2 if name == "frontend_demod" else 2 * c * m * 4
        ops = {"int8": c * m * 2 * 51 * 2}
        if name == "frontend_demod":
            ops["f32"] = c * m * 9
        return c * n + 2 * c * tail + out + 4 * c * 4, ops
    if name == "ifbank_mix":
        nbytes = c * n * 2 + 2 * c * n * 2 + 4 * c * (n // 256) * 4
        return nbytes + 2 * c * tail * 2, {"bf16": c * n * 4 * 51 * 2,
                                           "f32": c * n * 9}
    if name == "ifbank":
        return (c * n * 2 + 4 * c * n * 2 + 2 * c * tail * 2,
                {"bf16": c * n * 4 * 51 * 2, "f32": c * n})
    if name == "ffmix":
        params = 2 * 2 * c * (n // 256) * 4
        return (2 * c * n * 2 + c * tail * 2 + params + 2 * c * n * 2,
                {"f32": c * n * 10})
    if name == "audio_pair":
        m = n // 5
        return (2 * c * n * 2 + 4 * c * tail * 2 + 2 * c * m * 4,
                {"bf16": 2 * c * m * 51 * 2})
    g = {"pll": 1, "pll_chunked": 1, "pll_chunked_multi": 2}[name]
    return g * (2 * c * n * 4 + 2 * 5 * c * 4), {"f32": g * c * n * 50}


def mfb_work(pl, n_out: int, ingest: str, compute: str,
             out: str) -> tuple[float, dict]:
    """Bytes and operations of B7 over n_out output columns: the stream
    and its carried tail read once, the non-zero bank (2K rows x 2*taps
    taps), the phasor tables and both outputs; a multiply and an add for
    each non-zero tap of each of the 2K rows (in the compute dtype), and
    12 float32 operations a station and column for the rotation."""
    from sdr_tpu_torch.ops.cuda.channelizer_kernel import (
        EXT, _largest_tile_at_most)
    two_d, k, taps = 2 * pl.decim, pl.k, pl.taps
    tile = _largest_tile_at_most(n_out, pl.tile)
    nbytes = (two_d * (n_out + EXT) * (1 if ingest == "u8" else 4)
              + 2 * k * 2 * taps * 4 + 2 * k * (n_out // tile + tile) * 4
              + 2 * k * n_out * (2 if out == "bf16" else 4))
    ops = {"f32": 12 * k * n_out}
    ops[compute] = ops.get(compute, 0) + 2 * (2 * k) * (2 * taps) * n_out
    return nbytes, ops


# kernels that must run on the tensor cores -> their SASS instruction
TENSOR_CORE_KERNELS = {"mfb_tc_kernel": "HMMA",          # B7 bf16
                       "frontend_mma_kernel": "IMMA",    # B1/B2 int engines
                       "ifbank_mma_kernel": "HMMA",      # B3/B6 bf16
                       "pair_mma_kernel": "HMMA",        # B5 bf16
                       "banded_mma_kernel": "HMMA",      # tiled bf16
                       "banded_u1_mma_kernel": "HMMA"}   # tiled bf16, U = 1


def tensor_core_sass(lib: Path) -> None:
    """Logs the tensor-core instructions in the SASS of each kernel of
    TENSOR_CORE_KERNELS (cuobjdump); raises where a kernel has none of its
    kind."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {k: {} for k in TENSOR_CORE_KERNELS}
    fns = {k: set() for k in TENSOR_CORE_KERNELS}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        for kernel, op in TENSOR_CORE_KERNELS.items():
            if fn and kernel in fn:
                m = re.search(rf"\b({op}\.\S+)", line)
                if m:
                    c = counts[kernel]
                    c[m.group(1)] = c.get(m.group(1), 0) + 1
                    fns[kernel].add(fn)
    for kernel, op in TENSOR_CORE_KERNELS.items():
        if not counts[kernel]:
            raise AssertionError(f"no {op} instruction in {kernel}'s SASS")
        log(f"  cuobjdump: {kernel} ({len(fns[kernel])} instances) holds "
            + ", ".join(f"{n} {o}" for o, n in sorted(counts[kernel].items())))


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_device_ms(fn, reps: int, symbol: str) -> float:
    """Mean device time a call of fn() spends in the kernels whose name
    holds `symbol`, from torch.profiler over reps calls after a warm-up:
    the kernel alone, without the wrapper's small PyTorch ops or the
    host's pace.  0.0 where the profiler recorded no such event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if symbol in e.key and e.key not in ranges():
            t = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if t is None else t
    return total / reps / 1e3


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


def fm_streams(blocks, device, out_dtype):
    """fm_demod of consecutive u8 blocks (C, bytes) through the int8 front
    end, as the stereo paths' kernels take it."""
    import torch
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.ops import firdes
    from sdr_tpu_torch.ops.cuda.frontend_kernel import FusedFrontend
    cfg = MODES[0]
    c = blocks.shape[1]
    fe = FusedFrontend(firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1),
                       cfg.rf_decim, compute_dtype="int8",
                       out_dtype=out_dtype, device=device)
    tail = fe.init_state((c,))
    prev = (torch.zeros(c, device=device), torch.zeros(c, device=device))
    fms = []
    for blk in blocks:
        fm, tail, *prev, _ = fe.demod_call(blk, tail, *prev)
        fms.append(fm)
    return fms


def bank_coeffs():
    """The four band-pass FIRs of the IF bank (mode 0)."""
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.ops import firdes
    cfg = MODES[0]
    return [firdes.bandpass(cfg.if_fs, lo, hi, cfg.bp_taps) for lo, hi in (
        (cfg.stereo_lo, cfg.stereo_hi), (cfg.pilot_lo, cfg.pilot_hi),
        (cfg.rds_lo, cfg.rds_hi), (cfg.rds_carrier_lo, cfg.rds_carrier_hi))]


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
    from sdr_tpu_torch.ops.cuda.audio_kernel import pair_reference
    from sdr_tpu_torch.ops.cuda.ffmix_kernel import ffmix, ffmix_reference
    from sdr_tpu_torch.ops.cuda.ifbank_kernel import (FusedIFBankMix,
                                                      ifbank_mix_reference)
    from sdr_tpu_torch.ops.pll import pll_ff_params_from_sums, pll_init
    cfg = MODES[0]
    rx = Receiver(0, device=device, **STEREO_PROFILE)
    c = blocks.shape[1]
    bf16 = torch.bfloat16
    results = {}

    def timed(kernel, plain):
        return cuda_ms(kernel, reps), cuda_ms(plain, 3)

    # --- B3, the f32 engine then the path's bf16 engine
    coeffs = bank_coeffs()
    bank_outs = None
    for compute, out in ((torch.float32, None), (bf16, bf16)):
        bank = (rx._ifbank if compute == bf16 else FusedIFBankMix(
            *coeffs, window=rx.pll_window, pilot_freq=cfg.pilot_freq,
            rds_carrier_freq=cfg.rds_carrier_freq, fs=cfg.if_fs,
            compute_dtype=compute, out_dtype=out, device=device))
        fms = fm_streams(blocks, device,
                         bf16 if compute == bf16 else torch.float32)
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
        if not (torch.equal(got[2], fm[:, -128:])
                and torch.equal(got[3], mx[:, -128:])):
            raise AssertionError(f"audio_pair block {b}: the new tails are "
                                 "not the last 128 input columns")
        ta, tb, pta, ptb = got[2], got[3], got[2], got[3]
    t0 = pair.init_state((c,), bf16)
    ms, plain_ms = timed(
        lambda: pair(fm_bf16[0], mixed[0], t0, t0),
        lambda: pair_reference(pair, fm_bf16[0], mixed[0], t0, t0))
    # the library yardstick: one strided conv1d over tail ++ input of both
    # streams, bf16 as the kernel reads them (the port never calls it)
    ctx = pair.taps - 1
    xp = torch.cat([torch.cat([t0[:, 128 - ctx:], x], dim=-1)
                    for x in (fm_bf16[0], mixed[0])]).unsqueeze(1)
    weight = pair._weight.to(bf16)
    library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(
        xp, weight, stride=pair.down), reps)
    results["audio_pair"] = (err, ms, plain_ms, library_ms)
    log(f"kernel audio_pair/bf16: (C={c}, n={fm_bf16[0].shape[-1]}) max|err| "
        f"{err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, one "
        f"F.conv1d of both streams {library_ms:.4f} ms")
    del rx, bank_outs, fm_bf16, mixed, xp
    torch.cuda.empty_cache()
    return results


def check_loop_kernels(blocks, device, reps: int = 5) -> dict:
    """The carrier-loop slice's kernels against their plain versions on
    the card, at C stations x 768,000 IF samples of the stereo capture:
    the four-stream IF bank (f32, and bf16 as the ifbank-joint path runs
    it) over two consecutive blocks; then the loops on its pilot and
    114 kHz carrier streams, locked tones.  Over the whole block: the
    sequential loop as the scan engine runs it (exact, wrapping), the
    chunked loop (chunk 16 exact, chunk 32 polynomial) and the joint loop
    (G = 2, chunk 32) on the float32 streams of the joint path and the
    bf16 streams of the ifbank-joint path.  The sequential loop's counter
    (compat_pll) and polynomial modes over its first END_N samples and,
    from the kernel's own state there, its last END_N - 1, where the
    counter's argument is past 10^5 rad.  Returns {kernel: (max_abs_err,
    ms, plain_ms, n, plain_n)} for the path's variant."""
    import torch
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.ops.cuda.ifbank_kernel import (FusedIFBank,
                                                      ifbank_reference)
    from sdr_tpu_torch.ops.cuda import pll_kernel as K
    from sdr_tpu_torch.ops.pll import pll_init
    cfg = MODES[0]
    c = blocks.shape[1]
    bf16 = torch.bfloat16
    results = {}

    # --- B6: four streams; the bf16 engine rounds rds^2 to bf16 after
    # float32 sums taken in two orders, so a carrier sample can move by a
    # bf16 ulp of a square times a tap: the carrier within 1e-3 there
    streams = {}
    for compute, out in ((torch.float32, None), (bf16, bf16)):
        bank = FusedIFBank(*bank_coeffs(), compute_dtype=compute,
                           out_dtype=out, device=device)
        fms = fm_streams(blocks, device, out or torch.float32)
        tail = ptail = bank.init_state((c,)).to(fms[0].dtype)
        err = 0.0
        for b, fm in enumerate(fms):
            got = bank(fm, tail)
            want = ifbank_reference(bank, fm, ptail)
            torch.cuda.synchronize()
            for k, what in enumerate(("chan", "pilot", "rds_channel",
                                      "carrier_in")):
                rel = 1e-3 if (k == 3 and compute == bf16) else 1e-5
                err = max(err, max_err(got[k], want[k], rel, out == bf16,
                                       f"ifbank/{what} block {b}"))
            if not torch.equal(got[4], want[4]):
                raise AssertionError("ifbank: new tail differs")
            if b == 0:
                streams[compute] = (got[1], got[3])    # pilot, carrier_in
            tail, ptail = got[4], want[4]
        fm0, tail0 = fms[0], bank.init_state((c,)).to(fms[0].dtype)
        ms = cuda_ms(lambda: bank(fm0, tail0), reps)
        plain_ms = cuda_ms(lambda: ifbank_reference(bank, fm0, tail0), 3)
        name = "bf16" if compute == bf16 else "f32"
        n = fm0.shape[-1]
        log(f"kernel ifbank/{name}: (C={c}, n={n}) max|err| {err:.3g}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if compute == bf16:
            results["ifbank"] = (err, ms, plain_ms, n, n)
        del bank, fms
        torch.cuda.empty_cache()

    # --- the loops on the capture's locked pilot and 114 kHz line
    pilot, carrier = streams[torch.float32]
    n = pilot.shape[-1]
    st = pll_init((c,), device)
    pilot_kw = dict(freq=float(cfg.pilot_freq), fs=float(cfg.if_fs),
                    nco_scale=2.0, norm_bandwidth=0.01)
    carrier_params = (float(cfg.rds_carrier_freq), float(cfg.if_fs), 0.5,
                      0.0, 0.003)
    pilot_params = (pilot_kw["freq"], pilot_kw["fs"], 2.0, 0.0, 0.01)

    def loop_err(got, want, what):
        """nco within 2e-4 and the state within 1e-3, phase_acc modulo
        2 pi (the reference's gates for its loop kernels); trig_offset
        exactly."""
        (gn, gs), (wn, ws) = got, want
        torch.cuda.synchronize()
        err = (gn - wn).abs().max().item()
        if gn.dtype != wn.dtype or gn.shape != wn.shape or not err <= 2e-4:
            raise AssertionError(f"{what}: nco max |kernel - plain| {err}")
        for f, a, b in zip(gs._fields, gs, ws):
            d = (a - b).abs()
            if f == "phase_acc":
                d = torch.minimum(d % (2 * torch.pi),
                                  2 * torch.pi - d % (2 * torch.pi))
            d = d.max().item()
            if not d <= (0.0 if f == "trig_offset" else 1e-3):
                raise AssertionError(f"{what}: {f} max |kernel - plain| {d}")
        return err

    def plain_timed(fn):
        """fn() once, timed by CUDA events (the plain loops are too slow to
        warm up and repeat); returns (result, ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    # B8 as the scan engine runs it, over the whole block
    scan = dict(exact=True, wrap_phase=True)
    want, plain_ms = plain_timed(lambda: K.pll_kernel_reference(
        pilot, st, **pilot_kw, **scan))
    err = loop_err(K.pll_loop(pilot, st, **pilot_kw, **scan), want,
                   "pll/scan")
    ms = cuda_ms(lambda: K.pll_loop(pilot, st, **pilot_kw, **scan), 2)
    log(f"kernel pll/scan: (C={c}, n={n}) max|err| {err:.3g}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["pll"] = (err, ms, plain_ms, n, n)
    del want
    # the feedback pair's sincosf gives sinf's and cosf's bits everywhere
    differ = K.sincos_differences(device)
    if differ:
        raise AssertionError(f"sincosf differs from sinf/cosf on {differ} "
                             "float32 arguments")
    log("kernel pll: sincosf gives the bits of sinf and cosf for every "
        "finite float32")
    # B8's chain floor: one thread, its input in registers (shared memory),
    # nothing else issued; its state equals the plain loop's bit for bit.
    # The ms come from the kernel's own %globaltimer, at the clock the loop
    # ran; cycles over ns is that clock.
    floors = {}
    for name, kw in {"exact": {}, "poly": dict(exact=False),
                     "counter": dict(wrap_phase=False,
                                     lag_correction=False)}.items():
        x1 = pilot[0, :8192].contiguous()
        cps, nps, fin = K.chain_floor(x1, pll_init((), device),
                                      params=pilot_params, **kw)
        _, want = K.pll_kernel_reference(x1, pll_init((), device),
                                         **pilot_kw, **kw)
        if not torch.equal(fin, torch.stack(list(want))):
            raise AssertionError(f"pll chain floor/{name}: its state "
                                 "differs from the plain loop's")
        floor_ms = n * nps / 1e6
        floors[name] = (cps, floor_ms, cps / nps * 1e3)
        log(f"kernel pll chain floor/{name}: {cps:.1f} cycles, {nps:.2f} "
            f"ns a sample (one thread over 8192 samples, clock64 and "
            f"globaltimer; {cps / nps * 1e3:.0f} MHz while it ran), "
            f"{floor_ms:.2f} ms for n={n}")
    # the joint launch: the pilot and RDS loops as the receiver runs them,
    # against two single launches, bit for bit
    rds_kw = dict(freq=carrier_params[0], fs=carrier_params[1],
                  nco_scale=carrier_params[2],
                  norm_bandwidth=carrier_params[4])
    joint = K.pll_loop_multi((pilot, carrier), (st, st),
                             params=(pilot_params, carrier_params))
    singles = (K.pll_loop(pilot, st, **pilot_kw),
               K.pll_loop(carrier, st, **rds_kw))
    torch.cuda.synchronize()
    for g, (nco, new) in enumerate(singles):
        if not (torch.equal(joint[0][g], nco) and all(
                torch.equal(a, b) for a, b in zip(joint[1][g], new))):
            raise AssertionError(f"pll joint launch: instance {g} differs "
                                 "from its single launch")
    del joint, singles
    joint_ms = cuda_ms(lambda: K.pll_loop_multi(
        (pilot, carrier), (st, st), params=(pilot_params, carrier_params)),
        1)
    two_ms = cuda_ms(lambda: (K.pll_loop(pilot, st, **pilot_kw),
                              K.pll_loop(carrier, st, **rds_kw)), 1)
    log(f"kernel pll joint: (2 x C={c}, n={n}) equals two single launches "
        f"bit for bit; one joint launch {joint_ms:.4f} ms, two single "
        f"launches {two_ms:.4f} ms")
    results["pll_extra"] = dict(
        floor_cycles_per_sample=floors["exact"][0],
        floor_ms=floors["exact"][1], clock_mhz=floors["exact"][2],
        floor_poly_cycles_per_sample=floors["poly"][0],
        floor_counter_cycles_per_sample=floors["counter"][0],
        joint_ms=joint_ms, two_single_ms=two_ms)
    # B8's counter and polynomial modes at both ends of the block
    tail_n = END_N - 1
    for name, kw in {"counter": dict(exact=True, wrap_phase=False,
                                     lag_correction=False),
                     "poly": dict(exact=False, wrap_phase=True)}.items():
        head, plain_ms = plain_timed(lambda: K.pll_kernel_reference(
            pilot[:, :END_N], st, **pilot_kw, **kw))
        err = loop_err(K.pll_loop(pilot[:, :END_N], st, **pilot_kw, **kw),
                       head, f"pll/{name} first {END_N}")
        full = K.pll_loop(pilot, st, **pilot_kw, **kw)
        _, mid = K.pll_loop(pilot[:, :n - tail_n], st, **pilot_kw, **kw)
        last = K.pll_kernel_reference(pilot[:, n - tail_n:], mid,
                                      **pilot_kw, **kw)
        err = max(err, loop_err((full[0][:, n - tail_n:], full[1]), last,
                                f"pll/{name} last {tail_n}"))
        ms = cuda_ms(lambda: K.pll_loop(pilot, st, **pilot_kw, **kw), 2)
        where = ""
        if name == "counter":        # w0 * trig where the last part starts
            w0 = 2 * torch.pi * pilot_kw["freq"] / pilot_kw["fs"]
            where = (f"; the argument there "
                     f"{w0 * mid.trig_offset.max().item():.0f} rad")
        log(f"kernel pll/{name}: max|err| {err:.3g} over (C={c}) x (the "
            f"first {END_N}, the last {tail_n} of n={n}{where}), kernel "
            f"{ms:.4f} ms at n={n}, plain {plain_ms:.4f} ms at n={END_N}")
        del head, full, last
    # B9 over the whole block
    for name, chunk, exact in (("exact16", 16, True), ("poly32", 32, False)):
        args = dict(params=(pilot_params,), chunk=chunk, exact=exact)
        want, plain_ms = plain_timed(lambda: K.pll_chunked_kernel_reference(
            (pilot,), (st,), **args))
        got = K.pll_chunked_loop((pilot,), (st,), **args)
        err = loop_err((got[0][0], got[1][0]), (want[0][0], want[1][0]),
                       f"pll_chunked/{name}")
        ms = cuda_ms(lambda: K.pll_chunked_loop((pilot,), (st,), **args),
                     reps)
        log(f"kernel pll_chunked/{name}: (C={c}, n={n}) max|err| {err:.3g}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if name == "exact16":
            results["pll_chunked"] = (err, ms, plain_ms, n, n)
        del got, want
    # B10 over the whole block, on each joint path's streams
    args = dict(params=(pilot_params, carrier_params), chunk=32)
    for dtype, xs in streams.items():
        want, plain_ms = plain_timed(lambda: K.pll_chunked_kernel_reference(
            xs, (st, st), **args))
        got = K.pll_chunked_loop(xs, (st, st), **args)
        err = max(loop_err((got[0][g], got[1][g]), (want[0][g], want[1][g]),
                           f"pll_chunked_multi/{dtype} instance {g}")
                  for g in range(2))
        ms = cuda_ms(lambda: K.pll_chunked_loop(xs, (st, st), **args), reps)
        name = "bf16" if dtype == bf16 else "f32"
        log(f"kernel pll_chunked_multi/G=2 {name}: (C={c}, n={n}) max|err| "
            f"{err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if dtype == torch.float32:     # the joint path's streams
            results["pll_chunked_multi"] = (err, ms, plain_ms, n, n)
        del got, want
    # B9's and B10's chain floors: one warp per instance runs only the
    # per-chunk chain (the kernel's own device functions: sincosf, the
    # detector, the butterfly of the carried sums, the PI update and the
    # wrap) over station 0's first 4096 samples in shared memory; its state
    # equals the chunked kernel's bit for bit.  The ms at n are
    # from the floor kernel's own %globaltimer.
    fl = 4096
    x_p = pilot[0, :fl].contiguous().float()
    x_r = carrier[0, :fl].contiguous().float()
    for name, key, xs, params, chunk, exact in (
            ("exact16", "pll_chunked", (x_p,), (pilot_params,), 16, True),
            ("poly32", "pll_chunked", (x_p,), (pilot_params,), 32, False),
            ("joint32", "pll_chunked_multi", (x_p, x_r),
             (pilot_params, carrier_params), 32, False)):
        cps, nps, fin = K.chunk_floor(
            xs, tuple(pll_init((), device) for _ in xs), params=params,
            chunk=chunk, exact=exact)
        _, news = K.pll_chunked_loop(
            tuple(x[None] for x in xs),
            tuple(pll_init((1,), device) for _ in xs), params=params,
            chunk=chunk, exact=exact)
        for g, new in enumerate(news):
            if not torch.equal(fin[g], torch.stack([v[0] for v in new[:4]])):
                raise AssertionError(f"{key} chain floor/{name}: its state "
                                     "differs from the kernel's")
        floor_ms = n * nps / 1e6
        extra = results.setdefault(f"{key}_extra", {})
        extra[f"floor_{name}_cycles_per_sample"] = cps
        extra[f"floor_{name}_ms"] = floor_ms
        log(f"kernel {key} chain floor/{name}: {cps:.1f} cycles, {nps:.2f} "
            f"ns a sample, {cps * chunk:.0f} cycles a chunk ({len(xs)} "
            f"warp(s) over {fl} samples, clock64 and globaltimer; "
            f"{cps / nps * 1e3:.0f} MHz while it ran), {floor_ms:.2f} ms for "
            f"n={n}")
    del streams, pilot, carrier
    torch.cuda.empty_cache()
    return results


def check_channelizer(device, reps: int = 20) -> dict:
    """B7 against its plain version at the kernel-check shape of
    bench.py:171-204 (64 stations across +-4 MHz, 2^20 wideband pairs a
    call: 262,144 output columns), three consecutive calls with state
    carry, over the grid of ingest (u8, f32), compute (f32, bf16) and
    output (f32, bf16) dtypes.  Each call runs the kernel on the flat
    stream and on the pre-phased (2D, N/D) layout: the two must agree bit
    for bit and hold the same carried state as the plain version; the
    kernel is within 2e-5 of max|plain| (another summation order; plus
    one bf16 ulp for a bf16 output).  Times the kernel on both layouts
    (its device time, torch.profiler) and the wrapper's whole call (CUDA
    events), the plain version and, as the library yardstick, the cuBLAS
    torch.matmul of the bank (2Kp x 2D*n_shift) against the materialized
    im2col in the compute dtype (float32, or bf16 for the bf16 engine:
    the GEMM alone, without the rotation; the port never calls it).
    Returns {variant: (max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by, flat_ms, call_ms)}."""
    import torch
    from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
    from sdr_tpu_torch.ops.cuda.channelizer_kernel import (
        EXT, call_cols_reference)
    n_wide = 1 << 20
    results, library_ms = {}, {}
    for ingest, compute, out in MFB_VARIANTS:
        chan = WidebandChannelizer(FS_WIDE, 2.4e6, WIDE_FREQS, engine="pallas",
                                   ingest=ingest, compute_dtype=compute,
                                   out_dtype=out, device=device)
        pl = chan._pl
        two_d, n_out = 2 * pl.decim, n_wide // pl.decim
        name = f"{ingest}/{compute}->{out}"
        s_flat = s_cols = s_plain = pl.init_state()
        err = 0.0
        for b in range(3):
            if ingest == "u8":
                flat = torch.randint(0, 256, (2 * n_wide,), dtype=torch.uint8,
                                     device=device)
            else:
                flat = 0.3 * torch.randn(2 * n_wide, device=device)
            xbt = flat.reshape(n_out, two_d).T.contiguous()
            (i_f, q_f), s_flat = pl(flat, s_flat)
            (i_c, q_c), s_cols = pl.call_cols(xbt, s_cols)
            (i_p, q_p), s_plain = call_cols_reference(pl, xbt, s_plain)
            torch.cuda.synchronize()
            if not (torch.equal(i_f, i_c) and torch.equal(q_f, q_c)):
                raise AssertionError(f"mfb/{name} call {b}: flat and "
                                     "pre-phased layouts differ")
            for key in s_plain:
                if not (torch.equal(s_flat[key], s_plain[key])
                        and torch.equal(s_cols[key], s_plain[key])):
                    raise AssertionError(f"mfb/{name} call {b}: carried "
                                         f"{key} differs")
            for g, w, what in ((i_c, i_p, "I"), (q_c, q_p, "Q")):
                err = max(err, max_err(g, w, 2e-5, out == "bf16",
                                       f"mfb/{name} {what} call {b}"))
        st = pl.init_state()
        # the kernel's own device time (profiler); the wrapper's call,
        # with its small PyTorch ops for the phasor tables and the state,
        # by CUDA events
        ms = kernel_device_ms(lambda: pl.call_cols(xbt, st), reps, "mfb_")
        flat_ms = kernel_device_ms(lambda: pl(flat, st), reps, "mfb_")
        call_ms = cuda_ms(lambda: pl.call_cols(xbt, st), reps)
        if not (ms > 0 and flat_ms > 0):
            raise AssertionError(f"mfb/{name}: the profiler recorded no "
                                 "kernel event: the kernel's time is not "
                                 "measured")
        plain_ms = cuda_ms(lambda: call_cols_reference(pl, xbt, st), 3)
        if compute not in library_ms:
            x = torch.cat([st["tail"], xbt], dim=1).float()
            if ingest == "u8":
                x = (x - 128.0) / 128.0
            win = x[:, EXT - pl.t_cols:EXT - pl.t_cols + n_out
                    + pl._n_shift - 1]
            xim = win.unfold(1, n_out, 1).transpose(0, 1).reshape(-1, n_out
                                                                  ).clone()
            dt = torch.bfloat16 if compute == "bf16" else torch.float32
            bank, xim = pl._bm_dev.to(dt), xim.to(dt)
            library_ms[compute] = cuda_ms(lambda: torch.matmul(bank, xim),
                                          reps)
            del x, win, xim, bank
        bound_ms, bound_by = roofline(*mfb_work(pl, n_out, ingest, compute,
                                                out))
        results[name] = (err, ms, plain_ms, library_ms[compute], bound_ms,
                         bound_by, flat_ms, call_ms)
        log(f"kernel mfb/{name}: (K={pl.k}, 2D={two_d}, n_out={n_out}, bank "
            f"{2 * pl.kp}x{two_d * pl._n_shift}) max|err| {err:.3g}, kernel "
            f"{ms:.4f} ms (flat stream {flat_ms:.4f} ms; the wrapper's whole "
            f"call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, cuBLAS "
            f"{compute} GEMM alone {library_ms[compute]:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        del chan, pl, flat, xbt, i_f, q_f, i_c, q_c, i_p, q_p
        torch.cuda.empty_cache()
    return results


def time_mfb(root: Path, reps: int = 20) -> None:
    """B7 of the checkout at `root` (another commit's sdr_tpu_torch, built
    from its own csrc/) timed as phase 2d times it, at phase 2d's shape and
    in its five variants: the kernel's device time (torch.profiler) and
    the wrapper's whole call (CUDA events).  So two commits' kernels are
    compared by the same two measures:
    `python3 chip_smoke.py --time-mfb DIR`."""
    import torch
    sys.path.insert(0, str(root))
    import sdr_tpu_torch
    from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
    if Path(sdr_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"sdr_tpu_torch was not imported from {root}")
    log(f"nvidia-smi: {card_info()}")
    log(f"B7 of {root}")
    n_wide = 1 << 20
    for ingest, compute, out in MFB_VARIANTS:
        pl = WidebandChannelizer(FS_WIDE, 2.4e6, WIDE_FREQS, engine="pallas",
                                 ingest=ingest, compute_dtype=compute,
                                 out_dtype=out, device="cuda")._pl
        two_d, n_out = 2 * pl.decim, n_wide // pl.decim
        if ingest == "u8":
            flat = torch.randint(0, 256, (2 * n_wide,), dtype=torch.uint8,
                                 device="cuda")
        else:
            flat = 0.3 * torch.randn(2 * n_wide, device="cuda")
        xbt = flat.reshape(n_out, two_d).T.contiguous()
        st = pl.init_state()
        ms = kernel_device_ms(lambda: pl.call_cols(xbt, st), reps, "mfb_")
        if not ms > 0:
            raise AssertionError("the profiler recorded no mfb_ kernel event")
        call_ms = cuda_ms(lambda: pl.call_cols(xbt, st), reps)
        log(f"time mfb/{ingest}/{compute}->{out}: kernel {ms:.4f} ms "
            f"(profiler), the wrapper's whole call {call_ms:.4f} ms (CUDA "
            f"events), mean of {reps}")


# ----------------------------------------------------------------- phase 2e
def banded_cases() -> dict:
    """Every geometry the tiled engine meets -> (coeff, U, D, rows, n,
    input dtype): the 128-station steps' shapes for mono audio (the bf16
    fm stream of 5.12 MB of u8), the RDS resampler (the bf16 baseband of
    15.36 MB) and the RRC (its float32 output); the unfused front end's I
    stream of a 5.12 MB step (RF), mode 1's mono audio and the RDS band-
    pass at 128 stations; the ifbank joint step's audio pair (mono and
    stereo stacked: 2 x 128 rows of its bf16 IF streams, the stereo +
    RDS step's 768,000 samples) and its RDS resampler (float32 baseband:
    its mixer's output); modes 2 and 3 at
    the CLI's block (25 blocks, one station: mode 2's audio as the stacked
    mono + stereo pair)."""
    import torch
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.ops import firdes
    bf16, f32 = torch.bfloat16, torch.float32

    def n_if(mode, profile, blocks):
        rx = Receiver(mode, device="cpu", **profile)
        return rx.block_size_u8(blocks) // (2 * rx.cfg.rf_decim)

    def audio(m):
        c = MODES[m]
        return (firdes.lowpass(c.if_fs * c.audio_interp, c.audio_fc,
                               c.audio_taps, c.audio_gain),
                c.audio_interp, c.audio_decim)

    def rds(m):
        c = MODES[m]
        u, d = c.rds_resample
        return firdes.lowpass(c.if_fs * u, c.rds_fc, c.bp_taps * u, u), u, d

    cfg = MODES[0]
    mono = REAL_PROFILES["fast_int8"]
    n_rds = n_if(0, STEREO_PROFILE, BLOCKS_PER_STEP)
    return {
        "audio0": (*audio(0), STATIONS, n_if(0, mono, BLOCKS_PER_STEP),
                   bf16),
        "rds0": (*rds(0), STATIONS, n_rds, bf16),
        "rrc": (firdes.root_raised_cosine(cfg.rds_fs, 151,
                                          cfg.rds_symbol_rate), 1, 1,
                STATIONS, n_rds * 19 // 120, f32),
        "rf": (firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1), 1,
               cfg.rf_decim, STATIONS,
               10 * n_if(0, mono, BLOCKS_PER_STEP), f32),
        "audio1": (*audio(1), STATIONS, n_if(1, mono, BLOCKS_PER_STEP),
                   bf16),
        "bpf": (firdes.bandpass(cfg.if_fs, cfg.rds_lo, cfg.rds_hi,
                                cfg.bp_taps), 1, 1, STATIONS, n_rds, f32),
        "joint_audio": (*audio(0), 2 * STATIONS, n_rds, bf16),
        "joint_rds": (*rds(0), STATIONS, n_rds, f32),
        "audio2": (*audio(2), 2, n_if(2, STEREO_PROFILE, 25), bf16),
        "rds2": (*rds(2), 1, n_if(2, STEREO_PROFILE, 25), bf16),
        "audio3": (*audio(3), 1, n_if(3, mono, 25), bf16),
    }


def banded_work(fir, rows: int, n: int, in_bytes: int) -> tuple:
    """Bytes and operations of one banded-FIR call: block and tail read
    once, y (float32) and the new tail written once, the polyphase bank
    read once; a multiply and an add for each non-zero tap of each output
    (the bank's non-zero entries over U outputs), at the rate of the
    engine's type (bf16 operands with float32 sums could run on the
    tensor cores)."""
    import numpy as np
    import torch
    from sdr_tpu_torch.ops.cuda.banded_kernel import polyphase_bank
    s, n_out = fir.state_len, n // fir.down * fir.up
    store = 2 if fir.store_dtype == torch.bfloat16 else 4
    nbytes = (rows * (n + s) * in_bytes + rows * n_out * 4 + rows * s * store
              + fir.M * fir.up * 4)
    nnz = np.count_nonzero(polyphase_bank(fir._bank, fir.up, fir.down,
                                          fir.M))
    kind = "bf16" if fir.compute_dtype == torch.bfloat16 else "f32"
    return nbytes, {kind: 2 * rows * (n // fir.down) * nnz}


def check_banded(spills: dict, reps: int = 10) -> dict:
    """Phase 2e: the tiled engine's kernel (csrc/banded.cu) against its
    plain version (ops/banded.py tiled_reference, the reference's tile
    schedule in torch) in every geometry of `banded_cases` and both
    engines, over two carried blocks of seeded random input (the first
    tail random, one element off an 8-byte boundary): y within 1e-5 of
    max|plain|, the new tail bit for bit.  Times the kernel (its device
    time, torch.profiler), the wrapper's whole call (CUDA events), the
    plain version and two library yardsticks the port never calls: one
    torch.mm of the tile windows and the band matrix in the compute dtype
    with float32 output (the reference's own product; bf16 through
    `out_dtype`, where the card's torch has it for CUDA), and the float32
    cuDNN conv1d the conv engine runs (one call on the prepared
    window).  Fails if ptxas reported a spill in a banded kernel.
    Returns {"geometry/engine": {...}}."""
    import torch
    from sdr_tpu_torch.ops.banded import (TiledBandedFIR, tile_windows,
                                          tiled_reference)
    from sdr_tpu_torch.ops.cuda.banded_kernel import kernel_body
    from sdr_tpu_torch.ops.resample import PolyphaseResampler
    bad = [f"{fn}: {line}" for fn, line in spills.items() if "banded" in fn]
    if bad:
        raise AssertionError("ptxas spills in the banded kernels: "
                             + "; ".join(bad))
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(10)
    for case, (coeff, up, down, rows, n, in_dt) in banded_cases().items():
        xs = [(0.5 * torch.randn(rows, n, generator=gen, device="cuda")
               ).to(in_dt) for _ in range(2)]
        for engine in (torch.float32, torch.bfloat16):
            fir = TiledBandedFIR(coeff, up, down, compute_dtype=engine,
                                 device="cuda")
            s = fir.state_len
            buf = torch.empty(rows * s + 1, dtype=in_dt, device="cuda")
            tail = buf[1:].view(rows, s)
            tail.copy_(0.5 * torch.randn(rows, s, generator=gen,
                                         device="cuda"))
            ptail, err = tail, 0.0
            name = f"{case}/{'bf16' if engine == torch.bfloat16 else 'f32'}"
            for b, x in enumerate(xs):
                y, new = fir(x, tail)
                want_y, want_t = tiled_reference(fir, x, ptail)
                torch.cuda.synchronize()
                err = max(err, max_err(y, want_y, 1e-5, False,
                                       f"banded/{name} block {b}"))
                if not (new.dtype == fir.store_dtype
                        and torch.equal(new, want_t)):
                    raise AssertionError(f"banded/{name} block {b}: the "
                                         "new tail differs")
                tail, ptail = new, want_t
            t0 = ptail
            ms = kernel_device_ms(lambda: fir(xs[0], t0), reps, "banded_")
            if not ms > 0:
                raise AssertionError(f"banded/{name}: the profiler recorded "
                                     "no kernel event")
            call_ms = cuda_ms(lambda: fir(xs[0], t0), reps)
            plain_ms = cuda_ms(lambda: tiled_reference(fir, xs[0], t0), 3)
            # the yardsticks, on operands prepared beforehand
            win = tile_windows(fir, xs[0], t0)
            win = win.reshape(-1, win.shape[-1]).to(engine)
            a = fir.band_matrix.to("cuda", engine)
            try:
                torch.mm(win, a, out_dtype=torch.float32)
                mm_ms = cuda_ms(lambda: torch.mm(win, a,
                                                 out_dtype=torch.float32),
                                reps)
            except (RuntimeError, TypeError) as e:
                log(f"  banded/{name}: no torch.mm out_dtype here "
                    f"({str(e).splitlines()[0][:80]})")
                mm_ms = None
            del win, a
            conv = PolyphaseResampler(coeff, up, down, compute_dtype=engine,
                                      device="cuda")
            span = (n // down - 1) * down + conv.L
            start = s - (conv.M - 1)
            cwin = torch.cat([t0, xs[0]], dim=-1)[:, start:start + span]
            cwin = cwin.to(engine).float().reshape(rows, 1, span)
            conv_ms = cuda_ms(lambda: torch.nn.functional.conv1d(
                cwin, conv._weight, stride=down), reps)
            del cwin, conv
            in_bytes = 2 if in_dt == torch.bfloat16 else 4
            bound_ms, bound_by = roofline(*banded_work(fir, rows, n,
                                                       in_bytes))
            results[name] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=mm_ms, conv_ms=conv_ms, bound_ms=bound_ms,
                bound_by=bound_by, rows=rows, n=n,
                input=str(in_dt).replace("torch.", ""),
                geometry=f"{up}/{down}/{len(coeff)}",
                body=kernel_body(fir, in_dt))
            log(f"kernel banded/{name}: U/D/taps {up}/{down}/{len(coeff)}, "
                f"body {results[name]['body']}, "
                f"({rows}, {n}) {results[name]['input']} in, max|err| "
                f"{err:.3g}, kernel {ms:.4f} ms (the wrapper's call "
                f"{call_ms:.4f}), plain {plain_ms:.4f} ms, torch.mm "
                + ("not run" if mm_ms is None else f"{mm_ms:.4f} ms")
                + f", cuDNN conv1d {conv_ms:.4f} ms; bound {bound_ms:.4f} "
                f"ms ({bound_by})")
            del fir, buf, tail, ptail, t0, y, new, want_y, want_t
        del xs
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


def run_cli_stereo(device: str, mode: int, seconds: float = 1.2,
                   fast: bool = True) -> None:
    """The CLI's stereo + RDS path, in-process, on the verify recipe's
    capture: with --fast (every fused kernel; in mode 2 the audio pair
    declines the 147/800 ratio) or without it (the default profile: the
    scan loops on the unfused float32 chain).  The tones, the separation
    and the RDS decode on stderr are checked."""
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
        flag = ["--fast"] if fast else []
        argv = [str(mode), "2", "--rds", *flag, "--in", cap_path,
                "--out", pcm, "--wav", wav, "--stats"]
        cmd = " ".join(argv[:3 + len(flag)])
        if device != "cuda":
            argv += ["--device", device]
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        secs = time.perf_counter() - t0
        text = err.getvalue()
        if rc != 0:
            raise AssertionError(f"cli {cmd} exited {rc}:\n{text}")
        rx = Receiver(mode, device=device, **({
            k: v for k, v in STEREO_PROFILE.items()
            if not k.startswith("fe_")} if fast else DEFAULT_PROFILE))
        want = 2 * expected_samples(rx, len(cap), 25)
        got = os.path.getsize(pcm) // 2
        if got != want:
            raise AssertionError(f"cli {cmd}: {got} samples, "
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
            raise AssertionError(f"cli {cmd}: no RDS final line:"
                                 f"\n{text}")
        pi, ps, groups = m.group(1), m.group(2), int(m.group(3))
        ok = sep > min_sep and pi == "0x3d44" and groups >= 3
        if mode == 0:
            ok = ok and snr_l > 20.0 and snr_r > 20.0 and ps == "TPU FM  "
        if not ok:
            raise AssertionError(
                f"cli {cmd}: L {snr_l:.1f} dB, R {snr_r:.1f} dB, "
                f"separation {sep:.1f} dB, PI {pi}, PS {ps!r}, "
                f"{groups} groups\n{text}")
        log(f"cli {cmd}: {got // 2} frames, L 1 kHz "
            f"{snr_l:.1f} dB, R 2.5 kHz {snr_r:.1f} dB, separation "
            f"{sep:.1f} dB, RDS PI={pi} PS={ps!r} ({groups} groups), "
            f"{secs:.2f} s wall incl. set-up")
        for line in text.splitlines():
            if line.startswith(("processed", "spans over", "  ", "rds:",
                                "kernel launches")):
                log(f"  {line}")


WIDE_CLI_FREQS = (-1.2e6, 1.5e6)
WIDE_CLI_TONES = (800.0, 1300.0)


def wideband_cli_capture(seconds: float = 1.0):
    """Two stereo FM stations at -1.2 and +1.5 MHz in one 9.6 MS/s
    stream (numpy: the interleaved f32 stream and its u8 form): station k
    carries WIDE_CLI_TONES[k] on both sides and RDS groups of PI
    0x2000 + k."""
    import numpy as np
    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.ops.channelizer import synthesize_wideband
    from sdr_tpu_torch.rds import tx as rds_tx
    fs = float(MODES[0].rf_fs)
    n = int(seconds * fs)
    stations = []
    for k, tone_f in enumerate(WIDE_CLI_TONES):
        bits = rds_tx.standard_group_stream(
            pi=0x2000 + k, n_groups=int(seconds * 1187.5 / 104) + 3)
        tone = tx.tone(fs, tone_f, n)
        m = tx.make_multiplex(
            fs, n, left=tone, right=tone,
            rds_baseband=rds_tx.bits_to_baseband(bits, fs)[:n], a_rds=0.1)
        i, q = tx.fm_modulate(m, fs)
        stations.append((i + 1j * q) * 0.35)
    iw, qw = synthesize_wideband(stations, list(WIDE_CLI_FREQS), fs, FS_WIDE)
    wide = np.empty(2 * len(iw), np.float32)
    wide[0::2], wide[1::2] = iw, qw
    u8 = np.clip(np.round(wide * 128.0 + 128.0), 0, 255).astype(np.uint8)
    return wide, u8


def run_cli_wideband(device: str, flags: list[str], paths: dict,
                     ingest: str, scan: bool = False) -> None:
    """The CLI's `--wideband` on the two-station capture, in-process:
    every station's tone (> 18 dB on each side), its RDS PI with --rds,
    and with --scan both offsets found."""
    from sdr_tpu_torch import cli
    from sdr_tpu_torch.io.wav import read_wav
    from sdr_tpu_torch.utils.compare import tone_snr_db
    argv = [*flags, "--wideband", str(FS_WIDE), "--in", paths[ingest],
            "--blocks-per-step", "4"]
    argv += ["--scan"] if scan else ["--freqs=" + ",".join(
        str(f) for f in WIDE_CLI_FREQS)]
    if ingest == "u8":
        argv.append("--wideband-u8")
    cmd = " ".join(a for a in argv if not a.startswith(("--in", "/")))
    with tempfile.TemporaryDirectory() as wav_dir:
        argv += ["--wav-dir", wav_dir]
        if device != "cuda":
            argv += ["--device", device]
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        secs = time.perf_counter() - t0
        text = err.getvalue()
        if rc != 0:
            raise AssertionError(f"cli {cmd} exited {rc}:\n{text}")
        freqs = list(WIDE_CLI_FREQS)
        if scan:
            m = re.search(r"scan found stations at (.*)", text)
            found = [float(round(float(f.split()[0]) * 1e6))
                     for f in (m.group(1).split(", ") if m else [])]
            if sorted(found) != freqs:
                raise AssertionError(f"cli {cmd}: scan found {found}")
            freqs = found
        msgs = []
        for k, f in enumerate(freqs):
            tone_f = WIDE_CLI_TONES[WIDE_CLI_FREQS.index(f)]
            rate, pcm = read_wav(os.path.join(wav_dir, f"station{k}.wav"))
            sides = pcm.reshape(len(pcm), -1).T.astype("f8")
            snrs = [tone_snr_db(x, rate, tone_f, skip=rate // 4)
                    for x in sides]
            msg = f"{f / 1e6:+.2f} MHz {tone_f:.0f} Hz " + "/".join(
                f"{v:.1f}" for v in snrs) + " dB"
            ok = min(snrs) > 18.0
            if "--rds" in flags:
                pi = 0x2000 + WIDE_CLI_FREQS.index(f)
                final = re.search(re.escape(f"  {f / 1e6:+.2f} MHz RDS "
                                            "final: ")
                                  + r"PI=(0x[0-9a-f]+) .*\((\d+) groups\)",
                                  text)
                ok = ok and final is not None and int(final.group(1),
                                                      16) == pi
                msg += (f", RDS PI={final.group(1)} ({final.group(2)} "
                        "groups)" if final else ", RDS no sync")
            if not ok:
                raise AssertionError(f"cli {cmd}: {msg}\n{text}")
            msgs.append(msg)
        log(f"cli {cmd}: " + "; ".join(msgs)
            + f"; {secs:.2f} s wall incl. set-up")


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
    on the device: IQ MS/s per profile from CUDA events, one step's fm
    held against the plain front end on a few stations, and the --fast
    step's torch.profiler breakdown."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.ops.cuda.frontend_kernel import (
        frontend_demod_reference, frontend_reference)
    from sdr_tpu_torch.ops.demod import fm_arctan
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    c, bs = blocks.shape[1], blocks.shape[2]
    rates = {}
    launched = dict(LAUNCHES)
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
        if name == "fast_int8":   # the headline cell's breakdown
            state = profile_steps(rx, state, blocks, ms, label=f"mono {name}")
        del rx, state, st, st0, out
        torch.cuda.empty_cache()
    count_full_width(launched)
    return rates


def run_real_size_stereo(blocks, device, name: str = "stereo+RDS",
                         profile: dict | None = None, steps: int = 5,
                         stations_checked: int = 4,
                         profile_n: int = 10, keep: list | None = None
                         ) -> tuple:
    """A stereo + RDS profile (bench.py's by default) at C stations x
    15.36 MB per step, input resident on the device: two steps whose
    left, right and rds_soft are checked, then ms/step and IQ MS/s from
    CUDA events, and the step's torch.profiler breakdown.  The check holds
    a few stations to 45 dB SNR against the same steps on the CPU (where
    the plain versions run; a float32 last bit can flip a bf16 rounding,
    and a loop carries it through its feedback); a profile whose loops are
    too slow on the CPU at this length (the scan loops, one Python step
    per sample) gates every station's separation instead.  `keep`, where
    given, receives the checked steps' rds_soft (phase 5g reads it)."""
    import numpy as np
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    from sdr_tpu_torch.utils.compare import stereo_separation_db
    profile = STEREO_PROFILE if profile is None else profile
    c, bs = blocks.shape[1], blocks.shape[2]
    rx = Receiver(0, device=device, **profile)
    if bs % rx.block_align_u8():
        raise AssertionError(f"{name}: {bs} B is not a whole step")
    k = stations_checked
    check_cpu = profile.get("pll_impl", "auto") not in ("auto", "scan")
    crx = Receiver(0, device="cpu", **profile) if check_cpu else None
    st = rx.init_state((c,))
    cst = crx.init_state((k,)) if check_cpu else None
    n_if = bs // (2 * rx.cfg.rf_decim)
    rate_a = rx.cfg.audio_fs
    full = dict(LAUNCHES)
    launched = LAUNCHES["pll"]
    for b, blk in enumerate(blocks):
        st, out = rx.step(st, blk)
        if keep is not None:
            keep.append(out["rds_soft"])
        for key, n in (("left", n_if // rx.cfg.audio_decim),
                       ("right", n_if // rx.cfg.audio_decim),
                       ("rds_soft", None)):
            v = out[key]
            if not bool(torch.isfinite(v).all()) or v.shape[0] != c or (
                    n is not None and v.shape[-1] != n):
                raise AssertionError(f"{name} {key}: {tuple(v.shape)}")
        if check_cpu:
            cst, cout = crx.step(cst, blk[:k].cpu())
            for key in ("left", "right", "rds_soft"):
                snr = snr_db(cout[key].double().numpy(),
                             out[key][:k].double().cpu().numpy())
                if not snr >= 45.0:
                    raise AssertionError(f"{name} step {b} {key}: card vs "
                                         f"CPU {snr:.1f} dB")
            log(f"real size {name} step {b}: stations 0-{k - 1} agree with "
                f"the CPU (left/right/rds_soft >= 45 dB)")
        else:
            left = out["left"].double().cpu().numpy()
            right = out["right"].double().cpu().numpy()
            # the loops lock within the first quarter second
            skip = min(rate_a // 4, left.shape[-1] // 2) if b == 0 else 0
            sep = [stereo_separation_db(left[i], right[i], rate_a, 1000.0,
                                        skip=skip) for i in range(c)]
            if not min(sep) > 20.0:
                raise AssertionError(f"{name} step {b}: separation "
                                     f"{min(sep):.1f} dB on station "
                                     f"{int(np.argmin(sep))}")
            log(f"real size {name} step {b}: every station's separation "
                f"> 20 dB (min {min(sep):.1f}, max {max(sep):.1f} dB)")
    check_joint_loops(rx, LAUNCHES["pll"] - launched, len(blocks), name)
    state, feed = st, itertools.cycle(blocks)

    def one_step():
        nonlocal state
        state, _ = rx.step(state, next(feed))
    ms = cuda_ms(one_step, steps)
    rate = c * bs / 2 / (ms * 1e-3) / 1e6
    log(f"real size {name}: {c} stations x {bs} B/step, {ms:.3f} ms/step"
        f" = {rate:.1f} MS/s IQ (mean of {steps} steps, CUDA events)")
    count_full_width(full)
    state = profile_steps(rx, state, blocks, ms, steps=profile_n,
                          label=name)
    del rx, state, st, out
    torch.cuda.empty_cache()
    return ms, rate


def check_joint_loops(rx, launched: int, steps: int, name: str) -> None:
    """A receiver whose stereo and RDS carriers both run the sequential
    loop launches B8 once a step for both (pll_loop_multi), not twice."""
    if not (rx.stereo and rx.rds and (rx.compat_pll or rx.pll_impl in (
            "scan", "pallas"))):
        return
    if launched != steps:
        raise AssertionError(f"{name}: {launched} B8 launches in {steps} "
                             "steps, not one joint launch a step")
    log(f"real size {name}: one joint B8 launch a step for both loops "
        f"({launched} in {steps} steps)")


def wideband_stations_u8(device, pairs: int, amplitude: float = 0.025):
    """The 64-station wideband stream (u8 interleaved, on the device):
    four stereo + RDS FM basebands at 2.4 MS/s, upsampled to 9.6 MS/s once
    (scipy), station s the baseband s % 4 delayed by 4099*s samples and
    placed at WIDE_FREQS[s]."""
    import numpy as np
    import scipy.signal as sps
    import torch
    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.rds import tx as rds_tx
    fs = float(MODES[0].rf_fs)
    n = -(-pairs // 4) + 64
    bases = []
    for v in range(4):
        bits = rds_tx.standard_group_stream(pi=0x3000 + v, n_groups=int(
            n / fs * 1187.5 / 104) + 3)
        m = tx.make_multiplex(
            fs, n, left=tx.tone(fs, 700.0 + 300.0 * v, n),
            right=tx.tone(fs, 2500.0 - 200.0 * v, n),
            rds_baseband=rds_tx.bits_to_baseband(bits, fs)[:n], a_rds=0.1)
        i, q = tx.fm_modulate(m, fs)
        bases.append(sps.resample_poly(i + 1j * q, 4, 1)[:pairs])
    base = torch.from_numpy(np.stack(bases).astype(np.complex64)).to(device)
    t = torch.arange(pairs, dtype=torch.float64, device=device)
    wide = torch.zeros(pairs, dtype=torch.complex64, device=device)
    for s, f in enumerate(WIDE_FREQS):
        ph = torch.remainder(2 * np.pi * f / FS_WIDE * t, 2 * np.pi)
        osc = torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
        wide += torch.roll(base[s % 4], 4099 * s) * osc
    wide = wide * amplitude
    iq = torch.stack([wide.real, wide.imag], dim=-1).reshape(-1)
    return torch.clamp(torch.round(iq * 128.0 + 128.0), 0, 255).to(
        torch.uint8)


def check_mfb_at_step(pl, blk, cstate, name: str, compute: str) -> None:
    """B7 on one wideband step's block, as the step calls it (the flat
    stream), against its plain version on the pre-phased layout: every
    station within 2e-5 of max|plain|, the carried state bit-equal.  The
    comparison's launch is taken back out of the path's count."""
    import torch
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    from sdr_tpu_torch.ops.cuda.channelizer_kernel import call_cols_reference
    launched = LAUNCHES["mfb"]
    (i_k, q_k), s_k = pl(blk, cstate)
    LAUNCHES["mfb"] = launched
    (i_p, q_p), s_p = call_cols_reference(
        pl, blk.reshape(-1, 2 * pl.decim).T, cstate)
    err = max(max_err(i_k, i_p, 2e-5, False, f"{name} mfb I"),
              max_err(q_k, q_p, 2e-5, False, f"{name} mfb Q"))
    for key in s_p:
        if not torch.equal(s_k[key], s_p[key]):
            raise AssertionError(f"{name} mfb: carried {key} differs")
    n_out = i_k.shape[1]
    bound_ms, bound_by = roofline(*mfb_work(pl, n_out, pl.ingest, compute,
                                            "f32"))
    log(f"real size {name}: B7 {compute} at the step's shape (K={pl.k}, "
        f"n_out={n_out}) max|err| {err:.3g} against its plain version; "
        f"bound {bound_ms:.4f} ms ({bound_by})")


def run_real_size_wideband(wide_u8, device, name: str, compute: str,
                           rx_kw: dict, steps: int = 5,
                           stations_checked: int = 4,
                           profile_n: int = 10) -> tuple:
    """WidebandReceiver at the reference's wideband configuration (64
    stations, 9.6 MS/s u8, blocks_per_step 16, BASELINE.md:219-229; the
    CLI's engines: the channelizer kernel in `compute`, the unfused
    receiver) with the input resident on the device: two steps checked,
    then ms/step and wideband MS/s from CUDA events, and the step's
    torch.profiler breakdown.  The --fast profiles (feedforward carriers)
    hold stations 0-3 of every output to 45 dB against the same steps on
    the CPU: a 4-station channelizer with those offsets (each bank row is
    independent of the others) and the CPU receiver, the plain versions
    on the same inputs.  The default profile (the scan loops, too slow on
    the CPU at this length) is gated on finite outputs of every station;
    phase 3g gates its decode.  Before the first step, B7 is held against
    its plain version at the step's own shape on all 64 stations, from the
    state that step starts from (2e-5 of max|plain|, carried state
    bit-equal); that comparison's launch is not the path's and is not
    counted."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.models.wideband import WidebandReceiver
    from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES

    def build(freqs, dev):
        chan = WidebandChannelizer(FS_WIDE, 2.4e6, freqs, engine="pallas",
                                   ingest="u8", compute_dtype=compute,
                                   device=dev)
        return WidebandReceiver(chan, Receiver(0, device=dev, **rx_kw))

    wrx = build(WIDE_FREQS, device)
    bw = wrx.block_wide(WIDE_BLOCKS_PER_STEP)
    blocks = [wide_u8[b * bw:(b + 1) * bw] for b in range(len(wide_u8) // bw)]
    if len(blocks) < 2:
        raise AssertionError(f"{name}: the stream holds {len(blocks)} steps")
    k = stations_checked
    check_cpu = rx_kw.get("pll_impl") == "ff"
    cwrx = build(WIDE_FREQS[:k], "cpu") if check_cpu else None
    st = wrx.init_state()
    cst = cwrx.init_state() if check_cpu else None
    check_mfb_at_step(wrx.chan._pl, blocks[0], st[0], name, compute)
    cpu_s = 0.0
    full = dict(LAUNCHES)
    launched = LAUNCHES["pll"]
    for b, blk in enumerate(blocks[:2]):
        st, out = wrx.step(st, blk)
        for key, v in out.items():
            if not bool(torch.isfinite(v).all()) or v.shape[0] != len(
                    WIDE_FREQS):
                raise AssertionError(f"{name} {key}: {tuple(v.shape)}")
        if check_cpu:
            t0 = time.perf_counter()
            cst, cout = cwrx.step(cst, blk.cpu())
            cpu_s += time.perf_counter() - t0
            snrs = {key: snr_db(cout[key].double().numpy(),
                                out[key][:k].double().cpu().numpy())
                    for key in cout}
            if not min(snrs.values()) >= 45.0:
                raise AssertionError(f"{name} step {b}: card vs CPU {snrs}")
            log(f"real size {name} step {b}: stations 0-{k - 1} agree with "
                f"the CPU (" + ", ".join(f"{key} {v:.1f}" for key, v in
                                         sorted(snrs.items())) + " dB)")
        else:
            log(f"real size {name} step {b}: every output finite on all "
                f"{len(WIDE_FREQS)} stations")
    check_joint_loops(wrx.rx, LAUNCHES["pll"] - launched, 2, name)
    state, feed = st, itertools.cycle(blocks)

    def one_step():
        nonlocal state
        state, _ = wrx.step(state, next(feed))
    ms = cuda_ms(one_step, steps)
    rate = bw / 2 / (ms * 1e-3) / 1e6
    log(f"real size {name}: {len(WIDE_FREQS)} stations from {bw // 2} "
        f"wideband pairs/step, {ms:.3f} ms/step = {rate:.1f} wideband MS/s "
        f"(mean of {steps} steps, CUDA events); the CPU check took "
        f"{cpu_s:.1f} s")
    count_full_width(full)
    state = profile_steps(wrx, state, blocks, ms, steps=profile_n,
                          label=name)
    del wrx, state, st, out, blocks
    torch.cuda.empty_cache()
    return ms, rate


def run_loop_engines(device: str, seconds: float = 1.2) -> None:
    """Receiver.run on one station of the recipe's capture with the other
    loop engines: 'pallas' (the sequential kernel, polynomial detector),
    'pallas_chunked' stereo alone (the chunked kernel, one instance) and
    'chunked' (the chunked kernel, exact detector, one launch per
    carrier).  Each decodes the tones (separation > 20 dB) and, with RDS,
    the groups through StreamingRdsDecoder."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.rds.streaming import StreamingRdsDecoder
    from sdr_tpu_torch.utils.compare import stereo_separation_db, tone_snr_db
    cap = torch.from_numpy(stereo_capture(seconds))
    for engine, kw in (("pallas", dict(stereo=True, rds=True)),
                       ("pallas_chunked", dict(stereo=True)),
                       ("chunked", dict(stereo=True, rds=True))):
        rx = Receiver(0, device=device, pll_impl=engine, **kw)
        t0 = time.perf_counter()
        out, _ = rx.run(cap, blocks_per_step=25)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rate = rx.cfg.audio_fs
        left = out["left"].double().cpu().numpy()
        right = out["right"].double().cpu().numpy()
        skip = rate // 4
        snr_l = tone_snr_db(left, rate, 1000.0, skip=skip)
        snr_r = tone_snr_db(right, rate, 2500.0, skip=skip)
        sep = stereo_separation_db(left, right, rate, 1000.0, skip=skip)
        msg = (f"{engine} ({', '.join(kw)}): L {snr_l:.1f} dB, R "
               f"{snr_r:.1f} dB, separation {sep:.1f} dB")
        ok = snr_l > 20.0 and snr_r > 20.0 and sep > 20.0
        if rx.rds:
            dec = StreamingRdsDecoder(rx.cfg.rds_sps)
            dec.push(out["rds_soft"].float().cpu().numpy())
            info = dec.info
            msg += (f", RDS PI={info.pi and hex(info.pi)} "
                    f"PS={info.ps_name!r} ({info.groups_seen} groups)")
            ok = ok and info.pi == 0x3D44 and info.groups_seen >= 3
        if not ok:
            raise AssertionError(f"loop engine {msg}")
        log(f"loop engine {msg}, {secs:.2f} s wall incl. set-up")


# ------------------------------------------------------ phases 3h-3j, 4f
# the reference's --stations --fast profile (sdr_tpu/cli.py:404-405): the
# bf16 front end, feedforward carriers, bf16 convs; no fused IF bank, no
# tiled convs
STATIONS_FAST = dict(stereo=True, rds=True, fused_frontend="bf16",
                     pll_impl="ff", conv_dtype="bf16")
# phase 3h's four stations: (left tone, right tone); PI 0x3000 + k
STATION_TONES = ((1000.0, 2500.0), (700.0, 1900.0), (1300.0, 3100.0),
                 (900.0, 2200.0))
# the receiver's ranges that phase 3j's --profile trace must hold
SCOPES = ("rf_frontend", "ifbank_fused_mix", "carrier_ffmix",
          "audio_pair_kernel")


def station_capture(k: int, seconds: float = 1.2):
    """Phase 3h's station k (numpy u8): STATION_TONES[k] on left and right
    and RDS groups of PI 0x3000 + k."""
    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.rds import tx as rds_tx
    cfg = MODES[0]
    n = int(seconds * cfg.rf_fs)
    left, right = STATION_TONES[k]
    bits = rds_tx.standard_group_stream(
        pi=0x3000 + k, ps_name=f"FLEET {k} ",
        n_groups=int(seconds * 1187.5 / 104) + 3)
    return tx.synthesize_capture(
        cfg, seconds=seconds, seed=k, left=tx.tone(cfg.rf_fs, left, n),
        right=tx.tone(cfg.rf_fs, right, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n], a_rds=0.1)


def cli_call(argv: list[str], device: str) -> tuple[str, float]:
    """cli.main(argv) in-process: (its stderr, wall seconds); raises on a
    non-zero exit."""
    from sdr_tpu_torch import cli
    if device != "cuda":
        argv = [*argv, "--device", device]
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}:\n"
                             f"{err.getvalue()}")
    return err.getvalue(), secs


def run_cli_stations(device: str, fast: bool) -> None:
    """Phase 3h: the CLI's --stations on four one-station stereo + RDS
    captures of 1.2 s: every station's tones (> 20 dB), separation
    (> 20 dB) and PI."""
    from sdr_tpu_torch.io.wav import read_wav
    from sdr_tpu_torch.utils.compare import stereo_separation_db, tone_snr_db
    flag = ["--fast"] if fast else []
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k in range(len(STATION_TONES)):
            paths.append(os.path.join(tmp, f"station{k}.u8"))
            station_capture(k).tofile(paths[-1])
        wav_dir = os.path.join(tmp, "wav")
        text, secs = cli_call(["0", "2", "--rds", *flag, "--stations",
                               ",".join(paths), "--wav-dir", wav_dir],
                              device)
        msgs = []
        for k, (lt, rt) in enumerate(STATION_TONES):
            rate, pcm = read_wav(os.path.join(wav_dir, f"station{k}.wav"))
            left, right = pcm[:, 0].astype("f8"), pcm[:, 1].astype("f8")
            skip = rate // 4
            snr_l = tone_snr_db(left, rate, lt, skip=skip)
            snr_r = tone_snr_db(right, rate, rt, skip=skip)
            sep = stereo_separation_db(left, right, rate, lt, skip=skip)
            m = re.search(rf"station {k} RDS final: PI=(0x[0-9a-f]+) .*"
                          r"\((\d+) groups\)", text)
            msg = (f"station {k}: L {snr_l:.1f} dB, R {snr_r:.1f} dB, "
                   f"separation {sep:.1f} dB, PI "
                   + (f"{m.group(1)} ({m.group(2)} groups)" if m
                      else "no sync"))
            if not (snr_l > 20.0 and snr_r > 20.0 and sep > 20.0 and m
                    and int(m.group(1), 16) == 0x3000 + k):
                raise AssertionError(f"cli --stations {' '.join(flag)}: "
                                     f"{msg}\n{text}")
            msgs.append(msg)
    log(f"cli {' '.join(['0', '2', '--rds', *flag])} --stations (4 "
        "captures of 1.2 s): "
        + "; ".join(msgs) + f"; {secs:.2f} s wall incl. set-up")


def check_frontend_at_step(rx, blk, state, name: str) -> dict:
    """B1 in the receiver's own engine (bf16 for --stations --fast, fm
    stored at bf16) on one full-width step's block, from the state that
    step starts from, against its plain version: fm and the carried
    samples within 1e-5 of max|plain| (plus one bf16 ulp for fm, the
    float engine sums in another order), the carried u8 tail bit-equal.
    The comparison's launches are taken back out of the path's count."""
    import torch
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    from sdr_tpu_torch.ops.cuda.frontend_kernel import (
        frontend_demod_reference)
    fe, front = rx._fused_fe, state.front
    args = (blk, front.i_tail, front.prev_i, front.prev_q)
    launched = LAUNCHES["frontend_demod"]
    got = fe.demod_call(*args)
    want = frontend_demod_reference(fe, *args)
    err = max_err(got[0], want[0], 1e-5, got[0].dtype == torch.bfloat16,
                  f"{name} B1 fm")
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"{name} B1: carried tail differs from plain")
    for g, w, what in zip(got[2:4], want[2:4], ("prev_i", "prev_q")):
        max_err(g, w, 1e-5, False, f"{name} B1 {what}")
    ms = cuda_ms(lambda: fe.demod_call(*args), 10)
    plain_ms = cuda_ms(lambda: frontend_demod_reference(fe, *args), 3)
    LAUNCHES["frontend_demod"] = launched
    c, n = blk.shape
    m = n // (2 * rx.cfg.rf_decim)
    nbytes = c * n + 2 * c * 128 + c * m * got[0].element_size() + 16 * c
    bound_ms, bound_by = roofline(nbytes, {"f32": c * m * (2 * 51 * 2 + 9)})
    log(f"real size {name}: B1 {fe.compute_dtype}->{got[0].dtype} at the "
        f"step's shape (C={c}, n={n}) max|err| {err:.3g} against its plain "
        f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "c": c, "n": n}


def same_or_one_lsb(a, b) -> str:
    """'bit-equal' or 'within one LSB' of two float audio tensors (as s16,
    x16384, the CLI's packing); raises beyond one LSB."""
    import torch
    from sdr_tpu_torch.io.stream import pack_s16
    if a.dtype == b.dtype and torch.equal(a, b):
        return "bit-equal"
    d = (pack_s16(a.float()).int() - pack_s16(b.float()).int()).abs().max()
    if d.item() > 1:
        raise AssertionError(f"differs by {d.item()} LSB")
    return "within one LSB"


def checkpoint_real_size(blocks, device, profile: dict, name: str) -> None:
    """Phase 3i at full width: a 128-station state saved after one step,
    loaded and continued for a second step, against the uninterrupted
    second step (bit-equal, or every output within one LSB); the state's
    bytes and the save and load times (host clock around
    utils/checkpoint.py's calls, the device synchronized before the
    save)."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.utils.checkpoint import load_state, save_state
    rx = Receiver(0, device=device, **profile)
    c = blocks.shape[1]
    st, _ = rx.step(rx.init_state((c,)), blocks[0])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(path, st)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_state(path, rx.init_state((c,)))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    _, want = rx.step(st, blocks[1])
    _, got = rx.step(loaded, blocks[1])
    verdict = {k: same_or_one_lsb(got[k], want[k]) for k in ("left",
                                                            "right")}
    soft = ("bit-equal" if torch.equal(got["rds_soft"], want["rds_soft"])
            else "differs")
    if soft != "bit-equal":
        raise AssertionError(f"{name}: resumed rds_soft differs")
    log(f"checkpoint {name} ({c} stations): state {nbytes} B on disk, save "
        f"{save_s * 1e3:.1f} ms, load {load_s * 1e3:.1f} ms (host clock); "
        f"the resumed step against the uninterrupted one: left "
        f"{verdict['left']}, right {verdict['right']}, rds_soft {soft}")
    del rx, st, loaded
    torch.cuda.empty_cache()


def run_cli_resume(device: str, fast: bool) -> None:
    """Phase 3i through the CLI: `0 2 --rds [--fast]` on the recipe's
    capture cut at a step boundary into a run with --save-state and one
    with --resume; the joined audio against one uninterrupted run
    (bit-equal, or within one LSB)."""
    import numpy as np
    flag = ["--fast"] if fast else []
    common = ["0", "2", "--rds", *flag, "--blocks-per-step", "8"]
    from sdr_tpu_torch.models.receiver import Receiver
    rx = Receiver(0, device=device, **({
        k: v for k, v in STEREO_PROFILE.items() if not k.startswith("fe_")}
        if fast else DEFAULT_PROFILE))
    cap = stereo_capture(1.2)
    bs = rx.block_size_u8(8)
    half = len(cap) // 2 // bs * bs
    with tempfile.TemporaryDirectory() as tmp:
        parts = {"a": cap[:half], "b": cap[half:], "whole": cap}
        for k, v in parts.items():
            v.tofile(os.path.join(tmp, f"{k}.u8"))
        state = os.path.join(tmp, "state.npz")

        def run(part, *extra):
            out = os.path.join(tmp, f"{part}.raw")
            text, secs = cli_call([*common, "--in",
                                   os.path.join(tmp, f"{part}.u8"),
                                   "--out", out, *extra], device)
            return np.fromfile(out, "<i2").astype(np.int64), text, secs

        a, _, sa = run("a", "--save-state", state)
        b, text, sb = run("b", "--resume", state)
        whole, _, _ = run("whole")
        nbytes = os.path.getsize(state)
    if "Resumed state from" not in text:
        raise AssertionError(f"cli {' '.join(common)} --resume:\n{text}")
    joined = np.concatenate([a, b])
    if joined.shape != whole.shape:
        raise AssertionError(f"resume: {joined.shape} vs {whole.shape}")
    d = int(np.abs(joined - whole).max())
    if d > 1:
        raise AssertionError(f"cli {' '.join(common)}: the resumed stream "
                             f"differs from one run by {d} LSB")
    log(f"cli {' '.join(common)} --save-state / --resume: {len(whole)} "
        f"samples, the joined stream "
        f"{'bit-equal to' if d == 0 else 'within one LSB of'} one "
        f"uninterrupted run; state {nbytes} B; halves {sa:.2f} + {sb:.2f} s "
        "wall incl. set-up")


def scope_cost_us(scope, n: int = 200_000) -> float:
    """Host microseconds `with scope("rf_frontend"):` costs with no
    profiler running and tracing off (the loop's own cost taken out)."""
    t0 = time.perf_counter()
    for _ in range(n):
        with scope("rf_frontend"):
            pass
    ranged = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        pass
    bare = time.perf_counter() - t0
    return (ranged - bare) / n * 1e6


def run_cli_taps(device: str) -> None:
    """Phase 3j through the CLI on the recipe's stereo capture: --psd-dump
    (the pilot's peak near 19 kHz), --trace-iq (four traces of 512
    samples), --profile (the trace holds the receiver's ranges and the
    kernels' names), and --stats naming the native reader and sink."""
    import numpy as np
    cap = stereo_capture(1.2)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "cap.u8")
        cap.tofile(src)
        out = os.path.join(tmp, "a.raw")
        base = os.path.join(tmp, "t")
        text, secs = cli_call(["0", "2", "--fast", "--in", src, "--out", out,
                               "--psd-dump", base + "_psd", "--trace-iq",
                               base], device)
        psd = np.loadtxt(base + "_psd.dat", comments="#")
        band = (psd[:, 0] > 16.0) & (psd[:, 0] < 22.0)
        f_peak = psd[band][np.argmax(psd[band, 1]), 0]
        lift = psd[band, 1].max() - np.median(psd[:, 1])
        if not (abs(f_peak - 19.0) < 0.5 and lift > 20.0):
            raise AssertionError(f"--psd-dump: peak at {f_peak} kHz, "
                                 f"{lift:.1f} dB over the median")
        for name in ("i_time", "q_time", "i_filt_time", "q_filt_time"):
            rows = np.loadtxt(f"{base}_{name}.dat", comments="#")
            if rows.shape != (512, 2) or not np.isfinite(rows).all():
                raise AssertionError(f"--trace-iq {name}: {rows.shape}")
        log(f"cli 0 2 --fast --psd-dump --trace-iq: PSD peak {f_peak:.3f} "
            f"kHz, {lift:.1f} dB over the median; four traces of 512 "
            f"samples; {secs:.2f} s wall incl. set-up")
        prof = os.path.join(tmp, "prof")
        text, secs = cli_call(["0", "2", "--rds", "--fast", "--in", src,
                               "--out", out, "--profile", prof, "--stats",
                               "--blocks-per-step", "8"], device)
        if "host I/O: native reader, native sink" not in text:
            raise AssertionError(f"the CLI did not use the native ring:\n"
                                 f"{text}")
        events = json.loads(Path(prof, "trace.json").read_text()
                            )["traceEvents"]
    ranges = [e.get("name") for e in events
              if e.get("cat") == "user_annotation"]
    kernel_names = [e.get("name", "") for e in events
                    if e.get("cat") == "kernel"]
    counts = {s: ranges.count(s) for s in SCOPES}
    kernels = {sym: sum(sym in n for n in kernel_names) for sym in (
        "frontend_", "ifbank_", "ffmix_kernel", "pair_")}
    missing = [k for k, v in {**counts, **kernels}.items() if v == 0]
    if missing:
        raise AssertionError(f"--profile trace lacks {missing}")
    steps = counts["rf_frontend"]
    from torch.profiler import record_function
    from sdr_tpu_torch.io.logger import stage_scope
    raw, cost = scope_cost_us(record_function), scope_cost_us(stage_scope)
    log(f"cli 0 2 --rds --fast --profile --stats: native reader and sink; "
        f"the trace holds " + ", ".join(f"{k} x{v}" for k, v in
                                         counts.items())
        + " and the kernels " + ", ".join(f"{k}* x{v}" for k, v in
                                           kernels.items())
        + f"; {secs:.2f} s wall incl. set-up")
    per_step = sum(counts.values()) / steps
    log(f"ranges with no profiler running (host time, mean of 200000): "
        f"record_function {raw:.3f} us, the program's stage_scope "
        f"{cost:.3f} us; {per_step:.0f} ranges a --fast stereo + RDS step: "
        f"{cost * per_step:.2f} us a step ({raw * per_step:.2f} us as "
        "record_function)")


OPTION_PROFILES = {
    "deemphasis_us=75": dict(DEFAULT_PROFILE, deemphasis_us=75.0),
    "compat_shared_audio_state": dict(DEFAULT_PROFILE,
                                      compat_shared_audio_state=True),
    "filter_engine='fft'": dict(DEFAULT_PROFILE, filter_engine="fft"),
}


def run_options(device: str, steps: int = 2) -> None:
    """Phase 3j: the Receiver's last options in the default stereo + RDS
    profile (the sequential loop B8 on the card), one station of the
    recipe's capture, two steps with the state carried, against the same
    steps on the CPU: mono, left, right and rds_soft at >= 45 dB (the
    loops carry an ulp of detector input into the acquisition transient,
    as phase 4d's gate allows)."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    cap = stereo_capture(0.3)
    for name, kw in OPTION_PROFILES.items():
        rx = Receiver(0, device=device, **kw)
        crx = Receiver(0, device="cpu", **kw)
        bs = rx.block_size_u8(8)
        st, cst = rx.init_state(), crx.init_state()
        worst = {}
        for b in range(steps):
            blk = torch.from_numpy(cap[b * bs:(b + 1) * bs])
            st, out = rx.step(st, blk.to(device))
            cst, cout = crx.step(cst, blk)
            for key in ("mono", "left", "right", "rds_soft"):
                s = snr_db(cout[key].double().numpy(),
                           out[key].double().cpu().numpy())
                worst[key] = min(worst.get(key, 1e9), s)
        if not min(worst.values()) >= 45.0:
            raise AssertionError(f"option {name}: card vs CPU {worst}")
        log(f"option {name}: {steps} one-station steps of {bs} B agree with "
            "the CPU (" + ", ".join(f"{k} {v:.1f}" for k, v in worst.items())
            + " dB)")


def ranges() -> frozenset:
    """The program's span names (io/logger.py NAMES, imported when asked:
    --time-mfb imports another checkout's package): a trace holds them as
    annotations beside the kernels, and the device time they span is not
    a kernel's."""
    from sdr_tpu_torch.io.logger import NAMES
    return frozenset(NAMES)
# kernel symbol in a profiler trace -> the LAUNCHES keys that launch it
# (the front end's and the IF bank's float and tensor-core kernels)
KERNEL_SYMBOLS = {"frontend_": ("frontend_demod", "frontend"),
                  "ifbank_": ("ifbank_mix", "ifbank"),
                  "ffmix_kernel": ("ffmix",), "pair_": ("audio_pair",),
                  "pll_loop_kernel": ("pll",),
                  "pll_chunked_kernel": ("pll_chunked", "pll_chunked_multi"),
                  "mfb_": ("mfb",), "banded_": ("banded",)}


def profile_steps(rx, state, blocks, step_ms: float, steps: int = 10,
                  label: str = "stereo+RDS"):
    """torch.profiler breakdown of rx.step: device time per kernel (mean
    of `steps` steps, after one warm-up profiler cycle that sets CUPTI
    up), the device's busy time and its idle share of step_ms (the step
    by CUDA events, without the profiler), and the host's enqueue time
    per step without the profiler.  Each profiler window opens with one
    step in its warm-up phase (traced, left out of the results), so that a
    trace which drops the first kernel of its window drops one of that
    step.  Each kernel's event count in the trace is held against
    build.LAUNCHES over the profiled steps; where they differ (the trace
    lost events) it says so and profiles once more.  The steps taken here
    do not count in the path's launches: build.LAUNCHES is as it was on
    entry when this returns.  A measurement, not a gate: where the
    profiler sees no device time it says so.  One gate: a receiver of the
    tiled engine (conv_engine='tiled') runs no convolution in its step
    (aten::convolution calls), and `--stations --fast` (the conv engine,
    the reference's choice) runs some.  Returns the advanced state."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    counted = dict(LAUNCHES)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        state, _ = rx.step(state, blocks[0])
        torch.cuda.synchronize()
    tag = f"profile [{label}]:"

    def profiled():
        nonlocal state
        sched = schedule(wait=0, warmup=1, active=steps, repeat=1)
        with profile(activities=acts, schedule=sched) as prof:
            state, _ = rx.step(state, blocks[0])
            torch.cuda.synchronize()
            prof.step()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            for i in range(steps):
                state, _ = rx.step(state, blocks[i % len(blocks)])
                if i == steps - 1:
                    torch.cuda.synchronize()
                prof.step()
        wall = (time.perf_counter() - t0) / steps * 1e3
        rows = []
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            # ProfilerStep* is the schedule's span of a step and ranges()
            # the program's spans, not kernels
            if t > 0 and e.key not in ranges() and not e.key.startswith(
                    ("aten::", "cuda", "ProfilerStep")):
                rows.append((t / steps / 1e3, e.count, e.key))
        lost = []
        for sym, keys in KERNEL_SYMBOLS.items():
            seen = sum(n for _, n, key in rows if sym in key)
            want = sum(LAUNCHES[k] - before[k] for k in keys)
            if seen != want:
                lost.append(f"{sym} {seen} events for {want} launches")
        convs = sum(e.count for e in prof.key_averages()
                    if e.key == "aten::convolution") / steps
        return rows, wall, lost, convs

    rows, wall, lost, convs = profiled()
    if lost:
        log(f"{tag} the trace lost events ({'; '.join(lost)}): profiling "
            "again")
        rows, wall, lost, convs = profiled()
        if lost:
            log(f"{tag} the second trace lost events too "
                f"({'; '.join(lost)}): its numbers are incomplete")
    busy = sum(t for t, _, _ in rows)
    if busy == 0.0:
        log(f"{tag} torch.profiler recorded no device time: not measured")
    log(f"{tag} wall under the profiler {wall:.3f} ms/step, device busy "
        f"{busy:.3f} ms/step (mean of {steps} steps), idle share "
        f"{1 - busy / step_ms:.3f} of the {step_ms:.3f} ms step"
        + ("" if lost else "; every kernel's trace events match its "
           "launches"))
    for t, n, key in sorted(rows, reverse=True)[:25]:
        log(f"{tag} {t:9.4f} ms  x{n // steps:3d}  {key[:100]}")
    tiled = getattr(rx, "rx", rx)._args["conv_engine"] == "tiled"
    log(f"{tag} {convs:g} aten::convolution calls a step"
        + (" (the tiled engine's receiver)" if tiled else ""))
    if tiled and convs:
        raise AssertionError(f"{tag} a tiled-engine step runs {convs:g} "
                             "convolutions")
    if label == "stations --fast" and not convs:
        raise AssertionError(f"{tag} --stations --fast runs no convolution: "
                             "it keeps the conv engine")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, _ = rx.step(state, blocks[i % len(blocks)])
    host = (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.synchronize()
    log(f"{tag} host enqueue {host:.3f} ms/step (no sync)")
    LAUNCHES.update(counted)
    return state


# ------------------------------------------------------------------ phase 5
# the parallel layer (sdr_tpu_torch/parallel/): meshes of 8 shards on the
# one card, the counterpart of the reference's 8 virtual devices
# (tests/conftest.py); the shards on one device run as one batch
SHARDS = 8


def virtual_mesh(axis: str):
    import torch
    from sdr_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(SHARDS, axis, devices=[torch.device("cuda")] * SHARDS)


def timed(fn):
    """(fn(), its host wall ms), synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def state_leaves(state) -> list:
    from sdr_tpu_torch.parallel.mesh import tree_map
    leaves: list = []
    tree_map(leaves.append, state)
    return leaves


def launched_ms(fn, key: str, symbol: str, tries: int = 3
                ) -> tuple[float | None, int]:
    """(device ms of the `symbol` kernel in one fn() call, its launches in
    that call) from torch.profiler.  The profiler's window opens with a
    warm-up call (traced, left out), as in profile_steps: a trace drops
    the first kernels of its window now and then (PERF.md §7).  A trace
    whose kernel events still do not match the call's launches is taken
    again; after `tries` such traces the time is None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    launched = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before = LAUNCHES[key]
            fn()
            torch.cuda.synchronize()
            prof.step()
        launched = LAUNCHES[key] - before
        total, events = 0.0, 0
        for e in prof.key_averages():
            if symbol in e.key and e.key not in ranges():
                t = getattr(e, "self_device_time_total", None)
                total += e.self_cuda_time_total if t is None else t
                events += e.count
        if events == launched:
            return total / 1e3, launched
        log(f"profile of {symbol}: {events} events for {launched} "
            "launches: profiling again")
    log(f"profile of {symbol}: the traces lost events {tries} times: not "
        "measured")
    return None, launched


def run_channel_dp(device) -> dict:
    """Phase 5a: phase 4's mono --fast input (128 stations, two steps of
    5.12 MB) through `sharded_run` on make_mesh() (the card's devices) and
    on a virtual 8-shard mesh, against the serial Receiver.run on the
    same (128, 2 x 5.12 MB) u8: outputs within 1e-5 of max|ref| (bit-equal
    expected: the shards of one device run as one batch) and the final
    state leaf for leaf.  Times each whole run (two steps)."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.parallel.channels import sharded_run
    from sdr_tpu_torch.parallel.mesh import make_mesh
    rx = Receiver(MODE, device=device, **REAL_PROFILES["fast_int8"])
    bs = rx.block_size_u8(BLOCKS_PER_STEP)
    iq = station_blocks(capture(2 * bs / 2 / 2.4e6 + 0.01), STATIONS, bs, 2,
                        device).transpose(0, 1).reshape(STATIONS, 2 * bs)
    serial, s_final = rx.run(iq, blocks_per_step=BLOCKS_PER_STEP)
    _, serial_ms = timed(lambda: rx.run(iq, blocks_per_step=BLOCKS_PER_STEP))
    res = {"serial": serial_ms / 2}
    for name, mesh in (("make_mesh()", make_mesh()),
                       ("virtual 8", virtual_mesh("channels"))):
        def run():
            return sharded_run(rx, iq, mesh, blocks_per_step=BLOCKS_PER_STEP)
        outs, final = run()
        _, ms = timed(run)
        exact = True
        for key, want in serial.items():
            got = outs[key]
            if got.shape != want.shape:
                raise AssertionError(f"channel DP {name} {key}: "
                                     f"{tuple(got.shape)}")
            err = (got.double() - want.double()).abs().max().item()
            if err > 1e-5 * want.abs().max().item():
                raise AssertionError(f"channel DP {name} {key}: max|err| "
                                     f"{err}")
            exact = exact and err == 0.0
        for a, b in zip(state_leaves(final), state_leaves(s_final)):
            if not torch.equal(a, b):
                raise AssertionError(f"channel DP {name}: final state "
                                     "differs from the serial run's")
        res[name] = ms / 2
        log(f"channel DP on {name} ({len(mesh.devices)} shards): "
            f"{STATIONS} stations x 2 steps of {bs} B "
            f"{'bit-equal to' if exact else 'within 1e-5 of max of'} the "
            f"serial run, final state equal; {ms / 2:.3f} ms/step against "
            f"serial {serial_ms / 2:.3f} (host wall, whole runs)")
    return res


def tiled_capture(one, copies: int, device):
    """`copies` back-to-back copies of a capture on the device: a capture
    whose every tone and subcarrier runs a whole number of periods is
    seamless when repeated, and synthesizing the whole length would cost
    a minute of host time."""
    import numpy as np
    import torch
    return torch.from_numpy(np.tile(one, copies)).to(device)


def run_timeshard_mono(device, shapes: dict) -> dict:
    """Phase 5b: one mode-0 station's 30 s tone capture (144 MB of u8)
    through `timesharded_mono` on a virtual 8-shard mesh, in the int8
    --fast engines (B1) and the default float32 ones, against the serial
    Receiver.run at atol 2e-5 (tests/test_parallel.py:77), the tone's SNR
    above 20 dB (phase 3's bar).  Times both runs whole, and B1 on its 8
    rows."""
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.parallel.timeshard import timesharded_mono
    from sdr_tpu_torch.utils.compare import tone_snr_db
    cap = tiled_capture(capture(1.0), 30, device)
    mesh = virtual_mesh("time")
    res = {}
    for name, kw in (("int8 --fast", REAL_PROFILES["fast_int8"]),
                     ("f32 default", {})):
        rx = Receiver(MODE, device=device, **kw)

        def serial():
            return rx.run(cap, blocks_per_step=BLOCKS_PER_STEP)[0]["mono"]

        def sharded():
            return timesharded_mono(rx, cap, mesh)
        want, got = serial(), sharded()
        m = min(len(want), len(got))
        if m < len(want) - 4096 or got.dim() != 1:
            raise AssertionError(f"time-sharded mono {name}: "
                                 f"{tuple(got.shape)} vs {tuple(want.shape)}")
        err = (got[:m].double() - want[:m].double()).abs().max().item()
        if err > 2e-5:
            raise AssertionError(f"time-sharded mono {name}: max|err| {err}")
        rate = rx.cfg.audio_fs
        snr = tone_snr_db(got[rate // 4:rate * 3].double().cpu().numpy(),
                          rate, 1000.0)
        if not snr > 20.0:
            raise AssertionError(f"time-sharded mono {name}: tone SNR "
                                 f"{snr:.1f} dB")
        _, serial_ms = timed(serial)
        _, sharded_ms = timed(sharded)
        res[name] = (serial_ms, sharded_ms)
        log(f"time-sharded mono {name}: {len(cap)} B on {SHARDS} shards, "
            f"max|err| {err:.3g} against the serial run over {m} samples, "
            f"tone SNR {snr:.1f} dB; serial {serial_ms:.3f} ms, sharded "
            f"{sharded_ms:.3f} ms (host wall, whole runs)")
        if rx.fused_frontend:
            ms_p, n_p = launched_ms(sharded, "frontend_demod", "frontend_")
            ms_s, n_s = launched_ms(serial, "frontend_demod", "frontend_")
            shapes.setdefault("frontend_demod", {})[
                "timeshard mono, 8 rows"] = {
                "rows": SHARDS, "bytes_a_row": len(cap) // SHARDS,
                "ms_a_call": ms_p, "launches_a_call": n_p,
                "serial_ms_a_call": ms_s, "serial_launches_a_call": n_s}
            log(f"time-sharded mono {name}: B1 {ms_p} ms in {n_p} "
                f"launches on {SHARDS} rows (the halos', the chunks'); "
                f"serial {ms_s} ms in {n_s} launches on one row "
                "(profiler device time)")
    return res


def run_timeshard_stereo(device, shapes: dict) -> dict:
    """Phase 5c: one station's 10 s stereo capture (1 and 2.5 kHz) in the
    default profile (the scan loop, B8) through `timesharded_stereo` on a
    virtual 8-shard mesh: B8 steps 8 rows where the serial run steps one.
    Stream SNR above 30 dB after 0.2 s and separation within 2 dB of the
    serial run's (tests/test_parallel.py:106-119)."""
    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.parallel.timeshard import (stereo_warmup_if,
                                                  timesharded_stereo)
    from sdr_tpu_torch.utils.compare import (stereo_separation_db,
                                             stream_snr_db)
    cfg = MODES[0]
    n = int(cfg.rf_fs)
    one = tx.synthesize_capture(cfg, seconds=1.0,
                                left=tx.tone(cfg.rf_fs, 1000.0, n),
                                right=tx.tone(cfg.rf_fs, 2500.0, n))
    cap = tiled_capture(one, 10, device)
    mesh = virtual_mesh("time")
    rx = Receiver(0, stereo=True, device=device)

    def serial():
        out = rx.run(cap, blocks_per_step=BLOCKS_PER_STEP)[0]
        return out["left"], out["right"]

    def sharded():
        return timesharded_stereo(rx, cap, mesh)
    (l_s, r_s), (l_p, r_p) = serial(), sharded()
    if l_p.shape != l_s.shape or r_p.shape != r_s.shape:
        raise AssertionError(f"time-sharded stereo: {tuple(l_p.shape)} vs "
                             f"{tuple(l_s.shape)}")
    l_s, r_s, l_p, r_p = (x.double().cpu().numpy()
                          for x in (l_s, r_s, l_p, r_p))
    skip = int(0.2 * cfg.audio_fs)
    snr_l = stream_snr_db(l_p, l_s, skip=skip)
    snr_r = stream_snr_db(r_p, r_s, skip=skip)
    fs = float(cfg.audio_fs)
    sep_p = stereo_separation_db(l_p, r_p, fs, 1000.0, skip=skip)
    sep_s = stereo_separation_db(l_s, r_s, fs, 1000.0, skip=skip)
    if not (snr_l > 30 and snr_r > 30 and sep_s > 20
            and sep_p > sep_s - 2.0):
        raise AssertionError(f"time-sharded stereo: SNR {snr_l:.1f} / "
                             f"{snr_r:.1f} dB, separation {sep_p:.1f} "
                             f"against serial {sep_s:.1f} dB")
    _, serial_ms = timed(serial)
    _, sharded_ms = timed(sharded)
    ms_p, n_p = launched_ms(sharded, "pll", "pll_loop_kernel")
    ms_s, n_s = launched_ms(serial, "pll", "pll_loop_kernel")
    shapes.setdefault("pll", {})["timeshard stereo, 8 rows"] = {
        "rows": SHARDS, "if_samples_a_row": len(cap) // SHARDS // (
            2 * cfg.rf_decim) + stereo_warmup_if(rx),
        "ms_a_call": ms_p, "launches_a_call": n_p,
        "serial_ms_a_call": ms_s, "serial_launches_a_call": n_s}
    log(f"time-sharded stereo: {len(cap)} B on {SHARDS} shards, stream SNR "
        f"L {snr_l:.1f} R {snr_r:.1f} dB, separation {sep_p:.1f} dB "
        f"(serial {sep_s:.1f}); serial {serial_ms:.3f} ms, sharded "
        f"{sharded_ms:.3f} ms (host wall, whole runs); B8 {ms_p} ms in "
        f"{n_p} launches on {SHARDS} rows (the halos', the chunks'), serial "
        f"{ms_s} ms in {n_s} launches on one row (profiler device time)")
    return {"default": (serial_ms, sharded_ms), "b8": (ms_s, ms_p)}


def run_timeshard_full(device) -> dict:
    """Phase 5d: one station's ~10 s stereo + RDS capture in the --fast
    profile (B1, B3, B4, B5) through `timesharded_full` on a virtual
    8-shard mesh, the soft stream decoded by the port's decode_rds_soft on
    the card: PI and PS equal to the serial run's, at least the serial
    run's groups less one, separation above 15 dB
    (tests/test_parallel.py:164-177).  The capture is 6 copies of 1.664 s:
    19 RDS groups, a whole number of periods of every tone, subcarrier
    and symbol."""
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.parallel.timeshard import timesharded_full
    from sdr_tpu_torch.rds import decode_rds_soft
    from sdr_tpu_torch.utils.compare import stereo_separation_db
    cfg = MODES[0]
    one = stereo_capture(3_993_600 / cfg.rf_fs)
    cap = tiled_capture(one, 6, device)
    mesh = virtual_mesh("time")
    rx = Receiver(0, device=device, **STEREO_PROFILE)

    def serial():
        return rx.run(cap, blocks_per_step=BLOCKS_PER_STEP)[0]

    def sharded():
        return timesharded_full(rx, cap, mesh)
    out_s = serial()
    l_p, r_p, soft_p = sharded()
    skip = cfg.audio_fs // 4
    sep = stereo_separation_db(l_p.double().cpu().numpy(),
                               r_p.double().cpu().numpy(), cfg.audio_fs,
                               1000.0, skip=skip)
    info_p = decode_rds_soft(soft_p, cfg.rds_sps, device=device)
    info_s = decode_rds_soft(out_s["rds_soft"], cfg.rds_sps, device=device)
    if not (info_s.pi == 0x3D44 and info_p.pi == info_s.pi
            and info_p.ps_name == info_s.ps_name
            and info_p.groups_seen >= info_s.groups_seen - 1
            and sep > 15.0):
        raise AssertionError(f"time-sharded full: PI {info_p.pi} / "
                             f"{info_s.pi}, PS {info_p.ps_name!r} / "
                             f"{info_s.ps_name!r}, groups "
                             f"{info_p.groups_seen} / {info_s.groups_seen}, "
                             f"separation {sep:.1f} dB")
    _, serial_ms = timed(serial)
    _, sharded_ms = timed(sharded)
    log(f"time-sharded full: {len(cap)} B on {SHARDS} shards, RDS PI="
        f"{info_p.pi:#x} PS={info_p.ps_name!r} {info_p.groups_seen} groups "
        f"(serial {info_s.groups_seen}), separation {sep:.1f} dB; serial "
        f"{serial_ms:.3f} ms, sharded {sharded_ms:.3f} ms (host wall, whole "
        "runs, the host's polarity stitch included)")
    return {"--fast": (serial_ms, sharded_ms)}


def run_station_sharded_wideband(wide_u8, device, shapes: dict) -> dict:
    """Phase 5e: the wideband configuration (64 stations, 9.6 MS/s u8,
    blocks_per_step 16, B7 bf16, the mono --fast receiver) through
    `sharded_wideband_run` on a virtual 8-shard mesh of the one card,
    whose shards run as one channelizer (the serial one) and one batched
    receiver: bit-equal to the serial WidebandReceiver.run, outputs and
    final state, with one B7 launch a step.  Times both runs (the median
    of 5 of each, alternating) and logs the sharded-to-serial ratio, and
    B7 per run."""
    import torch
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    from sdr_tpu_torch.models.wideband import WidebandReceiver
    from sdr_tpu_torch.ops.channelizer import WidebandChannelizer
    from sdr_tpu_torch.parallel.wideband import sharded_wideband_run
    chan = WidebandChannelizer(FS_WIDE, 2.4e6, WIDE_FREQS, engine="pallas",
                               ingest="u8", compute_dtype="bf16",
                               device=device)
    rx = Receiver(0, device=device, **WIDE_FAST)
    wrx = WidebandReceiver(chan, rx)
    nsteps = len(wide_u8) // wrx.block_wide(WIDE_BLOCKS_PER_STEP)
    mesh = virtual_mesh("stations")

    def serial():
        return wrx.run(wide_u8, blocks_per_step=WIDE_BLOCKS_PER_STEP)

    def sharded():
        return sharded_wideband_run(chan, rx, wide_u8, mesh,
                                    blocks_per_step=WIDE_BLOCKS_PER_STEP)
    (want, (_, want_st)) = serial()
    before = LAUNCHES["mfb"]
    got, got_st = sharded()
    if LAUNCHES["mfb"] - before != nsteps:
        raise AssertionError(f"station-sharded wideband: "
                             f"{LAUNCHES['mfb'] - before} B7 launches in "
                             f"{nsteps} steps, not one a step")
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(
                f"station-sharded wideband {key}: not bit-equal to the "
                f"serial run ({tuple(g.shape)} vs {tuple(w.shape)}, max|err| "
                f"{(g.float() - w.float()).abs().max().item():.3g})")
    if not all(torch.equal(a, b) for a, b in zip(
            state_leaves(got_st), state_leaves(want_st), strict=True)):
        raise AssertionError("station-sharded wideband: the final state is "
                             "not the serial run's")
    serial_t, sharded_t = [], []
    for _ in range(5):
        serial_t.append(timed(serial)[1])
        sharded_t.append(timed(sharded)[1])
    serial_ms = sorted(serial_t)[2]
    sharded_ms = sorted(sharded_t)[2]
    ms_p, n_p = launched_ms(sharded, "mfb", "mfb_")
    ms_s, n_s = launched_ms(serial, "mfb", "mfb_")
    shapes.setdefault("mfb", {})["station-sharded, one launch a step"] = {
        "stations": len(WIDE_FREQS), "steps": nsteps,
        "ms_a_call": ms_p, "launches_a_call": n_p,
        "serial_ms_a_call": ms_s, "serial_launches_a_call": n_s}
    log(f"station-sharded wideband: {len(WIDE_FREQS)} stations on {SHARDS} "
        f"shards of one card, {nsteps} steps, bit-equal to the serial run "
        f"(outputs and final state); serial {serial_ms / nsteps:.3f} "
        f"ms/step, sharded {sharded_ms / nsteps:.3f} ms/step, ratio "
        f"{sharded_ms / serial_ms:.3f} (host wall, median of 5 runs each); "
        f"B7 {ms_p} ms in {n_p} launches of {len(WIDE_FREQS)} stations, "
        f"serial {ms_s} ms in {n_s} ({nsteps} steps each; profiler device "
        "time)")
    return {"mono --fast": (serial_ms / nsteps, sharded_ms / nsteps)}


def run_two_processes(device: str = "cuda", stations: int = STATIONS,
                      seconds: float = 0.5, timeout: int = 300) -> None:
    """Phase 5f: two processes rendezvous over gloo on 127.0.0.1
    (parallel/distributed.py) and each runs its half of `stations` on
    `device` (cuda: the card's first) through sharded_run, checked against
    its own serial run
    (tests/torch_multihost_worker.py, which imports only the port).  Fails
    unless both print their MULTIHOST_OK line; kills both on the way
    out."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    worker = str(ROOT / "tests" / "torch_multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port), device,
         str(stations), str(seconds)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    half = stations // 2
    for i, (p, out) in enumerate(zip(procs, outs)):
        want = (f"MULTIHOST_OK proc={i}/2 global_devices=8 local_devices=4 "
                f"channels={i * half}-{(i + 1) * half - 1} device={device}")
        line = next((ln for ln in out.splitlines() if ln.startswith(want)),
                    None)
        if p.returncode != 0 or line is None:
            raise AssertionError(f"worker {i} (rc {p.returncode}):\n"
                                 f"{out[-4000:]}")
        log(f"two processes: {line}")


def run_rds_helpers(soft, device) -> None:
    """Phase 5g: phase 4b's 128-station rds_soft (two steps) through the
    RDS device helpers on the card: recover_symbols' phases and symbols
    equal the CPU's, syndromes_sliding_device equals the host
    syndromes_sliding on every station's bits, and decode_rds_soft on 4
    stations gives the live decoder's PI and PS."""
    import numpy as np
    import torch
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.rds import (StreamingRdsDecoder, biphase_decode,
                                   decode_rds_soft, differential_decode,
                                   recover_symbols)
    from sdr_tpu_torch.rds.matrix import (syndromes_sliding,
                                          syndromes_sliding_device)
    sps = MODES[0].rds_sps
    sym_c, ph_c = recover_symbols(soft, sps)
    sym_h, ph_h = recover_symbols(soft.cpu(), sps)
    if not (torch.equal(ph_c.cpu(), ph_h) and torch.equal(sym_c.cpu(),
                                                          sym_h)):
        raise AssertionError("recover_symbols: the card's phases or symbols "
                             "differ from the CPU's")
    bits = [differential_decode(biphase_decode(s.float().numpy())[0])
            for s in sym_h]
    m = min(len(b) for b in bits)
    bits = np.stack([b[:m] for b in bits])
    syn, syn_ms = timed(lambda: syndromes_sliding_device(
        torch.from_numpy(bits).to(device)))
    syn = syn.cpu().numpy()
    for i, row in enumerate(bits):
        if not np.array_equal(syn[i], syndromes_sliding(row)):
            raise AssertionError(f"syndromes_sliding_device: station {i} "
                                 "differs from the host's")
    infos = []
    for i in range(4):
        info = decode_rds_soft(soft[i], sps, device=device)
        live = StreamingRdsDecoder(sps)
        live.push(soft[i].float().cpu().numpy())
        if not (info.pi == live.info.pi == 0x3D44
                and info.ps_name == live.info.ps_name):
            raise AssertionError(f"decode_rds_soft station {i}: PI "
                                 f"{info.pi} PS {info.ps_name!r}, live "
                                 f"{live.info.pi} {live.info.ps_name!r}")
        infos.append(info.groups_seen)
    log(f"RDS helpers: {tuple(soft.shape)} soft, phases and symbols equal "
        f"the CPU's; syndromes of {bits.shape} bits equal the host's "
        f"({syn_ms:.3f} ms on the card, host wall); decode_rds_soft = live "
        f"PI 0x3d44 PS {info.ps_name!r} on 4 stations ({infos} groups)")


# ------------------------------------------------------------------ phase 6
# the operating envelope (tools/bench_envelope_torch.py): the tool's 12
# rows and tests/test_impairments.py's 4, 0.9 s each with that test's RDS
# (PS "IMPAIR  ", 14 groups), repeated to the 128 stations; one
# Receiver.run per mode and engine set
ENVELOPE_SECONDS = 0.9
ENVELOPE_MODES = (0, 2)
DEMO_STATIONS = 8


def envelope_module():
    if str(ROOT / "tools") not in sys.path:
        sys.path.insert(0, str(ROOT / "tools"))
    import bench_envelope_torch
    return bench_envelope_torch


def envelope_rows() -> list[tuple[str, dict]]:
    env = envelope_module()
    return list(env.ROWS) + [(f"test: {name}", kw)
                             for name, kw in env.IMPAIRMENTS.items()]


def start_envelope(pool) -> tuple[dict, dict]:
    """Phase 6a's inputs, made in `pool` (spawned processes): the 16 rows'
    captures of each mode, and the CPU runs of each mode and engine set,
    submitted to run beside the card's: ({mode: (16, n) u8},
    {(mode, set): future of (outputs, metrics a row)})."""
    env = envelope_module()
    kws = [kw for _, kw in envelope_rows()]
    caps = {m: env.captures(m, kws, ENVELOPE_SECONDS, env.IMPAIR_PS,
                            env.IMPAIR_GROUPS, pool)
            for m in ENVELOPE_MODES}
    cpu = {(m, name): pool.submit(env.cpu_metrics, m, caps[m], engines)
           for m in ENVELOPE_MODES
           for name, engines in env.ENGINE_SETS.items()}
    return caps, cpu


def run_envelope(caps, mode: int, set_name: str, device) -> tuple:
    """One Receiver.run of the mode's 16 rows, each repeated to the 128
    stations (copy c of row r is station 16c + r), in the engine set;
    counted as full width.  Returns (outputs (128, n) on the host, wall
    s)."""
    import numpy as np
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    env = envelope_module()
    batch = np.tile(caps, (STATIONS // len(caps), 1))
    full = dict(LAUNCHES)
    t0 = time.perf_counter()
    out = env.run(mode, batch, env.ENGINE_SETS[set_name], device)
    wall = time.perf_counter() - t0
    count_full_width(full)
    return out, wall


def check_envelope(mode: int, set_name: str, out: dict, cpu_run) -> list:
    """Phase 6a's checks of one run: every copy of a row bit-equal to its
    first copy (the batch's rows are independent at full width); each
    distinct row within 45 dB of the CPU's run of it (the --fast chain's
    gate, phase 4b's; the loops' gate for the default set) on left, right
    and rds_soft, with the same decoded PI, PS and RDS group count; in
    mode 0 tests/test_impairments.py's rows meet its gates.  Every
    failing row is logged before the phase fails.  Returns the card's
    metrics of the 16 rows."""
    import numpy as np
    env = envelope_module()
    rows = envelope_rows()
    k = len(rows)
    what = f"envelope mode {mode} {set_name}"
    bad = []
    for key, v in out.items():
        if not np.isfinite(v).all() or v.shape[0] != STATIONS:
            bad.append(f"{key}: {v.shape}, finite {np.isfinite(v).all()}")
        copies = v.reshape(STATIONS // k, k, -1)
        for r in range(k):
            diff = [c for c in range(1, len(copies))
                    if not np.array_equal(copies[c, r], copies[0, r])]
            if diff:
                bad.append(f"{key} row {rows[r][0]!r}: copies {diff} differ "
                           "from the first (max|err| "
                           f"{np.abs(copies[diff, r] - copies[0, r]).max():.3g})")
    cpu_out, cpu_mets = cpu_run.result()
    mets = [env.metrics(out["left"][r], out["right"][r], out["rds_soft"][r],
                        mode) for r in range(k)]
    for r, (name, _) in enumerate(rows):
        m, c = mets[r], cpu_mets[r]
        for key in ("left", "right", "rds_soft"):
            snr = snr_db(cpu_out[key][r], out[key][r])
            if not snr >= 45.0:
                bad.append(f"row {name!r} {key}: card vs CPU {snr:.1f} dB")
        if (m["pi"], m["ps"], m["groups"]) != (c["pi"], c["ps"],
                                               c["groups"]):
            bad.append(f"row {name!r}: RDS {m['pi']} {m['ps']!r} "
                       f"{m['groups']} groups, CPU {c['pi']} {c['ps']!r} "
                       f"{c['groups']}")
        if mode == 0 and name.startswith("test: ") and not (
                m["separation_db"] > env.GATES["separation_db"]
                and m["snr_db"] > env.GATES["snr_db"]
                and m["pi"] == env.IMPAIR_PI and m["ps"] == env.IMPAIR_PS
                and m["groups"] >= env.GATES["groups"]):
            bad.append(f"row {name!r} misses tests/test_impairments.py's "
                       f"gates: {m}")
    for b in bad:
        log(f"{what}: {b}")
    if bad:
        raise AssertionError(f"{what}: {len(bad)} checks failed (above)")
    log(f"{what}: every copy of the {k} rows bit-equal to its first, each "
        "row within 45 dB of the CPU's with its PI, PS and groups"
        + (", the reference rows within tests/test_impairments.py's gates"
           if mode == 0 else ""))
    return mets


def run_envelope_phase(device, counted) -> dict:
    """Phase 6a: the captures and the CPU runs in 8 spawned processes,
    the four card runs counted as paths, then each run's checks and the
    table.  Returns {(mode, set): card wall s}."""
    env = envelope_module()
    t0 = time.perf_counter()
    with env.spawn_pool(8) as pool:
        caps, cpu_runs = start_envelope(pool)
        log(f"phase 6a: {len(caps) * len(envelope_rows())} captures of "
            f"{ENVELOPE_SECONDS} s synthesized in "
            f"{time.perf_counter() - t0:.1f} s (8 processes)")
        outs, walls = {}, {}
        for mode in ENVELOPE_MODES:
            for name in env.ENGINE_SETS:
                outs[mode, name], walls[mode, name] = counted(
                    f"envelope mode {mode} {name}",
                    lambda m=mode, n=name: run_envelope(caps[m], m, n,
                                                        device))
        t1 = time.perf_counter()
        table = {key: check_envelope(*key, outs[key], cpu_runs[key])
                 for key in outs}
        log(f"phase 6a: checks in {time.perf_counter() - t1:.1f} s (the CPU "
            "runs included where they were still running)")
    log("envelope on the card, 0.9 s a row, 128 stations a run "
        "(separation dB / L SNR dB / RDS groups):")
    head = "  ".join(f"{f'mode {m} {n}':<18}" for m in ENVELOPE_MODES
                     for n in env.ENGINE_SETS)
    log(f"  {'impairment':<22} {head}")
    for r, (name, _) in enumerate(envelope_rows()):
        log(f"  {name:<22} " + "  ".join(
            f"{env.cell(table[m, n][r]):<18}" for m in ENVELOPE_MODES
            for n in env.ENGINE_SETS))
    log("phase 6a: card runs " + ", ".join(
        f"mode {m} {n} {w:.1f} s" for (m, n), w in walls.items())
        + f"; the phase took {time.perf_counter() - t0:.1f} s")
    return walls


def run_demo(device) -> float:
    """Phase 6b: examples/demo_torch.py in-process with DEMO_STATIONS
    stations of 1.2 s: exit code 0, DEMO PASSED, and each station's PI
    the one it was sent (0x1000 + s).  Returns its decode wall s (the
    line it prints)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "demo_torch", ROOT / "examples" / "demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = demo.main(["--stations", str(DEMO_STATIONS), "--seconds", "1.2",
                        "--device", str(device)])
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip():
            log(f"  demo: {line}")
    pis = [(int(s), int(pi, 16)) for s, pi in re.findall(
        r"station (\d+): .* RDS PI=(0x[0-9a-f]+)", text)]
    if rc != 0 or "DEMO PASSED" not in text or pis != [
            (s, 0x1000 + s) for s in range(DEMO_STATIONS)]:
        raise AssertionError(f"demo: exit {rc}, PIs {pis}")
    m = re.search(r"([\d.]+) s wall", text)
    return float(m.group(1))


def main() -> int:
    if not (ROOT / "sdr_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py runs from a checkout of the repo "
                         "(sdr_tpu_torch/ not found beside it)")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the GPU")
    usage = "usage: chip_smoke.py [--time-mfb CHECKOUT | --banded]"
    if sys.argv[1:2] == ["--time-mfb"]:
        if len(sys.argv) != 3:
            raise SystemExit(usage)
        time_mfb(Path(sys.argv[2]).resolve())
        return 0
    banded_only = sys.argv[1:] == ["--banded"]
    if len(sys.argv) > 1 and not banded_only:
        raise SystemExit(usage)
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
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
    regs, fn, spills = [], "?", {}
    for line in (build.library_path().parent / "build.log").read_text(
            ).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(int(m.group(1)))
        if "spill" in line and not re.search(r"\b0 bytes spill stores, "
                                             r"0 bytes spill loads", line):
            log(f"  ptxas: {fn}: {line.strip()}")
            spills[fn] = line.strip()
    log(f"  ptxas: {len(regs)} kernel instances, {min(regs)}-{max(regs)} "
        "registers a thread, no spills unless listed above")
    tensor_core_sass(build.library_path())
    if banded_only:
        # phase 1 and 2e alone: the quick check of the tiled engine
        check_banded(spills)
        log("phase 2e: the tiled engine's FIR agrees with its plain version "
            "in every geometry and engine")
        return 0

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
    lkern = check_loop_kernels(sblocks, device)
    log("phase 2c: the IF bank's four streams and the carrier loops agree "
        "with their plain versions")
    t0 = time.perf_counter()
    wkern = check_channelizer(device)
    log("phase 2d: the wideband channelizer agrees with its plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    bkern = check_banded(spills)
    log("phase 2e: the tiled engine's FIR agrees with its plain version in "
        f"every geometry and engine ({time.perf_counter() - t0:.1f} s)")

    # each path runs with the counts at 0 and is read right after it; a
    # path lists the kernels it must launch and those it must not
    fused_ff = ("ifbank_mix", "ffmix", "audio_pair")
    # the tiled engine's FIR ("banded") runs wherever conv_engine='tiled'
    # does (--fast, ifbank joint); the default, joint, wideband and
    # --stations --fast profiles run the conv engine (the reference's
    # choice: sdr_tpu/cli.py:316-318, 404-405)
    paths = {"mono": (("frontend_demod", "frontend", "banded"), ()),
             "stereo+RDS": (("frontend_demod", "ifbank_mix", "ffmix",
                             "audio_pair", "banded"), ("pll", "ifbank")),
             "stereo+RDS mode 2": (("frontend_demod", "ifbank_mix", "ffmix",
                                    "banded"), ("audio_pair",)),
             "stereo+RDS default": (("pll",), ("frontend_demod", *fused_ff,
                                               "ifbank", "pll_chunked",
                                               "pll_chunked_multi",
                                               "banded")),
             "mode 2 default": (("pll",), ("frontend_demod", *fused_ff,
                                           "ifbank", "banded")),
             "stereo+RDS joint": (("frontend_demod", "pll_chunked_multi"),
                                  ("pll", "pll_chunked", "ifbank",
                                   *fused_ff, "banded")),
             "stereo+RDS ifbank joint": (("frontend_demod", "ifbank",
                                          "pll_chunked_multi", "banded"),
                                         (*fused_ff, "pll")),
             "loop engines, one station": (("pll", "pll_chunked"),
                                           ("pll_chunked_multi",
                                            *fused_ff, "banded")),
             "wideband": (("mfb",), ("frontend_demod", "frontend",
                                     *fused_ff, "ifbank", "pll",
                                     "pll_chunked", "pll_chunked_multi",
                                     "banded")),
             "wideband default": (("mfb", "pll"),
                                  ("frontend_demod", "frontend", *fused_ff,
                                   "ifbank", "pll_chunked",
                                   "pll_chunked_multi", "banded")),
             "stations --fast": (("frontend_demod",),
                                 ("frontend", *fused_ff, "ifbank", "pll",
                                  "pll_chunked", "pll_chunked_multi",
                                  "mfb", "banded")),
             "stations default": (("pll",), ("frontend_demod", *fused_ff,
                                             "ifbank", "pll_chunked",
                                             "pll_chunked_multi", "banded")),
             "resume": (("frontend_demod", *fused_ff, "pll", "banded"),
                        ("ifbank", "pll_chunked", "pll_chunked_multi")),
             "taps": (("frontend_demod", *fused_ff, "banded"),
                      ("ifbank", "pll")),
             "options": (("pll",), ("frontend_demod", *fused_ff, "ifbank",
                                    "pll_chunked", "pll_chunked_multi",
                                    "banded")),
             "channel DP": (("frontend_demod", "banded"), (
                 "frontend", *fused_ff, "ifbank", "pll", "pll_chunked",
                 "pll_chunked_multi", "mfb")),
             "time-sharded mono": (("frontend_demod", "banded"), (
                 "frontend", *fused_ff, "ifbank", "pll", "pll_chunked",
                 "pll_chunked_multi", "mfb")),
             "time-sharded stereo": (("pll",), (
                 "frontend_demod", "frontend", *fused_ff, "ifbank",
                 "pll_chunked", "pll_chunked_multi", "mfb", "banded")),
             "time-sharded full": (("frontend_demod", *fused_ff, "banded"), (
                 "frontend", "ifbank", "pll", "pll_chunked",
                 "pll_chunked_multi", "mfb")),
             "station-sharded wideband": (("mfb",), (
                 "frontend_demod", "frontend", *fused_ff, "ifbank", "pll",
                 "pll_chunked", "pll_chunked_multi", "banded")),
             "two processes": ((), tuple(KERNELS)),
             "RDS helpers": ((), tuple(KERNELS))}
    # phase 6: the envelope's runs take the launch lists of the 128-station
    # stereo + RDS paths of their engine set and mode; the demo runs the
    # default set
    loops_only = ("frontend_demod", "frontend", *fused_ff, "ifbank",
                  "pll_chunked", "pll_chunked_multi", "mfb", "banded")
    paths.update({
        "envelope mode 0 --fast": (("frontend_demod", *fused_ff, "banded"),
                                   ("frontend", "ifbank", "pll",
                                    "pll_chunked", "pll_chunked_multi",
                                    "mfb")),
        "envelope mode 0 default": (("pll",), loops_only),
        "envelope mode 2 --fast": (("frontend_demod", "ifbank_mix", "ffmix",
                                    "banded"),
                                   ("frontend", "audio_pair", "ifbank",
                                    "pll", "pll_chunked",
                                    "pll_chunked_multi", "mfb")),
        "envelope mode 2 default": (("pll",), loops_only),
        "demo": (("pll",), loops_only)})
    new_paths = ("stations --fast", "stations default", "resume", "taps",
                 "options", "channel DP", "time-sharded mono",
                 "time-sharded stereo", "time-sharded full",
                 "station-sharded wideband", "envelope mode 0 --fast",
                 "envelope mode 0 default", "envelope mode 2 --fast",
                 "envelope mode 2 default", "demo")
    launches = {}

    def counted(path, fn):
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        _RUNNING[0] = path
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
        out = run_real_size_stereo(sblocks, device, keep=rds_soft_4b)
        log("phase 4b: 128-station stereo + RDS steps agree with the CPU")
        return out

    def mode2_path():
        run_cli_stereo(device, 2)
        log("phase 3c: CLI 2 2 --rds --fast decodes the tones and the RDS "
            "groups")

    def default_path():
        run_cli_stereo(device, 0, fast=False)
        log("phase 3d: CLI 0 2 --rds (default profile) decodes the tones and "
            "the RDS groups")
        out = run_real_size_stereo(sblocks, device, "stereo+RDS default",
                                   DEFAULT_PROFILE, steps=3, profile_n=3)
        log("phase 4c: 128-station default-profile steps keep every "
            "station's separation")
        return out

    def stations_fast_path():
        t0 = time.perf_counter()
        run_cli_stations(device, fast=True)
        log("phase 3h: CLI --stations --fast decodes every station's tones "
            f"and PI ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        rx = Receiver(0, device=device, **STATIONS_FAST)
        b1 = check_frontend_at_step(rx, sblocks[0],
                                    rx.init_state((STATIONS,)),
                                    "stations --fast")
        del rx
        out = run_real_size_stereo(sblocks, device, "stations --fast",
                                   STATIONS_FAST)
        log("phase 4f: 128-station --stations --fast steps agree with the "
            f"CPU ({time.perf_counter() - t0:.1f} s)")
        checkpoint_real_size(sblocks, device, STATIONS_FAST,
                             "stations --fast")
        log("phase 3i: a 128-station --fast state saved, loaded and "
            "continued")
        return out, b1

    def stations_default_path():
        t0 = time.perf_counter()
        run_cli_stations(device, fast=False)
        log("phase 3h: CLI --stations (default profile) decodes every "
            f"station's tones and PI ({time.perf_counter() - t0:.1f} s)")

    def resume_path():
        t0 = time.perf_counter()
        run_cli_resume(device, fast=True)
        run_cli_resume(device, fast=False)
        log("phase 3i: CLI --save-state / --resume halves join into one "
            f"run ({time.perf_counter() - t0:.1f} s)")

    def taps_path():
        t0 = time.perf_counter()
        run_cli_taps(device)
        log("phase 3j: CLI --psd-dump, --trace-iq, --profile and the native "
            f"ring ({time.perf_counter() - t0:.1f} s)")

    def options_path():
        t0 = time.perf_counter()
        run_options(device)
        log("phase 3j: de-emphasis, the shared audio state and the fft "
            f"engine agree with the CPU ({time.perf_counter() - t0:.1f} s)")

    def default_mode2_path():
        run_cli_stereo(device, 2, fast=False)
        log("phase 3e: CLI 2 2 --rds (default profile) decodes the tones and "
            "the RDS groups")

    def joint_path(profile, name):
        out = run_real_size_stereo(sblocks, device, name, profile)
        log(f"phase 4d: 128-station {name} steps agree with the CPU")
        return out

    def loop_engines_path():
        run_loop_engines(device)
        log("phase 3f: the loop engines decode the tones and the RDS groups")

    def wideband_path(cli_paths, wide_u8):
        t0 = time.perf_counter()
        run_cli_wideband(device, ["0", "2", "--rds", "--fast"], cli_paths,
                         "f32")
        run_cli_wideband(device, ["0", "1", "--fast"], cli_paths, "u8",
                         scan=True)
        log("phase 3g: CLI --wideband --fast (and --scan) decodes every "
            f"station's tone and RDS PI ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        out = {"wideband_mono_fast": run_real_size_wideband(
                   wide_u8, device, "wideband mono --fast", "bf16",
                   WIDE_FAST),
               "wideband_stereo_rds_fast": run_real_size_wideband(
                   wide_u8, device, "wideband stereo+RDS --fast", "bf16",
                   dict(WIDE_FAST, stereo=True, rds=True))}
        log("phase 4e: 64-station --fast wideband steps agree with the CPU "
            f"({time.perf_counter() - t0:.1f} s)")
        return out

    def wideband_default_path(cli_paths, wide_u8):
        t0 = time.perf_counter()
        run_cli_wideband(device, ["0", "1", "--rds"], cli_paths, "u8")
        run_cli_wideband(device, ["0", "2", "--rds"], cli_paths, "u8")
        log("phase 3g: CLI --wideband (default profile) decodes every "
            f"station's tone and RDS PI ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        out = run_real_size_wideband(
            wide_u8, device, "wideband stereo+RDS default", "f32",
            dict(WIDE_DEFAULT, stereo=True, rds=True), steps=3, profile_n=3)
        log("phase 4e: 64-station default-profile wideband steps are "
            f"finite ({time.perf_counter() - t0:.1f} s)")
        return out

    def parallel_path(name, phase, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"phase {phase}: {name} ({time.perf_counter() - t0:.1f} s)")
        return out

    rds_soft_4b: list = []
    rates = counted("mono", mono_path)
    del blocks
    rates["stereo_rds_int8"] = counted("stereo+RDS", stereo_path)
    counted("stereo+RDS mode 2", mode2_path)
    rates["stereo_rds_default"] = counted("stereo+RDS default", default_path)
    counted("mode 2 default", default_mode2_path)
    rates["stereo_rds_joint"] = counted(
        "stereo+RDS joint", lambda: joint_path(JOINT_PROFILE,
                                               "stereo+RDS joint"))
    rates["stereo_rds_ifbank_joint"] = counted(
        "stereo+RDS ifbank joint",
        lambda: joint_path(IFBANK_JOINT_PROFILE, "stereo+RDS ifbank joint"))
    counted("loop engines, one station", loop_engines_path)
    rates["stations_fast"], stations_b1 = counted("stations --fast",
                                                  stations_fast_path)
    counted("stations default", stations_default_path)
    counted("resume", resume_path)
    counted("taps", taps_path)
    counted("options", options_path)
    del sblocks
    torch.cuda.empty_cache()
    # the wideband inputs: the CLI's two-station capture, and two steps of
    # the largest profile's 64-station stream
    import numpy as np
    bw = max(
        2 * (Receiver(0, device=device, stereo=True, rds=True,
                      **WIDE_FAST).block_size_u8() // 2) * 4,
        2 * (Receiver(0, device=device, stereo=True, rds=True,
                      **WIDE_DEFAULT).block_size_u8() // 2) * 4)
    t0 = time.perf_counter()
    wide_u8 = wideband_stations_u8(device,
                                   2 * (bw // 2) * WIDE_BLOCKS_PER_STEP)
    log(f"wideband streams synthesized in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        cli_paths = {"f32": os.path.join(tmp, "wide.cf32"),
                     "u8": os.path.join(tmp, "wide.u8")}
        for arr, path in zip(wideband_cli_capture(), cli_paths.values()):
            np.asarray(arr).tofile(path)
        rates.update(counted("wideband",
                             lambda: wideband_path(cli_paths, wide_u8)))
        rates["wideband_stereo_rds_default"] = counted(
            "wideband default",
            lambda: wideband_default_path(cli_paths, wide_u8))
    # phase 5: the parallel layer and the RDS device helpers
    shapes: dict = {}
    par = {"channel DP": counted("channel DP", lambda: parallel_path(
        "channel DP on make_mesh() and 8 virtual shards equals the serial "
        "run", "5a", lambda: run_channel_dp(device)))}
    par["time-sharded mono"] = counted(
        "time-sharded mono", lambda: parallel_path(
            "time-sharded mono equals the serial run", "5b",
            lambda: run_timeshard_mono(device, shapes)))
    par["time-sharded stereo"] = counted(
        "time-sharded stereo", lambda: parallel_path(
            "time-sharded stereo keeps the serial run's SNR and separation",
            "5c", lambda: run_timeshard_stereo(device, shapes)))
    par["time-sharded full"] = counted(
        "time-sharded full", lambda: parallel_path(
            "time-sharded stereo + RDS decodes the serial run's RDS", "5d",
            lambda: run_timeshard_full(device)))
    par["station-sharded wideband"] = counted(
        "station-sharded wideband", lambda: parallel_path(
            "station-sharded wideband equals the serial run", "5e",
            lambda: run_station_sharded_wideband(wide_u8, device, shapes)))
    del wide_u8
    counted("two processes", lambda: parallel_path(
        "two processes over gloo each match their serial run", "5f",
        lambda: run_two_processes(device)))
    counted("RDS helpers", lambda: parallel_path(
        "the RDS device helpers agree with the host", "5g",
        lambda: run_rds_helpers(torch.cat(rds_soft_4b, dim=-1), device)))
    del rds_soft_4b
    log(f"parallel layer on {card} (serial vs sharded, host wall ms; "
        "a step where named): " + json.dumps(par))
    # phase 6: the operating envelope and the demo
    torch.cuda.empty_cache()
    run_envelope_phase(device, counted)
    demo_s = counted("demo", lambda: parallel_path(
        f"examples/demo_torch.py decodes {DEMO_STATIONS} stations: DEMO "
        "PASSED", "6b", lambda: run_demo(device)))
    log(f"demo on {card}: {DEMO_STATIONS} stations x 1.2 s decoded in "
        f"{demo_s:.2f} s wall (the demo's own line)")
    for path, (ran, skipped) in paths.items():
        full = FULL_WIDTH.get(path, {})
        log(f"launches on the {path} path: " + ", ".join(
            f"{k} {launches[path][k]}" for k in (*ran, *skipped))
            + "; in its full-width steps: " + (", ".join(
                f"{k} {full.get(k, 0)}" for k in ran) if full else "none"))
        for k in ran:
            if launches[path][k] == 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"{path} path")
        for k in skipped:
            if launches[path][k] != 0:
                raise AssertionError(f"kernel {k} was launched on the "
                                     f"{path} path, which declines it")
    log(f"throughput on {card} (IQ MS/s of the stations; wideband MS/s of "
        "the antenna stream for the wideband steps): " + ", ".join(
            f"{name} {r:.1f} MS/s ({ms:.3f} ms/step)"
            for name, (ms, r) in rates.items()))
    entries = []
    for name, (source, replaces) in KERNELS.items():
        extra, library_ms = {}, None
        if name == "banded":
            # the stereo + RDS path's RDS resampler in the bf16 engine;
            # every geometry and engine beside it
            r = bkern["rds0/bf16"]
            err, ms, plain_ms = r["max_abs_err"], r["ms"], r["plain_ms"]
            # one torch.mm of the tile windows (or, where the card's torch
            # has no bf16 mm with float32 output, the cuDNN conv)
            library_ms = (r["conv_ms"] if r["library_ms"] is None
                          else r["library_ms"])
            bound_ms, bound_by = r["bound_ms"], r["bound_by"]
            extra = {"geometries": bkern}
        elif name == "mfb":
            # bench.py's channelizer check: u8 pre-phased, f32 compute/out;
            # every variant beside it (the bf16 engine's library time is
            # the bf16 cuBLAS GEMM)
            err, ms, plain_ms, library_ms, bound_ms, bound_by, *_ = wkern[
                "u8/f32->f32"]
            extra = {"variants": {
                v: dict(zip(("max_abs_err", "ms", "plain_ms", "library_ms",
                             "bound_ms", "bound_by", "flat_ms", "call_ms"),
                            r)) for v, r in wkern.items()}}
        else:
            if name in lkern:
                # phase 2c's kernels: the lengths compared and timed
                err, ms, plain_ms, n, plain_n = lkern[name]
                extra = {"n": n, "plain_n": plain_n}
                if f"{name}_extra" in lkern:
                    # the chain floor beside the roofline bound (and B8's
                    # joint launch of both loops beside two single ones)
                    extra.update(lkern[f"{name}_extra"])
            elif name in skern:
                # the stereo + RDS path's engines: bf16 IF bank and streams
                err, ms, plain_ms, *lib = skern[name]
                library_ms = lib[0] if lib else None
                n = sbs // 20
            else:
                # the mono path's engine: int8 (--fast), fm stored at bf16
                err, ms, plain_ms = kern[(name, "int8->bf16"
                                          if name == "frontend_demod"
                                          else "int8")]
                n = bs
            bound_ms, bound_by = roofline(*kernel_work(name, STATIONS, n))
        if name == "frontend_demod":
            # B1 in the --stations --fast engine at that step's shape
            extra["stations_fast_step"] = stations_b1
        if name in shapes:
            # the kernel at the parallel paths' shapes (phase 5)
            extra["sharded_shapes"] = shapes[name]
        extra["new_path_launches"] = {p: launches[p][name]
                                      for p in new_paths
                                      if launches[p][name]}
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[KERNEL_PATH[name]][name],
                        "full_width_launches": FULL_WIDTH.get(
                            KERNEL_PATH[name], {}).get(name, 0),
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, **extra})
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s from the "
        "first CUDA call")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
