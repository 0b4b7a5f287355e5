#!/usr/bin/env python3
"""The operating-envelope table (impairment matrix) of the PyTorch port.

The port's counterpart of tools/bench_envelope.py: the full stereo + RDS
chain over synthesized 1.2 s captures, each row with one impairment (or
several), through both engine sets (the default one and `--fast`); each
cell prints the stereo separation / 1 kHz L SNR / RDS groups seen by the
streaming decoder.  All rows are stacked as the stations of one
Receiver.run per engine set.

    python3 tools/bench_envelope_torch.py [--mode {0,2}] [--device cuda|cpu]

The card is the default; `--device cpu` runs the plain versions (the
default set's sequential loop then steps one sample at a time: minutes).
Imports nothing of jax or sdr_tpu.  chip_smoke.py (phase 6a) and
tests/test_torch_envelope.py build their captures with this module's
helpers.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the --fast engine set (tests/test_impairments.py:36-37)
FAST = dict(fused_frontend="int8", pll_impl="ff", conv_dtype="bf16",
            fused_ifbank="bf16", conv_engine="tiled")
ENGINE_SETS = {"default": {}, "--fast": FAST}

# tools/bench_envelope.py's capture length and rows
SECONDS = 1.2
ROWS = [
    ("none", {}),
    ("cfo +3 kHz", dict(cfo_hz=3000.0)),
    ("cfo +20 kHz", dict(cfo_hz=20000.0)),
    ("clock -100 ppm", dict(clock_ppm=-100.0)),
    ("clock +500 ppm", dict(clock_ppm=500.0)),
    ("phase noise 2 Hz", dict(pilot_linewidth_hz=2.0)),
    ("phase noise 10 Hz", dict(pilot_linewidth_hz=10.0)),
    ("phase noise 50 Hz", dict(pilot_linewidth_hz=50.0)),
    ("noise -10 dB", dict(noise_db=-10.0)),
    ("noise -6 dB", dict(noise_db=-6.0)),
    ("noise -4 dB", dict(noise_db=-4.0)),
    ("combo", dict(cfo_hz=2000.0, clock_ppm=-100.0,
                   pilot_linewidth_hz=0.5, noise_db=-14.0)),
]

# tests/test_impairments.py's rows (0.9 s, PS "IMPAIR  ", 14 groups) and
# the gates it holds mode 0 to
IMPAIRMENTS = {
    "cfo": dict(cfo_hz=3000.0),
    "clock_ppm": dict(clock_ppm=-100.0),
    "phase_noise": dict(pilot_linewidth_hz=2.0),
    "combo": dict(cfo_hz=2000.0, clock_ppm=100.0,
                  pilot_linewidth_hz=0.5, noise_db=-14.0),
}
IMPAIR_PI, IMPAIR_PS, IMPAIR_GROUPS = 0x3D44, "IMPAIR  ", 14
GATES = dict(separation_db=20.0, snr_db=18.0, groups=6)


def synthesize(mode: int, kw: dict, seconds: float, ps_name: str,
               n_groups: int) -> np.ndarray:
    """One stereo (L 1 kHz, R 2.5 kHz) + RDS (PI 0x3D44) capture of the
    mode, u8 interleaved, with the impairments `kw`."""
    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.rds import tx as rds_tx
    cfg = MODES[mode]
    n = int(seconds * cfg.rf_fs)
    bits = rds_tx.standard_group_stream(pi=IMPAIR_PI, ps_name=ps_name,
                                        n_groups=n_groups)
    return tx.synthesize_capture(
        cfg, seconds=seconds, left=tx.tone(cfg.rf_fs, 1000.0, n),
        right=tx.tone(cfg.rf_fs, 2500.0, n),
        rds_baseband=rds_tx.bits_to_baseband(bits, cfg.rf_fs)[:n],
        a_rds=0.1, **kw)


def synthesize_job(job: tuple) -> np.ndarray:
    """`synthesize(*job)`: a pool worker's job."""
    return synthesize(*job)


def captures(mode: int, rows: list[dict], seconds: float, ps_name: str,
             n_groups: int, pool=None) -> np.ndarray:
    """(len(rows), n) u8: one capture a row, synthesized in `pool` (a
    process pool) where one is given."""
    jobs = [(mode, kw, seconds, ps_name, n_groups) for kw in rows]
    return np.stack(list((pool.map if pool else map)(synthesize_job, jobs)))


def spawn_pool(workers: int):
    """A process pool whose workers start afresh (spawn): safe beside a
    parent that has initialised CUDA or OpenMP threads."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))


def rds_info(soft: np.ndarray, sps: int):
    """The streaming decoder's StationInfo over one station's rds_soft,
    pushed in 2048-sample pieces as tests/test_impairments.py does."""
    from sdr_tpu_torch.rds.streaming import StreamingRdsDecoder
    dec = StreamingRdsDecoder(sps)
    for i in range(0, len(soft), 2048):
        dec.push(soft[i:i + 2048])
    return dec.info


def metrics(left: np.ndarray, right: np.ndarray, soft: np.ndarray,
            mode: int) -> dict:
    """Stereo separation and 1 kHz L SNR (after the first quarter second)
    and the decoded RDS of one station."""
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.utils.compare import stereo_separation_db, tone_snr_db
    cfg = MODES[mode]
    skip = cfg.audio_fs // 4
    info = rds_info(soft, cfg.rds_sps)
    return dict(
        separation_db=float(stereo_separation_db(left, right, cfg.audio_fs,
                                                 1000.0, skip=skip)),
        snr_db=float(tone_snr_db(left[skip:], cfg.audio_fs, 1000.0)),
        pi=info.pi, ps=info.ps_name, groups=int(info.groups_seen))


def run(mode: int, caps: np.ndarray, engines: dict, device: str,
        blocks_per_step: int = 8) -> dict:
    """Every row of caps as a station of one stereo + RDS Receiver.run:
    {"left", "right", "rds_soft"} as float32 numpy (rows, n)."""
    from sdr_tpu_torch.models.receiver import Receiver
    rx = Receiver(mode, stereo=True, rds=True, device=device, **engines)
    out, _ = rx.run(caps, blocks_per_step=blocks_per_step)
    return {k: out[k].float().cpu().numpy()
            for k in ("left", "right", "rds_soft")}


def cpu_metrics(mode: int, caps: np.ndarray, engines: dict,
                threads: int = 2) -> tuple[dict, list[dict]]:
    """`run` on the CPU with `threads` torch threads, and each row's
    metrics: (outputs, [metrics a row]).  A pool worker's job."""
    import torch
    torch.set_num_threads(threads)
    out = run(mode, caps, engines, "cpu")
    return out, [metrics(out["left"][r], out["right"][r],
                         out["rds_soft"][r], mode)
                 for r in range(len(caps))]


def cell(m: dict) -> str:
    return f"{m['separation_db']:5.1f} / {m['snr_db']:5.1f} / {m['groups']:2d}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", type=int, choices=(0, 2), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
    with spawn_pool(min(8, os.cpu_count() or 1)) as pool:
        caps = captures(args.mode, [kw for _, kw in ROWS], SECONDS,
                        "ENVELOPE", 16, pool)
    table = {}
    for name, engines in ENGINE_SETS.items():
        out = run(args.mode, caps, engines, args.device)
        table[name] = [metrics(out["left"][r], out["right"][r],
                               out["rds_soft"][r], args.mode)
                       for r in range(len(ROWS))]
    print(f"mode {args.mode}, {SECONDS} s, device {args.device}: "
          "separation dB / L SNR dB / RDS groups")
    print(f"{'impairment':<20} {'default':<24} {'--fast':<24}")
    for r, (name, _) in enumerate(ROWS):
        print(f"{name:<20} {cell(table['default'][r]):<24} "
              f"{cell(table['--fast'][r]):<24}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
