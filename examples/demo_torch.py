"""End-to-end demo of the PyTorch port: synthesize a multi-station FM
band, decode everything.

The port's counterpart of examples/demo.py: synthesizes N simultaneous FM
stations (each with distinct stereo program and RDS metadata),
batch-decodes them as the stations of one Receiver (channel data
parallelism), and prints recovered audio quality + RDS station info.

    python examples/demo_torch.py [--stations 4] [--seconds 1.2]
                                  [--device cuda|cpu] [--cpu] [--wav-dir D]

The card is the default device; `--cpu` is `--device cpu`.  Without a
card and without either, it raises.  Imports nothing of jax or sdr_tpu.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

NAMES = ["JAZZ FM ", "ROCK 101", "NEWS 24 ", "CLASSICA",
         "TPU SDR ", "PODS FM ", "WAVE 88 ", "METAL X "]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stations", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (--device cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--wav-dir", default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    import numpy as np
    import torch

    import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
    from sdr_tpu_torch import tx
    from sdr_tpu_torch.config import MODES
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.rds import decode_rds_soft
    from sdr_tpu_torch.rds import tx as rds_tx
    from sdr_tpu_torch.utils.compare import stereo_separation_db, tone_snr_db

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu or --device cpu")
    cfg = MODES[0]
    n = int(args.seconds * cfg.rf_fs)

    print(f"Synthesizing {args.stations} stations "
          f"({args.seconds:.1f} s @ {cfg.rf_fs/1e6:.1f} MS/s each)...")
    caps, truths = [], []
    for s in range(args.stations):
        f_l = 600.0 + 300.0 * s
        f_r = 900.0 + 400.0 * s
        pi = 0x1000 + s
        bits = rds_tx.standard_group_stream(
            pi=pi, pty=(s % 31), ps_name=NAMES[s % len(NAMES)],
            radio_text=f"STATION {s} ON A TPU",
            n_groups=int(args.seconds * 1187.5 / 104) + 2)
        rds_bb = rds_tx.bits_to_baseband(bits, cfg.rf_fs)
        cap = tx.synthesize_capture(
            cfg, seconds=args.seconds,
            left=tx.tone(cfg.rf_fs, f_l, n), right=tx.tone(cfg.rf_fs, f_r, n),
            rds_baseband=rds_bb[:n], a_rds=0.1, seed=s)
        caps.append(cap)
        truths.append((f_l, f_r, pi))
    batch = np.stack(caps)

    rx = Receiver(0, stereo=True, rds=True, device=device)
    kind = (torch.cuda.get_device_name(torch.device(device))
            if rx.device.type == "cuda" else "cpu")
    print(f"Decoding on {kind} "
          f"(one batched receiver, {args.stations}-station batch)...")
    t0 = time.perf_counter()
    out, _ = rx.run(batch, blocks_per_step=4)
    audio = {k: v.float().cpu().numpy() for k, v in out.items()}
    dt = time.perf_counter() - t0
    ms = args.stations * (len(caps[0]) // 2) / dt / 1e6
    print(f"  {dt:.2f} s wall = {ms:.1f} IQ MS/s aggregate "
          f"(incl. kernel build on first run)\n")

    skip = cfg.audio_fs // 4
    ok = True
    for s, (f_l, f_r, pi) in enumerate(truths):
        l, r = audio["left"][s], audio["right"][s]
        snr_l = tone_snr_db(l, cfg.audio_fs, f_l, skip=skip)
        sep = stereo_separation_db(l, r, cfg.audio_fs, f_l, skip=skip)
        info = decode_rds_soft(audio["rds_soft"][s], cfg.rds_sps,
                               device=device)
        rds_ok = info.pi == pi
        ok &= rds_ok and snr_l > 15
        print(f"station {s}: L-tone {f_l:6.0f} Hz SNR {snr_l:5.1f} dB | "
              f"separation {sep:5.1f} dB | RDS PI={info.pi:#06x} "
              f"PS={info.ps_name!r} RT={info.radio_text.rstrip()!r} "
              f"[{'OK' if rds_ok else 'MISMATCH'}]")
        if args.wav_dir:
            from sdr_tpu_torch.io import wav as wavio
            os.makedirs(args.wav_dir, exist_ok=True)
            frames = np.stack([l, r], axis=1)
            pcm = np.clip(frames * 16384.0, -32768, 32767).astype(np.int16)
            wavio.write_wav(f"{args.wav_dir}/station{s}.wav", cfg.audio_fs,
                            pcm)

    print("\nDEMO", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
