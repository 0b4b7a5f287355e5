"""Command-line receiver, mono path: `python -m sdr_tpu_torch <mode> 1`.

Port of sdr_tpu/cli.py (the mono path of `main`).  Reference usage
(src/project.cpp:392-393):
    rtl_sdr -f 102.9M -s 2.4M - | ./project 0 1 | aplay -f S16_LE -r 48000
Here:
    rtl_sdr ... - | python -m sdr_tpu_torch 0 1 | aplay -f S16_LE -r 48000

Reads u8 IQ blocks from stdin (or --in FILE) and streams S16LE mono audio
to stdout (or --out FILE / --wav FILE).  The chain runs on --device
(default cuda); without that device the command fails rather than move to
the CPU.  `--fast` and `--exact-fast` select the fused CUDA front end.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdr_tpu_torch",
        description="FM broadcast receiver on PyTorch + CUDA (mono)")
    p.add_argument("mode", type=int, nargs="?", default=0,
                   help="operating mode 0-3 (default 0)")
    p.add_argument("channels", type=int, nargs="?", default=1,
                   choices=(1, 2), help="1=mono, 2=stereo (default 1)")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS (not yet ported)")
    p.add_argument("--in", dest="infile", default="-",
                   help="input u8 IQ file ('-' = stdin)")
    p.add_argument("--out", dest="outfile", default="-",
                   help="output S16LE stream ('-' = stdout)")
    p.add_argument("--wav", default=None, help="also write a WAV file")
    p.add_argument("--blocks-per-step", type=int, default=25,
                   help="reference blocks fused per step")
    p.add_argument("--stats", action="store_true",
                   help="print throughput stats to stderr")
    p.add_argument("--fast", action="store_true",
                   help="fast engines: fused int8 CUDA front end + bf16 "
                        "audio filter")
    p.add_argument("--exact-fast", action="store_true",
                   help="exact-integer front end (int8x2), f32 elsewhere")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not 0 <= args.mode <= 3:
        print(f"Invalid mode: {args.mode}!", file=sys.stderr)
        return 1
    if args.channels == 2 or args.rds:
        print("stereo and RDS are not yet ported (ROADMAP.md queue A "
              "item 7); run with channels=1", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"device {args.device} requested but no CUDA device is "
              "available (use --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1

    from sdr_tpu_torch.config import get_mode
    from sdr_tpu_torch.io import wav as wavio
    from sdr_tpu_torch.io.stream import SyncBlockReader, pack_s16
    from sdr_tpu_torch.models.receiver import Receiver

    cfg = get_mode(args.mode)
    print(f"Operating in mode {args.mode}, mono", file=sys.stderr)
    # the reference's profiles (sdr_tpu/cli.py:134-140), mono part
    fast = (dict(fused_frontend="int8", conv_dtype="bf16",
                 conv_engine="tiled") if args.fast else {})
    if args.exact_fast:
        fast["fused_frontend"] = "int8x2"
    rx = Receiver(args.mode, device=device, **fast)
    state = rx.init_state()
    block_size = rx.block_size_u8(args.blocks_per_step)

    fin = sys.stdin.buffer if args.infile == "-" else open(args.infile, "rb")
    fout = (sys.stdout.buffer if args.outfile == "-"
            else open(args.outfile, "wb"))
    wav_chunks: list[np.ndarray] = []

    def drain(out):
        pcm = pack_s16(out["mono"]).cpu().numpy()
        fout.write(pcm.astype("<i2").tobytes())
        wav_chunks.append(pcm)

    n_in = 0
    step_times: list[float] = []
    pending = None  # host drain of step k overlaps device work of step k+1
    t0 = time.perf_counter()
    try:
        src = SyncBlockReader(fin, block_size)
        for raw in src:
            ts = time.perf_counter()
            state, out = rx.step(state, torch.tensor(raw).to(device))
            step_times.append(time.perf_counter() - ts)
            if pending is not None:
                drain(pending)
            pending = out
            n_in += len(raw)
        # EOF flush: the partial final block at the finest aligned size
        tail = src.tail()
        tail_n = (len(tail) // rx.block_align_u8()) * rx.block_align_u8()
        if tail_n:
            state, out = rx.step(state,
                                 torch.tensor(tail[:tail_n]).to(device))
            if pending is not None:
                drain(pending)
            pending = out
            n_in += tail_n
        if pending is not None:
            drain(pending)
        fout.flush()
    finally:
        if fin is not sys.stdin.buffer:
            fin.close()
        if fout is not sys.stdout.buffer:
            fout.close()
    elapsed = time.perf_counter() - t0
    if args.stats:
        ms = n_in / 2 / elapsed / 1e6
        print(f"processed {n_in/2:.0f} IQ samples in {elapsed:.2f}s "
              f"= {ms:.2f} MS/s ({ms*1e6/cfg.rf_fs:.1f}x real time) "
              f"on {_device_name(device)}", file=sys.stderr)
        if len(step_times) > 1:
            # skip the first step (kernel build and warm-up); this is the
            # host's dispatch time per step, not the device's compute time
            st = sorted(step_times[1:])
            p50 = st[len(st) // 2] * 1e3
            p95 = st[int(len(st) * 0.95)] * 1e3
            blk_ms = block_size / 2 / cfg.rf_fs * 1e3
            print(f"step latency: p50 {p50:.1f} ms / p95 {p95:.1f} ms per "
                  f"{blk_ms:.1f} ms RF block step", file=sys.stderr)
    print("End of input stream reached!", file=sys.stderr)
    if args.wav and wav_chunks:
        wavio.write_wav(args.wav, cfg.audio_fs, np.concatenate(wav_chunks))
        print(f"Wrote {args.wav}", file=sys.stderr)
    return 0


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


if __name__ == "__main__":
    raise SystemExit(main())
