"""Command-line receiver: `python -m sdr_tpu_torch <mode> <channels>`.

Port of sdr_tpu/cli.py (`main`, without the reference's other entry
points).  Reference usage (src/project.cpp:392-393):
    rtl_sdr -f 102.9M -s 2.4M - | ./project 0 2 | aplay -c 2 -f S16_LE -r 48000
Here:
    rtl_sdr ... - | python -m sdr_tpu_torch 0 2 --rds --fast | aplay -c 2 ...

Reads u8 IQ blocks from stdin (or --in FILE) and streams S16LE audio to
stdout (or --out FILE / --wav FILE): mono (1) or interleaved R,L stereo
(2).  `--rds` prints decoded station info to stderr as groups arrive.  The
chain runs on --device (default cuda); without that device the command
fails rather than move to the CPU.  `--fast` selects the fused CUDA
kernels (front end; with stereo and RDS also the IF bank, the carrier
synthesis + mixers and the audio pair) and the feedforward carrier engine;
`--exact-fast` the exact-integer front end.  Stereo and RDS run only with
`--fast` until the carrier loop engines are ported.
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
        description="FM broadcast receiver on PyTorch + CUDA "
                    "(mono/stereo/RDS)")
    p.add_argument("mode", type=int, nargs="?", default=0,
                   help="operating mode 0-3 (default 0)")
    p.add_argument("channels", type=int, nargs="?", default=1,
                   choices=(1, 2), help="1=mono, 2=stereo (default 1)")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS and print station info to stderr")
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
                   help="fast engines: fused int8 CUDA front end, "
                        "feedforward carriers (fused IF bank, synth+mix and "
                        "audio-pair kernels with stereo + RDS), bf16 convs")
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
    from sdr_tpu_torch.config import get_mode
    cfg = get_mode(args.mode)
    stereo = args.channels == 2
    rds = args.rds and cfg.rds_sps is not None
    if (stereo or rds) and not args.fast:
        print("stereo and RDS run with --fast only: their default carrier "
              "engine (the sequential PLL) is not yet ported (ROADMAP.md "
              "queue B items 8-10, the PLL slice)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"device {args.device} requested but no CUDA device is "
              "available (use --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1

    from sdr_tpu_torch.io import wav as wavio
    from sdr_tpu_torch.io.stream import (SyncBlockReader,
                                         interleave_stereo_s16, pack_s16)
    from sdr_tpu_torch.models.receiver import Receiver

    print(f"Operating in mode {args.mode}, "
          f"{'stereo' if stereo else 'mono'}{' + RDS' if rds else ''}",
          file=sys.stderr)
    # the reference's profiles (sdr_tpu/cli.py:134-140)
    fast = (dict(fused_frontend="int8", pll_impl="ff", conv_dtype="bf16",
                 conv_engine="tiled") if args.fast else {})
    if args.fast and stereo and rds:
        fast["fused_ifbank"] = "bf16"
    if args.exact_fast:
        fast["fused_frontend"] = "int8x2"
    rx = Receiver(args.mode, stereo=stereo, rds=rds, device=device, **fast)
    state = rx.init_state()
    block_size = rx.block_size_u8(args.blocks_per_step)

    fin = sys.stdin.buffer if args.infile == "-" else open(args.infile, "rb")
    fout = (sys.stdout.buffer if args.outfile == "-"
            else open(args.outfile, "wb"))
    wav_chunks: list[np.ndarray] = []
    rds_decoder = None
    if rds:
        from sdr_tpu_torch.rds.streaming import StreamingRdsDecoder
        rds_decoder = StreamingRdsDecoder(cfg.rds_sps)

    def drain(out):
        if stereo:
            pcm = interleave_stereo_s16(out["left"], out["right"])
        else:
            pcm = pack_s16(out["mono"])
        pcm = pcm.cpu().numpy()
        fout.write(pcm.astype("<i2").tobytes())
        wav_chunks.append(pcm)
        if rds_decoder is not None and rds_decoder.push(
                out["rds_soft"].float().cpu().numpy()):
            info = rds_decoder.info
            print(f"RDS: PI={info.pi:#06x} PTY={info.pty_name!r} "
                  f"PS={info.ps_name!r} RT={info.radio_text.rstrip()!r} "
                  f"({info.groups_seen} groups"
                  + (f", {rds_decoder.bits_corrected} bits corrected)"
                     if rds_decoder.bits_corrected else ")"),
                  file=sys.stderr)

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
        audio = np.concatenate(wav_chunks)
        # stereo is stored interleaved (R, L); the WAV convention is (L, R)
        frames = audio.reshape(-1, 2)[:, ::-1] if stereo else audio
        wavio.write_wav(args.wav, cfg.audio_fs, frames)
        print(f"Wrote {args.wav}", file=sys.stderr)
    if rds_decoder is not None:
        info = rds_decoder.info
        print(f"RDS final: PI={info.pi:#06x} PTY={info.pty_name!r} "
              f"PS={info.ps_name!r} RT={info.radio_text.rstrip()!r} "
              f"({info.groups_seen} groups)"
              if info.pi is not None else "RDS: no sync", file=sys.stderr)
    return 0


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


if __name__ == "__main__":
    raise SystemExit(main())
