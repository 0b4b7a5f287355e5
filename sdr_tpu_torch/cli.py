"""Command-line receiver: `python -m sdr_tpu_torch <mode> <channels>`.

Port of sdr_tpu/cli.py, every flag of it, plus `--device`.  Reference
usage (src/project.cpp:392-393):
    rtl_sdr -f 102.9M -s 2.4M - | ./project 0 2 | aplay -c 2 -f S16_LE -r 48000
Here:
    rtl_sdr ... - | python -m sdr_tpu_torch 0 2 --rds --fast | aplay -c 2 ...

Reads u8 IQ blocks from stdin (or --in FILE) and streams S16LE audio to
stdout (or --out FILE / --wav FILE): mono (1) or interleaved R,L stereo
(2).  `--rds` prints decoded station info to stderr as groups arrive.  The
chain runs on --device (default cuda); without that device the command
fails rather than move to the CPU.  Without flags the receiver runs the
reference's default profile: the unfused float32 chain, and for stereo
and RDS the exact carrier loops (the scan engine, one sequential CUDA
kernel launch per carrier and step on the card).  `--fast` selects the
fused CUDA kernels (front end; with stereo and RDS also the IF bank, the
carrier synthesis + mixers and the audio pair) and the feedforward
carrier engine; `--exact-fast` the exact-integer front end.  Host I/O
goes through the native bounded-ring reader and writer threads
(sdr_tpu_torch/native) where a host compiler built them, else through
synchronous reads and writes; `--stats` says which ran, and prints the
program's spans (io/logger.py: the stream loop's read, step and drain,
the receiver's stages, the RDS decoder) and counters a step.

Other entry points and taps, as in the reference:
  --stations A,B,...  decode N captures in one batched step each, with
                      live RDS per station; station<i>.wav to --wav-dir.
  --wideband FS       channelize one wideband capture (--freqs or --scan)
                      and decode every station; station<i>.wav.
  --save-state/--resume   checkpoint the streaming state after the EOF
                      flush / start from one (utils/checkpoint.py, the
                      reference's format).
  --psd-dump/--psd-anim   Bartlett PSDs of the demodulated IF (.dat).
  --trace-iq BASE     the first block's I/Q before and after the channel
                      filter (.dat).
  --profile DIR       a torch.profiler Chrome trace of the stream loop,
                      with the receiver's stage names, in DIR/trace.json.
"""

from __future__ import annotations

import argparse
import contextlib
import os
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
    p.add_argument("--psd-dump", default=None,
                   help="write a Bartlett PSD .dat of the demodulated IF "
                        "for gnuplot inspection (basename, .dat appended)")
    p.add_argument("--psd-anim", default=None,
                   help="write a per-block PSD .dat SERIES of the "
                        "demodulated IF (basename; frames = gnuplot "
                        "indices, rendered by examples/psd_anim.gnuplot)")
    p.add_argument("--psd-anim-every", type=int, default=10,
                   help="emit one PSD frame per N reference blocks "
                        "(default 10)")
    p.add_argument("--trace-iq", default=None, metavar="BASE",
                   help="dump time-domain I/Q .dat traces of the FIRST "
                        "block, pre- and post-channel filter (BASE_i_time, "
                        "BASE_q_time, BASE_i_filt_time, BASE_q_filt_time; "
                        "render with examples/iq.gnuplot)")
    p.add_argument("--stats", action="store_true",
                   help="print throughput stats to stderr")
    p.add_argument("--save-state", default=None,
                   help="checkpoint the streaming state on exit")
    p.add_argument("--resume", default=None,
                   help="resume the streaming state from a checkpoint")
    p.add_argument("--fast", action="store_true",
                   help="fast engines: fused int8 CUDA front end, "
                        "feedforward carriers (fused IF bank, synth+mix and "
                        "audio-pair kernels with stereo + RDS), bf16 convs")
    p.add_argument("--exact-fast", action="store_true",
                   help="exact-integer front end (int8x2), f32 elsewhere")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace of the stream "
                        "loop to this directory (per-stage ranges "
                        "included)")
    p.add_argument("--stations", default=None,
                   help="comma-separated u8 IQ capture files: decode N "
                        "independent stations batched in one step; "
                        "requires --wav-dir")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--wav-dir", default=None,
                   help="output directory for per-station WAVs "
                        "(station<i>.wav)")
    p.add_argument("--wideband", type=float, default=None, metavar="FS",
                   help="treat --in as a float32 interleaved complex "
                        "wideband capture at FS samples/s; channelize the "
                        "stations given by --freqs on the device")
    p.add_argument("--freqs", default=None,
                   help="comma-separated station offsets in Hz for "
                        "--wideband (e.g. -1500000,0,1800000)")
    p.add_argument("--wideband-u8", action="store_true",
                   help="the --wideband capture is interleaved u8 IQ "
                        "((x-128)/128 decode on the device) instead of f32")
    p.add_argument("--scan", action="store_true",
                   help="with --wideband: detect the station offsets from "
                        "the capture's spectrum instead of --freqs")
    p.add_argument("--scan-snr", type=float, default=10.0,
                   help="detection threshold above the noise floor (dB)")
    p.add_argument("--max-stations", type=int, default=None,
                   help="with --scan: keep only the N strongest stations")
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
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"device {args.device} requested but no CUDA device is "
              "available (use --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1

    if args.wideband:
        return _run_wideband(args, cfg, stereo, rds, device)
    if args.stations:
        return _run_stations(args, cfg, stereo, rds, device)

    from sdr_tpu_torch.io import wav as wavio
    from sdr_tpu_torch.io.logger import stage_scope as scope
    from sdr_tpu_torch.io.stream import interleave_stereo_s16, pack_s16
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
    want_if = args.psd_dump is not None or args.psd_anim is not None
    rx = Receiver(args.mode, stereo=stereo, rds=rds, emit_if=want_if,
                  device=device, **fast)
    state = rx.init_state()
    if args.resume:
        from sdr_tpu_torch.utils.checkpoint import load_state
        state = load_state(args.resume, state)
        print(f"Resumed state from {args.resume}", file=sys.stderr)
    block_size = rx.block_size_u8(args.blocks_per_step)

    fin = sys.stdin.buffer if args.infile == "-" else open(args.infile, "rb")
    fout = (sys.stdout.buffer if args.outfile == "-"
            else open(args.outfile, "wb"))
    wav_chunks: list[np.ndarray] = []
    rds_decoder = None
    if rds:
        from sdr_tpu_torch.rds.streaming import StreamingRdsDecoder
        rds_decoder = StreamingRdsDecoder(cfg.rds_sps)
    if_chunks: list[np.ndarray] | None = [] if args.psd_dump else None
    psd_anim = (_PsdAnim(args.psd_anim, cfg, args.psd_anim_every)
                if args.psd_anim else None)

    def drain(out):
        with scope("cli.drain"):
            if stereo:
                pcm = interleave_stereo_s16(out["left"], out["right"])
            else:
                pcm = pack_s16(out["mono"])
            pcm = pcm.cpu().numpy()
            sink.write(pcm.astype("<i2").tobytes())
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
            if "fm_demod" in out:
                if if_chunks is not None:
                    if_chunks.append(out["fm_demod"].float().cpu().numpy())
                if psd_anim is not None:
                    psd_anim.push(out["fm_demod"])

    n_in = 0

    def blocks():
        nonlocal n_in
        it = iter(src)
        while True:
            # the wait for stdin, the file or the native reader's ring
            with scope("cli.read"):
                raw = next(it, None)
            if raw is None:
                break
            if args.trace_iq is not None and n_in == 0:
                _trace_iq(args.trace_iq, raw, rx)
            n_in += len(raw)
            yield raw
        # EOF flush: the partial final block at the finest aligned size
        tail = src.tail()
        tail_n = (len(tail) // rx.block_align_u8()) * rx.block_align_u8()
        if tail_n:
            n_in += tail_n
            yield tail[:tail_n]

    t0 = time.perf_counter()
    src, reader = _block_source(fin, block_size)
    sink, writer = _audio_sink(fout)
    try:
        with _profiling(args.profile, device), _stats(args.stats) as launches0:
            state = _pipeline(rx, state, blocks(), drain)
    finally:
        if reader == "native":
            src.close()
        sink.close()   # the native writer drains its ring and joins
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
        print(f"host I/O: {reader} reader, {writer} sink", file=sys.stderr)
        _print_stats(launches0)
    print("End of input stream reached!", file=sys.stderr)
    if args.wav and wav_chunks:
        audio = np.concatenate(wav_chunks)
        # stereo is stored interleaved (R, L); the WAV convention is (L, R)
        frames = audio.reshape(-1, 2)[:, ::-1] if stereo else audio
        wavio.write_wav(args.wav, cfg.audio_fs, frames)
        print(f"Wrote {args.wav}", file=sys.stderr)
    if psd_anim is not None:
        nframes = psd_anim.close()
        print(f"Wrote {args.psd_anim}.dat ({nframes} PSD frames; render "
              "with examples/psd_anim.gnuplot)", file=sys.stderr)
    if args.psd_dump and if_chunks:
        from sdr_tpu_torch.io.logger import log_vector
        from sdr_tpu_torch.ops.fourier import estimate_psd
        demod = torch.from_numpy(np.concatenate(if_chunks)).to(device)
        freq, psd = estimate_psd(demod, fs=float(cfg.if_fs))
        log_vector(args.psd_dump, freq / 1e3, psd.cpu().numpy())
        print(f"Wrote {args.psd_dump}.dat (Bartlett PSD of demodulated IF)",
              file=sys.stderr)
    if args.save_state:
        from sdr_tpu_torch.utils.checkpoint import save_state
        save_state(args.save_state, state)
        print(f"Saved state to {args.save_state}", file=sys.stderr)
    if rds_decoder is not None:
        info = rds_decoder.info
        print(f"RDS final: PI={info.pi:#06x} PTY={info.pty_name!r} "
              f"PS={info.ps_name!r} RT={info.radio_text.rstrip()!r} "
              f"({info.groups_seen} groups)"
              if info.pi is not None else "RDS: no sync", file=sys.stderr)
    return 0


def _pipeline(rx, state, blocks, drain):
    """Step the host blocks in turn: copy a block onto the receiver's
    device (io/stream.py to_device), issue its step, then drain the step
    before it, so that the host's drain of step k overlaps the device's
    work on step k+1; the last step drains at the end.  Returns the final
    state."""
    from sdr_tpu_torch.io.stream import to_device
    pending = None
    for raw in blocks:
        state, out = rx.step(state, to_device(raw, rx.device))
        if pending is not None:
            drain(pending)
        pending = out
    if pending is not None:
        drain(pending)
    return state


@contextlib.contextmanager
def _stats(on: bool):
    """With --stats, the program's spans and counters start from zero and
    are kept through the body, with no profiler needed.  Yields the CUDA
    kernel launches counted so far (build.LAUNCHES)."""
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    if not on:
        yield 0
        return
    from sdr_tpu_torch.io import logger
    logger.reset_stage_times()
    logger.set_tracing(True)
    try:
        yield sum(LAUNCHES.values())
    finally:
        logger.set_tracing(False)


def _print_stats(launches0: int) -> None:
    """--stats' table: each span's count, its mean and self ms a step
    (self: less its child spans), its total s; the copies onto the device
    by way (h2d.pinned, h2d.pageable); the RDS counters; the CUDA
    kernel launches a step (build.LAUNCHES).  A step is one
    Receiver.step."""
    from sdr_tpu_torch.io import logger
    from sdr_tpu_torch.ops.cuda.build import LAUNCHES
    spans, counters = logger.totals()
    own = logger.self_times()
    steps = spans.get("receiver.step", (0.0, 0))[1]
    if not steps:
        return
    order = {n: i for i, n in enumerate(logger.NAMES)}
    print(f"spans over {steps} steps: count, mean ms a step, self ms a "
          "step, total s", file=sys.stderr)
    for name in sorted(spans, key=lambda n: order.get(n, len(order))):
        total, n = spans[name]
        print(f"  {name:<20} {n:>7} {total / steps * 1e3:>10.3f} "
              f"{own[name] / steps * 1e3:>10.3f} {total:>9.3f}",
              file=sys.stderr)
    print(f"h2d: {counters.get('h2d.pinned', 0)} copies from page-locked "
          f"memory, {counters.get('h2d.pageable', 0)} pageable",
          file=sys.stderr)
    if "rds.windows" in counters:
        w, g = counters["rds.windows"], counters.get("rds.groups", 0)
        print(f"rds: {w} windows, {g} groups"
              + (f" ({100.0 * g / w:.1f}% of windows)" if w else "")
              + f", {counters.get('rds.sync_losses', 0)} sync losses, "
              f"{counters.get('rds.bits_corrected', 0)} bits corrected",
              file=sys.stderr)
        s = counters.get("rds.windows_skipped", 0)
        print(f"rds: {s} windows skipped by frame sync's walk"
              + (f" ({100.0 * s / w:.1f}% of windows)" if w else ""),
              file=sys.stderr)
        n = counters.get("rds.symbols_recovered", 0)
        t = spans.get("rds.symbols", (0.0, 0))[0]
        print(f"rds: {n} symbols recovered"
              + (f", {t / n * 1e6:.3f} us a symbol in rds.symbols" if n
                 else ""), file=sys.stderr)
    launches = sum(LAUNCHES.values()) - launches0
    print(f"kernel launches a step: {launches / steps:.1f}", file=sys.stderr)


@contextlib.contextmanager
def _profiling(directory: str | None, device: torch.device):
    """With a directory, trace the body with torch.profiler (host ranges,
    and the device's kernels on a CUDA device) and write a Chrome trace
    to directory/trace.json; the reference writes a jax.profiler trace
    there (sdr_tpu/cli.py:168-169, 199-201)."""
    if directory is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Wrote profiler trace to {path}", file=sys.stderr)


def _run_wideband(args, cfg, stereo: bool, rds: bool,
                  device: torch.device) -> int:
    """Channelize a wideband complex capture into K stations and decode
    them all (models/wideband.py WidebandReceiver), streaming the file
    block-wise so captures larger than RAM work (sdr_tpu/cli.py:260-371)."""
    from sdr_tpu_torch.io import wav as wavio
    from sdr_tpu_torch.models.receiver import Receiver
    from sdr_tpu_torch.models.wideband import WidebandReceiver
    from sdr_tpu_torch.ops.channelizer import WidebandChannelizer

    if not (args.freqs or args.scan) or not args.wav_dir:
        print("--wideband requires --freqs (or --scan) and --wav-dir",
              file=sys.stderr)
        return 1
    fs_wide = args.wideband
    dtype = np.dtype(np.uint8) if args.wideband_u8 else np.dtype("<f4")
    with open(args.infile, "rb") as fin:

        def read_scalars(count):
            return np.frombuffer(fin.read(count * dtype.itemsize),
                                 dtype=dtype)

        if args.scan:
            from sdr_tpu_torch.ops.spectrum import find_stations
            # survey a ~0.1 s prefix (plenty for energy detection), then
            # rewind so the decode stream includes it
            n_scan = max(1 << 18, int(0.1 * fs_wide))
            prefix = read_scalars(2 * n_scan)
            fin.seek(0)
            if args.wideband_u8:
                pf = (prefix.astype(np.float32) - 128.0) / 128.0
            else:
                pf = prefix
            freqs = find_stations(np.ascontiguousarray(pf[0::2]),
                                  np.ascontiguousarray(pf[1::2]), fs_wide,
                                  min_snr_db=args.scan_snr,
                                  max_stations=args.max_stations,
                                  device=device)
            if not freqs:
                print("scan found no stations", file=sys.stderr)
                return 1
            print("scan found stations at "
                  + ", ".join(f"{f/1e6:+.2f} MHz" for f in freqs),
                  file=sys.stderr)
        else:
            freqs = [float(f) for f in args.freqs.split(",") if f]
        # the CUDA channelizer kernel on the card, the plain mfb engine on
        # the CPU (the reference: its Pallas kernel on the TPU, mfb else)
        chan = WidebandChannelizer(
            fs_wide, cfg.rf_fs, freqs,
            engine="pallas" if device.type == "cuda" else "mfb",
            ingest="u8" if args.wideband_u8 else "f32",
            compute_dtype="bf16" if args.fast else "f32", device=device)
        rx = Receiver(args.mode, stereo=stereo, rds=rds,
                      fused_frontend=False,
                      pll_impl="ff" if args.fast else "auto", device=device)
        wrx = WidebandReceiver(chan, rx)
        print(f"Channelizing {len(freqs)} stations from {fs_wide/1e6:.1f} "
              f"MS/s wideband ({dtype.name} stream)", file=sys.stderr)

        def file_chunks():
            # stream the capture: bounded read-ahead, never the whole file
            chunk = wrx.block_wide(args.blocks_per_step)
            while True:
                data = read_scalars(chunk)
                if len(data) == 0:
                    return
                yield data

        mrds = None
        if rds:
            from sdr_tpu_torch.rds.streaming import MultiStreamingRds
            mrds = MultiStreamingRds(cfg.rds_sps, len(freqs))
        audio = []
        with _profiling(args.profile, device):
            for out, _state in wrx.stream(
                    file_chunks(), blocks_per_step=args.blocks_per_step,
                    scan_steps=4):
                if stereo:
                    audio.append(np.stack(
                        [out["left"].float().cpu().numpy(),
                         out["right"].float().cpu().numpy()], axis=-1))
                else:
                    audio.append(out["mono"].float().cpu().numpy())
                if mrds is not None and "rds_soft" in out:
                    # live per-station decode as the wideband capture
                    # streams
                    for i, _groups in mrds.push(
                            out["rds_soft"].float().cpu().numpy()):
                        info = mrds.info(i)
                        print(f"  {freqs[i]/1e6:+.2f} MHz RDS: "
                              f"PI={info.pi:#06x} PS={info.ps_name!r} "
                              f"({info.groups_seen} groups)",
                              file=sys.stderr)
    if not audio:
        print("capture shorter than one block", file=sys.stderr)
        return 1
    full = np.concatenate(audio, axis=1)
    os.makedirs(args.wav_dir, exist_ok=True)
    for i, f in enumerate(freqs):
        pcm = np.clip(np.nan_to_num(full[i]) * 16384.0, -32768, 32767
                      ).astype(np.int16)
        dst = os.path.join(args.wav_dir, f"station{i}.wav")
        wavio.write_wav(dst, cfg.audio_fs, pcm)
        print(f"  {f/1e6:+.2f} MHz -> {dst}", file=sys.stderr)
    if mrds is not None:
        for i, f in enumerate(freqs):
            info = mrds.info(i)
            msg = (f"PI={info.pi:#06x} PS={info.ps_name!r} "
                   f"({info.groups_seen} groups)"
                   if info.pi is not None else "no sync")
            print(f"  {f/1e6:+.2f} MHz RDS final: {msg}", file=sys.stderr)
    return 0


def _run_stations(args, cfg, stereo: bool, rds: bool,
                  device: torch.device) -> int:
    """Stream-decode N station captures batched in one step (channel data
    parallelism, sdr_tpu/cli.py:374-460).

    The captures are memory-mapped and fed one step at a time (bounded by
    blocks_per_step, so captures larger than RAM work), with each
    station's RDS decoded live as groups arrive (MultiStreamingRds).
    Files are truncated to the shortest capture so the batch is
    rectangular.  `--fast` here is the reference's fleet profile: the
    bf16 front end, the feedforward carriers and bf16 convs, without the
    fused IF bank or the tiled convs (sdr_tpu/cli.py:404-405).
    """
    from sdr_tpu_torch.io import wav as wavio
    from sdr_tpu_torch.io.logger import stage_scope as scope
    from sdr_tpu_torch.models.receiver import Receiver

    paths = [p for p in args.stations.split(",") if p]
    if not args.wav_dir:
        print("--stations requires --wav-dir", file=sys.stderr)
        return 1
    os.makedirs(args.wav_dir, exist_ok=True)
    maps = [np.memmap(p, dtype=np.uint8, mode="r") for p in paths]
    k = len(paths)
    n = min(m.shape[0] for m in maps)
    print(f"Decoding {k} stations x {n//2} IQ samples (streaming, batched)",
          file=sys.stderr)
    fast = (dict(fused_frontend="bf16", pll_impl="ff", conv_dtype="bf16")
            if args.fast else {})
    rx = Receiver(args.mode, stereo=stereo, rds=rds, device=device, **fast)
    bs = rx.block_size_u8(args.blocks_per_step)
    if bs > n:
        bs = (n // rx.block_align_u8()) * rx.block_align_u8()
        if bs == 0:
            print("captures shorter than one block", file=sys.stderr)
            return 1
    state = rx.init_state((k,))
    mrds = None
    if rds:
        from sdr_tpu_torch.rds.streaming import MultiStreamingRds
        mrds = MultiStreamingRds(cfg.rds_sps, k)
    audio_chunks: list[np.ndarray] = []

    def drain(out):
        with scope("cli.drain"):
            if stereo:
                audio_chunks.append(np.stack(
                    [out["left"].float().cpu().numpy(),
                     out["right"].float().cpu().numpy()], axis=-1))
            else:
                audio_chunks.append(out["mono"].float().cpu().numpy())
            if mrds is not None:
                # live per-station decode: groups print as they arrive
                soft = out["rds_soft"].float().cpu().numpy()
                for i, _groups in mrds.push(soft):
                    info = mrds.info(i)
                    print(f"  station {i} RDS: PI={info.pi:#06x} "
                          f"PS={info.ps_name!r} "
                          f"RT={info.radio_text.rstrip()!r} "
                          f"({info.groups_seen} groups)", file=sys.stderr)

    def batches():
        for off in range(0, n - bs + 1, bs):
            with scope("cli.read"):
                batch = np.stack([m[off:off + bs] for m in maps])
            yield batch

    with _profiling(args.profile, device), _stats(args.stats) as launches0:
        _pipeline(rx, state, batches(), drain)
    if args.stats:
        _print_stats(launches0)

    full = np.concatenate(audio_chunks, axis=1)
    for i, path in enumerate(paths):
        # the reference's expression, on the host: no clip (a sample out
        # of range wraps as numpy's cast does)
        pcm = np.where(np.isnan(full[i]), 0.0, full[i] * 16384.0
                       ).astype(np.int16)
        dst = os.path.join(args.wav_dir, f"station{i}.wav")
        wavio.write_wav(dst, cfg.audio_fs, pcm)
        print(f"  station {i} ({os.path.basename(path)}) -> {dst}",
              file=sys.stderr)
    if mrds is not None:
        for i in range(k):
            info = mrds.info(i)
            msg = (f"PI={info.pi:#06x} PS={info.ps_name!r} "
                   f"({info.groups_seen} groups)"
                   if info.pi is not None else "no sync")
            print(f"  station {i} RDS final: {msg}", file=sys.stderr)
    return 0


def _trace_iq(base: str, raw: np.ndarray, rx) -> None:
    """Write 4 time-domain .dat traces of one u8 block: decoded I/Q before
    the channel filter and decimated I/Q after it (the reference's
    stage-trace workflow, src/logfunc.cpp:23-43 feeding data/iq.gnuplot).

    The filtered trace is computed with the float32 resampler from a zero
    tail (first-block semantics) on the receiver's device, whatever engine
    the stream runs: a debug tap, not part of the audio path.
    """
    from sdr_tpu_torch.io.logger import log_vector
    from sdr_tpu_torch.ops import firdes
    from sdr_tpu_torch.ops.resample import PolyphaseResampler

    n_show = 512  # samples per trace, like the reference's 512-pt window
    i_raw = (raw[0::2].astype(np.float32) - 128.0) / 128.0
    q_raw = (raw[1::2].astype(np.float32) - 128.0) / 128.0
    idx = np.arange(min(n_show, len(i_raw)))
    log_vector(f"{base}_i_time", idx, i_raw[: len(idx)])
    log_vector(f"{base}_q_time", idx, q_raw[: len(idx)])
    cfg = rx.cfg
    rf = PolyphaseResampler(
        firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1), 1,
        cfg.rf_decim, device=rx.device)
    i_ds, _ = rf(torch.from_numpy(i_raw).to(rx.device), rf.init_state())
    q_ds, _ = rf(torch.from_numpy(q_raw).to(rx.device), rf.init_state())
    i_ds, q_ds = i_ds.cpu().numpy(), q_ds.cpu().numpy()
    idx_f = np.arange(min(n_show, i_ds.shape[-1]))
    log_vector(f"{base}_i_filt_time", idx_f, i_ds[: len(idx_f)])
    log_vector(f"{base}_q_filt_time", idx_f, q_ds[: len(idx_f)])
    print(f"Wrote {base}_{{i,q}}_time.dat + {base}_{{i,q}}_filt_time.dat "
          "(render with examples/iq.gnuplot)", file=sys.stderr)


def _block_source(fin, block_size: int):
    """(reader, name): the native bounded-ring reader thread where the
    runtime built and the input has a file descriptor (backpressure + I/O
    overlap, sdr_tpu_torch/native), else synchronous reads."""
    from sdr_tpu_torch import native
    from sdr_tpu_torch.io.stream import SyncBlockReader
    try:
        fd = fin.fileno()
    except (AttributeError, OSError):
        fd = None
    if fd is not None and native.available():
        return native.BlockReader(fd, block_size), "native"
    return SyncBlockReader(fin, block_size), "sync"


class _SyncSink:
    """Synchronous audio sink where the native runtime is absent."""

    def __init__(self, fout):
        self._fout = fout

    def write(self, data: bytes):
        self._fout.write(data)

    def close(self):
        self._fout.flush()


def _audio_sink(fout):
    """(sink, name): the native off-thread writer where available (a
    bounded ring drained by a C++ thread, so write latency never stalls
    the device-feed loop, src/project.cpp:195), else synchronous writes."""
    from sdr_tpu_torch import native
    try:
        fd = fout.fileno()
    except (AttributeError, OSError):
        fd = None
    if fd is not None and native.available():
        fout.flush()  # anything buffered goes out before raw-fd writes
        return native.BlockWriter(fd), "native"
    return _SyncSink(fout), "sync"


class _PsdAnim:
    """Per-block PSD frame emitter (model/fmMonoAnim.py): one Bartlett PSD
    of the demodulated IF every `every` reference blocks, computed on the
    device and appended to a gnuplot index-addressable .dat series
    (io/logger.py PsdAnimWriter)."""

    def __init__(self, base: str, cfg, every: int):
        self.base = base
        self.every = max(1, every)
        self.block_if = cfg.block_size_u8 // (2 * cfg.rf_decim)
        self.fs = float(cfg.if_fs)
        self.count = 0
        self.writer = None

    def push(self, fm_demod: torch.Tensor) -> None:
        from sdr_tpu_torch.io.logger import PsdAnimWriter
        from sdr_tpu_torch.ops.fourier import estimate_psd
        nb = fm_demod.shape[-1] // self.block_if
        for b in range(nb):
            idx = self.count + b
            if idx % self.every:
                continue
            seg = fm_demod[b * self.block_if:(b + 1) * self.block_if]
            freq, psd = estimate_psd(seg.float(), fs=self.fs)
            if self.writer is None:
                self.writer = PsdAnimWriter(self.base, freq / 1e3)
            self.writer.append(psd.cpu().numpy(), label=f"block {idx}")
        self.count += nb

    def close(self) -> int:
        if self.writer is None:
            return 0
        self.writer.close()
        return self.writer.frames


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


if __name__ == "__main__":
    raise SystemExit(main())
