"""Time-axis sequence parallelism: one station's stream split over a mesh
with overlap halos.

Port of sdr_tpu/parallel/timeshard.py.  The mono chain (channel filter ->
discriminator -> audio resample) has no unbounded recurrence: every audio
sample depends on a bounded window of past raw samples.  So the time axis
splits exactly: shard d steps its left halo, the tail of shard d-1's
chunk, then its own chunk, from a cold state, and keeps the chunk's
outputs.  The result equals the serial run's.

The stereo chain's pilot loop forgets its initial state: locked to the
pilot, it converges to a state the signal sets.  `timesharded_stereo`
therefore widens each shard's halo by a loop warm-up; the shards run
fully in parallel, and the result is equivalent to the serial run's in
behaviour (stream SNR, separation), not bit for bit.
`timesharded_full` does the same for the whole stereo + RDS chain, and
sign-aligns the shards' RDS soft streams on the host across their halo
overlap, since the 57 kHz carrier from squaring has a 180-degree
ambiguity per shard (`polarity_stitch`, a NumPy copy of the reference's).

Shard 0 has no left neighbour: it starts its chunk from the cold state,
as the serial run starts the capture, so its outputs equal the serial
run's in every chain.  (Its halo, u8 128, is stepped with the others and
its state then put back to cold.  The reference steps shard 0 through
that halo instead: the mono chain's filters stay at zero there, but a
carrier loop free-runs on zero input, where atan2(+-0, -0) = +-pi kicks
it off frequency, and the reference's shard 0 loses its stereo; ROADMAP
queue C.)

Where the reference moves each halo with a `ppermute`, here each halo is
a slice of the neighbour's chunk on its device, copied with `.to()` only
where the neighbour lies on another device; the shards on one device
step as one batch (`Receiver.step` from `rx.init_state((n_shards,))`,
over the halos, then over the chunks).  The outputs are gathered on the
mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.config import ModeConfig
from sdr_tpu_torch.io.stream import host_tensor, to_device
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.parallel.mesh import Mesh, gather, receivers, tree_map


def halo_if(cfg: ModeConfig, if_align: int = 1) -> int:
    """Left-context depth of the mono chain in IF samples.

    audio FIR needs ceil((audio_taps-1)/U) IF samples back, +1 for the
    discriminator's previous sample, + ceil((rf_taps-1)/rf_decim) IF slots
    whose raw windows reach past the halo start; rounded up to a multiple of
    audio_decim (polyphase output-grid phase alignment) and of `if_align`
    (e.g. the fused front-end's output tile).
    """
    ctx = (-(-(cfg.audio_taps - 1) // cfg.audio_interp) + 1
           + -(-(cfg.rf_taps - 1) // cfg.rf_decim))
    unit = int(np.lcm(cfg.audio_decim, if_align))
    return -(-ctx // unit) * unit


def halo_pairs(cfg: ModeConfig, if_align: int = 1) -> int:
    """Left-context depth in raw IQ pairs."""
    return halo_if(cfg, if_align) * cfg.rf_decim


def _if_align(rx: Receiver) -> int:
    return rx.fe_out_tile if rx.fused_frontend else 1


def _pad_for_mesh(iq_u8, n_dev: int, align: int
                  ) -> tuple[torch.Tensor, int]:
    """Make any capture length shardable: trim to the serial-equivalent
    alignment (rx.run drops the trailing partial block the same way), then
    right-pad with u8 value 128 (decodes to 0.0) so every shard receives
    an equal aligned chunk.  Returns (padded tensor on the input's
    device, n_valid); callers trim outputs back to the serial length."""
    arr = host_tensor(iq_u8)
    if arr.dim() != 1:
        raise ValueError(f"time sharding takes one station's (n,) stream, "
                         f"not {tuple(arr.shape)}")
    n = arr.shape[-1]
    n_valid = (n // align) * align
    if n_valid == 0:
        raise ValueError(f"capture of {n} bytes shorter than the minimum "
                         f"aligned block {align}")
    unit = n_dev * align
    n_pad = -(-n_valid // unit) * unit
    if n_pad == n_valid == n:
        return arr, n_valid
    out = torch.full((n_pad,), 128, dtype=torch.uint8, device=arr.device)
    out[:n_valid] = arr[:n_valid]
    return out, n_valid


def _run_extended(rx: Receiver, iq_u8, mesh: Mesh, axis: str, align: int,
                  halo_u8: int, keys: tuple[str, ...]):
    """Each shard's halo, then its chunk, through two batched rx.step
    calls per device from cold states, shard 0's state put back to cold
    between them, so that shard 0 starts its chunk as the serial run
    starts the capture.  Returns ({key: ((n_shards, warm-up outputs),
    (n_shards, chunk outputs)) on the first device}, n_valid, chunk_u8)."""
    if mesh.process_count > 1:
        raise ValueError("time sharding runs within one process")
    n_dev = mesh.shape[axis]
    iq, n_valid = _pad_for_mesh(iq_u8, n_dev, align)
    chunk_u8 = iq.shape[-1] // n_dev
    if chunk_u8 < halo_u8:
        raise ValueError(f"per-shard chunk {chunk_u8} u8 shorter than the "
                         f"halo {halo_u8}")
    chunks = [to_device(iq[d * chunk_u8:(d + 1) * chunk_u8], dev)
              for d, dev in enumerate(mesh.devices)]
    rxs = receivers(rx, mesh)
    warm, main, order = [], [], []
    for dev, shards in mesh.groups().items():
        halos = torch.stack([
            torch.full((halo_u8,), 128, dtype=torch.uint8, device=dev)
            if d == 0 else chunks[d - 1][-halo_u8:].to(dev) for d in shards])
        r = rxs[dev]
        cold = r.init_state((len(shards),))
        state, out_w = r.step(cold, halos)
        if 0 in shards:
            first = torch.zeros(len(shards), dtype=torch.bool, device=dev)
            first[shards.index(0)] = True
            state = tree_map(lambda w, c: torch.where(
                first.view((-1,) + (1,) * (w.dim() - 1)), c, w), state, cold)
        _, out_c = r.step(state, torch.stack([chunks[d] for d in shards]))
        warm.append(out_w)
        main.append(out_c)
        order += shards
    dev0 = mesh.devices[0]
    return ({k: tuple(gather([o[k] for o in outs], order, dev0)
                      for outs in (warm, main)) for k in keys},
            n_valid, chunk_u8)


def _n_audio(cfg: ModeConfig, n_valid: int) -> int:
    return (n_valid // (2 * cfg.rf_decim * cfg.audio_decim)
            * cfg.audio_interp)


def timesharded_mono(rx: Receiver, iq_u8, mesh: Mesh, *, axis: str = "time"
                     ) -> torch.Tensor:
    """Mono-decode a single station's u8 stream with time split over mesh.

    iq_u8: (n,) u8, any length: trimmed and padded internally (see
    _pad_for_mesh).  Returns the audio stream, equal to
    rx.run(iq_u8)['mono'].
    """
    cfg = rx.cfg
    ia = _if_align(rx)
    align = 2 * cfg.rf_decim * int(np.lcm(cfg.audio_decim, ia))
    outs, n_valid, _ = _run_extended(rx, iq_u8, mesh, axis, align,
                                     2 * halo_pairs(cfg, ia), ("mono",))
    return outs["mono"][1].reshape(-1)[:_n_audio(cfg, n_valid)]


def stereo_warmup_if(rx: Receiver, warmup_if: int = 4096) -> int:
    """Left-halo depth (IF samples) for the time-sharded stereo chain:
    FIR/discriminator context + BPF group delay + mono delay line + PLL
    lock-in, rounded so (a) the polyphase output grid and fused-front-end
    tile stay aligned and (b) the pilot NCO's free-run phase over a halo
    is a whole number of cycles (the reference's rule for its shard-0
    halo; here shard 0 starts cold)."""
    cfg = rx.cfg
    ia = _if_align(rx)
    ctx = (halo_if(cfg, 1) + cfg.bp_taps
           + cfg.mono_delay * cfg.audio_decim // cfg.audio_interp + warmup_if)
    unit = int(np.lcm(int(np.lcm(cfg.audio_decim, ia)),
                      int(cfg.if_fs) // int(np.gcd(int(cfg.pilot_freq),
                                                   int(cfg.if_fs)))))
    return -(-ctx // unit) * unit


def timesharded_stereo(rx: Receiver, iq_u8, mesh: Mesh, *,
                       axis: str = "time", warmup_if: int = 4096):
    """Stereo-decode a single station's u8 stream with time split over
    the mesh: timesharded_mono past its PLL limit through warm-up halos
    (see the module docstring).

    iq_u8: (n,) u8, any length.  Returns (left, right), equivalent in
    behaviour to rx.run(iq_u8)['left'/'right'] (stereo separation and
    SNR within tolerance after the serial lock-in transient).
    """
    cfg = rx.cfg
    if not (rx.stereo and not rx.rds):
        raise ValueError("stereo time-sharding; for stereo+RDS use "
                         "timesharded_full")
    ia = _if_align(rx)
    align = 2 * cfg.rf_decim * int(np.lcm(cfg.audio_decim, ia))
    outs, n_valid, _ = _run_extended(
        rx, iq_u8, mesh, axis, align,
        2 * cfg.rf_decim * stereo_warmup_if(rx, warmup_if), ("left", "right"))
    n_audio = _n_audio(cfg, n_valid)
    return tuple(outs[k][1].reshape(-1)[:n_audio] for k in ("left", "right"))


def full_warmup_if(rx: Receiver, warmup_if: int | None = None) -> int:
    """Left-halo depth (IF samples) for the full stereo+RDS chain.

    With the feedforward carrier engine (pll_impl='ff') there is no loop
    lock-in: the halo only covers FIR/RRC/resampler context plus one
    coherent-integration window; the feedback engines need the RDS
    carrier loop's pull-in (bw=0.003 -> ~4x the stereo warm-up).  Rounded
    to the lcm of every grid the chain carries (audio polyphase, RDS
    resampler/symbol grid, ff window, fused-front-end tile).
    """
    cfg = rx.cfg
    if warmup_if is None:
        warmup_if = 2048 if rx.pll_impl == "ff" else 16384
    ia = _if_align(rx)
    # FIR context: RF + IF BPF pair + squaring BPF + 3 kHz LPF + RRC
    # (expressed at the IF rate), plus the channel-vs-carrier delay line
    u, d = cfg.rds_resample
    ctx = (halo_if(cfg, 1) + 3 * cfg.bp_taps
           + (cfg.bp_taps * u) // u + (151 * d) // u
           + (cfg.bp_taps - 1) // 2 + warmup_if)
    unit = np.lcm.reduce([cfg.audio_decim, ia, rx.rds_if_align,
                          rx.pll_window if rx.pll_impl == "ff" else 1])
    return int(-(-ctx // int(unit)) * int(unit))


def timesharded_full(rx: Receiver, iq_u8, mesh: Mesh, *,
                     axis: str = "time", warmup_if: int | None = None):
    """Time-split the whole receiver, stereo + RDS, over the mesh.

    Every shard runs the chain over (warm-up halo + chunk) from a cold
    state and drops the warm-up outputs, as timesharded_stereo does.  The
    57 kHz carrier comes from squaring (nco_scale=0.5), so each shard's
    soft waveform carries its own sign: shards also return their warm-up
    soft output, which overlaps the left neighbour's chunk in time, and
    the host correlates the overlap and sign-corrects each segment before
    concatenating them (the decoder resolves the one global polarity
    left, as usual).

    Returns (left, right, rds_soft): audio tensors equivalent in
    behaviour to the serial run's, and the stitched soft stream (host
    float32 numpy), which decodes to the same groups.
    """
    cfg = rx.cfg
    if not (rx.stereo and rx.rds):
        raise ValueError("timesharded_full wants stereo+RDS")
    n_dev = mesh.shape[axis]
    ia = _if_align(rx)
    warm_if = full_warmup_if(rx, warmup_if)
    align_if = int(np.lcm.reduce(
        [cfg.audio_decim, ia, rx.rds_if_align,
         rx.pll_window if rx.pll_impl == "ff" else 1]))
    u, d = cfg.rds_resample
    warm_soft = warm_if * u // d
    outs, n_valid, chunk_u8 = _run_extended(
        rx, iq_u8, mesh, axis, 2 * cfg.rf_decim * align_if,
        2 * cfg.rf_decim * warm_if, ("left", "right", "rds_soft"))
    n_audio = _n_audio(cfg, n_valid)
    left, right = (outs[k][1].reshape(-1)[:n_audio]
                   for k in ("left", "right"))
    # host-side polarity stitch (1187.5 bit/s: negligible)
    chunk_soft = (chunk_u8 // (2 * cfg.rf_decim)) * u // d
    soft_all = torch.cat(outs["rds_soft"], dim=-1).float().cpu().numpy(
        ).reshape(n_dev, warm_soft + chunk_soft)
    rds_soft = polarity_stitch(soft_all, warm_soft)
    n_soft = (n_valid // (2 * cfg.rf_decim)) * u // d
    return left, right, rds_soft[:n_soft]


def polarity_stitch(soft_all: np.ndarray, warm_soft: int, *,
                    confidence: float = 0.5) -> np.ndarray:
    """Sign-align per-device RDS soft segments across their warm-up overlap.

    soft_all: (n_dev, warm_soft + chunk_soft) — each device's warm-up soft
    output followed by its chunk.  Device d's warm-up overlaps device d-1's
    chunk tail in absolute time; the normalized correlation over the LATER
    half of the warm-up (filters warmed) decides the relative 180-degree
    squaring ambiguity (spec pp.13-14: the 57 kHz carrier from squaring is
    sign-ambiguous per independent acquisition).

    A seam whose overlap carries no RDS energy (squelched station, deep
    fade) yields |corr| ~ 0 — an arbitrary sign decision.  Below
    `confidence` (normalized, in [0,1]) the seam keeps the running sign and
    warns instead of trusting the noise: a possibly-wrong seam sign is
    absorbed by the downstream DIFFERENTIAL decode (spec p.16 — a sign flip
    at a seam corrupts only the one bit spanning it, while a confidently
    wrong flip used to silently invert the whole remaining stream).

    Note the correction applied to device d is sgn(corr) itself, NOT
    sign * sgn(corr): `theirs` is already sign-corrected, so the
    correlation directly measures device d's polarity against the stitched
    stream.  (The round-3 stitch multiplied by the running sign, which
    carried every polarity change one device too far; it went unnoticed
    because clean captures acquire uniform polarity —
    tests/test_parallel.py::test_polarity_stitch_confident_flip_no_warning
    exercises the alternating case.)
    """
    import warnings
    n_dev = soft_all.shape[0]
    chunk_soft = soft_all.shape[1] - warm_soft
    segs = [soft_all[0, warm_soft:]]
    sign = 1.0
    for dev in range(1, n_dev):
        ov = max(warm_soft // 2, 1)
        mine = soft_all[dev, warm_soft - ov:warm_soft]
        theirs = sign * soft_all[dev - 1, warm_soft + chunk_soft - ov:]
        denom = float(np.linalg.norm(mine) * np.linalg.norm(theirs))
        ncorr = float(np.dot(mine, theirs)) / denom if denom > 0 else 0.0
        if abs(ncorr) < confidence:
            warnings.warn(
                f"polarity_stitch: seam {dev - 1}->{dev} overlap correlation "
                f"|{ncorr:.3f}| below confidence {confidence} (no RDS energy "
                f"in overlap?) — keeping running sign; differential decode "
                f"absorbs a wrong seam as one bit error", stacklevel=2)
        else:
            sign = 1.0 if ncorr >= 0 else -1.0
        segs.append(sign * soft_all[dev, warm_soft:])
    return np.concatenate(segs)
