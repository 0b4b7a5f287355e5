"""The FM broadcast receiver: `step(state, iq_block)`.

Port of sdr_tpu/models/receiver.py.  The chain per block:
  u8 IQ --decode--> I,Q --LPF 100k + decim--> IF --discriminator--> fm_demod
    mono:   fm_demod --U/D resample LPF 16k--> audio       (project.cpp:146)
    stereo: fm_demod --BPF 22-54k--> L-R DSB --mixer(carrier 19k x2)-->
            --U/D resample LPF 16k--> stereo; L/R matrix w/ delayed mono
    rds:    fm_demod --BPF 54-60k--> channel --(square, BPF 113.5-114.5k,
            carrier 114k scale .5)--> 57k carrier --mixer--> baseband
            --LPF 3k + U/D resample--> SPS*2375 --RRC--> soft waveform
Every option of the reference's Receiver is ported: the mono path in
every engine, the stereo and RDS branches on every carrier engine (the
loops: scan, chunked and their Pallas forms, compat_pll; the feedforward
estimator), both filter engines (direct and fft), de-emphasis and the
shared audio state.  The hot stages are CUDA kernels (ops/cuda/): the
fused front end, the fused IF bank (four streams for the loops, mix sums
for the estimator), the carrier loops, the fused synthesis and the audio
pair; the rest is plain PyTorch (the fft engine on torch.fft).  PyTorch
runs eagerly, so `run` is a Python loop over blocks where the reference
scans.  Independent stations batch over leading axes of the u8 block.
The stages carry the reference's profiler scope names as spans
(io/logger.py `stage_scope`: rf_frontend, demod, mono_path, ifbank_fused,
carrier_ffmix, pll_<impl>, audio_pair_kernel, ...; the unfused IF
filters as if_filters, the stereo matrix as stereo_matrix, the RDS
resampler and RRC as rds_resample and rds_rrc), inside receiver.step;
`run` adds receiver.run around the call and receiver.h2d around each
step's copy to the device.  The spans are kept only while a profiler
records or the CLI's --stats asks.

`conv_engine='tiled'` (the `--fast` engine) runs every direct-engine
resampling FIR and the RDS resampler through ops/banded.py
`TiledBandedFIR`, as the reference does: one CUDA launch a stage
(csrc/banded.cu), input and tail stored at the compute dtype;
`conv_engine='conv'` runs them as one cuDNN conv each.  The reference's
TPU-only choices `fe_out_tile`, `fe_sub_tiles` and the IF bank's tile
tile the TPU kernels.  They are accepted so that the reference's
configurations construct, and the tiles enter `block_align_u8`, so
`run` consumes and emits exactly as many samples as the reference;
`fe_sub_tiles` has no effect here.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.config import ModeConfig, get_mode
from sdr_tpu_torch.io.logger import stage_scope as scope
from sdr_tpu_torch.io.stream import decode_u8_iq, host_tensor, to_device
from sdr_tpu_torch.models.state import (FrontEndState, MonoState, RdsState,
                                        ReceiverState, StereoState)
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.banded import TiledBandedFIR
from sdr_tpu_torch.ops.demod import fm_arctan, fm_discriminator
from sdr_tpu_torch.ops.fft_conv import OverlapSaveFIR
from sdr_tpu_torch.ops.iir import deemphasis_alpha, first_order_iir
from sdr_tpu_torch.ops.pll import (pll, pll_chunked, pll_feedforward,
                                   pll_feedforward_from_sums,
                                   pll_feedforward_multi,
                                   pll_ff_params_from_sums, pll_init)
from sdr_tpu_torch.ops.pointwise import delay_line, lr_matrix, mixer
from sdr_tpu_torch.ops.resample import MultiFIR, PolyphaseResampler

# fused_frontend value -> coefficient engine of the CUDA front end
_FE_ENGINES = {True: "f32", "f32": "f32", "bf16": "bf16", "int8": "int8",
               "int8x2": "int8x2"}


class Receiver:
    """Configured receiver for one operating mode.

    Args (as sdr_tpu's Receiver):
      mode: 0-3 or a custom ModeConfig.
      stereo, rds: decode the stereo subcarrier / the RDS subcarrier to an
           RRC-filtered soft waveform (rds needs a mode with rds_sps).
      pll_impl: carrier engine of stereo and RDS: 'auto' = 'scan' (the
           exact per-sample loop, ops.pll.pll; the sequential CUDA kernel
           on the card), 'pallas' (the same loop with the polynomial
           detector, same kernel), 'chunked' (frozen feedback over
           pll_chunk samples, ops.pll.pll_chunked; the chunked kernel),
           'pallas_chunked' (the same with the polynomial detector; with
           stereo and rds both loops run in one chunked launch) or 'ff'
           (the feedforward estimator).
      pll_chunk: chunk of 'chunked' and 'pallas_chunked'.
      pll_wrap_phase: carry the scan loop's phase modulo its period
           ('pallas' always wraps).
      rds_pll_bandwidth: loop bandwidth of the 57 kHz carrier loop.
      compat_pll: every engine becomes the scan loop with the
           reference's trigOffset counter and no lag correction.
      pll_window: coherent-integration window of the 'ff' engine.
      rds_rrc_taps: taps of the RDS matched filter.
      emit_if: include the demodulated IF ('fm_demod') in the outputs.
      emit_rssi: include the per-block RSSI ('rssi_db', dBFS of the IF).
      demod: 'discriminator' | 'arctan'.
      fused_frontend: False | True/'f32' | 'bf16' | 'int8' | 'int8x2' —
           the u8 decode + channel filter + decimation as one CUDA kernel
           in one of the reference's coefficient engines.
      fe_out_tile, fe_sub_tiles: the reference's TPU tiling (see module
           docstring); fe_out_tile sets the block alignment.
      fuse_demod: fold the discriminator into the front-end kernel.
      fused_ifbank: False | True/'f32' | 'bf16' — with stereo and rds, the
           IF band-pass stages as one CUDA kernel (ops/cuda/
           ifbank_kernel.py): with 'ff' (no compat_pll) it writes the
           carrier estimators' mix sums, otherwise all four streams.
      fused_synth: with the fused IF bank, carrier synthesis + RDS delay +
           both mixers as one CUDA kernel (ops/cuda/ffmix_kernel.py); with
           conv_engine='tiled' in the integer-ratio modes it also brings
           the audio-pair kernel (ops/cuda/audio_kernel.py).
           With compat_shared_audio_state it is not used (the
           reference's rule: the mono resample is not deferred then).
      conv_engine: 'conv' | 'tiled'; conv_dtype: 'f32' | 'bf16'.
      filter_engine: 'direct' (polyphase conv) | 'fft' (overlap-save on
           torch.fft, ops/fft_conv.py, for every resampling FIR but the
           RDS resampler; the U > 1 stages of modes 2/3 by spectral
           replication).  The fused IF bank needs 'direct'.
      deemphasis_us: FM de-emphasis time constant (75 Americas, 50
           Europe) applied to the audio outputs, None = off.  In stereo
           it applies to left and right but not to 'mono' (the
           reference's rule).
      compat_shared_audio_state: in stereo, the stereo audio resample
           continues the mono resample's tail (the reference's defect,
           src/project.cpp:146,172), and stereo_audio_tail stays as it
           was.
      stereo_phase_adjust: radians added to the 38 kHz carrier phase.
      device: where the state lives and the chain runs.
    """

    def __init__(self, mode: int | ModeConfig = 0, *, stereo: bool = False,
                 rds: bool = False, compat_shared_audio_state: bool = False,
                 pll_wrap_phase: bool = True,
                 rds_pll_bandwidth: float = 0.003,
                 rds_rrc_taps: int = 151, emit_if: bool = False,
                 emit_rssi: bool = False, pll_impl: str = "auto",
                 pll_chunk: int = 16, pll_window: int = 256,
                 demod: str = "discriminator",
                 fused_frontend: bool | str = False, fe_out_tile: int = 128,
                 fe_sub_tiles: int = 2, fuse_demod: bool = True,
                 fused_ifbank: bool | str = False,
                 filter_engine: str = "direct", conv_engine: str = "conv",
                 conv_dtype: str = "f32", stereo_phase_adjust: float = 0.0,
                 compat_pll: bool = False,
                 deemphasis_us: float | None = None,
                 fused_synth: bool = True,
                 device: torch.device | str = "cuda"):
        # the constructor's arguments but the device, for `on`
        self._args = {k: v for k, v in locals().items()
                      if k not in ("self", "device")}
        cfg = get_mode(mode) if isinstance(mode, int) else mode
        if rds and cfg.rds_sps is None:
            raise ValueError(f"mode {cfg.mode} does not support RDS")
        if pll_impl == "auto":
            pll_impl = "scan"
        if pll_impl not in ("scan", "pallas", "chunked", "pallas_chunked",
                            "ff"):
            raise ValueError(f"pll_impl {pll_impl!r}")
        if filter_engine not in ("direct", "fft"):
            raise ValueError(f"filter_engine {filter_engine!r}")
        if demod not in ("discriminator", "arctan"):
            raise ValueError(f"demod {demod!r}")
        if conv_engine not in ("conv", "tiled"):
            raise ValueError(f"conv_engine {conv_engine!r}")
        if conv_dtype not in ("f32", "bf16"):
            raise ValueError(f"conv_dtype {conv_dtype!r}")
        if fused_frontend and fused_frontend not in _FE_ENGINES:
            raise ValueError(f"fused_frontend {fused_frontend!r}")
        self.cfg = cfg
        self.stereo = stereo
        self.rds = rds
        self.emit_if = emit_if
        self.emit_rssi = emit_rssi
        self.demod = demod
        self.pll_impl = pll_impl
        self.pll_chunk = int(pll_chunk)
        self.pll_window = int(pll_window)
        self.rds_pll_bandwidth = float(rds_pll_bandwidth)
        # the reference's trigOffset counter and NCO lead (its defects,
        # kept for parity experiments); it turns the phase wrap off
        self.compat_pll = bool(compat_pll)
        self.pll_wrap_phase = bool(pll_wrap_phase) and not compat_pll
        self.stereo_phase_adjust = float(stereo_phase_adjust)
        self.filter_engine = filter_engine
        self.compat_shared_audio_state = bool(compat_shared_audio_state)
        self.deemph_alpha = (None if deemphasis_us is None else
                             deemphasis_alpha(cfg.audio_fs, deemphasis_us))
        self.device = torch.device(device)
        cdt = torch.bfloat16 if conv_dtype == "bf16" else torch.float32
        if_fs = cfg.if_fs

        def direct(coeff, down=1, up=1):
            """The direct engine's resampler: the tiled engine's kernel or
            one conv."""
            if conv_engine == "tiled":
                return TiledBandedFIR(coeff, up, down, compute_dtype=cdt,
                                      device=self.device)
            return PolyphaseResampler(coeff, up, down, compute_dtype=cdt,
                                      device=self.device)

        def dec_filter(coeff, down=1, up=1):
            """Resampling FIR in the selected engine."""
            if filter_engine == "fft":
                return OverlapSaveFIR(coeff, down, up, device=self.device)
            return direct(coeff, down, up)

        rf_coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
        audio_coeff = firdes.lowpass(if_fs * cfg.audio_interp, cfg.audio_fc,
                                     cfg.audio_taps, cfg.audio_gain)
        self.rf_resampler = dec_filter(rf_coeff, cfg.rf_decim)
        self.fused_frontend = bool(fused_frontend)
        # bf16 materialization: the fm stream is stored at bf16 iff the
        # downstream compute is bf16 and the front end rounds at least as
        # coarsely (reference receiver.py:228-229)
        self._mat_bf16 = (fused_frontend in ("bf16", "int8")
                          and conv_dtype == "bf16")
        self._fm_dtype = torch.bfloat16 if self._mat_bf16 else torch.float32
        self.fe_out_tile = int(fe_out_tile)
        if fused_frontend:
            from sdr_tpu_torch.ops.cuda.frontend_kernel import FusedFrontend
            self._fused_fe = FusedFrontend(
                rf_coeff, cfg.rf_decim,
                compute_dtype=_FE_ENGINES[fused_frontend],
                out_dtype=self._fm_dtype, device=self.device)
        self._fuse_demod = bool(fused_frontend and fuse_demod
                                and demod == "discriminator")
        self.audio_resampler = dec_filter(audio_coeff, cfg.audio_decim,
                                          cfg.audio_interp)

        # IF band-pass stages reading fm_demod: with the direct engine one
        # conv for all of them, with the fft engine one filter each
        self.if_bpf3 = self.stereo_bpf = None
        self.channel_filter = self.carrier_filter = None
        if stereo:
            chan_coeff = firdes.bandpass(if_fs, cfg.stereo_lo, cfg.stereo_hi,
                                         cfg.bp_taps)
            pilot_coeff = firdes.bandpass(if_fs, cfg.pilot_lo, cfg.pilot_hi,
                                          cfg.bp_taps)
            if filter_engine == "fft":
                self.channel_filter = dec_filter(chan_coeff)
                self.carrier_filter = dec_filter(pilot_coeff)
            elif rds:
                rds_chan3 = firdes.bandpass(if_fs, cfg.rds_lo, cfg.rds_hi,
                                            cfg.bp_taps)
                self.if_bpf3 = MultiFIR([chan_coeff, pilot_coeff, rds_chan3],
                                        compute_dtype=cdt, device=self.device)
            else:
                self.stereo_bpf = MultiFIR([chan_coeff, pilot_coeff],
                                           compute_dtype=cdt,
                                           device=self.device)
            self.stereo_audio_resampler = dec_filter(
                audio_coeff, cfg.audio_decim, cfg.audio_interp)
        # the fused IF bank: mix sums for the feedforward chain, the four
        # streams for the loop engines
        self._ifbank = None
        self._ifbank_mix = False
        if fused_ifbank and stereo and rds and filter_engine == "direct":
            from sdr_tpu_torch.ops.cuda.ifbank_kernel import (FusedIFBank,
                                                              FusedIFBankMix)
            bank_coeffs = (
                firdes.bandpass(if_fs, cfg.stereo_lo, cfg.stereo_hi,
                                cfg.bp_taps),
                firdes.bandpass(if_fs, cfg.pilot_lo, cfg.pilot_hi,
                                cfg.bp_taps),
                firdes.bandpass(if_fs, cfg.rds_lo, cfg.rds_hi, cfg.bp_taps),
                firdes.bandpass(if_fs, cfg.rds_carrier_lo,
                                cfg.rds_carrier_hi, cfg.bp_taps))
            bf16_bank = fused_ifbank == "bf16"
            bank_kw = dict(
                compute_dtype=torch.bfloat16 if bf16_bank else torch.float32,
                out_dtype=(torch.bfloat16 if bf16_bank and conv_dtype == "bf16"
                           else None),
                device=self.device)
            if pll_impl == "ff" and not compat_pll:
                self._ifbank = FusedIFBankMix(
                    *bank_coeffs, window=self.pll_window,
                    pilot_freq=float(cfg.pilot_freq),
                    rds_carrier_freq=float(cfg.rds_carrier_freq),
                    fs=float(if_fs), **bank_kw)
                self._ifbank_mix = True
            else:
                self._ifbank = FusedIFBank(*bank_coeffs, **bank_kw)
        # post-IF-bank materialization (reference receiver.py:324-326)
        self._mat_bf16_post = (self._ifbank is not None
                               and fused_ifbank == "bf16"
                               and conv_dtype == "bf16")
        self._post_dtype = (torch.bfloat16 if self._mat_bf16_post
                            else torch.float32)
        self._fused_synth = bool(fused_synth) and self._ifbank_mix
        # the audio-pair kernel: integer-ratio modes only, and not with the
        # shared audio state, whose mono resample is not deferred
        self._audio_pair = None
        if (self._fused_synth and conv_engine == "tiled"
                and not self.compat_shared_audio_state
                and cfg.audio_interp == 1 and cfg.audio_taps <= 129):
            from sdr_tpu_torch.ops.cuda.audio_kernel import PairDecimFIR
            self._audio_pair = PairDecimFIR(
                audio_coeff, cfg.audio_decim, compute_dtype=cdt,
                out_dtype=torch.float32, device=self.device)
        if rds:
            u, d = cfg.rds_resample
            rds_chan = firdes.bandpass(if_fs, cfg.rds_lo, cfg.rds_hi,
                                       cfg.bp_taps)
            rds_carr = firdes.bandpass(if_fs, cfg.rds_carrier_lo,
                                       cfg.rds_carrier_hi, cfg.bp_taps)
            rds_lpf = firdes.lowpass(if_fs * u, cfg.rds_fc, cfg.bp_taps * u,
                                     u)
            rrc = firdes.root_raised_cosine(cfg.rds_fs, rds_rrc_taps,
                                            cfg.rds_symbol_rate)
            self.rds_channel_filter = (None if self.if_bpf3 is not None
                                       else dec_filter(rds_chan))
            self.rds_carrier_filter = dec_filter(rds_carr)
            self.rds_resampler = direct(rds_lpf, d, u)
            self.rds_rrc = dec_filter(rrc)
            # group-delay alignment of the channel path against the
            # square -> BPF(51 taps) -> carrier path (spec Fig 10 all-pass)
            self.rds_delay = (cfg.bp_taps - 1) // 2
            # IF samples per block must make symbols integral
            g = np.gcd(cfg.rds_sps, u)
            self.rds_if_align = d * cfg.rds_sps // g
        # both carrier loops in one chunked launch (per-lane parameters)
        self._joint_pll = (stereo and rds and pll_impl == "pallas_chunked"
                           and not compat_pll)

    def on(self, device: torch.device | str) -> "Receiver":
        """A Receiver built with this one's arguments on `device`."""
        return Receiver(device=device, **self._args)

    # ------------------------------------------------------------------ state
    def init_state(self, batch_shape: tuple[int, ...] = ()) -> ReceiverState:
        def zeros(shape=(), dtype=torch.float32):
            return torch.zeros(batch_shape + shape, dtype=dtype,
                               device=self.device)
        if self.fused_frontend:
            # the fused kernel carries the raw u8 tail (value 128 == 0.0)
            front = FrontEndState(self._fused_fe.init_state(batch_shape),
                                  zeros((0,)), zeros(), zeros())
        else:
            front = FrontEndState(self.rf_resampler.init_state(batch_shape),
                                  self.rf_resampler.init_state(batch_shape),
                                  zeros(), zeros())
        if self._audio_pair is not None:
            # the audio pair carries the last raw samples of each stream,
            # in the stream's dtype
            audio_tail = self._audio_pair.init_state(batch_shape,
                                                     self._fm_dtype)
        else:
            audio_tail = self.audio_resampler.init_state(batch_shape)
        mono = MonoState(audio_tail, zeros())
        stereo = None
        if self.stereo:
            ca_tail = zeros((0,))
            if self._ifbank is not None:
                # one carried raw-fm context, in the fm stream's dtype
                ch_tail = self._ifbank.init_state(batch_shape).to(
                    self._fm_dtype)
            elif self.channel_filter is not None:
                ch_tail = self.channel_filter.init_state(batch_shape)
                ca_tail = self.carrier_filter.init_state(batch_shape)
            else:
                # the reference starts this tail at float32 and carries it
                # in the fm stream's dtype from the first step on; here it
                # starts there (ROADMAP.md queue C)
                bpf = self.if_bpf3 or self.stereo_bpf
                ch_tail = bpf.init_state(batch_shape).to(self._fm_dtype)
            stereo = StereoState(
                channel_tail=ch_tail, carrier_tail=ca_tail,
                pll=pll_init(batch_shape, self.device),
                mono_delay=zeros((self.cfg.mono_delay,)),
                stereo_audio_tail=(
                    self._audio_pair.init_state(batch_shape,
                                                self._post_dtype)
                    if self._audio_pair is not None else
                    self.stereo_audio_resampler.init_state(batch_shape)),
                deemph_l=zeros(), deemph_r=zeros())
        rds = None
        if self.rds:
            rds = RdsState(
                channel_tail=(zeros((0,)) if self.if_bpf3 is not None else
                              self.rds_channel_filter.init_state(batch_shape)),
                carrier_tail=(zeros((0,)) if self._ifbank is not None else
                              self.rds_carrier_filter.init_state(batch_shape)),
                pll=pll_init(batch_shape, self.device),
                # fused synthesis: the delay is applied in the ffmix kernel
                # from 128 carried columns of the raw rds_channel stream
                delay=zeros((128 if self._fused_synth else self.rds_delay,),
                            self._post_dtype),
                lpf_resamp_tail=self.rds_resampler.init_state(batch_shape),
                rrc_tail=self.rds_rrc.init_state(batch_shape))
        return ReceiverState(front=front, mono=mono, stereo=stereo, rds=rds)

    # ------------------------------------------------------------------- step
    def step(self, state: ReceiverState, iq_u8: torch.Tensor
             ) -> tuple[ReceiverState, dict[str, torch.Tensor]]:
        """Process one u8 IQ block (..., block) -> (new_state, outputs).

        Outputs: 'mono' always; 'left'/'right' when stereo; 'rds_soft' (RRC
        output at SPS*2375) when rds."""
        with scope("receiver.step"):
            return self._step(state, iq_u8)

    def _step(self, state, iq_u8):
        if self.fused_frontend and self._fuse_demod:
            with scope("rf_frontend"):
                fm_demod, i_tail, prev_i, prev_q, psum = (
                    self._fused_fe.demod_call(iq_u8, state.front.i_tail,
                                              state.front.prev_i,
                                              state.front.prev_q))
            front = FrontEndState(i_tail, state.front.q_tail, prev_i, prev_q)
            rssi_power = (psum / fm_demod.shape[-1]
                          if self.emit_rssi else None)
            return self._post_demod(state, fm_demod, front, rssi_power)
        with scope("rf_frontend"):
            if self.fused_frontend:
                i_ds, q_ds, i_tail = self._fused_fe(iq_u8,
                                                    state.front.i_tail)
                q_tail = state.front.q_tail
            else:
                i_raw, q_raw = decode_u8_iq(iq_u8)
                i_ds, i_tail = self.rf_resampler(i_raw, state.front.i_tail)
                q_ds, q_tail = self.rf_resampler(q_raw, state.front.q_tail)
        return self._finish_step(state, i_ds, q_ds, i_tail, q_tail)

    def step_iq(self, state: ReceiverState, i_raw: torch.Tensor,
                q_raw: torch.Tensor
                ) -> tuple[ReceiverState, dict[str, torch.Tensor]]:
        """Like step() but on already-decoded float I/Q at the RF rate."""
        with scope("rf_frontend"):
            i_ds, i_tail = self.rf_resampler(i_raw, state.front.i_tail)
            q_ds, q_tail = self.rf_resampler(q_raw, state.front.q_tail)
        return self._finish_step(state, i_ds, q_ds, i_tail, q_tail)

    def _finish_step(self, state, i_ds, q_ds, i_tail, q_tail):
        with scope("demod"):
            if self.demod == "arctan":
                # prev_i slot carries the phase; prev_q is unused
                fm_demod, prev_phase = fm_arctan(i_ds, q_ds,
                                                 state.front.prev_i)
                front = FrontEndState(i_tail, q_tail, prev_phase,
                                      state.front.prev_q)
            else:
                fm_demod, prev_i, prev_q = fm_discriminator(
                    i_ds, q_ds, state.front.prev_i, state.front.prev_q)
                front = FrontEndState(i_tail, q_tail, prev_i, prev_q)
        rssi_power = (torch.mean(i_ds * i_ds + q_ds * q_ds, dim=-1)
                      if self.emit_rssi else None)
        return self._post_demod(state, fm_demod, front, rssi_power)

    def _post_demod(self, state, fm_demod, front, rssi_power):
        """Downstream of the discriminator: RSSI, mono, stereo and RDS."""
        outputs: dict[str, torch.Tensor] = {}
        if rssi_power is not None:
            outputs["rssi_db"] = 10.0 * torch.log10(rssi_power + 1e-12)
        if self.emit_if:
            outputs["fm_demod"] = fm_demod
        # in stereo the mono resample is deferred and batched with the
        # stereo one (the same filter bank), unless the two share a tail or
        # the fft engine runs (reference receiver.py:570-572)
        defer_mono = (self.stereo and not self.compat_shared_audio_state
                      and isinstance(self.audio_resampler,
                                     (PolyphaseResampler, TiledBandedFIR)))
        mono_audio = audio_tail = None
        if not defer_mono:
            with scope("mono_path"):
                mono_audio, audio_tail = self.audio_resampler(
                    fm_demod, state.mono.audio_tail)
        deemph = state.mono.deemph
        if self.deemph_alpha is not None and not self.stereo:
            outputs["mono"], deemph = first_order_iir(
                mono_audio, deemph, alpha=self.deemph_alpha)
        elif not defer_mono:
            outputs["mono"] = mono_audio
        rds_state = None
        if self.stereo or self.rds:
            channel, rds_channel, carriers = self._if_bands(state, fm_demod)
        if self.rds:
            rds_state, outputs["rds_soft"] = self._rds(state.rds, rds_channel,
                                                       carriers)
        if not self.stereo:
            return ReceiverState(front=front, mono=MonoState(audio_tail,
                                                             deemph),
                                 rds=rds_state), outputs
        st = state.stereo
        mixed = carriers["mixed"]
        if mixed is None:
            mixed = mixer(channel, carriers["nco_s"])
        stereo_audio_tail = st.stereo_audio_tail
        if self.compat_shared_audio_state:
            # the reference's defect: the stereo resample continues the
            # mono tail
            stereo_audio, audio_tail = self.audio_resampler(mixed,
                                                            audio_tail)
        elif self._audio_pair is not None:
            # both IF->audio FIRs in one CUDA launch
            with scope("audio_pair_kernel"):
                mono_audio, stereo_audio, audio_tail, stereo_audio_tail = (
                    self._audio_pair(fm_demod, mixed, state.mono.audio_tail,
                                     st.stereo_audio_tail))
            outputs["mono"] = mono_audio
        elif defer_mono:
            # one conv for both IF->audio resamples (same filter bank)
            with scope("audio_resample_pair"):
                pair, pair_tails = self.audio_resampler(
                    torch.stack([fm_demod, mixed.to(fm_demod.dtype)]),
                    torch.stack([state.mono.audio_tail,
                                 st.stereo_audio_tail]))
            mono_audio, stereo_audio = pair[0], pair[1]
            audio_tail, stereo_audio_tail = pair_tails[0], pair_tails[1]
            outputs["mono"] = mono_audio
        else:
            stereo_audio, stereo_audio_tail = self.stereo_audio_resampler(
                mixed, st.stereo_audio_tail)
        with scope("stereo_matrix"):
            # delayed mono against the BPF group delay
            # (src/project.cpp:152-159)
            mono_shift, mono_delay = delay_line(mono_audio, st.mono_delay)
            left, right = lr_matrix(mono_shift, stereo_audio)
            deemph_l, deemph_r = st.deemph_l, st.deemph_r
            if self.deemph_alpha is not None:
                left, deemph_l = first_order_iir(left, deemph_l,
                                                 alpha=self.deemph_alpha)
                right, deemph_r = first_order_iir(right, deemph_r,
                                                  alpha=self.deemph_alpha)
        outputs["left"], outputs["right"] = left, right
        stereo_state = StereoState(carriers["channel_tail"],
                                   carriers["carrier_tail"],
                                   carriers["pll_s"], mono_delay,
                                   stereo_audio_tail, deemph_l, deemph_r)
        return ReceiverState(front=front, mono=MonoState(audio_tail, deemph),
                             stereo=stereo_state, rds=rds_state), outputs

    def _if_bands(self, state, fm_demod):
        """The IF band-pass stages and carrier recovery.  Returns (channel,
        rds_channel, carriers): carriers holds the new carrier states
        ('pll_s', 'pll_r'), the NCOs ('nco_s', 'nco_r') or the fused
        synthesis' mixed streams ('mixed', 'baseband', 'delay'), and the
        new band-pass tails."""
        cfg = self.cfg
        fs, n_if = float(cfg.if_fs), fm_demod.shape[-1]
        pilot_freq = float(cfg.pilot_freq)
        rds_freq = float(cfg.rds_carrier_freq)
        adj = self.stereo_phase_adjust
        odt = self._post_dtype
        c = dict(mixed=None, baseband=None, delay=None, nco_s=None,
                 nco_r=None, pll_s=None, pll_r=None, channel_tail=None,
                 carrier_tail=None)
        channel = rds_channel = pilot = rds_carrier_in = None
        rs = state.rds
        if self.rds:
            c["rds_channel_tail"] = rs.channel_tail
            c["rds_carrier_tail"] = rs.carrier_tail
        if self.stereo:
            st = state.stereo
            c["carrier_tail"] = st.carrier_tail
            if self._ifbank_mix:
                with scope("ifbank_fused_mix"):
                    (channel, rds_channel, zp, zr,
                     c["channel_tail"]) = self._ifbank.mix_call(
                         fm_demod, st.channel_tail)
            elif self._ifbank is not None:
                with scope("ifbank_fused"):
                    (channel, pilot, rds_channel, rds_carrier_in,
                     c["channel_tail"]) = self._ifbank(fm_demod,
                                                       st.channel_tail)
        if self._ifbank is None:
            with scope("if_filters"):
                channel, pilot, rds_channel, rds_carrier_in = (
                    self._if_filters(state, fm_demod, c))

        if self._fused_synth:
            # estimate only (per-window math), then one CUDA pass
            # synthesizes both carriers, delays the RDS channel and mixes
            from sdr_tpu_torch.ops.cuda.ffmix_kernel import ffmix
            window = self._ifbank.window
            with scope("carrier_ffmix"):
                params_s, c["pll_s"] = pll_ff_params_from_sums(
                    *zp, st.pll, freq=pilot_freq, fs=fs, n=n_if,
                    nco_scale=2.0, window=window)
                params_r, c["pll_r"] = pll_ff_params_from_sums(
                    *zr, rs.pll, freq=rds_freq, fs=fs, n=n_if,
                    nco_scale=0.5, window=window)
                c["mixed"], c["baseband"] = ffmix(
                    channel, rds_channel, rs.delay, params_s, params_r,
                    n=n_if, window=window, pilot_freq=pilot_freq,
                    rds_freq=rds_freq, fs=fs, delay=self.rds_delay,
                    phase_adjust=adj, out_dtype=odt)
            c["delay"] = rds_channel[..., -128:].clone()
        elif self._ifbank_mix:
            window = self._ifbank.window
            with scope("carrier_ff_from_sums"):
                c["nco_s"], c["pll_s"] = pll_feedforward_from_sums(
                    *zp, st.pll, freq=pilot_freq, fs=fs, n=n_if,
                    nco_scale=2.0, phase_adjust=adj, window=window,
                    out_dtype=odt)
                c["nco_r"], c["pll_r"] = pll_feedforward_from_sums(
                    *zr, rs.pll, freq=rds_freq, fs=fs, n=n_if,
                    nco_scale=0.5, window=window, out_dtype=odt)
        elif self._joint_pll:
            # both loops in one chunked launch, per-lane parameters
            from sdr_tpu_torch.ops.cuda.pll_kernel import (
                pll_pallas_chunked_multi)
            with scope("pll_joint"):
                (c["nco_s"], c["nco_r"]), (c["pll_s"], c["pll_r"]) = (
                    pll_pallas_chunked_multi(
                        (pilot, rds_carrier_in), (st.pll, rs.pll),
                        params=((pilot_freq, fs, 2.0, adj, 0.01),
                                (rds_freq, fs, 0.5, 0.0,
                                 self.rds_pll_bandwidth)),
                        chunk=self.pll_chunk))
        elif (self.stereo and self.rds and self.pll_impl == "ff"
              and not self.compat_pll):
            with scope("carrier_ff_pair"):
                (c["nco_s"], c["nco_r"]), (c["pll_s"], c["pll_r"]) = (
                    pll_feedforward_multi(
                        (pilot, rds_carrier_in), (st.pll, rs.pll),
                        params=((pilot_freq, fs, 2.0, adj),
                                (rds_freq, fs, 0.5, 0.0)),
                        window=self.pll_window, out_dtype=odt))
        elif self.stereo and self.rds and (
                self.compat_pll or self.pll_impl in ("scan", "pallas")):
            # both sequential loops in one launch, side by side on the card
            from sdr_tpu_torch.ops.cuda.pll_kernel import pll_loop_multi
            pallas = self.pll_impl == "pallas" and not self.compat_pll
            with scope(f"pll_{self.pll_impl}"):
                (c["nco_s"], c["nco_r"]), (c["pll_s"], c["pll_r"]) = (
                    pll_loop_multi(
                        (pilot, rds_carrier_in), (st.pll, rs.pll),
                        params=((pilot_freq, fs, 2.0, adj, 0.01),
                                (rds_freq, fs, 0.5, 0.0,
                                 self.rds_pll_bandwidth)),
                        wrap_phase=pallas or self.pll_wrap_phase,
                        lag_correction=not self.compat_pll,
                        exact=not pallas))
        else:
            if self.stereo:
                c["nco_s"], c["pll_s"] = self._pll(
                    pilot, st.pll, freq=pilot_freq, fs=fs, nco_scale=2.0,
                    phase_adjust=adj, norm_bandwidth=0.01)
            if self.rds:
                c["nco_r"], c["pll_r"] = self._pll(
                    rds_carrier_in, rs.pll, freq=rds_freq, fs=fs,
                    nco_scale=0.5, norm_bandwidth=self.rds_pll_bandwidth)
        return channel, rds_channel, c

    def _if_filters(self, state, fm_demod, c):
        """The unfused IF band-pass filters: (channel, pilot, rds_channel,
        rds_carrier_in), each None where the profile has no such stream;
        their new tails go into `c`."""
        channel = pilot = rds_channel = rds_carrier_in = None
        rs = state.rds
        if self.stereo:
            st = state.stereo
            if self.if_bpf3 is not None:
                (channel, pilot, rds_channel), c["channel_tail"] = (
                    self.if_bpf3(fm_demod, st.channel_tail))
            elif self.stereo_bpf is not None:
                (channel, pilot), c["channel_tail"] = self.stereo_bpf(
                    fm_demod, st.channel_tail)
            else:
                channel, c["channel_tail"] = self.channel_filter(
                    fm_demod, st.channel_tail)
                pilot, c["carrier_tail"] = self.carrier_filter(
                    fm_demod, st.carrier_tail)
        if self.rds:
            if rds_channel is None:
                # channel extraction 54-60 kHz (reference
                # src/project.cpp:245)
                rds_channel, c["rds_channel_tail"] = (
                    self.rds_channel_filter(fm_demod, rs.channel_tail))
            # squaring nonlinearity -> 114 kHz line (project.cpp:248-252)
            rds_carrier_in, c["rds_carrier_tail"] = self.rds_carrier_filter(
                rds_channel * rds_channel, rs.carrier_tail)
        return channel, pilot, rds_channel, rds_carrier_in

    def _pll(self, x, st, **kw):
        """One carrier through the selected engine: (nco, new_state)."""
        with scope(f"pll_{self.pll_impl}"):
            return self._pll_inner(x, st, **kw)

    def _pll_inner(self, x, st, **kw):
        if self.compat_pll:
            return pll(x, st, wrap_phase=False, lag_correction=False, **kw)
        if self.pll_impl == "ff":
            return pll_feedforward(x, st, window=self.pll_window, **kw)
        if self.pll_impl in ("pallas", "pallas_chunked"):
            from sdr_tpu_torch.ops.cuda.pll_kernel import (
                pll_pallas, pll_pallas_chunked)
            if self.pll_impl == "pallas":
                return pll_pallas(x, st, **kw)
            return pll_pallas_chunked(x, st, chunk=self.pll_chunk, **kw)
        if self.pll_impl == "chunked":
            return pll_chunked(x, st, chunk=self.pll_chunk, **kw)
        return pll(x, st, wrap_phase=self.pll_wrap_phase, **kw)

    def _rds(self, rs, rds_channel, c):
        """All-pass delay, mixer, resampler to SPS*2375 and the RRC."""
        if c["baseband"] is not None:
            baseband, delay = c["baseband"], c["delay"]
        else:
            # all-pass delay aligning channel to carrier (project.cpp:260)
            chan_delayed, delay = delay_line(rds_channel, rs.delay)
            baseband = mixer(c["nco_r"], chan_delayed)
        with scope("rds_resample"):
            resampled, lpf_tail = self.rds_resampler(baseband,
                                                     rs.lpf_resamp_tail)
        with scope("rds_rrc"):
            soft, rrc_tail = self.rds_rrc(resampled, rs.rrc_tail)
        return RdsState(c["rds_channel_tail"], c["rds_carrier_tail"],
                        c["pll_r"], delay, lpf_tail, rrc_tail), soft

    # -------------------------------------------------------------- execution
    def block_align_u8(self) -> int:
        """Minimum valid step size in u8 bytes: every decimation must divide
        cleanly and every filter tail must fit."""
        cfg = self.cfg
        align = 2 * cfg.rf_decim * cfg.audio_decim
        if self.rds:
            align = int(np.lcm(align, 2 * cfg.rf_decim * self.rds_if_align))
        if (self.stereo or self.rds) and self.pll_impl == "ff":
            # the feedforward window grid stays block-size independent
            align = int(np.lcm(align, 2 * cfg.rf_decim * self.pll_window))
        if self._ifbank is not None:
            from sdr_tpu_torch.ops.cuda.ifbank_kernel import OUT_TILE
            align = int(np.lcm(align, 2 * cfg.rf_decim * OUT_TILE))
        if self.fused_frontend:
            # the reference's fused front end consumes whole out_tile tiles
            align = int(np.lcm(align, 2 * cfg.rf_decim * self.fe_out_tile))
        min_if = self.audio_resampler.state_len
        while align // (2 * cfg.rf_decim) < min_if:
            align *= 2
        return align

    def block_size_u8(self, blocks_per_step: int = 1) -> int:
        """u8 bytes per step; multiple reference blocks may be fused into
        one step (outputs are split-invariant)."""
        base = int(np.lcm(self.cfg.block_size_u8, self.block_align_u8()))
        return base * blocks_per_step

    def run(self, iq_u8: np.ndarray | torch.Tensor, *,
            blocks_per_step: int = 1, state: ReceiverState | None = None,
            unroll: int = 1):
        """Run the receiver over a whole capture (..., n) of u8.

        The capture is consumed in block_size_u8(blocks_per_step) steps,
        then the remainder is flushed with one extra step at the finest
        aligned size; only a sub-`block_align_u8` tail is dropped.
        Returns (outputs, final_state), outputs concatenated over time
        (per-step scalars such as rssi_db gain a trailing step axis).
        `unroll` (the reference's scan unrolling) is accepted and has no
        effect: the steps run eagerly.
        """
        with scope("receiver.run"):
            iq_u8 = host_tensor(iq_u8)
            *lead, n = iq_u8.shape
            if state is None:
                state = self.init_state(tuple(lead))
            chunks: dict[str, list[torch.Tensor]] = {}
            for off, size in self.spans(n, blocks_per_step):
                blk = to_device(iq_u8[..., off:off + size], self.device)
                state, out = self.step(state, blk)
                for k, v in out.items():
                    chunks.setdefault(k, []).append(v)
            return concat_steps(chunks, len(lead)), state

    def spans(self, n: int, blocks_per_step: int = 1
              ) -> list[tuple[int, int]]:
        """`run`'s steps over n bytes as (offset, size): whole
        block_size_u8(blocks_per_step) steps, then the remainder at the
        finest aligned size."""
        bs = self.block_size_u8(blocks_per_step)
        align = self.block_align_u8()
        if bs > n:
            bs = (n // align) * align
            if bs == 0:
                raise ValueError(f"capture of {n} bytes shorter than "
                                 f"minimum block {align}")
        nblocks = n // bs
        tail_bs = ((n - nblocks * bs) // align) * align
        spans = [(b * bs, bs) for b in range(nblocks)]
        if tail_bs:
            spans.append((nblocks * bs, tail_bs))
        return spans


def concat_steps(chunks: dict[str, list[torch.Tensor]], n_lead: int
                 ) -> dict[str, torch.Tensor]:
    """Per-step outputs {key: [step outputs]} over `n_lead` batch axes ->
    streams concatenated over time, per-step scalars (rssi_db) stacked on
    a trailing step axis."""
    return {k: torch.stack(vs, dim=-1) if vs[0].ndim == n_lead
            else torch.cat(vs, dim=-1) for k, vs in chunks.items()}
