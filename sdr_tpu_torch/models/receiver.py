"""The FM broadcast receiver: `step(state, iq_block)`.

Port of sdr_tpu/models/receiver.py.  The chain per block:
  u8 IQ --decode--> I,Q --LPF 100k + decim--> IF --discriminator--> fm_demod
    mono:   fm_demod --U/D resample LPF 16k--> audio       (project.cpp:146)
    stereo: fm_demod --BPF 22-54k--> L-R DSB --mixer(carrier 19k x2)-->
            --U/D resample LPF 16k--> stereo; L/R matrix w/ delayed mono
    rds:    fm_demod --BPF 54-60k--> channel --(square, BPF 113.5-114.5k,
            carrier 114k scale .5)--> 57k carrier --mixer--> baseband
            --LPF 3k + U/D resample--> SPS*2375 --RRC--> soft waveform
Ported: the mono path in every engine, and the stereo and RDS branches on
the feedforward carrier engine (`pll_impl='ff'`).  With the fused front
end, the fused IF bank and the fused synthesis the hot stages are CUDA
kernels (ops/cuda/); the rest is plain PyTorch.  PyTorch runs eagerly, so
`run` is a Python loop over blocks where the reference scans.  Independent
stations batch over leading axes of the u8 block.

The reference's TPU-only choices map as follows: `conv_engine='tiled'`
picks a TPU lowering of the same FIR, so both engines run one conv here
(the tiled engine keeps its bf16 tail storage); `fe_out_tile`,
`fe_sub_tiles` and the IF bank's tile tile the TPU kernels.  They are
accepted so that the reference's configurations construct, and the tiles
enter `block_align_u8`, so `run` consumes and emits exactly as many
samples as the reference; `fe_sub_tiles` has no effect here.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.config import ModeConfig, get_mode
from sdr_tpu_torch.io.stream import decode_u8_iq
from sdr_tpu_torch.models.state import (FrontEndState, MonoState, RdsState,
                                        ReceiverState, StereoState)
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.demod import fm_arctan, fm_discriminator
from sdr_tpu_torch.ops.pll import (pll_feedforward,
                                   pll_feedforward_from_sums,
                                   pll_feedforward_multi,
                                   pll_ff_params_from_sums, pll_init)
from sdr_tpu_torch.ops.pointwise import delay_line, lr_matrix, mixer
from sdr_tpu_torch.ops.resample import MultiFIR, PolyphaseResampler

# fused_frontend value -> coefficient engine of the CUDA front end
_FE_ENGINES = {True: "f32", "f32": "f32", "bf16": "bf16", "int8": "int8",
               "int8x2": "int8x2"}
_PLL_SLICE = "ROADMAP.md queue B items 8-10, the PLL slice"


class Receiver:
    """Configured receiver for one operating mode.

    Args (as sdr_tpu's Receiver):
      mode: 0-3 or a custom ModeConfig.
      stereo, rds: decode the stereo subcarrier / the RDS subcarrier to an
           RRC-filtered soft waveform (rds needs a mode with rds_sps).
      pll_impl: carrier engine of stereo and RDS.  Only 'ff' (feedforward)
           is ported; the loop engines ('auto' = 'scan', 'chunked',
           'pallas', 'pallas_chunked'), their tuning (pll_chunk,
           pll_wrap_phase, rds_pll_bandwidth) and compat_pll wait for the
           PLL slice.
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
           IF band-pass stages and the carrier estimators' mix sums as one
           CUDA kernel (ops/cuda/ifbank_kernel.py).
      fused_synth: with the fused IF bank, carrier synthesis + RDS delay +
           both mixers as one CUDA kernel (ops/cuda/ffmix_kernel.py); with
           conv_engine='tiled' in the integer-ratio modes it also brings
           the audio-pair kernel (ops/cuda/audio_kernel.py).
      conv_engine: 'conv' | 'tiled'; conv_dtype: 'f32' | 'bf16'.
      stereo_phase_adjust: radians added to the 38 kHz carrier phase.
      device: where the state lives and the chain runs.
    filter_engine='fft', deemphasis_us and compat_shared_audio_state raise
    NotImplementedError naming their ROADMAP.md item.
    """

    def __init__(self, mode: int | ModeConfig = 0, *, stereo: bool = False,
                 rds: bool = False, compat_shared_audio_state: bool = False,
                 rds_rrc_taps: int = 151, emit_if: bool = False,
                 emit_rssi: bool = False, pll_impl: str = "auto",
                 pll_window: int = 256,
                 demod: str = "discriminator",
                 fused_frontend: bool | str = False, fe_out_tile: int = 128,
                 fe_sub_tiles: int = 2, fuse_demod: bool = True,
                 fused_ifbank: bool | str = False,
                 filter_engine: str = "direct", conv_engine: str = "conv",
                 conv_dtype: str = "f32", stereo_phase_adjust: float = 0.0,
                 compat_pll: bool = False,
                 deemphasis_us: float | None = None,
                 fused_synth: bool = True,
                 device: torch.device | str = "cpu"):
        cfg = get_mode(mode) if isinstance(mode, int) else mode
        if rds and cfg.rds_sps is None:
            raise ValueError(f"mode {cfg.mode} does not support RDS")
        if pll_impl == "auto":
            pll_impl = "scan"
        if pll_impl not in ("scan", "pallas", "chunked", "pallas_chunked",
                            "ff"):
            raise ValueError(f"pll_impl {pll_impl!r}")
        if (stereo or rds) and (pll_impl != "ff" or compat_pll):
            raise NotImplementedError(
                f"stereo and RDS run on pll_impl='ff' only; the carrier "
                f"loop engines (pll_impl={pll_impl!r}, compat_pll) are not "
                f"ported yet ({_PLL_SLICE})")
        if filter_engine != "direct":
            raise NotImplementedError(
                "filter_engine='fft' is not ported yet "
                "(ROADMAP.md queue A item 9)")
        if deemphasis_us is not None:
            raise NotImplementedError(
                "de-emphasis is not ported yet (ROADMAP.md queue A item 7)")
        if compat_shared_audio_state and stereo:
            raise NotImplementedError(
                "compat_shared_audio_state is not ported yet "
                "(ROADMAP.md queue A item 7)")
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
        self.pll_window = int(pll_window)
        self.stereo_phase_adjust = float(stereo_phase_adjust)
        self.device = torch.device(device)
        cdt = torch.bfloat16 if conv_dtype == "bf16" else torch.float32
        # the tiled engine stores its input and tail at its compute dtype
        store = cdt if conv_engine == "tiled" else None
        if_fs = cfg.if_fs

        def dec_filter(coeff, down=1, up=1):
            return PolyphaseResampler(coeff, up, down, compute_dtype=cdt,
                                      store_dtype=store, device=self.device)

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

        # IF band-pass stages reading fm_demod: one conv for all of them
        self.if_bpf3 = self.stereo_bpf = None
        if stereo:
            chan_coeff = firdes.bandpass(if_fs, cfg.stereo_lo, cfg.stereo_hi,
                                         cfg.bp_taps)
            pilot_coeff = firdes.bandpass(if_fs, cfg.pilot_lo, cfg.pilot_hi,
                                          cfg.bp_taps)
            if rds:
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
        # the fused IF bank with in-kernel mix sums (feedforward chain)
        self._ifbank = None
        self._ifbank_mix = False
        if fused_ifbank and stereo and rds:
            from sdr_tpu_torch.ops.cuda.ifbank_kernel import FusedIFBankMix
            bank_coeffs = (
                firdes.bandpass(if_fs, cfg.stereo_lo, cfg.stereo_hi,
                                cfg.bp_taps),
                firdes.bandpass(if_fs, cfg.pilot_lo, cfg.pilot_hi,
                                cfg.bp_taps),
                firdes.bandpass(if_fs, cfg.rds_lo, cfg.rds_hi, cfg.bp_taps),
                firdes.bandpass(if_fs, cfg.rds_carrier_lo,
                                cfg.rds_carrier_hi, cfg.bp_taps))
            bf16_bank = fused_ifbank == "bf16"
            self._ifbank = FusedIFBankMix(
                *bank_coeffs, window=self.pll_window,
                pilot_freq=float(cfg.pilot_freq),
                rds_carrier_freq=float(cfg.rds_carrier_freq),
                fs=float(if_fs),
                compute_dtype=torch.bfloat16 if bf16_bank else torch.float32,
                out_dtype=(torch.bfloat16 if bf16_bank and conv_dtype == "bf16"
                           else None),
                device=self.device)
            self._ifbank_mix = True
        # post-IF-bank materialization (reference receiver.py:324-326)
        self._mat_bf16_post = (self._ifbank is not None
                               and fused_ifbank == "bf16"
                               and conv_dtype == "bf16")
        self._post_dtype = (torch.bfloat16 if self._mat_bf16_post
                            else torch.float32)
        self._fused_synth = bool(fused_synth) and self._ifbank_mix
        # the audio-pair kernel: integer-ratio modes only
        self._audio_pair = None
        if (self._fused_synth and conv_engine == "tiled"
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
            self.rds_resampler = dec_filter(rds_lpf, d, u)
            self.rds_rrc = dec_filter(rrc)
            # group-delay alignment of the channel path against the
            # square -> BPF(51 taps) -> carrier path (spec Fig 10 all-pass)
            self.rds_delay = (cfg.bp_taps - 1) // 2
            # IF samples per block must make symbols integral
            g = np.gcd(cfg.rds_sps, u)
            self.rds_if_align = d * cfg.rds_sps // g

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
            if self._ifbank is not None:
                # one carried raw-fm context, in the fm stream's dtype
                ch_tail = self._ifbank.init_state(batch_shape).to(
                    self._fm_dtype)
            else:
                # the reference starts this tail at float32 and carries it
                # in the fm stream's dtype from the first step on; here it
                # starts there (ROADMAP.md queue C)
                bpf = self.if_bpf3 or self.stereo_bpf
                ch_tail = bpf.init_state(batch_shape).to(self._fm_dtype)
            stereo = StereoState(
                channel_tail=ch_tail, carrier_tail=zeros((0,)),
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
        if self.fused_frontend and self._fuse_demod:
            fm_demod, i_tail, prev_i, prev_q, psum = self._fused_fe.demod_call(
                iq_u8, state.front.i_tail, state.front.prev_i,
                state.front.prev_q)
            front = FrontEndState(i_tail, state.front.q_tail, prev_i, prev_q)
            rssi_power = (psum / fm_demod.shape[-1]
                          if self.emit_rssi else None)
            return self._post_demod(state, fm_demod, front, rssi_power)
        if self.fused_frontend:
            i_ds, q_ds, i_tail = self._fused_fe(iq_u8, state.front.i_tail)
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
        i_ds, i_tail = self.rf_resampler(i_raw, state.front.i_tail)
        q_ds, q_tail = self.rf_resampler(q_raw, state.front.q_tail)
        return self._finish_step(state, i_ds, q_ds, i_tail, q_tail)

    def _finish_step(self, state, i_ds, q_ds, i_tail, q_tail):
        if self.demod == "arctan":
            # prev_i slot carries the phase; prev_q is unused
            fm_demod, prev_phase = fm_arctan(i_ds, q_ds, state.front.prev_i)
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
        if not self.stereo:
            mono_audio, audio_tail = self.audio_resampler(
                fm_demod, state.mono.audio_tail)
            outputs["mono"] = mono_audio
            mono = MonoState(audio_tail=audio_tail, deemph=state.mono.deemph)
        rds_state = None
        if self.stereo or self.rds:
            channel, rds_channel, carriers = self._if_bands(state, fm_demod)
        if self.rds:
            rds_state, outputs["rds_soft"] = self._rds(state.rds, rds_channel,
                                                       carriers)
        if not self.stereo:
            return ReceiverState(front=front, mono=mono,
                                 rds=rds_state), outputs
        st = state.stereo
        mixed = carriers["mixed"]
        if mixed is None:
            mixed = mixer(channel, carriers["nco_s"])
        if self._audio_pair is not None:
            # both IF->audio FIRs in one CUDA launch
            mono_audio, stereo_audio, audio_tail, stereo_audio_tail = (
                self._audio_pair(fm_demod, mixed, state.mono.audio_tail,
                                 st.stereo_audio_tail))
        else:
            # one conv for both IF->audio resamples (same filter bank)
            pair, pair_tails = self.audio_resampler(
                torch.stack([fm_demod, mixed.to(fm_demod.dtype)]),
                torch.stack([state.mono.audio_tail, st.stereo_audio_tail]))
            mono_audio, stereo_audio = pair[0], pair[1]
            audio_tail, stereo_audio_tail = pair_tails[0], pair_tails[1]
        outputs["mono"] = mono_audio
        # delayed mono against the BPF group delay (src/project.cpp:152-159)
        mono_shift, mono_delay = delay_line(mono_audio, st.mono_delay)
        outputs["left"], outputs["right"] = lr_matrix(mono_shift,
                                                      stereo_audio)
        stereo_state = StereoState(carriers["channel_tail"], st.carrier_tail,
                                   carriers["pll_s"], mono_delay,
                                   stereo_audio_tail, st.deemph_l,
                                   st.deemph_r)
        mono = MonoState(audio_tail=audio_tail, deemph=state.mono.deemph)
        return ReceiverState(front=front, mono=mono, stereo=stereo_state,
                             rds=rds_state), outputs

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
                 nco_r=None, pll_s=None, pll_r=None, channel_tail=None)
        channel = rds_channel = pilot = rds_carrier_in = None
        rs = state.rds
        if self.rds:
            c["rds_channel_tail"] = rs.channel_tail
            c["rds_carrier_tail"] = rs.carrier_tail
        if self.stereo:
            st = state.stereo
            if self._ifbank_mix:
                (channel, rds_channel, zp, zr,
                 c["channel_tail"]) = self._ifbank.mix_call(fm_demod,
                                                            st.channel_tail)
            elif self.if_bpf3 is not None:
                (channel, pilot, rds_channel), c["channel_tail"] = (
                    self.if_bpf3(fm_demod, st.channel_tail))
            else:
                (channel, pilot), c["channel_tail"] = self.stereo_bpf(
                    fm_demod, st.channel_tail)
        if self.rds and rds_channel is None:
            # channel extraction 54-60 kHz (reference src/project.cpp:245)
            rds_channel, c["rds_channel_tail"] = self.rds_channel_filter(
                fm_demod, rs.channel_tail)
        if self.rds and not self._ifbank_mix:
            # squaring nonlinearity -> 114 kHz line (project.cpp:248-252)
            rds_carrier_in, c["rds_carrier_tail"] = self.rds_carrier_filter(
                rds_channel * rds_channel, rs.carrier_tail)

        if self._fused_synth:
            # estimate only (per-window math), then one CUDA pass
            # synthesizes both carriers, delays the RDS channel and mixes
            window = self._ifbank.window
            params_s, c["pll_s"] = pll_ff_params_from_sums(
                *zp, st.pll, freq=pilot_freq, fs=fs, n=n_if, nco_scale=2.0,
                window=window)
            params_r, c["pll_r"] = pll_ff_params_from_sums(
                *zr, rs.pll, freq=rds_freq, fs=fs, n=n_if, nco_scale=0.5,
                window=window)
            from sdr_tpu_torch.ops.cuda.ffmix_kernel import ffmix
            c["mixed"], c["baseband"] = ffmix(
                channel, rds_channel, rs.delay, params_s, params_r, n=n_if,
                window=window, pilot_freq=pilot_freq, rds_freq=rds_freq,
                fs=fs, delay=self.rds_delay, phase_adjust=adj,
                out_dtype=odt)
            c["delay"] = rds_channel[..., -128:].clone()
        elif self._ifbank_mix:
            window = self._ifbank.window
            c["nco_s"], c["pll_s"] = pll_feedforward_from_sums(
                *zp, st.pll, freq=pilot_freq, fs=fs, n=n_if, nco_scale=2.0,
                phase_adjust=adj, window=window, out_dtype=odt)
            c["nco_r"], c["pll_r"] = pll_feedforward_from_sums(
                *zr, rs.pll, freq=rds_freq, fs=fs, n=n_if, nco_scale=0.5,
                window=window, out_dtype=odt)
        elif self.stereo and self.rds:
            (c["nco_s"], c["nco_r"]), (c["pll_s"], c["pll_r"]) = (
                pll_feedforward_multi(
                    (pilot, rds_carrier_in), (st.pll, rs.pll),
                    params=((pilot_freq, fs, 2.0, adj),
                            (rds_freq, fs, 0.5, 0.0)),
                    window=self.pll_window, out_dtype=odt))
        else:
            if self.stereo:
                c["nco_s"], c["pll_s"] = pll_feedforward(
                    pilot, st.pll, freq=pilot_freq, fs=fs, nco_scale=2.0,
                    phase_adjust=adj, window=self.pll_window)
            if self.rds:
                c["nco_r"], c["pll_r"] = pll_feedforward(
                    rds_carrier_in, rs.pll, freq=rds_freq, fs=fs,
                    nco_scale=0.5, window=self.pll_window)
        return channel, rds_channel, c

    def _rds(self, rs, rds_channel, c):
        """All-pass delay, mixer, resampler to SPS*2375 and the RRC."""
        if c["baseband"] is not None:
            baseband, delay = c["baseband"], c["delay"]
        else:
            # all-pass delay aligning channel to carrier (project.cpp:260)
            chan_delayed, delay = delay_line(rds_channel, rs.delay)
            baseband = mixer(c["nco_r"], chan_delayed)
        resampled, lpf_tail = self.rds_resampler(baseband, rs.lpf_resamp_tail)
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
            blocks_per_step: int = 1, state: ReceiverState | None = None):
        """Run the receiver over a whole capture (..., n) of u8.

        The capture is consumed in block_size_u8(blocks_per_step) steps,
        then the remainder is flushed with one extra step at the finest
        aligned size; only a sub-`block_align_u8` tail is dropped.
        Returns (outputs, final_state), outputs concatenated over time
        (per-step scalars such as rssi_db gain a trailing step axis).
        """
        iq_u8 = torch.as_tensor(iq_u8)
        bs = self.block_size_u8(blocks_per_step)
        *lead, n = iq_u8.shape
        align = self.block_align_u8()
        if bs > n:
            bs = (n // align) * align
            if bs == 0:
                raise ValueError(f"capture of {n} bytes shorter than "
                                 f"minimum block {align}")
        nblocks = n // bs
        tail_bs = ((n - nblocks * bs) // align) * align
        if state is None:
            state = self.init_state(tuple(lead))
        spans = [(b * bs, bs) for b in range(nblocks)]
        if tail_bs:
            spans.append((nblocks * bs, tail_bs))
        chunks: dict[str, list[torch.Tensor]] = {}
        for off, size in spans:
            blk = iq_u8[..., off:off + size].to(self.device).contiguous()
            state, out = self.step(state, blk)
            for k, v in out.items():
                chunks.setdefault(k, []).append(v)
        outputs = {}
        for k, vs in chunks.items():
            if vs[0].ndim == len(lead):     # per-step scalar
                outputs[k] = torch.stack(vs, dim=-1)
            else:
                outputs[k] = torch.cat(vs, dim=-1)
        return outputs, state
