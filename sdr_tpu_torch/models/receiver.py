"""The FM broadcast receiver, mono path: `step(state, iq_block)`.

Port of sdr_tpu/models/receiver.py (mono only).  The chain per block:
  u8 IQ --decode--> I,Q --LPF 100k + decim--> IF --discriminator--> fm_demod
        --U/D resample LPF 16k--> mono audio        (reference project.cpp:146)
With a fused front end the first three stages are one CUDA kernel
(ops/cuda/frontend_kernel.py); the rest is plain PyTorch.  PyTorch runs
eagerly, so `run` is a Python loop over blocks where the reference scans.
Independent stations batch over leading axes of the u8 block.

The reference's TPU-only choices map as follows: `conv_engine='tiled'`
picks a TPU lowering of the same FIR, so both engines run one conv here
(the tiled engine keeps its bf16 tail storage); `fe_out_tile` and
`fe_sub_tiles` tile the TPU kernel.  They are accepted so that the
reference's configurations construct, and `fe_out_tile` enters
`block_align_u8`, so `run` consumes and emits exactly as many samples as
the reference; `fe_sub_tiles` has no effect here.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.config import ModeConfig, get_mode
from sdr_tpu_torch.io.stream import decode_u8_iq
from sdr_tpu_torch.models.state import FrontEndState, MonoState, ReceiverState
from sdr_tpu_torch.ops import firdes
from sdr_tpu_torch.ops.demod import fm_arctan, fm_discriminator
from sdr_tpu_torch.ops.resample import PolyphaseResampler

# fused_frontend value -> coefficient engine of the CUDA front end
_FE_ENGINES = {True: "f32", "f32": "f32", "bf16": "bf16", "int8": "int8",
               "int8x2": "int8x2"}


class Receiver:
    """Configured mono receiver for one operating mode.

    Args (as sdr_tpu's Receiver; only the mono path is ported):
      mode: 0-3 or a custom ModeConfig.
      emit_if: include the demodulated IF ('fm_demod') in the outputs.
      emit_rssi: include the per-block RSSI ('rssi_db', dBFS of the IF).
      demod: 'discriminator' | 'arctan'.
      fused_frontend: False | True/'f32' | 'bf16' | 'int8' | 'int8x2' —
           the u8 decode + channel filter + decimation as one CUDA kernel
           in one of the reference's coefficient engines.
      fe_out_tile, fe_sub_tiles: the reference's TPU tiling (see module
           docstring); fe_out_tile sets the block alignment.
      fuse_demod: fold the discriminator into the front-end kernel.
      conv_engine: 'conv' | 'tiled'; conv_dtype: 'f32' | 'bf16'.
      device: where the state lives and the chain runs.
    """

    def __init__(self, mode: int | ModeConfig = 0, *, stereo: bool = False,
                 rds: bool = False, emit_if: bool = False,
                 emit_rssi: bool = False, demod: str = "discriminator",
                 fused_frontend: bool | str = False, fe_out_tile: int = 128,
                 fe_sub_tiles: int = 2, fuse_demod: bool = True,
                 filter_engine: str = "direct", conv_engine: str = "conv",
                 conv_dtype: str = "f32",
                 deemphasis_us: float | None = None,
                 device: torch.device | str = "cpu"):
        if stereo:
            raise NotImplementedError(
                "stereo is not ported yet (ROADMAP.md queue A item 7)")
        if rds:
            raise NotImplementedError(
                "RDS is not ported yet (ROADMAP.md queue A items 7-8)")
        if filter_engine != "direct":
            raise NotImplementedError(
                "filter_engine='fft' is not ported yet "
                "(ROADMAP.md queue A item 9)")
        if deemphasis_us is not None:
            raise NotImplementedError(
                "de-emphasis is not ported yet (ROADMAP.md queue A item 7)")
        if demod not in ("discriminator", "arctan"):
            raise ValueError(f"demod {demod!r}")
        if conv_engine not in ("conv", "tiled"):
            raise ValueError(f"conv_engine {conv_engine!r}")
        if conv_dtype not in ("f32", "bf16"):
            raise ValueError(f"conv_dtype {conv_dtype!r}")
        if fused_frontend and fused_frontend not in _FE_ENGINES:
            raise ValueError(f"fused_frontend {fused_frontend!r}")
        cfg = get_mode(mode) if isinstance(mode, int) else mode
        self.cfg = cfg
        self.emit_if = emit_if
        self.emit_rssi = emit_rssi
        self.demod = demod
        self.device = torch.device(device)
        cdt = torch.bfloat16 if conv_dtype == "bf16" else torch.float32
        # the tiled engine stores its input and tail at its compute dtype
        store = cdt if conv_engine == "tiled" else None

        def dec_filter(coeff, down=1, up=1):
            return PolyphaseResampler(coeff, up, down, compute_dtype=cdt,
                                      store_dtype=store, device=self.device)

        rf_coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
        audio_coeff = firdes.lowpass(cfg.if_fs * cfg.audio_interp,
                                     cfg.audio_fc, cfg.audio_taps,
                                     cfg.audio_gain)
        self.rf_resampler = dec_filter(rf_coeff, cfg.rf_decim)
        self.fused_frontend = bool(fused_frontend)
        # bf16 materialization: the fm stream is stored at bf16 iff the
        # downstream compute is bf16 and the front end rounds at least as
        # coarsely (reference receiver.py:228-229)
        self._mat_bf16 = (fused_frontend in ("bf16", "int8")
                          and conv_dtype == "bf16")
        self.fe_out_tile = int(fe_out_tile)
        if fused_frontend:
            from sdr_tpu_torch.ops.cuda.frontend_kernel import FusedFrontend
            self._fused_fe = FusedFrontend(
                rf_coeff, cfg.rf_decim,
                compute_dtype=_FE_ENGINES[fused_frontend],
                out_dtype=torch.bfloat16 if self._mat_bf16 else torch.float32,
                device=self.device)
        self._fuse_demod = bool(fused_frontend and fuse_demod
                                and demod == "discriminator")
        self.audio_resampler = dec_filter(audio_coeff, cfg.audio_decim,
                                          cfg.audio_interp)

    # ------------------------------------------------------------------ state
    def init_state(self, batch_shape: tuple[int, ...] = ()) -> ReceiverState:
        def zeros(shape=()):
            return torch.zeros(batch_shape + shape, dtype=torch.float32,
                               device=self.device)
        if self.fused_frontend:
            # the fused kernel carries the raw u8 tail (value 128 == 0.0)
            front = FrontEndState(self._fused_fe.init_state(batch_shape),
                                  zeros((0,)), zeros(), zeros())
        else:
            front = FrontEndState(self.rf_resampler.init_state(batch_shape),
                                  self.rf_resampler.init_state(batch_shape),
                                  zeros(), zeros())
        mono = MonoState(self.audio_resampler.init_state(batch_shape),
                         zeros())
        return ReceiverState(front=front, mono=mono)

    # ------------------------------------------------------------------- step
    def step(self, state: ReceiverState, iq_u8: torch.Tensor
             ) -> tuple[ReceiverState, dict[str, torch.Tensor]]:
        """Process one u8 IQ block (..., block) -> (new_state, outputs)."""
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
        """Downstream of the discriminator: RSSI and the mono path."""
        outputs: dict[str, torch.Tensor] = {}
        if rssi_power is not None:
            outputs["rssi_db"] = 10.0 * torch.log10(rssi_power + 1e-12)
        if self.emit_if:
            outputs["fm_demod"] = fm_demod
        mono_audio, audio_tail = self.audio_resampler(fm_demod,
                                                      state.mono.audio_tail)
        outputs["mono"] = mono_audio
        mono = MonoState(audio_tail=audio_tail, deemph=state.mono.deemph)
        return ReceiverState(front=front, mono=mono), outputs

    # -------------------------------------------------------------- execution
    def block_align_u8(self) -> int:
        """Minimum valid step size in u8 bytes: every decimation must divide
        cleanly and every filter tail must fit."""
        align = 2 * self.cfg.rf_decim * self.cfg.audio_decim
        if self.fused_frontend:
            # the reference's fused front end consumes whole out_tile tiles
            align = int(np.lcm(align,
                               2 * self.cfg.rf_decim * self.fe_out_tile))
        min_if = self.audio_resampler.state_len
        while align // (2 * self.cfg.rf_decim) < min_if:
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
