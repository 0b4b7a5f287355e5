"""Receiver streaming state: NamedTuples of tensors.

Port of sdr_tpu/models/state.py, leaf for leaf, so that a state converts
one to one between the two packages (utils/convert.py).  All leaves have
shape batch_shape + (...,).  Which leaves are empty (..., 0) and which
dtype a tail has depend on the engines, exactly as in the reference
(`Receiver.init_state`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdr_tpu_torch.ops.pll import PLLState


class FrontEndState(NamedTuple):
    """RF front end: I/Q channelizer tails + discriminator prev sample.

    With the fused front end, i_tail is the carried raw u8 tail (128 bytes,
    value 128 decodes to 0.0) and q_tail is empty."""
    i_tail: torch.Tensor
    q_tail: torch.Tensor
    prev_i: torch.Tensor
    prev_q: torch.Tensor


class MonoState(NamedTuple):
    """Mono path: IF->audio resampler tail + de-emphasis IIR carry."""
    audio_tail: torch.Tensor
    deemph: torch.Tensor


class StereoState(NamedTuple):
    """Stereo path: channel/pilot BPF tails, pilot carrier state, mono delay
    line and a separate stereo audio resampler tail."""
    channel_tail: torch.Tensor
    carrier_tail: torch.Tensor
    pll: PLLState
    mono_delay: torch.Tensor
    stereo_audio_tail: torch.Tensor
    deemph_l: torch.Tensor
    deemph_r: torch.Tensor


class RdsState(NamedTuple):
    """RDS path: channel / carrier BPF tails, 57 kHz carrier state, the
    all-pass delay, and the resampler and RRC tails."""
    channel_tail: torch.Tensor
    carrier_tail: torch.Tensor
    pll: PLLState
    delay: torch.Tensor
    lpf_resamp_tail: torch.Tensor
    rrc_tail: torch.Tensor


class ReceiverState(NamedTuple):
    front: FrontEndState
    mono: MonoState
    stereo: StereoState | None = None
    rds: RdsState | None = None
