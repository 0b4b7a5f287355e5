"""Receiver streaming state: NamedTuples of tensors.

Port of sdr_tpu/models/state.py, leaf for leaf, so that a state converts
one to one between the two packages (utils/convert.py).  All leaves have
shape batch_shape + (...,).  The stereo and RDS states are not ported yet
(ROADMAP.md queue A items 6-7); their slots stay None.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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


class ReceiverState(NamedTuple):
    front: FrontEndState
    mono: MonoState
    stereo: None = None
    rds: None = None
