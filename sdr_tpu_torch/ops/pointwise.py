"""Pointwise streaming ops: mixer, stereo matrix, delay line.

Port of sdr_tpu/ops/pointwise.py (reference src/filter.cpp:176-199 and the
delay line of src/project.cpp:152-159).  Each keeps its inputs' dtype, as
the reference's weakly typed python-float constants do.
"""

from __future__ import annotations

import torch


def mixer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DSB-SC downconversion product with x2 gain: 2*a*b."""
    return 2.0 * a * b


def lr_matrix(mono: torch.Tensor, stereo: torch.Tensor):
    """L/R de-matrixing: L = (mono + stereo)/2, R = (mono - stereo)/2."""
    return (mono + stereo) * 0.5, (mono - stereo) * 0.5


def delay_line(x: torch.Tensor, state: torch.Tensor):
    """Fixed integer delay with carried tail: out = state ++ x[:-d],
    new_state = x[-d:] (d = state length)."""
    d = state.shape[-1]
    n = x.shape[-1]
    out = torch.cat([state, x[..., :n - d]], dim=-1)
    return out, x[..., n - d:].clone()
