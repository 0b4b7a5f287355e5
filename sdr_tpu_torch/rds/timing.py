"""RDS clock/data recovery (CDR): branchless sampling-phase selection.

Port of sdr_tpu/rds/timing.py.  The spec asks for the best sampling
instant per 2375 Hz symbol out of SPS candidates (spec p.14): reshape the
RRC-filtered waveform to (nsym, SPS), score each phase by the mean
|amplitude| at its sampling instants, and take the winning column.  Both
functions take tensors batched over leading axes and run where the
tensor lies.
"""

from __future__ import annotations

import torch


def recover_symbols(soft: torch.Tensor, sps: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick the max-energy sampling phase and slice symbols.

    Args:
      soft: (..., n) RRC-filtered baseband; a trailing n % sps is dropped.
    Returns:
      (symbols (..., n // sps), phase (...,) int32 chosen sampling
      offset).  A tie between phases goes to the first, as jnp.argmax
      decides it.
    """
    nsym = soft.shape[-1] // sps
    grid = soft[..., : nsym * sps].reshape(*soft.shape[:-1], nsym, sps)
    score = grid.abs().mean(dim=-2)                     # (..., sps)
    phase = torch.argmax(score, dim=-1)                 # (...,)
    idx = phase[..., None, None].expand(*grid.shape[:-1], 1)
    symbols = torch.gather(grid, -1, idx)[..., 0]
    return symbols, phase.to(torch.int32)


def manchester_pairing_score(symbols: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score both biphase pairing parities.

    RDS transmits each bit as two opposite-polarity symbols; the receiver
    must decide whether pairs start at even or odd symbol indices.  The
    correct parity maximizes |s0 - s1| summed over pairs (opposite-sign
    pairs add, same-sign cancel).  Returns (score_even, score_odd).
    """
    n = symbols.shape[-1] - (symbols.shape[-1] % 2)
    even = symbols[..., :n]
    s_even = (even[..., 0::2] - even[..., 1::2]).abs().sum(dim=-1)
    m = symbols.shape[-1] - 1
    m -= m % 2
    odd = symbols[..., 1:1 + m]
    s_odd = (odd[..., 0::2] - odd[..., 1::2]).abs().sum(dim=-1)
    return s_even, s_odd
