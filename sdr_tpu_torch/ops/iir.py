"""First-order IIR (single pole) as a parallel prefix scan.

Port of sdr_tpu/ops/iir.py: FM de-emphasis (75 us Americas / 50 us
Europe), offered as `Receiver(deemphasis_us=...)`; the reference
receiver's chain omits it.

y[n] = a*y[n-1] + b*x[n] is a linear recurrence.  The per-sample affine
maps y -> a*y + b*x[n] compose associatively, (a2, b2) o (a1, b1) =
(a1*a2, a2*b1 + b2), so their prefix compositions take ceil(log2 N)
elementwise passes (a Hillis-Steele scan) instead of N sequential steps.
The reference evaluates the same compositions with
`jax.lax.associative_scan`, which groups the products in another order,
so the two agree to float32 rounding, not bit for bit.  Streaming state
is the last output sample.
"""

from __future__ import annotations

import numpy as np
import torch


def first_order_iir(x: torch.Tensor, y_prev: torch.Tensor, *,
                    alpha: float):
    """y[n] = (1-alpha)*y[n-1] + alpha*x[n], streaming.

    Args:
      x: (..., N) float32 input block.
      y_prev: (...,) last output of the previous block.
    Returns (y (..., N), new y_prev (...,)).
    """
    x = x.to(torch.float32)
    a = torch.full_like(x, np.float32(1.0 - alpha))
    b = x * torch.tensor(np.float32(alpha), device=x.device)
    n = x.shape[-1]
    d = 1
    while d < n:
        # position i composes its map after the prefix ending at i - d
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]],
                      dim=-1)
        a = torch.cat([a[..., :d], a[..., :-d] * a[..., d:]], dim=-1)
        d *= 2
    y = a * y_prev[..., None] + b
    return y, y[..., -1].clone()


def deemphasis_alpha(fs: float, tau_us: float) -> float:
    """Discretized pole for an RC de-emphasis with time constant tau."""
    return float(1.0 - np.exp(-1.0 / (fs * tau_us * 1e-6)))
