"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit) and the roofline bound of a piece of work.

Frozen copy of chip_smoke.py's `HBM_BYTES_S`, `PEAK_OPS_S` and `roofline`
at commit c6f277a (the bound in seconds here, not milliseconds).
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def roofline(nbytes: float, ops: dict) -> tuple[float, str]:
    """(bound_s, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the peak rate
    of their type (summed over the types)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[t] for t, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
