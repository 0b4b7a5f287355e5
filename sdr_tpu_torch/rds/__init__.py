"""RDS (Radio Data System) decode stack.

On the device: carrier recovery, resampling and the RRC (in
models/receiver.py), clock-data recovery (rds/timing.py) and the batched
frame-sync syndromes (`matrix.syndromes_sliding_device`).  On the host:
bit decode, frame sync and the application layer (kbit/s rates).
`decode_rds_soft` chains the whole post-RRC path for a finished capture;
the live path, `StreamingRdsDecoder`, is NumPy only.

app, framing, groups, matrix, correct, decode, streaming and tx are copies
of their sdr_tpu/rds/ originals with only the imports renamed (importing
sdr_tpu pulls in jax, which the GPU machine does not have), matrix.py
with `syndromes_sliding_device` in torch, streaming.py with spans and
counters and its CDR's symbols emitted as one array computation a push;
tests/test_torch_host_copies.py pins each copy to its original, and
tests/test_torch_rds_cdr.py the CDR to the original's loop bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sdr_tpu_torch.rds.app import StationInfo, decode_groups, update_info
from sdr_tpu_torch.rds.decode import biphase_decode, differential_decode
from sdr_tpu_torch.rds.framing import extract_groups
from sdr_tpu_torch.rds.streaming import StreamingRdsDecoder
from sdr_tpu_torch.rds.timing import recover_symbols


def decode_rds_soft(soft: np.ndarray | torch.Tensor, sps: int, *,
                    device: torch.device | str = "cuda") -> StationInfo:
    """RRC-filtered soft waveform (n,) at SPS*2375 -> decoded station info.

    The symbol recovery runs on `device`, the bit decode on the host.  A
    float64 array is taken at float32, as the reference takes it."""
    if not isinstance(soft, torch.Tensor):
        soft = torch.from_numpy(np.array(soft))
    if soft.dtype == torch.float64:
        soft = soft.float()
    symbols, _ = recover_symbols(soft.to(device), sps)
    bits_diff, _ = biphase_decode(symbols.float().cpu().numpy())
    bits = differential_decode(bits_diff)
    groups, _ = extract_groups(bits)
    return decode_groups(groups)


__all__ = ["StationInfo", "decode_groups", "update_info", "biphase_decode",
           "differential_decode", "extract_groups", "recover_symbols",
           "decode_rds_soft", "StreamingRdsDecoder"]
