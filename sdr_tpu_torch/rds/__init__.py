"""RDS (Radio Data System) host decode stack.

Copies of sdr_tpu/rds/{app,framing,groups,matrix,correct,decode,streaming,
tx}.py with only the imports renamed (importing sdr_tpu pulls in jax, which
the GPU machine does not have); tests/test_torch_host_copies.py pins each
copy to its original.  Left out: `timing.py` (`recover_symbols`, which
runs on the accelerator in the reference), `matrix.syndromes_sliding_device`
and the offline `decode_rds_soft` built on them (ROADMAP.md queue A item
8).  The live path, `StreamingRdsDecoder`, is NumPy only.
"""

from __future__ import annotations

from sdr_tpu_torch.rds.app import StationInfo, decode_groups, update_info
from sdr_tpu_torch.rds.decode import biphase_decode, differential_decode
from sdr_tpu_torch.rds.framing import extract_groups
from sdr_tpu_torch.rds.streaming import StreamingRdsDecoder

__all__ = ["StationInfo", "decode_groups", "update_info", "biphase_decode",
           "differential_decode", "extract_groups", "StreamingRdsDecoder"]
