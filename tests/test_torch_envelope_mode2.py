"""The operating envelope on the port in mode 2 (audio 147/800, RDS at
35 samples a symbol, the mode most sensitive to fractional timing):
tests/test_impairments.py's four impaired rows with the `--fast` set,
each held to sdr_tpu's run of it as tests/test_torch_envelope.py holds
mode 0's (within 0.1 dB, the same PI, PS and groups, 45 dB on left,
right and rds_soft).  A file of its own for tier-1 time."""

import pytest

from test_torch_envelope import ROWS, check_row


@pytest.mark.parametrize("row", ROWS)
def test_mode2_row_matches_reference(row):
    check_row(2, row)
