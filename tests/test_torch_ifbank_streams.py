"""The plain PyTorch version of the four-stream IF bank (FusedIFBank, the
IF bank of the carrier loop engines) against sdr_tpu's Pallas kernel in
interpret mode, on the same numpy-seeded IF stream over two blocks (the
tail carries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_tpu.ops.pallas import ifbank_kernel as jifbank
from sdr_tpu_torch.ops.cuda import ifbank_kernel

from test_torch_stereo_kernels import (BF16, assert_close, bank_coeffs,
                                       fm_blocks, to_np)


@pytest.mark.parametrize("fm_dtype,compute", [
    ("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16")])
def test_ifbank_streams_match_reference(fm_dtype, compute):
    """The four streams (chan, pilot, rds_channel, carrier_in) within 1e-5
    of max|ref|, plus one bf16 ulp where stored at bf16, as B3's test
    holds its streams; the carrier in the bf16 engine within 1e-4 (an ulp
    of the RDS channel can flip a bf16 rounding of its square, as in
    B3's carrier sums)."""
    bf = fm_dtype == "bf16"
    tdt, jdt = (BF16, jnp.bfloat16) if bf else (torch.float32, jnp.float32)
    tcomp = BF16 if compute == "bf16" else torch.float32
    jcomp = jnp.bfloat16 if compute == "bf16" else jnp.float32
    jbank = jifbank.FusedIFBank(*bank_coeffs(), compute_dtype=jcomp,
                                out_dtype=jnp.bfloat16 if bf else None)
    tbank = ifbank_kernel.FusedIFBank(*bank_coeffs(), compute_dtype=tcomp,
                                      out_dtype=BF16 if bf else None,
                                      device="cpu")
    assert ifbank_kernel.OUT_TILE == jbank.out_tile
    blocks = fm_blocks()
    jtail = jbank.init_state((3,))
    ttail = tbank.init_state((3,))
    assert ttail.dtype == tdt and ttail.shape == jtail.shape
    for b in range(blocks.shape[1]):
        jout = jbank(jnp.asarray(blocks[:, b]).astype(jdt), jtail,
                     interpret=True)
        tout = tbank(torch.from_numpy(blocks[:, b]).to(tdt), ttail)
        assert len(tout) == 5
        for k in range(4):
            assert tout[k].dtype == tdt
            rel = 1e-4 if (k == 3 and compute == "bf16") else 1e-5
            assert_close(tout[k], jout[k], rel, bf)
        np.testing.assert_array_equal(to_np(tout[4]), to_np(jout[4]))
        jtail, ttail = jout[4], tout[4]


def test_ifbank_streams_share_the_mix_banks_filters():
    """The four-stream bank and the mix bank run the same FIRs: the mix
    bank's stereo and RDS channels are the four-stream bank's, bit for
    bit."""
    kw = dict(window=256, pilot_freq=19e3, rds_carrier_freq=114e3,
              fs=240e3, compute_dtype=BF16)
    mix = ifbank_kernel.FusedIFBankMix(*bank_coeffs(), **kw, device="cpu")
    four = ifbank_kernel.FusedIFBank(*bank_coeffs(), compute_dtype=BF16,
                                     device="cpu")
    fm = torch.from_numpy(fm_blocks()[:, 0])
    tail = four.init_state((3,))
    a, b = mix.mix_call(fm, tail), four(fm, tail)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[2], rtol=0, atol=0)


def test_ifbank_refuses_a_partial_tile():
    bank = ifbank_kernel.FusedIFBank(*bank_coeffs(), device="cpu")
    with pytest.raises(ValueError, match="tile"):
        bank(torch.zeros(2, 768), bank.init_state((2,)))
