"""Checkpoints cross between the packages: the reference runs half a
capture and saves, the port loads and runs the rest, and the joined
output equals the reference's uninterrupted run within the port's
tolerance for the profile; the other way round, the reference's
load_state takes a file the port wrote and continues."""

import jax
import numpy as np
import pytest

from sdr_tpu.models.receiver import Receiver as JaxReceiver
from sdr_tpu.utils import checkpoint as jckpt
from sdr_tpu_torch.models.receiver import Receiver
from sdr_tpu_torch.utils.checkpoint import load_state, save_state

from test_torch_checkpoint import CLI_PROFILES
from test_torch_stereo_receiver import capture, jax_run, snr_db

# mono default; stereo + RDS --fast (bf16 and u8 leaves); stereo + RDS in
# the default profile (the carrier loops)
CROSS = ["mono", "stereo_rds_fast", "stereo_rds"]


def check_joined(profile, joined, want):
    """mono within 1e-5 of max|ref| where the chain is float32, 80 dB in
    the bf16 chain; left / right / rds_soft at 45 dB, where a bf16
    rounding or a carrier loop's feedback moves them
    (test_torch_stereo_receiver's bounds for these profiles)."""
    bf16 = CLI_PROFILES[profile].get("conv_dtype") == "bf16"
    for k, w in want.items():
        got = np.asarray(joined[k], np.float64)
        assert got.shape == w.shape, k
        if k == "mono" and not bf16:
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), k
        else:
            floor = 80.0 if k == "mono" else 45.0
            assert snr_db(w, got) > floor, (k, snr_db(w, got))


def split(rx, cap, bps=2):
    bs = rx.block_size_u8(bps)
    half = len(cap) // 2 // bs * bs
    return cap[:half], cap[half:]


@pytest.mark.parametrize("profile", CROSS)
def test_reference_checkpoint_resumes_in_port(tmp_path, profile):
    kw = CLI_PROFILES[profile]
    cap = capture(0, 0.3)
    jrx, rx = JaxReceiver(0, **kw), Receiver(0, **kw, device="cpu")
    first, second = split(rx, cap)
    want, _ = jax_run(jrx, cap, 2)
    out1, jst = jax_run(jrx, first, 2)
    path = str(tmp_path / "ref.npz")
    jckpt.save_state(path, jst)
    out2, _ = rx.run(second, blocks_per_step=2,
                     state=load_state(path, rx.init_state()))
    joined = {k: np.concatenate([out1[k], out2[k].float().numpy()], -1)
              for k in want}
    check_joined(profile, joined, want)


@pytest.mark.parametrize("profile", CROSS)
def test_port_checkpoint_resumes_in_reference(tmp_path, profile):
    kw = CLI_PROFILES[profile]
    cap = capture(0, 0.3)
    jrx, rx = JaxReceiver(0, **kw), Receiver(0, **kw, device="cpu")
    first, second = split(rx, cap)
    want, _ = jax_run(jrx, cap, 2)
    out1, st = rx.run(first, blocks_per_step=2)
    path = str(tmp_path / "port.npz")
    save_state(path, st)
    jst = jckpt.load_state(path, jrx.init_state())
    out2, _ = jax_run(jrx, second, 2, state=jax.tree.map(jax.numpy.asarray,
                                                          jst))
    joined = {k: np.concatenate([out1[k].float().numpy(), out2[k]], -1)
              for k in want}
    check_joined(profile, joined, want)
