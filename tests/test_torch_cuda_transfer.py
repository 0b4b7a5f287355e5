"""io/stream.py's to_device on the card: a reused host block, registered
as page-locked memory the second time it comes, is copied bit for bit as
the pageable way copies it, and the copy has ended when to_device
returns.  Marked `cuda`; without a CUDA device every test skips.  This
file imports neither jax nor sdr_tpu, so on the GPU machine run it
without the tests' conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_transfer.py
"""

import numpy as np
import pytest
import torch

import sdr_tpu_torch  # noqa: F401  (turns TF32 off)
from sdr_tpu_torch import tx
from sdr_tpu_torch.config import MODES
from sdr_tpu_torch.io import logger
from sdr_tpu_torch.io.stream import to_device
from sdr_tpu_torch.models.receiver import Receiver

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def test_a_registered_copy_equals_the_pageable_one(dev):
    """The second call with the same block registers it (is_pinned holds,
    h2d.pinned counts it) and copies the same bytes as a pageable copy of
    a fresh array with them."""
    a = _noise((128, 640_000), 1)
    logger.reset_stage_times()
    logger.set_tracing(True)
    try:
        first = to_device(a, dev)
        assert not torch.from_numpy(a).is_pinned()
        second = to_device(a, dev)
    finally:
        logger.set_tracing(False)
    _, counters = logger.totals()
    logger.reset_stage_times()
    assert torch.from_numpy(a).is_pinned()
    assert counters == {"h2d.pageable": 1, "h2d.pinned": 1}
    want = torch.from_numpy(a.copy()).to(dev)
    assert torch.equal(first, want) and torch.equal(second, want)


def test_overwriting_the_block_after_the_copy_returns_changes_nothing(dev):
    """to_device returns once the DMA has read the block: the caller may
    refill it at once (as the harness's gather does) and what reached the
    card is the old contents."""
    a = _noise((128, 3_840_000), 2)
    want = a.copy()
    for _ in range(2):
        to_device(a, dev)
    assert torch.from_numpy(a).is_pinned()
    for seed in (3, 4):
        got = to_device(a, dev)
        a[:] = 0
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), torch.from_numpy(want))
        want = _noise(a.shape, seed)
        np.copyto(a, want)


def test_a_refused_registration_copies_pageable_and_leaves_no_error(dev):
    """Where the runtime refuses the range (part of it is page-locked
    already), the copy goes the pageable way, the same bytes arrive, the
    range is not offered again, and the next kernel launches cleanly."""
    a = _noise((4, 1 << 20), 6)
    t = torch.from_numpy(a)
    cudart = torch.cuda.cudart()
    half = t.untyped_storage().data_ptr() + a.nbytes // 2
    assert cudart.cudaHostRegister(half, a.nbytes // 2, 1) == \
        cudart.cudaError.success
    try:
        logger.reset_stage_times()
        logger.set_tracing(True)
        try:
            got = [to_device(a, dev) for _ in range(3)]
        finally:
            logger.set_tracing(False)
        _, counters = logger.totals()
        logger.reset_stage_times()
        assert counters == {"h2d.pageable": 3}
        assert not torch.from_numpy(a).is_pinned()
        assert float((torch.ones(8, device=dev) * 2).sum()) == 16.0
        for g in got:
            assert torch.equal(g.cpu(), t)
    finally:
        torch.cuda.check_error(cudart.cudaHostUnregister(half))


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def test_receiver_steps_on_one_reused_block_equal_steps_on_fresh_ones(dev):
    """Three Receiver.run steps fed from one host block refilled each
    step (registered on the second) give the outputs and state of the
    same steps fed fresh copies."""
    rx = Receiver(0, device=dev, stereo=True, rds=True,
                  fused_frontend="int8", pll_impl="ff", conv_dtype="bf16",
                  conv_engine="tiled", fused_ifbank="bf16")
    n, cfg = rx.block_size_u8(2), MODES[0]
    stations, samples = 4, 3 * n // 2 + 100
    cap = np.stack([tx.synthesize_capture(
        cfg, seconds=samples / cfg.rf_fs, seed=s, noise_db=-30.0,
        mono=tx.tone(cfg.rf_fs, 900.0 + 100 * s, samples))[:3 * n]
        for s in range(stations)])
    runs = []
    for reuse in (True, False):
        block = np.empty((stations, n), np.uint8)
        state, outs = None, []
        for j in range(3):
            if reuse:
                np.copyto(block, cap[:, j * n:(j + 1) * n])
                blk = block
            else:
                blk = cap[:, j * n:(j + 1) * n].copy()
            out, state = rx.run(blk, blocks_per_step=2, state=state)
            outs.append({k: v.cpu() for k, v in out.items()})
        if reuse:
            assert torch.from_numpy(block).is_pinned()
        runs.append((_flat(outs), [t.cpu() if isinstance(t, torch.Tensor)
                                   else t for t in _flat(state)]))
    (out_a, st_a), (out_b, st_b) = runs
    assert len(out_a) == len(out_b) and len(st_a) == len(st_b)
    for x, y in zip(out_a + st_a, out_b + st_b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
