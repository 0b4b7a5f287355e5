"""io/stream.py's HostPins: when `to_device` registers a host block as
page-locked memory.  The CUDA runtime's register and unregister calls are
replaced by fakes that record them, so the decisions run on the CPU; the
copies themselves are tested on the card (tests/test_torch_cuda_transfer.py).
"""

import numpy as np
import pytest
import torch

from sdr_tpu_torch.io import logger, stream
from sdr_tpu_torch.io.stream import HostPins, host_tensor, to_device


class FakeRuntime:
    """cudaHostRegister / cudaHostUnregister stand-ins: a log of the calls,
    and registrations refused where `refuse` says."""

    def __init__(self, refuse=False):
        self.refuse = refuse
        self.calls = []

    def register(self, ptr, nbytes):
        self.calls.append(("register", ptr, nbytes))
        return not self.refuse

    def unregister(self, ptr):
        self.calls.append(("unregister", ptr))


@pytest.fixture
def rt():
    return FakeRuntime()


@pytest.fixture
def pins(rt):
    return HostPins(rt.register, rt.unregister)


def _block(rows=4, n=4096):
    return np.random.default_rng(rows * n).integers(0, 256, (rows, n),
                                                    dtype=np.uint8)


def _storage(a):
    t = torch.from_numpy(a)
    return t.untyped_storage().data_ptr(), t.untyped_storage().nbytes()


def test_a_reused_block_is_registered_on_its_second_call(pins, rt):
    """The first call copies pageable; the second, with the same memory,
    registers the block's whole storage once; later calls (new tensors on
    the same array, as a reader's reused buffer gives) read it pinned."""
    a = _block()
    assert not pins.pinned(torch.from_numpy(a))
    assert rt.calls == []
    for _ in range(3):
        assert pins.pinned(torch.from_numpy(a))
    assert rt.calls == [("register", *_storage(a))]


def test_a_view_inside_the_registered_range_reads_pinned(pins, rt):
    """A contiguous block inside the registered storage is read from it
    with no further registration."""
    a = _block(1, 8192)
    for _ in range(2):
        pins.pinned(torch.from_numpy(a))
    assert pins.pinned(torch.from_numpy(a)[:, 1024:5120])
    assert pins.pinned(torch.from_numpy(a[0, 4096:]))
    assert len(rt.calls) == 1


def _fresh():
    return [torch.from_numpy(_block()) for _ in range(4)]


def _column_slices():
    a = torch.from_numpy(_block(4, 8192))
    return [a[:, :4096]] * 4


def _read_only():
    raw = _block().tobytes()
    return [host_tensor(np.frombuffer(raw, dtype=np.uint8))
            for _ in range(4)]


def _empty():
    a = np.zeros((4, 0), np.uint8)
    return [torch.from_numpy(a)] * 4


@pytest.mark.parametrize("blocks", [_fresh, _column_slices, _read_only,
                                    _empty])
def test_blocks_that_do_not_come_back_are_never_registered(pins, rt,
                                                           blocks):
    """A fresh array each call, the same non-contiguous column slice of a
    fleet's array, a read-only block (host_tensor copies it each call)
    and an empty block are copied the pageable way and never
    registered."""
    for t in blocks():
        assert not pins.pinned(t)
    assert rt.calls == []


def test_a_fresh_block_in_a_freed_blocks_place_is_not_the_same_memory(
        pins, rt):
    """The previous block is held until the next call, so a fresh array
    of the same size, dropped after each call, never lands on the
    address it is compared with."""
    for _ in range(6):
        assert not pins.pinned(torch.from_numpy(_block().copy()))
    assert rt.calls == []


def test_a_cpu_target_never_registers(monkeypatch, rt):
    """to_device onto the CPU consults no registration, however often the
    same block comes back."""
    monkeypatch.setattr(stream, "_PINS", HostPins(rt.register,
                                                  rt.unregister))
    a = _block()
    for _ in range(3):
        out = to_device(a, "cpu")
        assert np.shares_memory(out.numpy(), a)
    assert rt.calls == []


def test_a_second_repeating_buffer_takes_the_first_ones_place(pins, rt):
    """One range is held: when another buffer starts repeating, the old
    one is unregistered before the new one is registered; a block of the
    old buffer is pageable again until it repeats."""
    a, b = _block(), _block(4, 8192)
    for _ in range(2):
        pins.pinned(torch.from_numpy(a))
    assert not pins.pinned(torch.from_numpy(b))
    assert pins.pinned(torch.from_numpy(b))
    assert not pins.pinned(torch.from_numpy(a))
    assert pins.pinned(torch.from_numpy(a))
    (pa, na), (pb, nb) = _storage(a), _storage(b)
    assert rt.calls == [("register", pa, na),
                        ("unregister", pa), ("register", pb, nb),
                        ("unregister", pb), ("register", pa, na)]


def test_a_refused_registration_falls_back_and_is_not_retried():
    """Where the runtime refuses a range, the copies go the pageable way
    and that range is not offered again; another range still is."""
    rt = FakeRuntime(refuse=True)
    pins = HostPins(rt.register, rt.unregister)
    a = _block()
    for _ in range(5):
        assert not pins.pinned(torch.from_numpy(a))
    assert rt.calls == [("register", *_storage(a))]
    rt.refuse = False
    b = _block(4, 8192)
    assert [pins.pinned(torch.from_numpy(b)) for _ in range(3)] == [
        False, True, True]
    assert rt.calls[1:] == [("register", *_storage(b))]


def test_counters_say_which_way_each_copy_went():
    """Each to_device counts one of h2d.pinned and h2d.pageable under its
    receiver.h2d span; onto the CPU every copy is pageable."""
    logger.reset_stage_times()
    logger.set_tracing(True)
    try:
        a = _block()
        for x in (a, a, torch.from_numpy(a)[:, ::2], a.tobytes()):
            to_device(np.frombuffer(x, np.uint8) if isinstance(x, bytes)
                      else x, "cpu")
    finally:
        logger.set_tracing(False)
    spans, counters = logger.totals()
    logger.reset_stage_times()
    assert spans["receiver.h2d"][1] == 4
    assert counters.get("h2d.pinned", 0) == 0
    assert counters["h2d.pageable"] == 4
