"""The port's streaming frame sync (sdr_tpu_torch/rds/streaming.py
`StreamingRdsDecoder._advance_sync`) reads every window's syndromes from
one pass over the bit buffer and walks only to the starts where something
can happen; the reference (sdr_tpu/rds/streaming.py) tests one 104-bit
window a start, four syndrome products each.  Both must agree bit for bit,
push by push: the groups (blocks, version, offset, bits corrected), the
windows tested, the locks lost, the bits corrected, the polarity and its
repins, the search pointer and the bits kept; over clean, inverted,
seamed, corrupted, burst-corrected, wrongly pinned (with a group on the
first start the repin opens) and mid-group streams, every push length
from one bit to a batch step.  The fleet decoder over a (128, 30,400)
soft batch equals one reference decoder a row."""

import dataclasses

import numpy as np
import pytest

from sdr_tpu.rds import streaming as jstreaming
from sdr_tpu_torch.io import logger
from sdr_tpu_torch.rds import streaming as tstreaming
from sdr_tpu_torch.rds import tx as rds_tx
from sdr_tpu_torch.rds.matrix import encode_block

SPS = 16


class _Ref(jstreaming.StreamingRdsDecoder):
    """The reference's decoder, counting as the port does: a window each
    `_try_group` call (one a start tested), a sync loss each lock dropped
    at the expected start."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.windows = self.sync_losses = 0
        self._at_expected = False

    def _note_loss(self):
        if self._at_expected and self._locked_at < 0:
            self.sync_losses += 1
        self._at_expected = False

    def _try_group(self, window104):
        self._note_loss()
        self.windows += 1
        self._at_expected = (self._locked_at >= 0
                             and self._p == self._locked_at + 104)
        return super()._try_group(window104)

    def _advance_sync(self):
        new = super()._advance_sync()
        self._note_loss()
        return new


def _group_0b(pi: int, segment: int) -> np.ndarray:
    """A version-B group (0B): PI again in block 3, offset C'."""
    b = (1 << 11) | (5 << 5) | segment
    return np.concatenate([encode_block(pi, "A"), encode_block(b, "B"),
                           encode_block(pi, "C'"),
                           encode_block(0x2020 + segment, "D")])


def _broadcast(n_groups: int, pi: int = 0x3D44, seam_every: int = 0):
    """0A/2A groups with every third a 0B one; with seam_every, 56 zero
    bits after each seam_every groups (the batch traffic's loop seam)."""
    groups = rds_tx.standard_group_stream(pi=pi, ps_name="TPU FM  ",
                                          n_groups=n_groups).reshape(-1, 104)
    out = []
    for g in range(n_groups):
        out.append(_group_0b(pi, g % 4) if g % 3 == 2 else groups[g])
        if seam_every and g % seam_every == seam_every - 1:
            out.append(np.zeros(56, np.uint8))
    return np.concatenate(out)


def _stream(name: str):
    """(bits, decoder keywords) of a named case."""
    clean = _broadcast(24)
    if name == "clean":
        return clean, {}
    if name == "inverted":
        return clean ^ 1, {}
    if name == "seams":
        return _broadcast(24, seam_every=8), {}
    if name == "corrupted":
        # groups 5 and 14 replaced by random bits that no burst correction
        # fixes: the lock is lost there and the search starts over
        bad = clean.copy()
        rng = np.random.default_rng(5)
        for g in (5, 14):
            bad[104 * g:104 * g + 104] = rng.integers(0, 2, 104)
        return bad, {}
    if name == "bursts":
        # span <= 5 bursts the expected start corrects, in every slot (the
        # C' slot of a 0B group included)
        bad = clean.copy()
        for g, q, burst in ((3, 5, [1, 0, 1, 1]), (5, 52 + 7, [1, 1]),
                            (8, 78 + 20, [1, 0, 0, 0, 1]), (11, 30, [1]),
                            (17, 52 + 3, [1, 0, 1])):
            bad[104 * g + q:104 * g + q + len(burst)] ^= np.array(
                burst, np.uint8)
        return bad, {}
    if name == "decoy":
        # one group at the wrong polarity pins it; the real stream is
        # searched past polarity_repin_bits, unpinned, and repinned
        decoy = rds_tx.standard_group_stream(pi=0x0BAD, n_groups=1) ^ 1
        return np.concatenate([decoy, clean]), {}
    if name == "repin_edge":
        # as decoy, one bit later: the broadcast's third group starts at
        # the first start tested under both polarities again
        decoy = rds_tx.standard_group_stream(pi=0x0BAD, n_groups=1) ^ 1
        return np.concatenate([decoy, [1], clean]).astype(np.uint8), {}
    if name == "mid_group":
        return clean[37:], {}
    if name == "noise_then_short_repin":
        # random bits searched under both polarities, then the broadcast
        # inverted after a decoy at polarity 0, with a short repin span
        rng = np.random.default_rng(7)
        decoy = rds_tx.standard_group_stream(pi=0x0BAD, n_groups=1)
        return np.concatenate([rng.integers(0, 2, 300, dtype=np.uint8),
                               decoy, clean ^ 1]), {
            "polarity_repin_bits": 40, "correct_bursts": False}
    raise KeyError(name)


STREAMS = ("clean", "inverted", "seams", "corrupted", "bursts", "decoy",
           "repin_edge", "mid_group", "noise_then_short_repin")
PUSHES = (1, 25, 26, 103, 104, 105, 950, 30400)


def _asdicts(groups):
    return [dataclasses.asdict(g) for g in groups]


def _state(dec):
    return (dec.windows, dec.sync_losses, dec.bits_corrected, dec.polarity,
            dec.polarity_repins, dec._p, dec._locked_at, dec._last_hit,
            dec._bit_base)


@pytest.mark.parametrize("push", PUSHES)
@pytest.mark.parametrize("stream", STREAMS)
def test_advance_sync_bit_equal_to_the_loop(stream, push):
    """Bit level, as tests/test_rds_streaming.py drives it: the same bits
    appended and `_advance_sync` called, push by push."""
    bits, kw = _stream(stream)
    t = tstreaming.StreamingRdsDecoder(SPS, **kw)
    j = _Ref(SPS, **kw)
    for k, i in enumerate(range(0, len(bits), push)):
        for dec in (t, j):
            dec._bits = np.concatenate([dec._bits, bits[i:i + push]])
        got, want = t._advance_sync(), j._advance_sync()
        assert _asdicts(got) == _asdicts(want), k
        assert all(type(b) is int for g in got for b in g.blocks)
        assert _state(t) == _state(j), k
        np.testing.assert_array_equal(t._bits, j._bits)
        t.groups += got
    assert 0 <= t.windows_skipped <= t.windows
    n = len(t.groups)
    assert n >= 20, n
    assert any(g.version_b for g in t.groups)
    if stream in ("seams", "corrupted"):
        # one-bit pushes bring one window each: the walk has none to pass
        assert t.sync_losses >= 2 and (t.windows_skipped > 0) == (push > 1)
    if stream == "bursts":
        assert t.bits_corrected >= 10 and t.sync_losses == 0
    if stream in ("decoy", "repin_edge", "noise_then_short_repin"):
        assert t.polarity_repins >= 1
    if stream == "repin_edge":
        assert t.groups[1].bit_offset == 104 + 1 + 2 * 104
    if stream in ("inverted", "noise_then_short_repin"):
        assert t.polarity == 1


def test_fleet_frame_sync_equals_one_reference_decoder_a_row():
    """A (128, 30,400) soft batch a push, three pushes; station s plays one
    of four seamed broadcasts from its own seeded start, at its own seeded
    polarity and noise.  Each station's groups, StationInfo, windows, sync
    losses, bits corrected, polarity and search pointer equal a reference
    decoder fed that row; the program's counters total the stations', and
    the walk passed over windows after the seams."""
    k, n, pushes = 128, 30_400, 3
    rng = np.random.default_rng(22)
    base = [rds_tx.bits_to_baseband(_broadcast(40, pi=0x3000 + b,
                                               seam_every=9), 38_000.0)
            for b in range(4)]
    soft = np.empty((k, pushes * n), np.float32)
    for s in range(k):
        start = int(rng.integers(0, 20_000))
        x = rng.choice([-1.0, 1.0]) * base[s % 4][start:start + pushes * n]
        soft[s] = x + rng.normal(0, rng.uniform(0.1, 0.5) * np.std(x),
                                 x.shape)

    fleet = tstreaming.MultiStreamingRds(SPS, k)
    ref = [_Ref(SPS) for _ in range(k)]
    logger.reset_stage_times()
    logger.set_tracing(True)
    try:
        synced = [fleet.push(soft[:, p * n:(p + 1) * n])
                  for p in range(pushes)]
    finally:
        logger.set_tracing(False)
    _, counters = logger.totals()
    logger.reset_stage_times()
    for p in range(pushes):
        for s, dec in enumerate(ref):
            new = dec.push(soft[s, p * n:(p + 1) * n])
            assert _asdicts(dict(synced[p]).get(s, [])) == _asdicts(new), (
                p, s)

    for s, (got, want) in enumerate(zip(fleet.decoders, ref)):
        assert _asdicts(got.groups) == _asdicts(want.groups), s
        assert dataclasses.asdict(fleet.info(s)) == dataclasses.asdict(
            want.info), s
        assert _state(got) == _state(want), s
        assert got.info.pi == 0x3000 + s % 4, s
    for name in ("windows", "sync_losses", "bits_corrected"):
        assert counters[f"rds.{name}"] == sum(
            getattr(d, name) for d in ref), name
    assert sum(d.sync_losses for d in ref) >= k
    assert 0 < counters["rds.windows_skipped"] == sum(
        d.windows_skipped for d in fleet.decoders) < counters["rds.windows"]
