"""A run on the CPU with the timed path broken underneath: `correct`
comes out false for each fault a cell can have.  (One chip a cell: no
exchange between chips to leave out.)"""

import json

import pytest

from conftest import ROOT

from sdr_tpu_torch.models.receiver import Receiver

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
BATCH = [c for c in CELLS if "batch" in c]
RUN = Receiver.run


def state_unchanged(monkeypatch):
    """Each step returns the state it was given."""
    step = Receiver.step

    def broken(self, state, iq_u8):
        return state, step(self, state, iq_u8)[1]
    monkeypatch.setattr(Receiver, "step", broken)


def half_batch(monkeypatch):
    """Half of the stations left out, their outputs the mean of the rest."""
    def broken(self, iq_u8, **kw):
        out, state = RUN(self, iq_u8, **kw)
        half = iq_u8.shape[0] // 2
        for v in out.values():
            v[half:] = v[:half].mean(0)
        return out, state
    monkeypatch.setattr(Receiver, "run", broken)


def answer_altered(key):
    def fault(monkeypatch):
        """One sample of one step's `key` output altered."""
        calls = []

        def broken(self, iq_u8, **kw):
            out, state = RUN(self, iq_u8, **kw)
            calls.append(1)
            if len(calls) == 3:
                out[key][..., 0, 7] += 0.5 * out[key].abs().max()
            return out, state
        monkeypatch.setattr(Receiver, "run", broken)
    fault.__name__ = f"altered_{key}"
    return fault


def nan_in_left(monkeypatch):
    """One sample of one step's left channel a NaN."""
    calls = []

    def broken(self, iq_u8, **kw):
        out, state = RUN(self, iq_u8, **kw)
        calls.append(1)
        if len(calls) == 3:
            out["left"][..., 0, 7] = float("nan")
        return out, state
    monkeypatch.setattr(Receiver, "run", broken)


def right_dropped(monkeypatch):
    """The right channel not produced."""
    def broken(self, iq_u8, **kw):
        out, state = RUN(self, iq_u8, **kw)
        out.pop("right")
        return out, state
    monkeypatch.setattr(Receiver, "run", broken)


def rds_lost_unchecked(monkeypatch):
    """From the third step on, the RDS output of a station the comparison
    of streams does not check is silent (only the group counts see it)."""
    from benchmark import harness
    checked = []
    draw = harness.draw_checked

    def remember(rng, stations, k):
        checked[:] = draw(rng, stations, k)
        return checked
    monkeypatch.setattr(harness, "draw_checked", remember)
    calls = []

    def broken(self, iq_u8, **kw):
        out, state = RUN(self, iq_u8, **kw)
        calls.append(1)
        if len(calls) >= 3:
            s = min(set(range(iq_u8.shape[0])) - set(checked))
            out["rds_soft"][s] = 0.0
        return out, state
    monkeypatch.setattr(Receiver, "run", broken)


CASES = ([(c, state_unchanged) for c in CELLS]
         + [(c, half_batch) for c in BATCH]
         + [(c, answer_altered("left")) for c in CELLS]
         + [(c, answer_altered("rds_soft")) for c in CELLS
            if c.startswith("stereo_rds")]
         + [(c, nan_in_left) for c in CELLS]
         + [(c, right_dropped) for c in CELLS]
         + [(c, rds_lost_unchecked) for c in BATCH
            if c.startswith("stereo_rds")])


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_fails_the_run(run_tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = run_tiny(cell, seconds=0.5)
    assert not r["correct"], r["compared"]


def test_sound_run_is_correct(run_tiny):
    """The control of these tests: the same run unbroken."""
    assert run_tiny("stations_stereo.batch128", seconds=0.5)["correct"]


def test_control_fails_the_run(run_tiny):
    """The reference one format below the stated precision, in the
    program's place, at the CPU's tiny size (the card's cell-size check is
    test_bench_control.py)."""
    r = run_tiny("stereo_rds.live1", seconds=0.5, system="control")
    assert not r["correct"]
    assert r["compared"]["audio_gap"]["value"] > \
        r["compared"]["audio_gap"]["limit"]
