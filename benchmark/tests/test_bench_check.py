"""The comparison's arithmetic (check.py): a value that is not finite, or
an output missing or short, fails; the RDS group count of a looped
stream."""

import math

import numpy as np
import pytest

from benchmark import check

REF = np.sin(np.linspace(0, 20, 400)).reshape(2, 200)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("row", [0, 1])
def test_non_finite_sample_fails(bad, row):
    prog = REF.copy()
    prog[row, 37] = bad
    g = check.gaps({"left": prog, "right": REF}, {"left": REF, "right": REF},
                   ["left", "right"])
    assert g["audio_gap"] == math.inf
    ok, table = check.judge(g, {"audio_gap": 0.03})
    assert not ok and table["audio_gap"]["value"] == math.inf


@pytest.mark.parametrize("prog", [{"left": REF}, {"left": REF,
                                                  "right": REF[:, :-3]}],
                         ids=["missing", "short"])
def test_missing_or_short_output_fails(prog):
    g = check.gaps(prog, {"left": REF, "right": REF}, ["left", "right"])
    assert g["audio_gap"] == math.inf
    assert not check.judge(g, {"audio_gap": 0.03})[0]


def test_worst_keeps_a_nan_anywhere():
    assert math.isnan(check.worst([0.001, math.nan]))
    assert math.isnan(check.worst([math.nan, 0.001]))
    assert check.worst([0.001, 0.004]) == 0.004


def test_judge_fails_a_number_without_a_limit():
    assert not check.judge({"new_gap": 0.0}, {})[0]
    assert check.judge({"gap": 0.01}, {"gap": 0.01})[0]


@pytest.mark.parametrize("b0,b1,want", [
    (0, 3800, 36), (0, 7600, 72), (1, 3800, 35), (3700, 3900, 0),
    (3744, 3904, 1), (104 * 5, 3800 * 3 + 104 * 2, 31 + 36 + 36 + 2)])
def test_groups_carried(b0, b1, want):
    assert check.groups_carried(b0, b1, 3800, 36) == want


def test_seams_crossed():
    assert check.seams_crossed(0, 3800, 3800, 36) == 0
    assert check.seams_crossed(3700, 3900, 3800, 36) == 1
    assert check.seams_crossed(100, 3800 * 3 + 5, 3800, 36) == 3
    assert check.seams_crossed(0, 3952 * 4, 3952, 38) == 0   # whole groups


def test_groups_missed_counts_the_worst_station():
    slack = 104 * check.SLACK_GROUPS
    spans = [(0, 3952 * 3), (500, 500 + 3952 * 3)]
    carried = [check.groups_carried(b0 + slack, b1 - slack, 3952, 38)
               for b0, b1 in spans]
    assert check.groups_missed(carried, spans, 3952, 38) == (0, 0)
    got = [carried[0] + 2, carried[1] - 7]
    assert check.groups_missed(got, spans, 3952, 38) == (7, -7)
    assert check.groups_missed([c + 3 for c in carried], spans, 3952,
                               38) == (0, 3)
