"""On the card, at each cell's own size: the control (the reference one
format below the configuration's stated precision, in the program's
place) comes out not correct on three seeds.  Run on the card with
`python -m pytest -m cuda benchmark/tests/test_bench_control.py`."""

import json
import time

import pytest

from conftest import ROOT

from benchmark import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
def test_control_is_not_correct(cuda, cell, seed):
    r = harness.run_cell(ROOT, cell, seed, BENCH["run_seconds"], False,
                         t_start=time.perf_counter(), device=cuda,
                         system="control")
    print("CONTROL", cell, seed, {k: v["value"] for k, v in r["compared"].items()})
    assert not r["correct"], r["compared"]
