"""Fixtures of the benchmark's own tests (run them with
`python -m pytest benchmark/tests`; those marked `cuda` need a card)."""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny forms of the traffic mixes for runs on the CPU
TINY = {"live1": dict(buffer_seconds=0.832),
        "batch128": dict(stations=4, blocks_per_step=4, buffer_seconds=0.768,
                         programmes=2, check_stations=2,
                         warmup={"min_steps": 6, "max_steps": 6})}


def copy_benchmark(dst: Path, tiny: bool = True) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under dst (the traffic
    shrunk to CPU sizes); returns the copy's root."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    if tiny:
        for name, over in TINY.items():
            p = dst / "benchmark" / "traffic" / f"{name}.json"
            p.write_text(json.dumps({**json.loads(p.read_text()), **over}))
    return dst


@pytest.fixture(autouse=True)
def _few_threads():
    """Few threads a test: the tests run in several workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path):
    return copy_benchmark(tmp_path)


@pytest.fixture
def run_tiny(tiny_root):
    """run_tiny(cell, seconds=..., trace=..., system=...) on the CPU."""
    from benchmark import harness

    def run(cell, seconds=0.4, trace=False, seed=2 ** 31 + 7, **kw):
        return harness.run_cell(tiny_root, cell, seed, seconds, trace,
                                t_start=time.perf_counter(), device="cpu",
                                **kw)
    return run


@pytest.fixture
def cuda():
    """The card; skips without one (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
