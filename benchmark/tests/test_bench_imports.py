"""Nothing the benchmark runs loads jax or the JAX package `sdr_tpu`
(top-level names compared whole: `sdr_tpu_torch` is the program), and the
reference and the synthesis load nothing of the program either."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "sdr_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    yardstick = ("reference" in path.parts or "traffic" in path.parts
                 or "metrics" in path.parts or "work" in path.parts
                 or path.name in ("check.py", "peaks.py"))
    if yardstick:
        assert "sdr_tpu_torch" not in names


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_what_a_run_loads():
    """Every module a run imports, the program's included."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.run, benchmark.harness as h\n"
        "import sdr_tpu_torch.models.receiver, sdr_tpu_torch.rds.streaming\n"
        "from pathlib import Path\n"
        "for p in sorted(Path('benchmark').glob('[msw]*/*.py')): h._load(p)\n"
        "print(*{m.split('.')[0] for m in sys.modules})\n")
    loaded = _loaded(code)
    assert "sdr_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_what_the_reference_loads():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.receiver, benchmark.traffic.synth\n"
            "import benchmark.check, benchmark.peaks\n"
            "print(*{m.split('.')[0] for m in sys.modules})\n")
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"sdr_tpu_torch"})
