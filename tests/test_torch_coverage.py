"""Every public top-level function and class of each sdr_tpu module has a
same-named counterpart in the same-path module of sdr_tpu_torch
(`ops/pallas/X` maps to `ops/cuda/X`), apart from the exemptions below,
each with its reason.  Reads the sources with `ast` and imports neither
package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "sdr_tpu", ROOT / "sdr_tpu_torch"

# (module, name) -> why the port has no counterpart
EXEMPT = {
    ("parallel/mesh.py", "channel_sharding"):
        "a JAX NamedSharding spec: the port's meshes are devices that may "
        "repeat, one batch a device, and it has no sharded arrays",
    ("parallel/mesh.py", "replicated"):
        "a JAX NamedSharding spec (as channel_sharding): nothing in the "
        "port is placed by a sharding",
}

MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _port_path(rel: str) -> Path:
    parts = Path(rel).parts
    if parts[:2] == ("ops", "pallas"):
        parts = ("ops", "cuda") + parts[2:]
    return PORT.joinpath(*parts)


def _public(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")]


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_counterpart(rel):
    port = _port_path(rel)
    assert port.is_file(), f"sdr_tpu/{rel} has no counterpart {port}"
    have = set(_public(port))
    missing = [name for name in _public(REF / rel)
               if name not in have and (rel, name) not in EXEMPT]
    assert not missing, f"{port.relative_to(ROOT)} lacks {missing}"


def test_exemptions_are_needed():
    """Each exemption names a public reference function the port still
    lacks, and gives a reason."""
    for (rel, name), reason in EXEMPT.items():
        assert name in _public(REF / rel), (rel, name)
        assert name not in _public(_port_path(rel)), (rel, name)
        assert reason


def test_maps_modules_by_path():
    """ops/pallas/X maps to ops/cuda/X, and a module the port lacks is
    found missing (ops/banded.py was, until the port had it)."""
    assert "ops/banded.py" in MODULES
    assert "TiledBandedFIR" in _public(REF / "ops/banded.py")
    assert _port_path("ops/pallas/audio_kernel.py") == (
        PORT / "ops" / "cuda" / "audio_kernel.py")
    assert not _port_path("ops/none.py").exists()
