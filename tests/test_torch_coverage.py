"""Every public top-level function and class of each sdr_tpu module has a
same-named counterpart in the same-path module of sdr_tpu_torch
(`ops/pallas/X` maps to `ops/cuda/X`), and every public function and
method of it (`__init__` and `__call__` too) takes each parameter its
reference takes, under the same name, apart from the exemptions below,
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

# (module, function or Class.method, parameter) -> why the port does not
# take it
PARAM_EXEMPT: dict[tuple[str, str, str], str] = {}

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


def _callables(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    """Public top-level functions, and the public methods of public
    classes with their `__init__` and `__call__`, as "Class.method"."""
    fn_types = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for n in tree.body:
        if isinstance(n, fn_types) and not n.name.startswith("_"):
            out[n.name] = n
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            for m in n.body:
                if isinstance(m, fn_types) and (
                        not m.name.startswith("_")
                        or m.name in ("__init__", "__call__")):
                    out[f"{n.name}.{m.name}"] = m
    return out


def _missing_params(ref: ast.FunctionDef, port: ast.FunctionDef
                    ) -> list[str]:
    """The parameters of `ref` that a caller may pass by name and `port`
    does not take.  A `*args` name is never passed by name; a port
    `**kwargs` takes every name (it forwards them)."""
    if port.args.kwarg is not None:
        return []

    def names(f):
        a = f.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    have = set(names(port))
    return [x for x in names(ref) if x not in have]


def _param_gaps(rel: str) -> list[tuple[str, str]]:
    port = _port_path(rel)
    if not port.is_file():
        return []
    ref_fns = _callables(ast.parse((REF / rel).read_text()))
    port_fns = _callables(ast.parse(port.read_text()))
    return [(name, p) for name, fn in ref_fns.items() if name in port_fns
            for p in _missing_params(fn, port_fns[name])]


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


@pytest.mark.parametrize("rel", MODULES)
def test_callables_take_reference_parameters(rel):
    """A call that runs against sdr_tpu does not raise TypeError against
    sdr_tpu_torch for a keyword the port lacks."""
    missing = [(name, p) for name, p in _param_gaps(rel)
               if (rel, name, p) not in PARAM_EXEMPT]
    assert not missing, f"sdr_tpu_torch/{rel}: missing parameters {missing}"


def test_param_exemptions_are_needed():
    """Each parameter exemption names a reference parameter the port still
    lacks, and gives a reason."""
    for (rel, name, param), reason in PARAM_EXEMPT.items():
        assert (name, param) in _param_gaps(rel), (rel, name, param)
        assert reason


def test_finds_a_missing_parameter():
    """The parameter check finds a keyword the port lacks (as
    pll_feedforward's norm_bandwidth was), by name and not by position,
    and takes a port **kwargs as forwarding every name."""
    ref = ast.parse("def f(x, *coeffs, a=1, b=2): pass\n"
                    "class C:\n"
                    "    def __call__(self, u8_block, interpret=False): pass")
    port = ast.parse("def f(x, b=2): pass\n"
                     "class C:\n"
                     "    def __call__(self, u8): pass")
    r, p = _callables(ref), _callables(port)
    assert set(r) == set(p) == {"f", "C.__call__"}
    assert _missing_params(r["f"], p["f"]) == ["a"]
    assert _missing_params(r["C.__call__"], p["C.__call__"]) == [
        "u8_block", "interpret"]
    fwd = ast.parse("def f(x, **kw): pass").body[0]
    assert _missing_params(r["f"], fwd) == []
