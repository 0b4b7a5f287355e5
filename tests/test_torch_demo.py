"""The port's demo (examples/demo_torch.py) against the reference's
(examples/demo.py, with --cpu), both in-process at 2 stations and 0.6 s
(the shortest capture at or above 0.6 s at which the reference passes):
the same PI, PS and RT per station, SNR and separation within 0.5 dB of
the reference's, separation above 20 dB, and DEMO PASSED with exit code
0 from both."""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LINE = re.compile(r"station (\d+): L-tone +(\d+) Hz SNR +([-\d.]+) dB \| "
                  r"separation +([-\d.]+) dB \| RDS PI=(\S+) PS=('.*') "
                  r"RT=('.*') \[(\w+)\]")
ARGS = ["--stations", "2", "--seconds", "0.6", "--cpu"]


def load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stations(text):
    rows = {}
    for m in LINE.finditer(text):
        rows[int(m.group(1))] = dict(
            tone=float(m.group(2)), snr=float(m.group(3)),
            sep=float(m.group(4)), pi=m.group(5), ps=m.group(6),
            rt=m.group(7), ok=m.group(8))
    return rows


@pytest.fixture(scope="module")
def demos():
    """(exit code, stdout) of each demo."""
    import contextlib
    import io
    import sys
    out = {}
    for name in ("demo", "demo_torch"):
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = [f"{name}.py", *ARGS]
        try:
            with contextlib.redirect_stdout(buf):
                mod = load(name)
                rc = mod.main() if name == "demo" else mod.main(ARGS)
        finally:
            sys.argv = argv
        out[name] = (rc, buf.getvalue())
    return out


def test_both_demos_pass(demos):
    for name, (rc, text) in demos.items():
        assert rc == 0, (name, text)
        assert "DEMO PASSED" in text, (name, text)
        assert sorted(stations(text)) == [0, 1], (name, text)


def test_port_decodes_as_the_reference(demos):
    want = stations(demos["demo"][1])
    got = stations(demos["demo_torch"][1])
    for s, w in want.items():
        g = got[s]
        assert (g["tone"], g["pi"], g["ps"], g["rt"], g["ok"]) == (
            w["tone"], w["pi"], w["ps"], w["rt"], "OK"), (g, w)
        assert g["pi"] == f"{0x1000 + s:#06x}"
        assert abs(g["snr"] - w["snr"]) <= 0.5, (g, w)
        assert abs(g["sep"] - w["sep"]) <= 0.5, (g, w)
        assert g["sep"] > 20.0, g


def test_port_demo_wants_a_device():
    """Without a card, the port's demo raises unless asked for the CPU:
    there is no fallback."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("demo_torch").main(["--stations", "1", "--seconds", "0.1"])
