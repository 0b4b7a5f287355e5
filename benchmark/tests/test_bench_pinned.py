"""The inputs of the benchmark's cells, pinned: the tiny forms of the
traffic mixes (conftest `TINY`) on two seeds give the buffer, the checked
stations, the programmes' offsets, the RDS bits a loop and the bit spans
written here.  The values were taken before the harness learned the
`antenna` layout; a traffic file without `antenna` keeps them byte for
byte."""

import hashlib

import pytest
import torch

from benchmark import harness

SEEDS = (2 ** 31 + 7, 2 ** 33 + 12345)
# steps [first, end) whose bit spans are pinned: the start, a run that
# wraps the buffer more than once
SPANS = ((0, 1), (3, 17))

PINNED = {
    ("live1", 2147483655): {
        "sha256": "ca2c31862140110dee55cfa0c59a58c0"
                  "10e3448e0368b4f565b6a4620e695eb4",
        "shape": [1, 3993600], "checked": [0],
        "offsets": [1466763],
        "n_bits": 988,
        "bit_spans": [[[725, 763]], [[839, 1371]]]},
    ("live1", 8589946937): {
        "sha256": "aec2f72c3d4fca582f3062656e93de0c"
                  "fde9ff2f777c715dac4ba8f5a3a61445",
        "shape": [1, 3993600], "checked": [0],
        "offsets": [820897],
        "n_bits": 988,
        "bit_spans": [[[406, 444]], [[520, 1052]]]},
    ("batch128", 2147483655): {
        "sha256": "c748ff606476c9890f699704c7974159"
                  "151d8b400985559e5dba08ac38f683d1",
        "shape": [4, 3686400], "checked": [0, 3],
        "offsets": [702986, 1297997, 148468, 1738679],
        "n_bits": 912,
        "bit_spans": [[[347, 499], [642, 794], [73, 225], [860, 1012]],
                      [[803, 2931], [1098, 3226], [529, 2657],
                       [1316, 3444]]]},
    ("batch128", 8589946937): {
        "sha256": "c286d4b2e7f51ba74bfb8e16bf55dff5"
                  "ca71eb9fefdf9ce62bfac7861f83e0ff",
        "shape": [4, 3686400], "checked": [0, 3],
        "offsets": [305347, 1708049, 556008, 568319],
        "n_bits": 912,
        "bit_spans": [[[151, 303], [845, 997], [275, 427], [281, 433]],
                      [[607, 2735], [1301, 3429], [731, 2859],
                       [737, 2865]]]},
}


def digest(tiny_root, cell_name: str, seed: int) -> dict:
    cell = harness.load_cell(tiny_root, cell_name)
    system = cell.module("systems", cell.config["system"])
    t = harness.make_traffic(
        cell, system.step_bytes(cell.config,
                                cell.traffic["blocks_per_step"]),
        seed, torch.device("cpu"))
    return {"sha256": hashlib.sha256(t.buf.tobytes()).hexdigest(),
            "shape": list(t.buf.shape),
            "checked": list(t.checked),
            "offsets": [int(o) for o in t.offsets],
            "n_bits": t.n_bits,
            "bit_spans": [t.bit_spans(a, b) for a, b in SPANS]}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("traffic,cell", [("live1", "stereo_rds.live1"),
                                          ("batch128", "stereo_rds.batch128")])
def test_inputs_are_pinned(tiny_root, traffic, cell, seed):
    got = digest(tiny_root, cell, seed)
    got["bit_spans"] = [[list(s) for s in spans]
                        for spans in got["bit_spans"]]
    assert got == PINNED[traffic, seed]
