"""On the card, at the cells' own sizes: the fp8 control fails one of each
cell's limits where the program passes them all, on three seeds. Skips without a card;
run there with

    python -m pytest portbench/tests/test_portbench_card.py -q -p no:cacheprovider
"""

import json

import pytest

from portbench import harness, precision
from portbench.registry import ROOT, Registry

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    reg = Registry.load()
    lim = reg.limits(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        r = harness.run_cell(reg, cell, seed, 4.0, False, device=card,
                             control=precision.Fp8())
        d = r["check_detail"]
        assert r["correct"]
        assert (d["control"] > lim["mad_excess"]
                or d["control_row_excess_max"] > lim["row_excess_max"])
