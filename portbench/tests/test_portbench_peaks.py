"""The frozen copy of the kernel's least time, and the FLOPs of each
configuration's file against its program's recount."""

import functools
import json

import pytest

from portbench.flops import count
from portbench.peaks import dilate_erode_bound
from portbench.registry import DEFAULT_PROGRAM, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_dilate_erode_bound_at_the_swap_and_composite_shapes():
    ms, kind = dilate_erode_bound((3, 256, 256, 1), 2, 5)  # a swap's launch, bf16
    assert kind == "bytes" and round(ms * 1e3, 3) == 0.352
    ms, kind = dilate_erode_bound((1, 1024, 1024, 1), 4, 30)  # the composite's, f32
    assert kind == "bytes" and round(ms * 1e3, 3) == 3.756
    ms, kind = dilate_erode_bound((1, 64, 64, 1), 4, 200)
    assert kind == "operations"


CONFS = {c["file"]: json.loads((ROOT / c["file"]).read_text()) for c in BENCH["configs"]}


@functools.lru_cache(maxsize=None)
def recount(config):
    return count(CONFS[config])


@pytest.mark.parametrize("config", sorted(CONFS))
def test_flops_per_transfer_recount(config):
    total, per_op = recount(config)
    assert total == CONFS[config]["flops_per_transfer"] and sum(per_op.values()) == total


@pytest.mark.parametrize("config", sorted(f for f, c in CONFS.items()
                                          if c.get("program", DEFAULT_PROGRAM) == DEFAULT_PROGRAM))
def test_a_swaps_flops_are_mostly_convolution(config):
    total, per_op = recount(config)
    assert per_op["aten.convolution"] > 0.9 * total
