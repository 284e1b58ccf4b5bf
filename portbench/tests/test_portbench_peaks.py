"""The frozen copy of the kernel's least time, and the FLOPs of each
configuration's file against a recount on meta tensors."""

import json

import pytest

from portbench.flops import count
from portbench.peaks import dilate_erode_bound
from portbench.registry import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_dilate_erode_bound_at_the_swap_and_composite_shapes():
    ms, kind = dilate_erode_bound((3, 256, 256, 1), 2, 5)  # a swap's launch, bf16
    assert kind == "bytes" and round(ms * 1e3, 3) == 0.352
    ms, kind = dilate_erode_bound((1, 1024, 1024, 1), 4, 30)  # the composite's, f32
    assert kind == "bytes" and round(ms * 1e3, 3) == 3.756
    ms, kind = dilate_erode_bound((1, 64, 64, 1), 4, 200)
    assert kind == "operations"


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_flops_per_transfer_recount(config):
    conf = json.loads((ROOT / config).read_text())
    total, per_op = count(conf)
    assert total == conf["flops_per_transfer"]
    assert per_op["aten.convolution"] > 0.9 * total
