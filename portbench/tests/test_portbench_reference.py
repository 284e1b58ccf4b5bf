"""The frozen reference agrees with the port; the port's bf16 run stays
inside the limits where the fp8 control fails them; the yardstick imports
nothing of the port or of JAX."""

import ast
import contextlib

import numpy as np
import pytest
import torch

from portbench import check, load, precision, weights
from portbench.registry import HERE
from portbench.tests.micro import MICRO_CONFIG, MICRO_LIMITS

FORBIDDEN = {"jax", "jaxlib", "flax", "hairfastgan_tpu", "hairfastgan_torch"}
YARDSTICK = ["check.py", "weights.py", "precision.py", "flops.py", "peaks.py", "load.py"] + [
    str(p.relative_to(HERE)) for p in (HERE / "reference").rglob("*.py")]


@pytest.mark.parametrize("rel", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port_or_jax(rel):
    tree = ast.parse((HERE / rel).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN


@pytest.fixture(scope="module")
def micro():
    zoo, _ = weights.make_zoo(MICRO_CONFIG["weights"], 11, "cpu", torch.float32)
    pool = load.make_pool(3, 6, 128, 32, "cpu")
    return zoo, [[torch.from_numpy(im[None]) for im in pool[k:k + 3]] for k in (0, 3)]


def _port(zoo, imgs, dtype):
    from hairfastgan_torch.pipeline.swap import hair_fast
    from hairfastgan_torch.zoo import cast_zoo

    from portbench.harness import program_config

    with torch.inference_mode():
        z = cast_zoo(zoo, dtype) if dtype != torch.float32 else zoo
        out = hair_fast(z, *imgs, cfg=program_config(MICRO_CONFIG), dtype=dtype,
                        generator=torch.Generator().manual_seed(5))
    return check.served_u8(out, None).numpy()


def _ref(zoo, imgs, mode=None, dtype=torch.float32):
    from portbench.reference.pipeline.swap import hair_fast

    z = weights.map_tree(zoo, lambda _, t: t.to(dtype))
    with torch.no_grad(), (mode or contextlib.nullcontext()):
        out = hair_fast(z, *imgs, cfg=check.reference_config(MICRO_CONFIG), dtype=dtype)
    return check.served_u8(out, None).numpy()


def test_reference_equals_port_in_float32(micro):
    zoo, (imgs, _) = micro
    assert check.mad(_port(zoo, imgs, torch.float32), _ref(zoo, imgs)) == 0.0


def test_bf16_passes_where_the_control_fails(micro):
    zoo, (imgs, other) = micro
    ref = _ref(zoo, imgs)
    d_r = check.mad(_ref(zoo, imgs, dtype=torch.bfloat16), ref)
    d_x = check.apart([ref, _ref(zoo, other)])

    def passes(out):
        e = check.excess(check.mad(out, ref), d_r, d_x)  # one row: the mean is the worst row
        return check.verdict({"mad_excess": e, "row_excess_max": e}, MICRO_LIMITS)[0]

    assert passes(_port(zoo, imgs, torch.bfloat16))
    assert not passes(_ref(zoo, imgs, precision.Fp8()))


def test_fp8_round_is_e4m3():
    x = torch.tensor([1.0, 1.0625, 448.0, -3.3, 0.0])
    y = precision.fp8_round(x)
    assert y[0] == 1.0 and y[2] == 448.0 and y[4] == 0.0 and y[1] in (1.0, 1.125)
    assert abs(float(y[3]) + 3.3) / 3.3 < 2 ** -3
    assert np.isfinite(precision.fp8_round(torch.zeros(3)).numpy()).all()
