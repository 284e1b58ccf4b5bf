"""A whole swap on a model-axis zoo with two data rows: the micro zoo's
B=2 swap on a (2, 2) mesh of the CPU repeated, every case, against JAX's
model-axis hair_fast and the one-device swap, with the fixture and check
of tests/test_torch_port_model_axis_swap.py (the (1, 2) mesh there); and
noise drawn by a generator on that mesh. A file of its own so that
`--dist loadfile` runs the two halves on two workers.
"""

import numpy as np
import pytest
import torch

from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.pipeline.swap import CASES, hair_fast
from tests.test_torch_port_model_axis_swap import (case_inputs, check_swap, plan_of,  # noqa: F401
                                                   world)


@pytest.mark.parametrize("shape", [(2, 2)], ids=["2x2"])
@pytest.mark.parametrize("case", CASES)
def test_swap_on_the_model_axis(case, shape, world, monkeypatch):
    check_swap(case, shape, world, monkeypatch)


def test_generator_noise_draws_as_one_device(world):
    """With a generator the renders' noise is drawn on the lead device and
    SEAN's inside the decode for the whole batch, as the one-device swap
    draws them: the (2, 2) swap equals the one-device swap with the seed."""
    zoo, cfg, trip, _, one, _ = world
    case = "face_eq_color"  # SEAN decode, two renders with noise, one shape module
    args = case_inputs(case, *trip)
    tp = mesh.shard_params_model_axis(plan_of(2, 2), zoo)
    with torch.inference_mode():
        ref = hair_fast(zoo, *args, case=case, cfg=cfg, generator=torch.Generator().manual_seed(9))
        got = hair_fast(tp, *args, case=case, cfg=cfg, generator=torch.Generator().manual_seed(9))
    assert float((ref - one[case][0]).abs().max()) > 1e-4  # the noise reaches the image
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
