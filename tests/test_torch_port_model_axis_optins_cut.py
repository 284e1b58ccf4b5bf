"""The rotate render's cuts on a model-axis zoo: the micro zoo's B=2
distinct swap on a (1, 2) mesh of the CPU repeated with
cfg.rot_render_pairs=3 and cfg.rot_seg_size=64 together, against JAX's
model-axis hair_fast with the same config (1e-4) and the one-device swap
(1e-5), its all_gathers and dilate/erode calls pinned, with the fixture
and check of tests/test_torch_port_model_axis_optins.py.
"""

import pytest

from tests.test_torch_port_model_axis_optins import check_optin_swap, optin_world


@pytest.fixture(scope="module")
def world():
    return optin_world(["cut"])


@pytest.mark.parametrize("name,shape", [("cut", (1, 2))], ids=["cut-1x2"])
def test_optin_swap_on_the_model_axis(name, shape, world, monkeypatch):
    check_optin_swap(name, shape, world, monkeypatch)
