"""A packed zoo with every fast-path opt-in on the model axis: the micro
zoo's packed B=2 distinct swap on a (1, 2) mesh of the CPU repeated with
cfg.pair_shape_modules, cfg.rot_render_pairs and cfg.rot_seg_size all on,
against JAX's model-axis hair_fast on its packed zoo and the one-device
packed swap, with the fixture and check of
tests/test_torch_port_model_axis_packed.py; and the same swap in bf16,
which makes the f32 swap's moves (a cast of a slice, the split biases'
among them, is gathered as the cast of its source's whole) and gives the
one-device bf16 packed swap.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.pipeline.swap import hair_fast
from tests.test_torch_port_model_axis_packed import MOVES, check_packed_swap, packed_world
from tests.test_torch_port_model_axis_swap import plan_of

ALL = dict(pair_shape_modules=True, rot_render_pairs=3, rot_seg_size=64)


@pytest.fixture(scope="module")
def world():
    return packed_world({"all_optins": ("distinct", ALL)})


def test_packed_swap_with_every_optin(world, monkeypatch):
    check_packed_swap("all_optins", "distinct", ALL, world, monkeypatch)


def test_bf16_packed_swap_moves_as_f32(world):
    zoo, cfg, trip, _, _ = world
    cfg = dataclasses.replace(cfg, **ALL)
    zoo16 = tzoo.cast_zoo(zoo, torch.bfloat16)
    tp = mesh.shard_params_model_axis(plan_of(1, 2), zoo16)
    mesh.MOVES.clear()
    with torch.inference_mode():
        got = hair_fast(tp, *trip, cfg=cfg, dtype=torch.bfloat16)
        moves = {k: v for k, v in mesh.MOVES.items() if v}
        ref = hair_fast(zoo16, *trip, cfg=cfg, dtype=torch.bfloat16)
    assert moves == MOVES["all_optins"]
    assert got.dtype == ref.dtype and bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), rtol=0, atol=2e-2)
