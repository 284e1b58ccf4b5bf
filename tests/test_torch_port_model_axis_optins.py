"""The fast-path opt-ins on a model-axis zoo: `pipeline.swap.hair_fast` on
the zoo that `mesh.shard_params_model_axis` placed, with
cfg.pair_shape_modules here, and with cfg.rot_render_pairs and
cfg.rot_seg_size together in tests/test_torch_port_model_axis_optins_cut.py
(which shares this file's fixture and check: two files, so that `--dist
loadfile` runs their JAX compiles on two workers); f32, CPU.

The micro zoo (lively: tests/torch_port_util), the B=2 distinct triples of
tests/test_torch_port_model_axis_swap.py, zero noise, on (1, 2) and (2, 2)
meshes of the CPU repeated. References:
  * JAX's model-axis hair_fast, `jax.jit(hair_fast)` with the same config
    on the JAX package's shard_params_model_axis over a (1, 2) mesh, atol
    1e-4 on the [0, 1] image
  * the port's one-device swap with the same config, atol 1e-5
The paired render runs at 2b; on two data rows its 4 rows split 2 and 2,
and the shape adaptor's recombination tiles each face code beside its two
hair codes before the split (shape_adaptor.get_new_shape), so every hair
code meets its own face. The dilate/erode calls stay two per swap on the
lead device at the one-device shapes; the all_gathers are pinned. The
paired swap with a generator on (2, 2) is in
tests/test_torch_port_model_axis_packed_blocks.py (this file's JAX
compiles take most of its time).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from hairfastgan_tpu.parallel import mesh as jmesh
from hairfastgan_tpu.pipeline.swap import hair_fast as jax_hair_fast
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.pipeline.swap import hair_fast
from tests.test_torch_port_model_axis_swap import B, Spy, plan_of
from tests.torch_port_util import lively

torch.set_num_threads(2)
CPU = torch.device("cpu")
OPTINS = {"paired": dict(pair_shape_modules=True),
          "cut": dict(rot_render_pairs=3, rot_seg_size=64)}
GATHERS = {"paired": 111, "cut": 138}  # all_gathers per swap, either mesh


def optin_world(names):
    """(micro port zoo, {name: cfg}, B=2 triples, {name: JAX model-axis
    result}, {name: one-device (result, dilate/erode calls)}) for the
    OPTINS `names`."""
    jz, jcfg = init_micro_zoo_fast(0)
    jz = lively(jz)
    cfg = tzoo.micro_zoo_shapes()[1]
    rng = np.random.default_rng(40)
    trip = [rng.random((B, 128, 128, 3), dtype=np.float32) for _ in range(3)]
    jplan = jmesh.make_mesh(n_data=1, n_model=2)
    placed = jmesh.shard_params_model_axis(jplan, jz)
    jout = {}
    with jplan.mesh:
        for name in names:
            jout[name] = np.asarray(jax.jit(functools.partial(
                jax_hair_fast, cfg=dataclasses.replace(jcfg, **OPTINS[name])))(placed, *trip))
    zoo = bridge_zoo(jz)
    trip = [torch.from_numpy(t) for t in trip]
    cfgs = {name: dataclasses.replace(cfg, **OPTINS[name]) for name in names}
    one = {}
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        spy = Spy(mp)
        for name, c in cfgs.items():
            spy.calls = []
            one[name] = (hair_fast(zoo, *trip, cfg=c), spy.calls)
    return zoo, cfgs, trip, jout, one


@pytest.fixture(scope="module")
def world():
    return optin_world(["paired"])


def check_optin_swap(name, shape, world, monkeypatch):
    """The swap with opt-in `name` on a `shape` mesh against JAX's
    model-axis swap and the one-device swap, its moves and dilate/erode
    calls."""
    zoo, cfgs, trip, jout, one = world
    tp = mesh.shard_params_model_axis(plan_of(*shape), zoo)
    spy = Spy(monkeypatch)
    mesh.MOVES.clear()
    with torch.inference_mode():
        out = hair_fast(tp, *trip, cfg=cfgs[name])
    moves = {k: v for k, v in mesh.MOVES.items() if v}
    assert moves["all_gather"] == GATHERS[name] and set(moves) == (
        {"all_gather", "scatter", "gather"} if shape[0] > 1 else {"all_gather", "broadcast"})
    assert out.shape == (B, 128, 128, 3) and out.device == CPU
    np.testing.assert_allclose(out.numpy(), jout[name], rtol=0, atol=1e-4)
    ref, calls = one[name]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    assert spy.calls == calls and len(calls) == 2
    assert all(dev == CPU and s == (3 * B, 256, 256, 1) for dev, s in calls)


@pytest.mark.parametrize("name,shape", [("paired", (1, 2)), ("paired", (2, 2))],
                         ids=["paired-1x2", "paired-2x2"])
def test_optin_swap_on_the_model_axis(name, shape, world, monkeypatch):
    check_optin_swap(name, shape, world, monkeypatch)


def test_new_shape_keeps_each_face_with_its_hair_codes(world):
    """shape_adaptor.get_new_shape with k=2 hair codes per face code on two
    data rows equals the one-device call (the face codes tiled before the
    rows split the batch), and the face code matters to the labels."""
    from hairfastgan_torch.models import shape_adaptor as tsa

    p = world[0]["shape_adaptor"]
    rng = np.random.default_rng(42)
    face = torch.from_numpy(rng.standard_normal((B, 1024), dtype=np.float32)) * 3
    hair = torch.from_numpy(rng.standard_normal((2 * B, 16), dtype=np.float32)) * 3
    with torch.inference_mode():
        ref = tsa.get_new_shape(p, face, hair)
        swapped = tsa.get_new_shape(p, face.flip(0), hair)
        got = tsa.get_new_shape(mesh.shard_params_model_axis(plan_of(2, 2), p), face, hair)
    assert ref.shape == (2 * B, 256, 256) and not torch.equal(ref, swapped)
    assert torch.equal(got, ref)
