"""A whole swap on a model-axis zoo: `pipeline.swap.hair_fast` on the zoo
that `mesh.shard_params_model_axis` placed, every model column-parallel
(parallel/tensor.py), the glue on the lead device; f32, CPU.

The micro zoo (lively: tests/torch_port_util), B=2 triples, zero noise,
every case, on a (1, 2) mesh of the CPU repeated here and on a (2, 2) one
in tests/test_torch_port_model_axis_swap_rows.py, which shares this
file's fixture and check (two files, so `--dist loadfile` runs them on two
workers: the mesh positions take turns, so a (1, 2) micro swap costs ~2x
the one-device swap on the CPU). References:
  * JAX's model-axis hair_fast, `jax.jit(hair_fast)` on the JAX package's
    shard_params_model_axis over a (1, 2) mesh (one compile per case for
    the module, ~60 s in all), atol 1e-4 on the [0, 1] image, as
    tests/test_torch_port_pipeline.py holds the one-device swap to the
    JAX golden
  * the port's one-device swap on the same zoo for every case, atol 1e-5
    (the same math blocked another way: the two agree to ~1e-7 here), and
    its intermediates (return_intermediate) within 1e-5 of each one's
    largest magnitude, labels and masks exactly
The dilate/erode calls stay where they were: two per swap (one where the
alignment is skipped: face_eq_shape, same), on the lead device, at the
one-device shapes. Noise drawn by a generator equals the one-device swap's
draw. In bf16 the swap makes the f32 swap's all_gathers. The spatial split
(`sp`) on a model-axis zoo raises: make_sharded_swap takes such a zoo.
"""

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
from hairfastgan_torch.parallel import mesh, spatial
from hairfastgan_torch.pipeline import alignment, blending
from hairfastgan_torch.pipeline.swap import CASES, hair_fast
from tests.torch_port_util import lively

torch.set_num_threads(2)
CPU = torch.device("cpu")
B = 2
# all_gathers of the micro zoo's swap by case, either mesh
GATHERS = {"distinct": 138, "shape_eq_color": 111, "face_eq_shape": 92, "face_eq_color": 111,
           "same": 44}


def plan_of(n_data, n_model):
    return mesh.make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


def case_inputs(case, face, shape, color):
    """The triple with the identities `case` names."""
    shape = face if case in ("face_eq_shape", "same") else shape
    color = {"shape_eq_color": shape, "face_eq_color": face, "same": face}.get(case, color)
    return face, shape, color


class Spy:
    """The dilate/erode calls of a swap: (device, mask shape) of each."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod in (alignment, blending):
            monkeypatch.setattr(mod, "dilate_erode", self.wrap(mod.dilate_erode))

    def wrap(self, fn):
        def call(mask, iterations=5):
            self.calls.append((mask.device, tuple(mask.shape)))
            return fn(mask, iterations)
        return call


@pytest.fixture(scope="module")
def world():
    """(micro port zoo, cfg, B=2 triples, {case: JAX model-axis result},
    {case: one-device (result, dilate/erode calls)},
    one-device intermediates of the distinct case)."""
    jz, jcfg = init_micro_zoo_fast(0)
    jz = lively(jz)
    cfg = tzoo.micro_zoo_shapes()[1]
    rng = np.random.default_rng(40)
    trip = [rng.random((B, 128, 128, 3), dtype=np.float32) for _ in range(3)]
    jplan = jmesh.make_mesh(n_data=1, n_model=2)
    placed = jmesh.shard_params_model_axis(jplan, jz)
    jout = {}
    with jplan.mesh:
        for case in CASES:
            jout[case] = np.asarray(jax.jit(functools.partial(jax_hair_fast, case=case, cfg=jcfg))(
                placed, *case_inputs(case, *trip)))
    zoo = bridge_zoo(jz)
    trip = [torch.from_numpy(t) for t in trip]
    one, inter = {}, None
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        spy = Spy(mp)
        for case in CASES:
            spy.calls = []
            out = hair_fast(zoo, *case_inputs(case, *trip), case=case, cfg=cfg,
                            return_intermediate=case == "distinct")
            if case == "distinct":
                out, inter = out
            one[case] = (out, spy.calls)
    return zoo, cfg, trip, jout, one, inter


def check_swap(case, shape, world, monkeypatch):
    """The swap of `case` on a `shape` mesh against JAX's model-axis swap
    and the one-device swap, its moves and dilate/erode calls."""
    zoo, cfg, trip, jout, one, inter = world
    tp = mesh.shard_params_model_axis(plan_of(*shape), zoo)
    spy = Spy(monkeypatch)
    mesh.MOVES.clear()
    with torch.inference_mode():
        out = hair_fast(tp, *case_inputs(case, *trip), case=case, cfg=cfg,
                        return_intermediate=case == "distinct")
    moves = {k: v for k, v in mesh.MOVES.items() if v}
    assert moves["all_gather"] == GATHERS[case] and set(moves) == (
        {"all_gather", "scatter", "gather"} if shape[0] > 1 else {"all_gather", "broadcast"})
    if case == "distinct":
        out, got = out
        assert set(got) == set(inter)
        for k, v in got.items():
            ref = inter[k]
            assert v.shape == ref.shape and v.dtype == ref.dtype and v.device == CPU, k
            if v.dtype.is_floating_point and k != "HM_X":
                assert float((v - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), k
            else:
                assert torch.equal(v, ref), k
    np.testing.assert_allclose(out.numpy(), jout[case], rtol=0, atol=1e-4)
    ref, calls = one[case]
    assert out.shape == (B, 128, 128, 3) and out.device == CPU
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    assert spy.calls == calls and len(calls) == (1 if case in ("face_eq_shape", "same") else 2)
    assert all(dev == CPU and s == (3 * B, 256, 256, 1) for dev, s in calls)


@pytest.mark.parametrize("shape", [(1, 2)], ids=["1x2"])
@pytest.mark.parametrize("case", CASES)
def test_swap_on_the_model_axis(case, shape, world, monkeypatch):
    check_swap(case, shape, world, monkeypatch)


def test_bf16_swap_gathers_as_f32(world):
    """In bf16 the norms fold in f32: a cast of a slice is gathered as the
    cast of its source's whole, so the swap makes the f32 swap's
    all_gathers, none twice (the `same` case: 44, where gathering casts
    apart made 64), and gives the one-device bf16 swap."""
    zoo, cfg, trip, _, _, _ = world
    zoo16 = tzoo.cast_zoo(zoo, torch.bfloat16)
    tp = mesh.shard_params_model_axis(plan_of(1, 2), zoo16)
    args = case_inputs("same", *trip)
    mesh.MOVES.clear()
    with torch.inference_mode():
        got = hair_fast(tp, *args, case="same", cfg=cfg, dtype=torch.bfloat16)
        gathers = mesh.MOVES["all_gather"]
        ref = hair_fast(zoo16, *args, case="same", cfg=cfg, dtype=torch.bfloat16)
    assert gathers == GATHERS["same"]
    assert got.dtype == ref.dtype and bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("name", ["sp"])
def test_later_combinations_raise(name, world):
    """The model axis with the spatial split raises a ValueError naming
    make_sharded_swap (which gathers a model-axis zoo whole for the bands),
    before any work and without falling back to an unsharded swap. The
    fast-path opt-ins and a packed zoo run on the model axis:
    tests/test_torch_port_model_axis_{optins,optins_cut,packed,packed_optins}.py."""
    zoo, cfg, trip, _, _, _ = world
    tp = mesh.shard_params_model_axis(plan_of(1, 2), zoo)
    sp = spatial.spatial_plan(mesh.make_mesh(devices=[CPU] * 2), from_res=64)
    mesh.MOVES.clear()
    with pytest.raises(ValueError, match="make_sharded_swap"):
        hair_fast(tp, *trip, cfg=cfg, sp=sp)
    assert not mesh.MOVES["all_gather"]
