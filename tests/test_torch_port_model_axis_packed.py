"""A packed zoo (`zoo.pack_zoo`) on the model axis: `pipeline.swap.hair_fast`
on the packed zoo that `mesh.shard_params_model_axis` placed; f32, CPU
(with every fast-path opt-in, and in bf16, in
tests/test_torch_port_model_axis_packed_optins.py, which shares this
file's fixture and check: two files, so that `--dist loadfile` runs their
JAX compiles on two workers).

The micro zoo (lively: tests/torch_port_util), the B=2 triples of
tests/test_torch_port_model_axis_swap.py, zero noise, on a (1, 2) mesh of
the CPU repeated. On the micro zoo the packed leaves that split are SEAN's
`fc_mu_b` [19, 512] and the FSE / PostProcess `styles_b` [n, 512]; the
packed kinds it leaves whole run split at wider widths in
tests/test_torch_port_model_axis_packed_blocks.py. References:
  * JAX's model-axis hair_fast: the JAX package's zoo.pack_zoo, its
    shard_params_model_axis over a (1, 2) mesh, `jax.jit(hair_fast)`,
    atol 1e-4 on the [0, 1] image
  * the port's one-device swap on the same packed zoo, atol 1e-5
The moves and the dilate/erode calls are pinned. The FSE's packed head
adds its [n, 512] biases after the product, as the JAX package does; on
one device that equals the former fused form exactly in f32.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hairfastgan_tpu.parallel import mesh as jmesh
from hairfastgan_tpu.pipeline.swap import hair_fast as jax_hair_fast
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_tpu.zoo import pack_zoo as jax_pack_zoo
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.models import iresnet as tir
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.pipeline.swap import hair_fast
from tests.test_torch_port_model_axis_swap import B, Spy, case_inputs, plan_of
from tests.torch_port_util import lively

torch.set_num_threads(2)
CPU = torch.device("cpu")
RUNS = {"distinct": ("distinct", {}), "same": ("same", {})}
# moves per packed swap on (1, 2); the all-opt-ins run is in
# tests/test_torch_port_model_axis_packed_optins.py
MOVES = {"distinct": {"all_gather": 142, "broadcast": 26},
         "same": {"all_gather": 46, "broadcast": 8},
         "all_optins": {"all_gather": 115, "broadcast": 20}}


def packed_world(runs):
    """(packed micro port zoo, cfg, B=2 triples, {run: JAX model-axis
    result}, {run: one-device (result, dilate/erode calls)}) for `runs`
    ({run: (case, cfg changes)})."""
    jz, jcfg = init_micro_zoo_fast(0)
    jz = lively(jz)
    cfg = tzoo.micro_zoo_shapes()[1]
    rng = np.random.default_rng(40)
    trip = [rng.random((B, 128, 128, 3), dtype=np.float32) for _ in range(3)]
    jplan = jmesh.make_mesh(n_data=1, n_model=2)
    placed = jmesh.shard_params_model_axis(jplan, jax_pack_zoo(jz))
    jout = {}
    with jplan.mesh:
        for run, (case, changes) in runs.items():
            jout[run] = np.asarray(jax.jit(functools.partial(
                jax_hair_fast, case=case, cfg=dataclasses.replace(jcfg, **changes)))(
                placed, *case_inputs(case, *trip)))
    zoo = tzoo.pack_zoo(bridge_zoo(jz))
    trip = [torch.from_numpy(t) for t in trip]
    one = {}
    with pytest.MonkeyPatch.context() as mp, torch.inference_mode():
        spy = Spy(mp)
        for run, (case, changes) in runs.items():
            spy.calls = []
            one[run] = (hair_fast(zoo, *case_inputs(case, *trip), case=case,
                                  cfg=dataclasses.replace(cfg, **changes)), spy.calls)
    return zoo, cfg, trip, jout, one


@pytest.fixture(scope="module")
def world():
    return packed_world(RUNS)


def check_packed_swap(run, case, changes, world, monkeypatch):
    """The packed swap of `run` on (1, 2) against JAX's model-axis swap and
    the one-device packed swap, its moves and dilate/erode calls."""
    zoo, cfg, trip, jout, one = world
    tp = mesh.shard_params_model_axis(plan_of(1, 2), zoo)
    assert tp.dims["fse"]["styles_b"] is not None and tp.dims["fse"]["styles_w"] is None
    assert tp.dims["sean"]["head0"]["ace0"]["fc_mu_b"] is not None
    spy = Spy(monkeypatch)
    mesh.MOVES.clear()
    with torch.inference_mode():
        out = hair_fast(tp, *case_inputs(case, *trip), case=case,
                        cfg=dataclasses.replace(cfg, **changes))
    assert {k: v for k, v in mesh.MOVES.items() if v} == MOVES[run]
    assert out.shape == (B, 128, 128, 3) and out.device == CPU
    np.testing.assert_allclose(out.numpy(), jout[run], rtol=0, atol=1e-4)
    ref, calls = one[run]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    assert spy.calls == calls and len(calls) == (1 if case == "same" else 2)
    assert all(dev == CPU and s == (3 * B, 256, 256, 1) for dev, s in calls)


@pytest.mark.parametrize("run", list(RUNS))
def test_packed_swap_on_the_model_axis(run, world, monkeypatch):
    check_packed_swap(run, *RUNS[run], world, monkeypatch)


def test_packed_fs_head_equals_its_former_form(world):
    """One device, f32: the packed FSE and PostProcess face-encoder heads
    (product, then the [n, 512] biases) equal the former single linear with
    the biases flattened into it, bit for bit."""
    zoo, _, trip, _, _ = world
    x = torch.cat(trip).permute(0, 3, 1, 2) * 2 - 1
    for p in (zoo["fse"], zoo["post_process"]["encoder_face"]):
        with torch.inference_mode():
            styles, _ = tir.fs_encode_nchw(p, x)
            feats = tir.trunk_features(p["trunk"], x)
            flat = torch.cat([F.adaptive_avg_pool2d(f, (3, 3)) for f in feats], 1).flatten(1)
            n, d, f = p["styles_w"].shape
            former = F.linear(flat, p["styles_w"].reshape(n * d, f),
                              p["styles_b"].reshape(n * d)).reshape(-1, n, d)
        assert styles.shape == (3 * B, n, 512) and torch.equal(styles, former)
