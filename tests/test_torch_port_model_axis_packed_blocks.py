"""The packed leaf kinds of `zoo.pack_zoo` that the micro zoo does not split,
on the port's model axis (parallel/tensor.py), at the widths that split
them, against the JAX package's model axis and the port's one-device
forwards; f32, CPU. Also `make_sharded_swap` handed a model-axis zoo, and
the paired swap (cfg.pair_shape_modules) with a generator on two data rows.

Each block is packed by the JAX package's own packer, filled and He-scaled
as in tests/test_torch_port_model_axis_zoo.py, bridged, and run on (1, 2)
and (1, 4) meshes of the CPU repeated:
  * one SPADE block at 512 channels with every ACE packed: the spade `gb`
    and the region `conv_gb` ([2C, ...], gamma first) split on their output
    channels, so the split falls at the gamma|beta seam on (1, 2) and
    inside gamma and inside beta on (1, 4); their `.chunk(2, dim=1)` reads
    the output whole (one all_gather each: no slice of gamma or of beta
    lies on its own position, so no rule could keep one without moving
    data), and the split `fc_mu_b` [19, 512] is added to its slice
  * e4e's IR-SE-50 at width 1 with 8 heads packed: `conv0` (the heads'
    first convs, output channels concatenated) and `lin_b` split; the
    grouped chain and `lin_w` are rank 5 and 3, replicated, and read the
    conv0 output whole
  * the FSE (fs_layers (5,)) and an encoder of the PostProcess
    `encoder_face` layout (fs_layers (9,), the block_2 tap) at width 1,
    packed: `styles_b` [n, 512] split, `styles_w` replicated; the packed
    head adds the split bias to its slice of the product
References as in the zoo test: JAX's `jax.jit(fn)` on its (1, 2)
placement within tests/torch_port_util.REL of the largest magnitude, the
port's one-device forward within 1e-5 of it. The test first asserts that
the intended packed leaves are split, and pins the moves.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hairfastgan_tpu.models import e4e as je4e
from hairfastgan_tpu.models import iresnet as jir
from hairfastgan_tpu.models import sean as jsean
from hairfastgan_tpu.parallel import mesh as jmesh
from hairfastgan_tpu.zoo import init_micro_zoo_fast
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.models import e4e as te4e
from hairfastgan_torch.models import iresnet as tir
from hairfastgan_torch.params.bridge import bridge_zoo, map_tree
from hairfastgan_torch.parallel import mesh, spatial, tensor
from hairfastgan_torch.pipeline.swap import hair_fast
from tests.test_torch_port_model_axis_zoo import (B, KEY, _spade_block_nhwc, filled, image,
                                                  labels, plan_of)
from tests.torch_port_util import close, lively

torch.set_num_threads(2)
CPU = torch.device("cpu")
MESHES = [(1, 2), (1, 4)]


def _packed_spade_block(p):
    return {k: jsean._pack_ace(v) if k.startswith("ace") else v for k, v in p.items()}


def spec(name):
    """(packed JAX tree, JAX fn, port fn, numpy inputs, the split packed
    leaves by path, all_gathers)."""
    rng = np.random.default_rng(7)
    w = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    if name == "spade_block512":
        jp = _packed_spade_block(filled(lambda: jsean.init_spade_block(KEY, 512, 512), 4))
        seg = np.eye(19, dtype=np.float32)[labels(16)[:, ::32, ::32]]
        split = [(a, *leaf) for a in ("ace0", "ace1") for leaf in
                 (("spade", "gb", "w"), ("conv_gb", "w"), ("fc_mu_b",))]
        return (jp, jsean.spade_block, _spade_block_nhwc,
                (w(B, 8, 8, 512), seg, w(B, 19, 512) * 0.3), split, 8)
    if name == "e4e_width1":
        jp = filled(lambda: je4e.init_e4e(KEY, n_styles=8, se=True, width=1.0), 2)
        jp = jax.tree_util.tree_map_with_path(  # residual branches damped, as in the zoo test
            lambda path, v: v * np.float32(0.1)
            if "bn_out" in str(path) and "gamma" in str(path) else v, jp)
        jp = je4e.pack_style_heads(jp)
        split = [("styles_packed", g, *leaf) for g in range(3)
                 for leaf in (("conv0", "w"), ("lin_b",))]
        return jp, je4e.e4e_encode, te4e.e4e_encode, (image(5, 64),), split, 28
    if name in ("fse_width1", "pp_encoder_face_width1"):
        layers = (5,) if name == "fse_width1" else (9,)
        jp = jir.pack_fs_styles(filled(lambda: jir.init_fs_encoder(
            KEY, n_styles=2, fs_layers=layers, depth=18, width=1.0, content_ch=512), 1))
        return jp, jir.fs_encode, tir.fs_encode, (image(2, 64),), [("styles_b",)], 7
    raise KeyError(name)


NAMES = ["spade_block512", "e4e_width1", "fse_width1", "pp_encoder_face_width1"]
REPLICATED = {"e4e_width1": [("styles_packed", 0, "chain", 0, "w"), ("styles_packed", 0, "lin_w")],
              "fse_width1": [("styles_w",)], "pp_encoder_face_width1": [("styles_w",)]}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(name):
        if name not in cache:
            jp, jfn, tfn, args, split, gathers = spec(name)
            jplan = jmesh.make_mesh(n_data=1, n_model=2)
            with jplan.mesh:
                jout = jax.jit(jfn)(jmesh.shard_params_model_axis(jplan, jp), *args)
            tp = bridge_zoo(jp)
            targs = [torch.from_numpy(np.array(a)) for a in args]
            with torch.inference_mode():
                one = tfn(tp, *targs)
            cache[name] = (tp, tfn, targs, split, gathers, jax.tree.map(np.asarray, jout), one)
        return cache[name]

    return get


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flat(v)]
    return [x]


@pytest.mark.parametrize("shape", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("name", NAMES)
def test_packed_block_on_the_model_axis(name, shape, refs):
    tree, fn, args, split, gathers, jout, one = refs(name)
    tp = mesh.shard_params_model_axis(plan_of(*shape), tree)
    for path in split:  # the packed leaves this test exists for are split
        assert _at(tp.dims, path) is not None, path
    for path in REPLICATED.get(name, []):
        assert _at(tp.dims, path) is None, path
    mesh.MOVES.clear()
    with torch.inference_mode():
        out = fn(tp, *args) if name != "spade_block512" else tensor.spmd(tp, fn, *args)
    assert {k: v for k, v in mesh.MOVES.items() if v} == {"all_gather": gathers, "broadcast": 1}
    got, ones, jax_out = _flat(out), _flat(one), _flat(jout)
    assert len(got) == len(ones) == len(jax_out)
    for g, o, j in zip(got, ones, jax_out):
        g, o = g.numpy(), o.numpy()
        assert g.shape == o.shape == j.shape and g.dtype == o.dtype
        scale = float(np.abs(o).max())
        assert scale > 0 and float(np.abs(g - o).max()) <= 1e-5 * scale, name
        close(g, j)


@pytest.fixture(scope="module")
def micro_zoo():
    return bridge_zoo(lively(init_micro_zoo_fast(0)[0])), tzoo.micro_zoo_shapes()[1]


def test_paired_generator_noise_draws_as_one_device(micro_zoo):
    """With a generator the paired render's one [2b, ...] noise draw happens
    on the lead device, as the one-device paired swap draws it, and SEAN's
    inside the decode for the whole batch: the paired swap on a (2, 2) mesh
    equals the one-device paired swap with the seed (B=2 distinct triples)."""
    zoo, cfg = micro_zoo
    cfg = dataclasses.replace(cfg, pair_shape_modules=True)
    rng = np.random.default_rng(40)
    trip = [torch.from_numpy(rng.random((B, 128, 128, 3), dtype=np.float32)) for _ in range(3)]
    tp = mesh.shard_params_model_axis(plan_of(2, 2), zoo)
    with torch.inference_mode():
        flat = hair_fast(zoo, *trip, cfg=cfg)
        ref = hair_fast(zoo, *trip, cfg=cfg, generator=torch.Generator().manual_seed(9))
        got = hair_fast(tp, *trip, cfg=cfg, generator=torch.Generator().manual_seed(9))
    assert float((ref - flat).abs().max()) > 1e-4  # the noise reaches the image
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_make_sharded_swap_takes_a_model_axis_zoo(micro_zoo):
    """make_sharded_swap handed a zoo placed over a model axis gathers it
    whole on the lead device once (one `gather` of its split leaves, on the
    first call with that zoo object) and gives the banded swap of the whole
    zoo exactly, f32, zero noise; later calls move what the banded swap
    moves."""
    zoo, cfg = micro_zoo
    rng = np.random.default_rng(41)
    trip = [torch.from_numpy(rng.random((1, 128, 128, 3), dtype=np.float32)) for _ in range(3)]
    bands = mesh.make_mesh(devices=[CPU] * 2)
    tp = mesh.shard_params_model_axis(plan_of(1, 2), zoo)
    with torch.inference_mode():
        ref = spatial.make_sharded_swap(bands, cfg=cfg, from_res=64)(zoo, *trip)
        swap = spatial.make_sharded_swap(bands, cfg=cfg, from_res=64)
        mesh.MOVES.clear()
        got = swap(tp, *trip)
        first = {k: v for k, v in mesh.MOVES.items() if v}
        mesh.MOVES.clear()
        again = swap(tp, *trip)
        later = {k: v for k, v in mesh.MOVES.items() if v}
        whole = mesh.whole_params(tp)
    assert first == {"gather": 5, "scatter": 4} and later == {"gather": 4, "scatter": 4}
    assert torch.equal(got, ref) and torch.equal(again, ref)
    leaves = [], []
    for t, acc in zip((zoo, whole), leaves):
        map_tree(t, lambda _, x: acc.append(x))
    assert len(leaves[0]) == len(leaves[1])
    assert all(type(b) is torch.Tensor and torch.equal(a, b) for a, b in zip(*leaves))
