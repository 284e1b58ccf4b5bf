"""The port's model axis against the JAX package's, f32, CPU: the
tensor-parallel placement (parallel/mesh.py: shard_params_model_axis,
_model_spec_for, MeshPlan.spatial and place), the column-parallel generator
(parallel/tensor.py) and the library functions ported with them (e4e's
gradual_style_encode, the PostProcess training variants, the IResNet
ArcFace, get_hair_face_code, zero_noise, equal_conv2d, region_broadcast,
spade_gamma_beta).

Meshes repeat the CPU ([cpu] * n), as tests/test_torch_port_parallel.py's;
the JAX side runs on the conftest's 8 CPU devices. The generator is 64^2
with channel_multiplier 1, so that the model axis splits something: its
mapping, its convs up to 32^2 (512 channels), their modulations and the
constant input are split, pair 4 (256 channels) is not, save the
modulation of its up conv, whose input has 512. Weights are drawn by the
init law (tests/test_torch_port_parallel._init_law): the flat 0.05 fill
leaves renders almost signal-free.

Tolerances: renders 2e-5 absolute (tests/test_mesh_equivalence.py:61; the
renders' largest |value| is ~3); the column-parallel op against the
one-device op 1e-5 of scale (the same products per output channel, blocked
another way); the fused up-blur against the two-pass conv rtol 1e-4 and
atol 1e-5 (tests/test_torch_port_fastpaths.py's); placements and counts
exact; the library functions 2e-4 of the reference's largest magnitude
(tests/torch_port_util.REL, the model parities' bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu import zoo as jzoo
from hairfastgan_tpu.config import StyleGANConfig as JSG
from hairfastgan_tpu.models import e4e as je4e
from hairfastgan_tpu.models import encoders as jenc
from hairfastgan_tpu.models import iresnet as jir
from hairfastgan_tpu.models import sean as jsean
from hairfastgan_tpu.models import shape_adaptor as jsa
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_tpu.ops import equalized as jeq
from hairfastgan_tpu.ops import segops as jseg
from hairfastgan_tpu.parallel import mesh as jmesh
from hairfastgan_tpu.zoo import _fill_random
from hairfastgan_torch.config import StyleGANConfig
from hairfastgan_torch.models import e4e as te4e
from hairfastgan_torch.models import encoders as tenc
from hairfastgan_torch.models import iresnet as tir
from hairfastgan_torch.models import sean as tsean
from hairfastgan_torch.models import shape_adaptor as tsa
from hairfastgan_torch.models import stylegan2 as tsg
from hairfastgan_torch.ops import equalized as teq
from hairfastgan_torch.ops import modconv
from hairfastgan_torch.ops import segops as tseg
from hairfastgan_torch.params.bridge import bridge_zoo, map_tree, port_perm, to_port
from hairfastgan_torch.parallel import mesh, tensor
from tests.test_torch_port_parallel import _init_law
from tests.torch_port_util import close, lively

torch.set_num_threads(2)
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)
CFG = StyleGANConfig(size=64, channel_multiplier=1)
JCFG = JSG(size=64, channel_multiplier=1)
B = 4
MESHES = [(1, 2), (2, 2), (1, 4)]
# all_gathers per call at CFG: the 8 mapping linears; a full render: the
# constant input, conv1 (style, output), to_rgb1 (style), pairs 1-3
# (5 each: two convs' styles and outputs, the ToRGB style) and pair 4's up
# conv style
MAPPING_GATHERS, RENDER_GATHERS = 8, 20
G03_GATHERS, G48_GATHERS = 19, 1


def plan_of(n_data, n_model):
    return mesh.make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


def moves():
    return {k: v for k, v in mesh.MOVES.items() if v}


def entry_exit(n_data):
    """The batch's moves in and out of one call on n_data rows."""
    return {"scatter": 1, "gather": 1} if n_data > 1 else {"broadcast": 1}


def _paths(tree, path=()):
    """(path, leaf) of every array leaf of a port tree, as jax flattens it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    elif hasattr(tree, "shape"):
        yield path, tree


def _dims(dims, params):
    """path -> split dim of each array leaf of `params`, from the
    model_split_dims tree `dims` (which keeps the tree's Python values)."""
    out = {}
    for path, _ in _paths(params):
        d = dims
        for k in path:
            d = d[k]
        out[path] = d
    return out


def jax_port_dims(jplan, jtree):
    """The JAX package's model-axis placement of `jtree`, each leaf's split
    dim mapped through to_port's permutation: path -> port dim or None."""
    placed = jmesh.shard_params_model_axis(jplan, jtree)
    out = {}
    for jpath, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        path = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in jpath)
        split = [d for d, name in enumerate(leaf.sharding.spec) if name == "model"]
        if not split:
            out[path] = None
            continue
        key = path[-1] if isinstance(path[-1], str) else None
        perm = port_perm(key, leaf.ndim) or tuple(range(leaf.ndim))
        out[path] = perm.index(split[0])
    return out


@pytest.fixture(scope="module")
def gen():
    """The generator at CFG by its init's law (JAX tree, port tree) and
    B=4 latents z."""
    jparams = _init_law(jax.eval_shape(lambda: jsg.init_generator_params(KEY, JCFG)), 0)
    z = np.random.default_rng(1).standard_normal((B, 512)).astype(np.float32)
    return jparams, bridge_zoo(jparams), z


def _jax_render(p, z):
    w = jsg.mapping(p, z, JCFG)
    return jsg.generate(p, jsg.latent_to_wplus(w, JCFG.n_latent), cfg=JCFG)


@pytest.fixture(scope="module")
def renders(gen):
    """The port's one-device mapping and render, and the JAX package's
    render on make_mesh(n_data=4, n_model=2) with the params on its model
    axis, out_shardings=plan.spatial() (H over `model`)."""
    jparams, tparams, z = gen
    w1 = tsg.mapping(tparams, torch.from_numpy(z), CFG)
    img1 = tsg.generate(tparams, tsg.latent_to_wplus(w1, CFG.n_latent), cfg=CFG)
    jplan = jmesh.make_mesh(n_data=4, n_model=2)
    with jplan.mesh:
        out = jax.jit(_jax_render, out_shardings=jplan.spatial())(
            jmesh.shard_params_model_axis(jplan, jparams), jmesh.shard_batch(jplan, z))
    return w1, img1, jplan, out


# --- placement ---------------------------------------------------------------

@pytest.fixture(scope="module")
def micro_zoo():
    jz, _ = jzoo.init_micro_zoo_fast(0)
    return jz, bridge_zoo(jz)


@pytest.mark.parametrize("tree", ["micro_zoo", "generator512"])
@pytest.mark.parametrize("n_model", [2, 3])
def test_placement_matches_jax(tree, n_model, request, gen):
    """Leaf for leaf, the port's split dim is JAX's shard_params_model_axis
    spec mapped through to_port (a port linear [out, in] splits dim 0, not
    its in features; a dim not divisible by n_model stays whole), and each
    position holds its slice of every split leaf: slice j at model index j,
    the replicated leaves whole, in one scatter and one broadcast."""
    jtree, ttree = (request.getfixturevalue("micro_zoo") if tree == "micro_zoo"
                    else gen[:2])
    jplan = jmesh.make_mesh(n_data=2, n_model=n_model)
    ref = jax_port_dims(jplan, jtree)
    plan = plan_of(2, n_model)
    mesh.MOVES.clear()
    tp = mesh.shard_params_model_axis(plan, ttree)
    assert moves() == {"scatter": 1, "broadcast": 1}
    got = _dims(tp.dims, ttree)
    assert got == ref
    assert got == _dims(mesh.model_split_dims(ttree, n_model), ttree)
    assert any(d is not None for d in got.values()) == (n_model == 2)  # 512 % 3 != 0
    if tree == "generator512" and n_model == 2:
        assert got[("style", 0, "w")] == 0 and got[("input",)] == 1
        assert got[("convs", 0, "conv", "w")] == 0 and got[("to_rgb1", "conv", "w")] is None
    whole = dict(_paths(ttree))
    for i in range(2):
        for j in range(n_model):
            for path, leaf in _paths(tp.trees[i, j]):
                d = got[path]
                want = whole[path] if d is None else whole[path].chunk(n_model, dim=d)[j]
                assert leaf.shape == want.shape and torch.equal(leaf, want), path


def test_full_width_generator_leaf_count():
    """On the full-width generator's port-layout shapes (meta tensors, no
    allocation) the spec function splits 33 leaves holding 104.03 MiB in
    f32 (8 mapping linears, 15 modulations whose cin is 512, the 3x3
    kernels of conv1 and convs[0..7], the constant input), the leaves the
    JAX rule picks on the JAX-layout shapes."""
    cfg = StyleGANConfig()
    shapes = map_tree(tsg.init_generator_params(cfg), to_port)
    got = {p: d for p, d in _dims(mesh.model_split_dims(shapes, 2), shapes).items()
           if d is not None}
    jshapes = jax.eval_shape(lambda: jsg.init_generator_params(KEY, JSG()))
    ref = set()
    for jpath, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]:
        if any(name == "model" for name in jmesh._model_spec_for("", leaf)):
            ref.add(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in jpath))
    assert set(got) == ref and len(got) == 33
    sizes = dict(_paths(shapes))
    assert sum(sizes[p].numel() for p in got) * 4 / 2 ** 20 == pytest.approx(104.03125)
    kinds = {p[-1] if p[-1] != "w" else p[-2] for p in got}
    assert kinds == {"input", "modulation", "conv"} | {k for k in range(8)}


def _in_g03(path) -> bool:
    """Whether a generator leaf runs in G[0..3] (pairs 0-3), not G[4..8]."""
    return path[0] in ("input", "conv1", "to_rgb1") or (
        path[0] == "convs" and path[1] < 6) or (path[0] == "to_rgbs" and path[1] < 3)


def test_chip_smoke_gather_counts():
    """chip_smoke's model_axis phase pins the full-width all_gather counts:
    one per split leaf a call runs through (a split linear or conv gathers
    its output, a split modulation its styles, the split constant input
    itself), counted here from the full-width split dims (meta shapes)."""
    import chip_smoke

    shapes = map_tree(tsg.init_generator_params(StyleGANConfig()), to_port)
    split = [p for p, d in _dims(mesh.model_split_dims(shapes, 2), shapes).items()
             if d is not None]
    synth = [p for p in split if p[0] != "style"]
    want = {"mapping": len(split) - len(synth), "render": len(synth),
            "g03": sum(map(_in_g03, synth)), "g48": sum(not _in_g03(p) for p in synth)}
    assert chip_smoke.MODEL_AXIS_GATHERS == want
    assert chip_smoke.MODEL_AXIS_SPLIT == len(split)


def test_no_model_axis_replicates(gen):
    _, tparams, _ = gen
    plan = mesh.make_mesh(devices=[CPU] * 2)
    out = mesh.shard_params_model_axis(plan, tparams)
    assert isinstance(out, mesh.Replicas)
    with pytest.raises(TypeError):
        tensor.mapping(out, torch.zeros(2, 512), CFG)


# --- the column-parallel generator -------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_render_matches_one_device_and_jax(shape, gen, renders, monkeypatch):
    """mapping -> latent_to_wplus -> generate on the model axis equals the
    one-device render and JAX's model-axis render; every all_gather moves
    an activation or a style of the row's batch, never a weight."""
    _, tparams, z = gen
    w1, img1, _, jout = renders
    n_data, _ = shape
    tp = mesh.shard_params_model_axis(plan_of(*shape), tparams)
    seen = []
    move = tensor.move

    def spy(xs, to, kind):
        if kind == "all_gather":
            seen.extend(tuple(x.shape) for x in xs)
        return move(xs, to, kind)

    monkeypatch.setattr(tensor, "move", spy)
    mesh.MOVES.clear()
    w = tensor.mapping(tp, torch.from_numpy(z), CFG)
    assert moves() == {**entry_exit(n_data), "all_gather": MAPPING_GATHERS}
    np.testing.assert_allclose(w.numpy(), w1.numpy(), rtol=0, atol=2e-5)
    mesh.MOVES.clear()
    img = tensor.generate(tp, tsg.latent_to_wplus(w, CFG.n_latent), cfg=CFG)
    assert moves() == {**entry_exit(n_data), "all_gather": RENDER_GATHERS}
    assert img.shape == (B, 64, 64, 3)
    np.testing.assert_allclose(img.numpy(), img1.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(img.numpy(), np.asarray(jout), rtol=0, atol=2e-5)
    assert seen and all(s[0] == B // n_data for s in seen)


@pytest.mark.parametrize("shape", MESHES[:2], ids=[f"{a}x{b}" for a, b in MESHES[:2]])
def test_synthesis_slices_match_one_device(shape, gen):
    """G[0..3] (features and skip), G[4..8] from F with and without the
    skip, with noise lists holding Nones, and generate(generator=) drawing
    its noise on the lead device, each as the one-device call gives it."""
    _, tparams, z = gen
    n_data, _ = shape
    tp = mesh.shard_params_model_axis(plan_of(*shape), tparams)
    lat = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, CFG.n_latent, 512)).astype(np.float32)) * 0.7
    g = torch.Generator().manual_seed(3)
    noise = [None if k % 3 == 1 else n.permute(0, 2, 3, 1)
             for k, n in enumerate(tsg.make_noise(g, CFG, B))]
    kw = dict(noise=noise, cfg=CFG, dtype=torch.float32)
    f1, s1 = tsg.synthesis(tparams, lat, start_layer=0, end_layer=3, **kw)
    mesh.MOVES.clear()
    f, s = tensor.synthesis(tp, lat, start_layer=0, end_layer=3, **kw)
    assert moves() == {**({"scatter": 1, "gather": 2} if n_data > 1 else {"broadcast": 1}),
                       "all_gather": G03_GATHERS}
    for got, ref in ((f, f1), (s, s1)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-5)
    for skip in (None, s1):
        ref = tsg.synthesis(tparams, lat, start_layer=4, end_layer=8, layer_in=f1, skip=skip,
                            **kw)
        mesh.MOVES.clear()
        got = tensor.synthesis(tp, lat, start_layer=4, end_layer=8, layer_in=f1, skip=skip,
                               **kw)
        assert mesh.MOVES["all_gather"] == G48_GATHERS
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)
    ref = tsg.generate(tparams, lat, generator=torch.Generator().manual_seed(4), cfg=CFG)
    got = tensor.generate(tp, lat, generator=torch.Generator().manual_seed(4), cfg=CFG)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("fuse_blur", [False, True], ids=["two_pass", "fused"])
def test_column_parallel_up_conv(fuse_blur, gen):
    """The up StyledConv's modulated conv (convs[0], 512 -> 512) split over
    (2, 2): each output slice from the whole input, the styles and the
    output gathered (2 all_gathers), equal to ops/modconv's one-device
    conv, the fused up-blur too."""
    _, tparams, _ = gen
    tp = mesh.shard_params_model_axis(plan_of(2, 2), tparams)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, 512, 4, 4)).astype(np.float32))
    style = torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32))
    p = tparams["convs"][0]["conv"]
    ref = modconv.modulated_conv2d(p, x, style, up=True, fuse_blur=fuse_blur)
    xs, ss = tensor._scatter_rows(tp, [x, style])
    mesh.MOVES.clear()
    ys = tensor.modulated_conv2d(tp, ("convs", 0), xs, ss, up=True, fuse_blur=fuse_blur)
    assert moves() == {"all_gather": 2}
    got = torch.cat([row[1] for row in ys])
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    two_pass = modconv.modulated_conv2d(p, x, style, up=True)
    np.testing.assert_allclose(got.numpy(), two_pass.numpy(), rtol=1e-4, atol=1e-5)


def test_generator_refuses_what_it_cannot_place(gen):
    _, tparams, _ = gen
    tp = mesh.shard_params_model_axis(plan_of(2, 2), tparams)
    with pytest.raises(ValueError, match="divisible"):
        tensor.mapping(tp, torch.zeros(3, 512), CFG)
    with pytest.raises(TypeError):
        tensor.generate(tparams, torch.zeros(2, CFG.n_latent, 512), cfg=CFG)


# --- MeshPlan.spatial ----------------------------------------------------------

def test_spatial_bands_match_jax_on_the_model_axis(gen, renders):
    """place(plan, render, plan.spatial()) on a (4, 2) mesh: device (i, j)
    holds H band j, as JAX's out_shardings=plan.spatial() puts it on the
    same position of its (4, 2) mesh."""
    _, tparams, z = gen
    _, _, jplan, jout = renders
    tp = mesh.shard_params_model_axis(plan_of(2, 2), tparams)
    img = tensor.generate(tp, tsg.latent_to_wplus(tensor.mapping(tp, torch.from_numpy(z), CFG),
                                                  CFG.n_latent), cfg=CFG)
    plan = plan_of(4, 2)
    assert plan.spatial() == mesh.Placement("model", 1)
    mesh.MOVES.clear()
    bands = mesh.place(plan, img, plan.spatial())
    assert moves() == {"scatter": 1}
    shards = {s.device: np.asarray(s.data) for s in jout.addressable_shards}
    for k, (i, j) in enumerate(np.ndindex(4, 2)):
        ref = shards[jplan.mesh.devices[i, j]]
        assert bands[k].shape == ref.shape == (B, 32, 64, 3)
        np.testing.assert_allclose(bands[k].numpy(), ref, rtol=0, atol=2e-5)


def test_spatial_bands_match_jax_on_a_data_mesh(gen, renders):
    """On a 1-D mesh of 8 the bands go over `data`: device i holds band i,
    as JAX's replicated render with out_shardings=plan.spatial()."""
    jparams, _, z = gen
    _, img1, _, _ = renders
    jplan = jmesh.make_mesh(n_data=8)
    with jplan.mesh:
        out = jax.jit(_jax_render, out_shardings=jplan.spatial())(
            jmesh.replicate(jplan, jparams), jmesh.replicate(jplan, z))
    plan = mesh.make_mesh(devices=[CPU] * 8)
    assert plan.spatial() == mesh.Placement("data", 1)
    bands = mesh.place(plan, img1, plan.spatial())
    shards = {s.device: np.asarray(s.data) for s in out.addressable_shards}
    for i in range(8):
        ref = shards[jplan.mesh.devices[i]]
        assert bands[i].shape == ref.shape == (B, 8, 64, 3)
        np.testing.assert_allclose(bands[i].numpy(), ref, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        mesh.place(mesh.make_mesh(devices=[CPU] * 3), img1, mesh.Placement("data", 1))


# --- the library functions -----------------------------------------------------

def jfill(init, seed):
    """A JAX init tree's shapes, numpy-filled from `seed` and made lively."""
    return jax.tree.map(np.array, lively(_fill_random(jax.eval_shape(init), seed)))


def shapes_of(tree):
    return {p: tuple(x.shape) for p, x in _paths(tree)}


def test_gradual_style_encode_matches_jax(micro_zoo):
    jz, _ = micro_zoo
    jp = lively(jz["e4e"])
    x = np.random.default_rng(6).uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    for avg in (True, False):
        got = te4e.gradual_style_encode(bridge_zoo(jp), torch.from_numpy(x), add_latent_avg=avg)
        close(got.numpy(), np.asarray(je4e.gradual_style_encode(jp, x, add_latent_avg=avg)))


def _pp_train_tree(use_mod):
    """init_post_process_train_model's tree, its encoder narrowed (IResNet-18
    at width 0.25, 16 content channels) and its F-fuser cut to one block,
    so that the CPU runs it in seconds."""
    def init():
        p = jenc.init_post_process_train_model(KEY, use_mod=use_mod)
        p["encoder_face"] = jir.init_fs_encoder(KEY, n_styles=18, fs_layers=(9,), depth=18,
                                                width=0.25, content_ch=16)
        p["to_feature"] = jir.init_feature_iresnet(KEY, blocks=((16, 1),), inplanes=32)
        return p

    return jfill(init, 7)


@pytest.mark.parametrize("use_mod", [True, False])
def test_post_process_train_model_tree_matches_jax(use_mod):
    """The port's init (a JAX-layout meta tree) has the JAX init's leaves."""
    ref = jax.eval_shape(lambda: jenc.init_post_process_train_model(KEY, use_mod=use_mod))
    assert shapes_of(tenc.init_post_process_train_model(use_mod=use_mod)) == shapes_of(ref)


@pytest.mark.parametrize("case", ["default", "pretrain", "use_mod_off", "use_full_off"])
def test_post_process_model_train_matches_jax(case):
    jp = _pp_train_tree(use_mod=case != "use_mod_off")
    rng = np.random.default_rng(8)
    src, tgt = (rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(0, 1, (2, 256, 256, 1)) > 0.5).astype(np.float32)
    kw = {"default": {}, "pretrain": dict(pretrain=True), "use_mod_off": dict(use_mod=False),
          "use_full_off": dict(use_full=False)}[case]
    m = mask if case == "use_full_off" else None
    s, f = tenc.post_process_model_train(bridge_zoo(jp), torch.from_numpy(src),
                                         torch.from_numpy(tgt),
                                         None if m is None else torch.from_numpy(m), **kw)
    js, jf = jenc.post_process_model_train(jp, src, tgt, m, **kw)
    assert s.shape == (2, 18, 512) and f.shape == jf.shape
    close(s.numpy(), np.asarray(js))
    close(f.numpy(), np.asarray(jf))


def test_arcface_matches_jax():
    """The IResNet ArcFace (iresnet.init_arcface / arcface_embed; the
    rotate trainer's identity model is the IR-SE one of losses/identity)."""
    jp = jfill(lambda: jir.init_arcface(KEY, depth=18), 9)
    assert shapes_of(tir.init_arcface(depth=18)) == shapes_of(jp)
    x = np.random.default_rng(10).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    got = tir.arcface_embed(bridge_zoo(jp), torch.from_numpy(x))
    assert got.shape == (2, 512)
    close(got.numpy(), np.asarray(jir.arcface_embed(jp, x)))


def test_get_hair_face_code_matches_jax(micro_zoo):
    jz, tz = micro_zoo
    labels = np.random.default_rng(11).integers(0, 19, (2, 256, 256)).astype(np.int32)
    face, hair = tsa.get_hair_face_code(tz["shape_adaptor"], torch.from_numpy(labels))
    jface, jhair = jsa.get_hair_face_code(jz["shape_adaptor"], labels)
    close(face.numpy(), np.asarray(jface))
    close(hair.numpy(), np.asarray(jhair))


def test_zero_noise_matches_jax(gen):
    _, tparams, _ = gen
    got, ref = tsg.zero_noise(CFG, batch=2), jsg.zero_noise(JCFG, batch=2)
    assert [tuple(n.shape) for n in got] == [n.shape for n in ref]
    assert all(not n.any() for n in got)
    lat = torch.ones((2, CFG.n_latent, 512)) * 0.3
    kw = dict(cfg=CFG, dtype=torch.float32)
    assert torch.equal(tsg.synthesis(tparams, lat, noise=got, **kw)[1],
                       tsg.synthesis(tparams, lat, **kw)[1])


def test_equal_conv2d_matches_jax():
    rng = np.random.default_rng(12)
    jp = {"w": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
          "b": rng.standard_normal(8).astype(np.float32)}
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    for kw in (dict(), dict(stride=2, padding=1)):
        got = teq.equal_conv2d(bridge_zoo(jp), torch.from_numpy(x).permute(0, 3, 1, 2), **kw)
        close(got.permute(0, 2, 3, 1).numpy(), np.asarray(jeq.equal_conv2d(jp, x, **kw)))


def test_region_broadcast_matches_jax():
    rng = np.random.default_rng(13)
    codes = rng.standard_normal((2, 19, 8)).astype(np.float32)
    labels = rng.integers(0, 21, (2, 16, 16))  # 19, 20: no region, zeros
    onehot = np.asarray(jseg.one_hot_mask(labels, 19))
    got = tseg.region_broadcast(torch.from_numpy(codes),
                                tseg.one_hot_mask(torch.from_numpy(labels), 19))
    ref = np.asarray(jseg.region_broadcast(codes, onehot))
    close(got.permute(0, 2, 3, 1).numpy(), ref)
    assert not ref[labels >= 19].any()


@pytest.mark.parametrize("packed", [False, True])
def test_spade_gamma_beta_matches_jax(packed):
    jp = jfill(lambda: jsean.init_spade(KEY, norm_nc=8, nhidden=16), 14)
    if packed:
        jp = {"shared": jp["shared"],
              "gb": {k: np.concatenate([jp["gamma"][k], jp["beta"][k]], axis=-1)
                     for k in ("w", "b")}}
    labels = np.random.default_rng(15).integers(0, 19, (2, 16, 16))
    seg = np.asarray(jseg.one_hot_mask(labels, 19))
    g, b = tsean.spade_gamma_beta(bridge_zoo(jp), torch.from_numpy(seg).permute(0, 3, 1, 2))
    jg, jb = jsean.spade_gamma_beta(jp, jnp.asarray(seg))
    close(g.permute(0, 2, 3, 1).numpy(), np.asarray(jg))
    close(b.permute(0, 2, 3, 1).numpy(), np.asarray(jb))
