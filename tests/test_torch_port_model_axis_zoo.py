"""The zoo's models on the port's model axis (parallel/tensor.py) against
the JAX package's model axis and the port's own one-device forwards, f32,
CPU.

Every model of the zoo, and the blocks whose split leaf kinds the micro zoo
does not split, runs on `mesh.shard_params_model_axis` over (1, 2), (2, 2)
and (1, 4) meshes of the CPU repeated ([cpu] * n, as
tests/test_torch_port_model_axis.py's). References:
  * JAX: `jax.jit(fn)` of the same function on the JAX package's
    shard_params_model_axis over a (1, 2) mesh of the conftest's CPU
    devices (its answer does not depend on the mesh), within
    tests/torch_port_util.REL = 2e-4 of the largest magnitude
  * the port's one-device forward on the same tree, within 1e-5 of it:
    the same products per output feature, blocked another way
Integer labels are compared where the top-2 logit gap is clear of the
logit tolerance. `MOVES` is pinned exactly per model: the batch in (one
scatter, or one broadcast on one data row), one gather per result out on
two data rows, and the all_gathers: one per split tensor that an op had to
read whole. None of them moves a weight (a test below shows that an op
which would gather one raises).

Models run at the micro zoo's widths (lively: tests/torch_port_util). Where
the micro zoo splits none of a model's leaf kinds, the model or block runs
at the widths that split them on small inputs: the FSE trunk at width 1
(stage 4, the content head, BatchNorm and PReLU tails) at 64^2, e4e's
IR-SE-50 at width 1 with 8 heads (SE gates, shortcut convs, the style
convs, both latlayers) at 64^2, a one-block CLIP at width 512 (the patch
conv, pos_emb, in_proj split across the q/k/v boundary), one SPADE block
at 512 channels (spade gamma/beta, the region convs, conv0/conv1) at 8^2,
and BiSeNet at the tiny zoo's widths (full width; its layer4) at 64^2.
"""

import jax
import numpy as np
import pytest
import torch

from hairfastgan_tpu.models import bisenet as jbis
from hairfastgan_tpu.models import clip_vit as jclip
from hairfastgan_tpu.models import e4e as je4e
from hairfastgan_tpu.models import encoders as jenc
from hairfastgan_tpu.models import iresnet as jir
from hairfastgan_tpu.models import sean as jsean
from hairfastgan_tpu.models import shape_adaptor as jsa
from hairfastgan_tpu.parallel import mesh as jmesh
from hairfastgan_tpu.zoo import _fill_random, init_micro_zoo_fast
from hairfastgan_torch.models import bisenet as tbis
from hairfastgan_torch.models import e4e as te4e
from hairfastgan_torch.models import encoders as tenc
from hairfastgan_torch.models import iresnet as tir
from hairfastgan_torch.models import sean as tsean
from hairfastgan_torch.models import shape_adaptor as tsa
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.parallel import mesh, tensor
from hairfastgan_torch.pipeline.embedding import add_latent_avg
from tests.torch_port_util import REL, close, lively

torch.set_num_threads(2)
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)
MESHES = [(1, 2), (2, 2), (1, 4)]
B = 2


def plan_of(n_data, n_model):
    return mesh.make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


def filled(init_fn, seed=0):
    """A JAX init's tree, numpy-filled and lively, its conv and linear
    weights rescaled from the fill's N(0, 0.05) to He's N(0, 2 / fan_in):
    at width 1 the flat fill grows the maps block by block (to ~1e7 in
    IR-SE-50) and f32 sums of such maps agree to ~1e-3 of scale only."""
    def he(path, v):
        if getattr(path[-1], "key", None) == "w" and v.ndim in (2, 4):
            return v * np.float32(np.sqrt(2.0 / np.prod(v.shape[:-1])) / 0.05)
        return v

    return jax.tree_util.tree_map_with_path(he, lively(_fill_random(jax.eval_shape(init_fn),
                                                                    seed)))


def image(seed, size=256, b=B):
    return np.random.default_rng(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def labels(seed, b=B):
    small = np.random.default_rng(seed).integers(0, 19, size=(b, 16, 16))
    return np.repeat(np.repeat(small, 16, axis=1), 16, axis=2).astype(np.int32)


@pytest.fixture(scope="module")
def micro():
    return lively(init_micro_zoo_fast(0)[0])


# -- the models: (JAX tree, JAX fn, port fn, numpy inputs, all_gathers) --------
# The all_gather counts: a split linear or conv gathers its output where a
# later op reads it whole (a stack of split heads, a per-channel tail or an
# elementwise sum with another slice stays split and gathers once), a split
# modulation / style head stack where the next product reads it, and each
# split result once on the way out.


def _spade_block_nhwc(p, x, seg, codes):
    return tsean.spade_block(p, x.permute(0, 3, 1, 2), seg.permute(0, 3, 1, 2),
                             codes).permute(0, 2, 3, 1)


def _shape_adaptor(sa, decode):
    def fn(p, m1, m2):
        face, hair = sa.get_face_code(p, m1), sa.get_hair_code(p, m2)
        code = decode.cat([face, hair])
        hl, fl = sa.mask_decode(p["hair_decoder"], code), sa.mask_decode(p["face_decoder"], face)
        return face, hair, decode.nhwc(hl), decode.nhwc(fl), sa.get_new_shape(p, face, hair)
    return fn


class _J:
    cat = staticmethod(lambda xs: jax.numpy.concatenate(xs, axis=-1))
    nhwc = staticmethod(lambda x: x)


class _T:
    cat = staticmethod(lambda xs: torch.cat(xs, dim=-1))
    nhwc = staticmethod(lambda x: x.permute(0, 2, 3, 1))


def _bisenet(bis, nchw):
    def fn(p, img01):
        x = img01.permute(0, 3, 1, 2) if nchw else img01
        logits = bis.bisenet_logits_nchw(p, bis.to_bisenet_input(x)) if nchw else \
            bis.bisenet_logits(p, bis.to_bisenet_input(x))
        return (logits.permute(0, 2, 3, 1) if nchw else logits), \
            (bis.segment_256_nchw(p, x) if nchw else bis.segment_256(p, x))
    return fn


def spec(name, micro):
    rng = np.random.default_rng(7)
    w = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    if name == "fse":
        return micro["fse"], jir.fs_encode, tir.fs_encode, (image(1),), 1
    if name == "fse_latent_avg":
        return (micro["fse_latent_avg"], lambda a, s: s + a[None], add_latent_avg,
                (w(B, 12, 512),), 1)
    if name == "fse_width1":
        jp = filled(lambda: jir.init_fs_encoder(KEY, n_styles=2, fs_layers=(5,), depth=18,
                                                width=1.0, content_ch=512), 1)
        return jp, jir.fs_encode, tir.fs_encode, (image(2, 64),), 7
    if name == "e4e":
        return micro["e4e"], je4e.e4e_encode, te4e.e4e_encode, (image(3),), 2
    if name == "gradual_style_encode":
        return (micro["e4e"], je4e.gradual_style_encode, te4e.gradual_style_encode,
                (image(4),), 1)
    if name == "e4e_width1":
        jp = filled(lambda: je4e.init_e4e(KEY, n_styles=8, se=True, width=1.0), 2)
        jp = jax.tree_util.tree_map_with_path(  # residual branches at 1/10: the 24 units'
            lambda path, v: v * np.float32(0.1)  # sums stay O(10), not O(1e3)
            if "bn_out" in str(path) and "gamma" in str(path) else v, jp)
        return jp, je4e.e4e_encode, te4e.e4e_encode, (image(5, 64),), 51
    if name == "rotate":
        return micro["rotate"], jenc.rotate_model, tenc.rotate_model, (w(B, 6, 512),
                                                                          w(B, 6, 512)), 20
    if name == "blending":
        return (micro["blending"], jenc.blending_model, tenc.blending_model,
                (w(B, 6, 512), w(B, 6, 512), image(6), image(8)), 21)
    if name == "blending_clip512":
        jp = dict(micro["blending"], clip=filled(lambda: jclip.init_clip_image_tower(
            KEY, width=512, layers=1, heads=8), 3))
        return (jp, jenc.blending_model, tenc.blending_model,
                (w(B, 6, 512), w(B, 6, 512), image(9), image(10)), 27)
    if name == "post_process":
        return (micro["post_process"], jenc.post_process_model, tenc.post_process_model,
                (image(11), image(12)), 40)
    if name == "sean_encode":
        return micro["sean"], jsean.sean_encode, tsean.sean_encode, (image(13), labels(14)), 1
    if name == "sean_decode":
        codes = w(B, 19, 512) * 0.3
        codes[0, 3] = 0.0  # an empty region: the mean_codes fallback
        return micro["sean"], jsean.sean_decode, tsean.sean_decode, (codes, labels(15)), 16
    if name == "spade_block512":
        jp = filled(lambda: jsean.init_spade_block(KEY, 512, 512), 4)
        seg = np.eye(19, dtype=np.float32)[labels(16)[:, ::32, ::32]]
        return (jp, jsean.spade_block, _spade_block_nhwc,
                (w(B, 8, 8, 512), seg, w(B, 19, 512) * 0.3), 5)
    if name == "shape_adaptor":
        return (micro["shape_adaptor"], _shape_adaptor(jsa, _J), _shape_adaptor(tsa, _T),
                (labels(17), labels(18)), 11)
    if name == "bisenet_full_width":
        jp = filled(lambda: jbis.init_bisenet(KEY, n_classes=19), 5)
        img01 = np.random.default_rng(19).uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
        return jp, _bisenet(jbis, False), _bisenet(tbis, True), (img01,), 10
    raise KeyError(name)


NAMES = ["fse", "fse_latent_avg", "fse_width1", "e4e", "gradual_style_encode", "e4e_width1",
         "rotate", "blending", "blending_clip512", "post_process", "sean_encode",
         "sean_decode", "spade_block512", "shape_adaptor", "bisenet_full_width"]
ENTRIES = {"fse", "fse_latent_avg", "fse_width1", "e4e", "gradual_style_encode", "e4e_width1",
           "rotate", "blending", "blending_clip512", "post_process", "sean_encode",
           "sean_decode"}  # column_parallel entry points; the rest run through tensor.spmd


@pytest.fixture(scope="module")
def refs(micro):
    """name -> (JAX tree, port tree, port fn, torch inputs, gathers, JAX
    model-axis result, port one-device result), computed once per name."""
    cache = {}

    def get(name):
        if name not in cache:
            jp, jfn, tfn, args, gathers = spec(name, micro)
            jplan = jmesh.make_mesh(n_data=1, n_model=2)
            with jplan.mesh:
                jout = jax.jit(jfn)(jmesh.shard_params_model_axis(jplan, jp), *args)
            tp = bridge_zoo(jp)
            targs = [torch.from_numpy(np.array(a)) for a in args]
            with torch.inference_mode():
                one = tfn(tp, *targs)
            cache[name] = (tp, tfn, targs, gathers, jax.tree.map(np.asarray, jout), one)
        return cache[name]

    return get


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) and not hasattr(x, "shape") else [x]


def _flat(x):
    out = []
    for v in _leaves(x):
        out.extend(_flat(v) if isinstance(v, (tuple, list)) else [v])
    return out


@pytest.mark.parametrize("shape", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("name", NAMES)
def test_model_on_the_model_axis(name, shape, refs):
    tree, fn, args, gathers, jout, one = refs(name)
    n_data = shape[0]
    tp = mesh.shard_params_model_axis(plan_of(*shape), tree)
    assert any(d is not None for d in jax.tree.leaves(tp.dims)), name  # something splits
    mesh.MOVES.clear()
    with torch.inference_mode():
        out = fn(tp, *args) if name in ENTRIES else tensor.spmd(tp, fn, *args)
    got, ones, jax_out = _flat(out), _flat(one), _flat(jout)
    want = {"all_gather": gathers, "scatter" if n_data > 1 else "broadcast": 1}
    if n_data > 1:
        want["gather"] = len(got)
    assert {k: v for k, v in mesh.MOVES.items() if v} == want
    assert len(got) == len(ones) == len(jax_out)
    for g, o, j in zip(got, ones, jax_out):
        g, o = g.numpy(), o.numpy()
        assert g.shape == o.shape == j.shape and g.dtype == o.dtype
        if g.dtype.kind == "i":  # labels: where the one-device logits are clear
            continue
        scale = float(np.abs(o).max())
        assert scale > 0 and float(np.abs(g - o).max()) <= 1e-5 * scale, name
        close(g, j)
    if name in ("shape_adaptor", "bisenet_full_width"):
        _labels_agree(name, got, ones, jax_out)


def _labels_agree(name, got, ones, jax_out):
    """The label maps of the model axis equal the one-device and JAX ones
    where the top-2 logit gap is clear of the logit tolerance."""
    if name == "shape_adaptor":
        hl, fl = jax_out[2], jax_out[3]
        logit = np.concatenate([fl[..., :13], hl, fl[..., 13:]], -1)
    else:
        logit = jax_out[0][..., list(jbis.FACE_PARSING_TO_CELEBA)]
        logit = np.repeat(np.repeat(logit, 4, axis=1), 4, axis=2)  # 64 -> 256 nearest
    top2 = np.sort(logit, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * REL * np.abs(logit).max()
    assert clear.mean() > 0.5
    label, one_label, jax_label = got[-1].numpy(), ones[-1].numpy(), jax_out[-1]
    np.testing.assert_array_equal(label[clear], one_label[clear])
    np.testing.assert_array_equal(label[clear], jax_label[clear])


def test_sean_decode_noise_draws_as_one_device(micro):
    """With a generator, every ACE's noise is drawn on the lead device for
    the whole batch, as the one-device decode draws it: the (2, 2) decode
    equals the one-device decode with the same seed."""
    tree = bridge_zoo(micro["sean"])
    codes = torch.from_numpy(np.random.default_rng(20).standard_normal(
        (B, 19, 512), dtype=np.float32)) * 0.3
    target = torch.from_numpy(labels(21))
    with torch.inference_mode():
        ref = tsean.sean_decode(tree, codes, target, torch.Generator().manual_seed(5))
        flat = tsean.sean_decode(tree, codes, target)
        tp = mesh.shard_params_model_axis(plan_of(2, 2), tree)
        got = tsean.sean_decode(tp, codes, target, torch.Generator().manual_seed(5))
    assert float((ref - flat).abs().max()) > 1e-3  # the noise reaches the image
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_a_split_weight_never_moves(micro):
    """An op that would read a split weight whole raises, and so does a
    linear whose weight is split on its input features; outside a region a
    placed split leaf is the slice its position holds."""
    tp = mesh.shard_params_model_axis(plan_of(1, 2), bridge_zoo(micro["rotate"]))
    w = tp.trees[0, 1]["mods"][0]["fc"]["w"]
    assert isinstance(w, tensor.Cols) and w.shape == (256, 512)  # outside a region: the slice
    with pytest.raises(RuntimeError, match="would move"):
        tensor.spmd(tp, lambda p, x: x + p["mods"][0]["fc"]["w"].flatten()[:1],
                    torch.zeros(2, 1))
    clip = mesh.shard_params_model_axis(plan_of(1, 2), bridge_zoo(micro["blending"]["clip"]))
    with pytest.raises(RuntimeError, match="output features"):  # proj: [in, out], split on out
        tensor.spmd(clip, lambda p, x: torch.nn.functional.linear(x, p["proj"]),
                    torch.zeros(2, 512))


@pytest.mark.parametrize("name", ["rotate", "shape_adaptor"])
def test_positions_taking_turns(name, refs):
    """The positions take turns: one runs until its next collective, then
    the next, so one thread runs at a time. A (2, 2) mesh gives the
    one-device answer with the same collectives, and a failing position
    ends the region with its error, not a hang."""
    tree, fn, args, gathers, _, one = refs(name)
    tp = mesh.shard_params_model_axis(plan_of(2, 2), tree)
    mesh.MOVES.clear()
    with torch.inference_mode():
        out = fn(tp, *args) if name in ENTRIES else tensor.spmd(tp, fn, *args)
    assert mesh.MOVES["all_gather"] == gathers
    for g, o in zip(_flat(out), _flat(one)):
        if o.is_floating_point():  # labels: held where clear in the test above
            assert float((g - o).abs().max()) <= 1e-5 * float(o.abs().max())

    def fails_on_one(p, x):
        if tensor._CTX.pos == (1, 0):
            raise KeyError("position (1, 0)")
        return x + p["mods"][0]["fc"]["b"][:1]

    if name == "rotate":
        with pytest.raises(KeyError, match="position"):
            tensor.spmd(tp, fails_on_one, torch.zeros(2, 1))


def test_regions_under_fast_thread_switching(refs):
    """The rotate encoder on a (2, 4) mesh, eight positions taking turns,
    with the interpreter switching threads every microsecond: the region
    ends in time with the one-device answer and its 20 all_gathers."""
    import sys
    import threading

    tree, fn, args, gathers, _, one = refs("rotate")
    tp = mesh.shard_params_model_axis(plan_of(2, 4), tree)
    got = {}

    def run():
        with torch.inference_mode():
            got["out"] = fn(tp, *args)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    mesh.MOVES.clear()
    try:
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive() and "out" in got
    assert mesh.MOVES["all_gather"] == gathers
    assert float((got["out"] - one).abs().max()) <= 1e-5 * float(one.abs().max())
