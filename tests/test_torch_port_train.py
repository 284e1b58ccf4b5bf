"""The port's training path (hairfastgan_torch/train/{common,blending,
rotate}.py, losses/identity, the train state, convert_irse_backbone /
convert_arcface) against the JAX package's, f32, CPU. The generators of
train/datagen.py are held in tests/test_torch_port_datagen.py.

Weights are the JAX init trees numpy-filled (zoo._fill_random) and passed
through tests/torch_port_util.lively, bridged into the port
(params/bridge.bridge_zoo); inputs are numpy-seeded. Micro configs:
generator 64^2 at max_channels 128, CLIP width 64 x 2 layers, IR-SE-50 at
width 0.25, STAR at 2 stacks x 2 levels x 8 channels.

Tolerances, stated once:
  * losses: 1e-5 relative (f32 sums in another order over a few hundred
    ops: the f32 epsilon 6.0e-8 times ~170 sequential roundings; a wrong
    term, mask or stop-grad moves them by O(1));
  * gradients: 1e-4 of the leaf's largest |grad| (backward sums in
    another order, each op's backward a sum over its fan-out: the epsilon
    times ~1,700 roundings; a wrong path moves them by O(scale));
  * the rotate pose loss and the train step hold both packages' f32 runs
    against one float64 reference, the port's own float64 run (the JAX
    package folds norms and demodulation in f32 even for f64 inputs, so
    it has no f64 path): the JAX run within the bounds above of it (the
    reference is the JAX function), and the port's f32 gradient error at
    most F32_RATIO = 2 times the JAX run's own (`f32_no_worse`). Held
    against each other, the two f32 runs' errors add, and on some hosts
    their sum crossed 1e-4 of scale. Measured ratios (x86 CPU, torch
    2.13, jax 0.9): rotate pose 0.69 (injected keypoints) and 0.45
    (STAR); train step 0.69 (clip off), 0.47 (clip on), 0.85 (blending).
    The losses are scalars, one rounding each, so a ratio of two of them
    says nothing; they keep the 1e-5 bound against the reference on each
    side;
  * params after an Adam step: lr/5 absolute. Adam's m/(sqrt(v)+eps) turns
    the ULP noise of near-zero gradients into lr-sized steps of either sign
    (the reason tests/test_losses_train.py:248-250 gives), so the bound is
    under the lr-sized step every coordinate takes;
  * converters: exact (numpy arithmetic on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairfastgan_tpu.config import HairFastConfig as JConfig
from hairfastgan_tpu.config import StyleGANConfig as JSG
from hairfastgan_tpu.losses import identity as jid
from hairfastgan_tpu.models import clip_vit as jclip
from hairfastgan_tpu.models import encoders as jenc
from hairfastgan_tpu.models import star as jstar
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_tpu.ops.basic import adaptive_avg_pool
from hairfastgan_tpu.params import convert as JC
from hairfastgan_tpu.train import blending as jbl
from hairfastgan_tpu.train import common as jcommon
from hairfastgan_tpu.train import rotate as jrot
from hairfastgan_tpu.zoo import _fill_random
from hairfastgan_torch import zoo as tzoo
from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
from hairfastgan_torch.losses import identity as tid
from hairfastgan_torch.models import encoders as tenc
from hairfastgan_torch.models import star as tstar
from hairfastgan_torch.models import stylegan2 as tsg
from hairfastgan_torch.params import checkpoint as tckpt
from hairfastgan_torch.params import convert as TC
from hairfastgan_torch.params.bridge import bridge_zoo, map_tree
from hairfastgan_torch.train import blending as tbl
from hairfastgan_torch.train import common as tcommon
from hairfastgan_torch.train import rotate as trot
from hairfastgan_torch.train.common import tensor_leaves
from tests.test_torch_port_convert import SD, assert_same_tree
from tests.test_torch_port_zoo import flat
from tests.torch_port_util import close, lively

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
LR = 1e-3

SIZE, MAXC = 64, 128
JCFG = JConfig(stylegan=JSG(size=SIZE, max_channels=MAXC))
TCFG = HairFastConfig(stylegan=StyleGANConfig(size=SIZE, max_channels=MAXC))
N_LATENT = TCFG.stylegan.n_latent  # 10


def jfill(init, seed):
    """A JAX init tree's shapes, numpy-filled from `seed` and made lively."""
    return jax.tree.map(np.array, lively(_fill_random(jax.eval_shape(init), seed)))


def rel_close(got, ref, rel):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    ref = float(ref)
    assert abs(got - ref) <= rel * abs(ref), (got, ref)


def grads_close(got, ref, rel=GRAD_REL):
    """Leaf lists of gradients: each leaf within rel of the largest |grad|."""
    assert len(got) == len(ref)
    scale = max(float(r.abs().max()) for r in ref)
    assert scale > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        err = float((g.detach() - r).abs().max())
        assert err <= rel * scale, (i, err, scale)


F32_RATIO = 2.0


def d64(tree):
    """A port tree (or a tuple of tensors) in float64."""
    if isinstance(tree, tuple):
        return tuple(t.double() for t in tree)
    return map_tree(tree, lambda _, t: t.double())


def grad_err(got, ref):
    """The largest |got - ref| over all leaves, over the reference's largest |grad|."""
    assert len(got) == len(ref)
    scale = max(float(r.abs().max()) for r in ref)
    assert scale > 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
    return max(float((g.detach().double() - r).abs().max()) for g, r in zip(got, ref)) / scale


def f32_no_worse(port32, jax32, ref64, rel=GRAD_REL):
    """The f32 gradients of both packages against the port's float64 run:
    the JAX package's within `rel` of the largest |grad| (the reference
    computes the JAX function), the port's error at most F32_RATIO times
    the JAX package's own. Returns the ratio."""
    e_jax, e_port = grad_err(jax32, ref64), grad_err(port32, ref64)
    assert e_jax <= rel, (e_jax, rel)
    assert e_port <= F32_RATIO * e_jax, (e_port, e_jax)
    return e_port / e_jax


def port_grads(loss_fn, params):
    """(loss, aux, [grad per leaf]) of loss_fn(params) by autograd."""
    leaves = tensor_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, aux = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    return loss, aux, [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


def jax_grads(loss_fn, jparams):
    """(loss, aux, [grad per leaf, port layout]) of loss_fn(jparams), jax.grad."""
    (loss, aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    return loss, aux, tensor_leaves(bridge_zoo(g))


# --- setups -------------------------------------------------------------------

def blocky(rng, b, n, ch=3, lo=-1.0, hi=1.0):
    """[b,256,256,ch] images of n x n blocks of uniform values (structure at
    a scale the micro CLIP tower tells apart, unlike pixel noise)."""
    x = rng.uniform(lo, hi, (b, n, n, ch)).astype(np.float32)
    return np.repeat(np.repeat(x, 256 // n, 1), 256 // n, 2)


def centered_clip(clip, images):
    """The CLIP tower with ln_post's beta set so that the embeddings of
    `images` average to zero: a random tower embeds every image along
    nearly one direction (cos ~ 0.99), so a 1 - cos loss would sit at the
    f32 noise floor; centered, it is O(1)."""
    p = dict(clip, ln_post=dict(clip["ln_post"], beta=np.zeros_like(clip["ln_post"]["beta"])))
    e0 = np.asarray(jenc.clip_image_embed(p, images))  # (LN(x) * gamma) @ proj
    p["ln_post"]["beta"] = -(e0.mean(0) @ np.linalg.pinv(p["proj"])).astype(np.float32)
    return p


def blend_batch(rng, b):
    return (rng.standard_normal((b, N_LATENT, 512), np.float32) * 0.3,
            rng.standard_normal((b, N_LATENT, 512), np.float32) * 0.3,
            rng.standard_normal((b, 32, 32, TCFG.stylegan.channels(32)), np.float32) * 0.3,
            blocky(rng, b, 4), blocky(rng, b, 4),
            (blocky(rng, b, 8, 1, 0, 1) > 0.3).astype(np.float32),
            (blocky(rng, b, 8, 1, 0, 1) > 0.5).astype(np.float32),
            (blocky(rng, b, 8, 1, 0, 1) > 0.5).astype(np.float32))


@pytest.fixture(scope="module")
def blend_setup():
    """Frozen generator + CLIP (centered on the batch's crops), trainable
    mods and a B=2 batch, both sides."""
    clip = lambda: jclip.init_clip_image_tower(KEY, width=64, layers=2, heads=2,  # noqa: E731
                                               embed_dim=512)
    batch = blend_batch(np.random.default_rng(4), 2)
    crops = np.concatenate([batch[4] * batch[5], batch[3] * batch[6]])
    jfrozen = {"generator": jfill(lambda: jsg.init_generator_params(KEY, JCFG.stylegan), 1),
               "clip": centered_clip(jfill(clip, 2), crops)}
    jparams = {"mods": jfill(lambda: jenc.init_blending_model(KEY)["mods"], 3)}
    return jfrozen, jparams, batch


def tb(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def standardized_irse(p, images01):
    """The IR-SE backbone with bn_feat's statistics set to those of the
    embeddings of `images01` (NHWC [0,1] 256^2): a random backbone embeds
    every image along nearly one direction, so a 1 - cos loss would sit at
    the f32 noise floor; standardized, it is O(1)."""
    p = dict(p, bn_feat={k: np.zeros_like(v) if k in ("beta", "mean") else np.ones_like(v)
                         for k, v in p["bn_feat"].items()})
    e = np.asarray(jid.irse_embed(p, adaptive_avg_pool(images01, (112, 112)) * 2.0 - 1.0))
    p["bn_feat"] = dict(p["bn_feat"], mean=e.mean(0), var=e.var(0) + np.float32(1e-4))
    return p


@pytest.fixture(scope="module")
def rotate_setup():
    """Frozen generator + IR-SE-50 (width 0.25, standardized) + small STAR,
    trainable rotate mods and a B=2 pose batch, both sides."""
    rng = np.random.default_rng(9)
    b = 2
    batch = (blocky(rng, b, 8, 3, 0, 1),
             rng.uniform(0, 255, (b, 76, 2)).astype(np.float32),
             rng.standard_normal((b, N_LATENT, 512), np.float32) * 0.5,
             rng.standard_normal((b, N_LATENT, 512), np.float32) * 0.5)
    arc = jfill(lambda: jid.init_irse_backbone(KEY, width=0.25), 6)
    jfrozen = {"generator": jfill(lambda: jsg.init_generator_params(KEY, JCFG.stylegan), 5),
               "arcface": standardized_irse(arc, np.concatenate(
                   [batch[0], blocky(rng, 4, 8, 3, 0, 1)])),
               "star": jfill(lambda: jstar.init_star(KEY, nstack=2, nlevels=2, channels=8), 11)}
    jfrozen["star"]["e2h_w"], jfrozen["star"]["e2h_b"] = jstar._e2h_matrix(
        jstar.WFLW_EDGE_INFO, 98, 9)
    jparams = jfill(lambda: jenc.init_rotate_model(KEY), 8)
    return jfrozen, jparams, batch


def _grid_points(fr, img):
    """An injected keypoint_fn: 76 pixel values of a 9x9 grid, as coordinates."""
    pts = img[:, ::29, ::29, :2].reshape(img.shape[0], -1, 2)[:, :76]
    return pts * 255.0


KEYPOINT_FNS = {
    "star": (lambda fr, img: jstar.keypoints_256(fr["star"], img),
             lambda fr, img: tstar.keypoints_256(fr["star"], img)),
    "injected": (_grid_points, _grid_points),
}


# --- models and losses --------------------------------------------------------

def test_clip_image_embed_nhwc(blend_setup):
    jfrozen, _, batch = blend_setup
    got = tenc.clip_image_embed(bridge_zoo(jfrozen["clip"]), torch.from_numpy(batch[3]))
    close(got.numpy(), np.asarray(jenc.clip_image_embed(jfrozen["clip"], batch[3])))


def test_blending_loss_and_grads_match_jax(blend_setup):
    jfrozen, jparams, batch = blend_setup
    frozen, params = bridge_zoo(jfrozen), bridge_zoo(jparams)
    loss, aux, grads = port_grads(lambda p: tbl.blending_loss(p, frozen, tb(batch), TCFG),
                                  params)
    jloss, jaux, jgrads = jax_grads(lambda p: jbl.blending_loss(p, jfrozen, batch, JCFG),
                                    jparams)
    rel_close(loss, jloss, LOSS_REL)
    for k in ("face_loss", "hair_loss"):
        rel_close(aux[k], jaux[k], LOSS_REL)
    grads_close(grads, jgrads)


def test_blending_latent_rows_0_5_are_zero(blend_setup, monkeypatch):
    """While training, G[4..8] gets zeros in rows 0-5 (blending_train.py:109)
    and the blend encoder's output in rows 6: (those rows G[4..8] never
    reads are pinned here, not by the loss)."""
    jfrozen, jparams, batch = blend_setup
    seen = []
    orig = tsg.synthesis_nchw

    def spy(params, latent, **kw):
        seen.append(latent.detach().clone())
        return orig(params, latent, **kw)

    monkeypatch.setattr(tbl.stylegan2, "synthesis_nchw", spy)
    with torch.no_grad():
        tbl.blending_loss(bridge_zoo(jparams), bridge_zoo(jfrozen), tb(batch), TCFG)
    (latent,) = seen
    assert latent.shape == (2, N_LATENT, 512)
    assert torch.count_nonzero(latent[:, :6]) == 0
    jblend = jenc.blending_model(dict(jparams, clip=jfrozen["clip"]), batch[1][:, 6:],
                                 batch[0][:, 6:], batch[4] * batch[5], batch[3] * batch[6])
    close(latent[:, 6:].numpy(), np.asarray(jblend))


@pytest.mark.parametrize("kp", sorted(KEYPOINT_FNS))
def test_rotate_pose_loss_and_grads_match_jax(rotate_setup, kp):
    """The pose loss (with MAL multipliers and raw) and its gradients: both
    packages' f32 runs against the port's float64 run (`f32_no_worse`)."""
    jfrozen, jparams, batch = rotate_setup
    jkp, tkp = KEYPOINT_FNS[kp]
    frozen, params = bridge_zoo(jfrozen), bridge_zoo(jparams)
    mults = (0.7, 1.3)
    loss, aux, grads = port_grads(
        lambda p: trot.rotate_pose_loss(p, frozen, tb(batch), tkp, TCFG, mults=mults), params)
    ref, raux, rgrads = port_grads(
        lambda p: trot.rotate_pose_loss(p, d64(frozen), d64(tb(batch)), tkp, TCFG, mults=mults),
        d64(params))
    jloss, jaux, jgrads = jax_grads(
        lambda p: jrot.rotate_pose_loss(p, jfrozen, batch, jkp, JCFG,
                                        mults=jnp.asarray(mults)), jparams)
    for got in (loss, jloss):
        rel_close(got, ref, LOSS_REL)
    for k in ("mse_points", "arc_face"):
        for got in (aux[k], jaux[k]):
            rel_close(got, raux[k], LOSS_REL)
    assert float(raux["arc_face"]) > 1e-3  # the identity term is alive
    f32_no_worse(grads, jgrads, rgrads)
    with torch.no_grad():  # raw sums (validation): mults=None
        raw = trot.rotate_pose_loss(d64(params), d64(frozen), d64(tb(batch)), tkp, TCFG)[0]
        rel_close(trot.rotate_pose_loss(params, frozen, tb(batch), tkp, TCFG)[0], raw, LOSS_REL)
    rel_close(jrot.rotate_pose_loss(jparams, jfrozen, batch, jkp, JCFG)[0], raw, LOSS_REL)


def test_rotate_render_matches_jax(rotate_setup):
    jfrozen, jparams, batch = rotate_setup
    with torch.no_grad():
        got = trot.rotate_render(bridge_zoo(jparams), bridge_zoo(jfrozen),
                                 torch.from_numpy(batch[2]), torch.from_numpy(batch[3]), TCFG)
    ref = jrot.rotate_render(jparams, jfrozen, batch[2], batch[3], JCFG)
    assert got.shape == (2, 256, 256, 3)
    close(got.numpy(), np.asarray(ref))


def test_rotate_hair_loss_and_grads_match_jax(rotate_setup):
    _, jparams, batch = rotate_setup
    wb = batch[2:]
    loss, aux, grads = port_grads(
        lambda p: trot.rotate_hair_loss(p, tb(wb), mults=(2.5,)), bridge_zoo(jparams))
    jloss, jaux, jgrads = jax_grads(
        lambda p: jrot.rotate_hair_loss(p, wb, mults=jnp.asarray([2.5])), jparams)
    rel_close(loss, jloss, LOSS_REL)
    rel_close(aux["mse_latents"], jaux["mse_latents"], LOSS_REL)
    grads_close(grads, jgrads)


def test_arcface_cosine_grads_match_jax(rotate_setup):
    """d/d(img) against JAX; d/d(ref) is zero on both sides (stop-grad)."""
    jfrozen, _, batch = rotate_setup
    frozen = bridge_zoo(jfrozen)
    rng = np.random.default_rng(10)
    img = rng.random((2, 256, 256, 3), np.float32)
    ref = batch[0]
    ti, tr = torch.from_numpy(img).requires_grad_(), torch.from_numpy(ref).requires_grad_()
    loss = trot._arcface_cosine(frozen, ti, tr)
    gi, gr = torch.autograd.grad(loss, (ti, tr), allow_unused=True)
    jloss, (jgi, jgr) = jax.jit(jax.value_and_grad(
        lambda a, b: jrot._arcface_cosine(jfrozen, a, b), argnums=(0, 1)))(img, ref)
    rel_close(loss, jloss, LOSS_REL)
    assert float(np.abs(np.asarray(jgr)).max()) == 0.0
    assert gr is None or float(gr.abs().max()) == 0.0
    grads_close([gi], [torch.from_numpy(np.array(jgi))])


@pytest.fixture(scope="module")
def irse():
    """IR-SE-50 at width 0.25 as filled (id_loss's 1 - <a, b> needs no
    standardizing; standardized, JAX's own f32 gradient of it strays by
    ~2.5% from a float64 run while the port's stays within 1e-5)."""
    return jfill(lambda: jid.init_irse_backbone(KEY, width=0.25), 6)


def test_irse_embed_matches_jax(irse):
    x = np.random.default_rng(11).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    got = tid.irse_embed(bridge_zoo(irse), torch.from_numpy(x))
    close(got.detach().numpy(), np.asarray(jid.irse_embed(irse, x)))


def test_id_loss_and_grads_match_jax(irse):
    """id_loss and d/d(y_hat) against JAX; d/dy is zero (stop-grad)."""
    jfrozen = {"arcface": irse}
    p = bridge_zoo(irse)
    rng = np.random.default_rng(12)
    y_hat, y = (rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32) for _ in range(2))
    th, ty = torch.from_numpy(y_hat).requires_grad_(), torch.from_numpy(y).requires_grad_()
    loss = tid.id_loss(p, th, ty)
    gh, gy = torch.autograd.grad(loss, (th, ty), allow_unused=True)
    jloss, (jgh, jgy) = jax.jit(jax.value_and_grad(
        lambda a, b: jid.id_loss(jfrozen["arcface"], a, b), argnums=(0, 1)))(y_hat, y)
    rel_close(loss, jloss, LOSS_REL)
    assert float(np.abs(np.asarray(jgy)).max()) == 0.0
    assert gy is None or float(gy.abs().max()) == 0.0
    grads_close([gh], [torch.from_numpy(np.array(jgh))])


def test_irse_backbone_shapes_and_fill_match_jax():
    """init_irse_backbone (width 0.25) filled by zoo.fill_random equals the
    JAX init tree numpy-filled with the same seed, bridged."""
    jtree = jax.eval_shape(lambda: jid.init_irse_backbone(KEY, width=0.25))
    got = flat(tzoo.fill_random(tid.init_irse_backbone(width=0.25), 3))
    ref = flat(bridge_zoo(_fill_random(jtree, 3)))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v, k


# --- train step ---------------------------------------------------------------

def _hair_case(mult):
    return (lambda p, wf, wt: trot.rotate_hair_loss(p, (wf, wt), mults=(mult,)),
            lambda p, wf, wt: jrot.rotate_hair_loss(p, (wf, wt), mults=jnp.asarray([mult])))


@pytest.mark.parametrize("case", ["hair_clip_off", "hair_clip_on", "blending"])
def test_train_step_matches_optax(case, rotate_setup, blend_setup):
    """One step of make_train_step + adam_with_clip against the JAX step:
    loss, pre-clip grad_norm, each gradient and the params after Adam, with
    the global clip inactive (||g|| < 5) and active (||g|| > 5). The
    gradients of both packages' f32 runs are held against the port's
    float64 run (`f32_no_worse`), the steps each against the port's
    float64 step."""
    if case == "blending":
        jfrozen, jparams, batch = blend_setup
        frozen = bridge_zoo(jfrozen)
        tstep, _ = tbl.make_blending_train_step(frozen, TCFG, lr=LR)
        tstep64, _ = tbl.make_blending_train_step(d64(frozen), TCFG, lr=LR)
        jstep, jtx = jbl.make_blending_train_step(jfrozen, JCFG, lr=LR)
        tloss = lambda p: tbl.blending_loss(p, frozen, tb(batch), TCFG)  # noqa: E731
        tloss64 = lambda p: tbl.blending_loss(p, d64(frozen), d64(tb(batch)), TCFG)  # noqa: E731
        jloss = lambda p: jbl.blending_loss(p, jfrozen, batch, JCFG)  # noqa: E731
    else:
        _, jparams, batch = rotate_setup
        batch = batch[2:]
        tfn, jfn = _hair_case(0.05 if case == "hair_clip_off" else 5e2)
        tstep = tcommon.make_train_step(tfn, tcommon.adam_with_clip(LR))
        tstep64 = tstep
        jtx = jcommon.adam_with_clip(LR)
        jstep = jcommon.make_train_step(jfn, jtx, donate=False)
        tloss = lambda p: tfn(p, *tb(batch))  # noqa: E731
        tloss64 = lambda p: tfn(p, *d64(tb(batch)))  # noqa: E731
        jloss = lambda p: jfn(p, *batch)  # noqa: E731
    params = bridge_zoo(jparams)
    _, _, grads = port_grads(tloss, params)
    _, _, rgrads = port_grads(tloss64, d64(params))
    _, _, jgrads = jax_grads(jloss, jparams)
    f32_no_worse(grads, jgrads, rgrads)

    tx = tcommon.adam_with_clip(LR)
    p64 = d64(params)
    p64, _, raux = tstep64(p64, tx.init(p64), *d64(tb(batch)))
    params, opt, aux = tstep(params, tx.init(params), *tb(batch))
    jp1, _, jaux = jstep(jparams, jtx.init(jparams), *batch)
    for got in (aux, jaux):
        rel_close(got["loss"], raux["loss"], LOSS_REL)
        rel_close(got["grad_norm"], raux["grad_norm"], GRAD_REL)
    assert (float(raux["grad_norm"]) > 5.0) == (case == "hair_clip_on")
    for got in (params, bridge_zoo(jp1)):
        for a, b in zip(tensor_leaves(got), tensor_leaves(p64)):
            np.testing.assert_allclose(a.detach().double().numpy(), b.detach().numpy(),
                                       atol=LR / 5, rtol=0)
    assert all(t.grad is None for t in tensor_leaves(params))


def test_clip_is_optax_clip_without_eps():
    """At ||g|| = 5 + 1e-6 the clip scales by exactly 5/||g||; the +1e-6 of
    clip_grad_norm_ would not."""
    g = [torch.full((4,), 2.5 + 5e-7, dtype=torch.float64)]
    norm = tcommon.adam_with_clip().clip_(g)
    assert float(norm) == pytest.approx(5.0 + 1e-6, abs=1e-12)
    assert float(tcommon.global_norm(g)) == pytest.approx(5.0, abs=1e-12)
    small = [torch.full((4,), 1.0, dtype=torch.float64)]
    tcommon.adam_with_clip().clip_(small)
    assert torch.equal(small[0], torch.ones(4, dtype=torch.float64))


def test_frozen_leaves_stay_frozen(blend_setup):
    """A blending step moves every trainable leaf and leaves every frozen one
    (generator, CLIP) untouched, with no .grad: even leaves handed in with
    requires_grad=True are frozen by make_train_step."""
    jfrozen, jparams, batch = blend_setup
    frozen, params = bridge_zoo(jfrozen), bridge_zoo(jparams)
    for t in tensor_leaves(frozen):
        t.requires_grad_(True)
    before = [t.detach().clone() for t in tensor_leaves(frozen)]
    p0 = [t.clone() for t in tensor_leaves(params)]
    step, tx = tbl.make_blending_train_step(frozen, TCFG, lr=LR)
    params, _, aux = step(params, tx.init(params), *tb(batch))
    assert np.isfinite(float(aux["loss"])) and np.isfinite(float(aux["grad_norm"]))
    for t, b in zip(tensor_leaves(frozen), before):
        assert t.grad is None and not t.requires_grad and torch.equal(t, b)
    assert all(not torch.equal(a, b) for a, b in zip(tensor_leaves(params), p0))


def test_train_step_after_an_inference_mode_swap(blend_setup):
    """The resize matrices are cached per device; a first use under
    torch.inference_mode() (as every swap runs) must not leave inference
    tensors there, or a later training step could not save them for its
    backward pass."""
    from hairfastgan_torch.ops import resample

    jfrozen, jparams, batch = blend_setup
    resample._on_device.cache_clear()
    with torch.inference_mode():
        for size in (64, 1024):  # the micro and the full-width blend renders' to_res
            tbl.to_res(torch.zeros(1, 3, size, size), 256)
    frozen, params = bridge_zoo(jfrozen), bridge_zoo(jparams)
    step, tx = tbl.make_blending_train_step(frozen, TCFG, lr=LR)
    _, _, aux = step(params, tx.init(params), *tb(batch))
    assert np.isfinite(float(aux["loss"]))


def test_rotate_hair_step():
    params = tzoo.fill_random(tenc.init_rotate_model(), 0)
    tx = tcommon.adam_with_clip(1e-4)
    step = tcommon.make_train_step(lambda p, *b: trot.rotate_hair_loss(p, b), tx)
    p0 = [t.clone() for t in tensor_leaves(params)]
    rng = np.random.default_rng(1)
    w_from, w_to = (torch.from_numpy(rng.standard_normal((2, 18, 512), np.float32) * 0.1)
                    for _ in range(2))
    params, _, aux = step(params, tx.init(params), w_from, w_to)
    assert np.isfinite(float(aux["loss"]))
    assert max(float((a - b).abs().max()) for a, b in zip(tensor_leaves(params), p0)) > 0


def test_blending_train_step_tiny():
    frozen, params, cfg = tzoo.blending_train_tiny(0)
    step, tx = tbl.make_blending_train_step(frozen, cfg)
    n, b = cfg.stylegan.n_latent, 1
    rng = np.random.default_rng(2)
    batch = [rng.standard_normal((b, n, 512), np.float32) * 0.1,
             rng.standard_normal((b, n, 512), np.float32) * 0.1,
             rng.standard_normal((b, 32, 32, 512), np.float32) * 0.1,
             rng.standard_normal((b, 256, 256, 3), np.float32) * 0.5,
             rng.standard_normal((b, 256, 256, 3), np.float32) * 0.5] + [
        np.ones((b, 256, 256, 1), np.float32)] * 3
    _, _, aux = step(params, tx.init(params), *tb(batch))
    assert np.isfinite(float(aux["loss"])) and np.isfinite(float(aux["face_loss"]))


def test_nan_guard():
    tcommon.check_finite_loss(torch.tensor(1.0), 0)
    with pytest.raises(FloatingPointError):
        tcommon.check_finite_loss(torch.tensor(float("nan")), 3)
    with pytest.raises(FloatingPointError):
        tcommon.check_finite_loss(torch.tensor(float("inf")), 4)


def test_train_step_remat_equivalence():
    """remat=True (torch.utils.checkpoint) gives the same update: the same
    math, recomputed on the backward pass."""
    loss = lambda p, wf, wt: trot.rotate_hair_loss(p, (wf, wt))  # noqa: E731
    tx = tcommon.adam_with_clip(1e-3)
    plain = tcommon.make_train_step(loss, tx)
    remat = tcommon.make_train_step(loss, tx, remat=True)
    rng = np.random.default_rng(3)
    wf, wt = (torch.from_numpy(rng.standard_normal((2, 6, 512), np.float32) * 0.3)
              for _ in range(2))
    pa, pb = (tzoo.fill_random(tenc.init_rotate_model(), 0) for _ in range(2))
    ga = port_grads(lambda p: loss(p, wf, wt), pa)[2]
    gb = port_grads(lambda p: torch.utils.checkpoint.checkpoint(
        lambda q: loss(q, wf, wt), p, use_reentrant=False), pb)[2]
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, rtol=0)
    pa, _, a0 = plain(pa, tx.init(pa), wf, wt)
    pb, _, a1 = remat(pb, tx.init(pb), wf, wt)
    assert float(a0["loss"]) == pytest.approx(float(a1["loss"]), rel=1e-6)
    assert float(a0["grad_norm"]) == pytest.approx(float(a1["grad_norm"]), rel=1e-5)
    for x, y in zip(tensor_leaves(pa), tensor_leaves(pb)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), atol=2e-4, rtol=0)


def _overfit(step, params, opt, args, n_steps):
    losses = []
    for _ in range(n_steps):
        params, opt, aux = step(params, opt, *args)
        loss = float(aux["loss"])
        assert np.isfinite(loss) and np.isfinite(float(aux["grad_norm"]))
        losses.append(loss)
    return losses


def test_rotate_overfit_smoke():
    """40 steps on 4 fixed hair pairs: the loss falls under 0.6x its start
    (a sign flip, stale optimizer state or tree mixup would not)."""
    params = tzoo.fill_random(tenc.init_rotate_model(), 0)
    _, hair_step, tx = trot.make_rotate_train_steps({}, None, lr=1e-3)
    rng = np.random.default_rng(4)
    w_from, w_to = (torch.from_numpy(rng.standard_normal((4, 18, 512), np.float32) * 0.1)
                    for _ in range(2))
    losses = _overfit(hair_step, params, tx.init(params), (w_from, w_to, None), 40)
    assert losses[-1] < 0.6 * losses[0], losses


def test_blending_overfit_smoke(blend_setup):
    """20 steps of the micro blending trainer on one fixed batch of 2: the
    loss falls under 0.6x its start."""
    jfrozen, jparams, _ = blend_setup
    frozen, params = bridge_zoo(jfrozen), bridge_zoo(jparams)
    step, tx = tbl.make_blending_train_step(frozen, TCFG, lr=1e-2)
    batch = blend_batch(np.random.default_rng(5), 2)
    losses = _overfit(step, params, tx.init(params), tb(batch), 20)
    assert losses[-1] < 0.6 * losses[0], losses


# --- train state --------------------------------------------------------------

def test_train_state_round_trip(tmp_path, blend_setup):
    """save_train_state -> restore_train_state: the params without the CLIP
    tower, Adam's moments and the step, leaf for leaf; a step from the
    restored state equals a step from the live one."""
    jfrozen, jparams, batch = blend_setup
    frozen, params = bridge_zoo(jfrozen), bridge_zoo(jparams)
    step, tx = tbl.make_blending_train_step(frozen, TCFG, lr=LR)
    opt = tx.init(params)
    params, opt, _ = step(params, opt, *tb(batch))
    path = tckpt.save_train_state(tmp_path / "last", dict(params, clip=frozen["clip"]),
                                  opt.state_dict(), 7)
    assert path == tmp_path / "last" / "train_state.pt"
    state = tckpt.restore_train_state(tmp_path / "last", device="cpu")
    assert sorted(state) == ["opt_state", "params", "step"] and state["step"] == 7
    assert sorted(state["params"]) == ["mods"]  # the frozen CLIP tower is stripped
    for a, b in zip(tensor_leaves(state["params"]), tensor_leaves(params)):
        assert torch.equal(a, b.detach())
    live = opt.state_dict()["state"]
    assert sorted(state["opt_state"]["state"]) == sorted(live)
    for i, s in live.items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state["opt_state"]["state"][i][k], s[k]), (i, k)

    restored = state["params"]
    opt2 = tx.init(restored)
    opt2.load_state_dict(state["opt_state"])
    restored, _, _ = step(restored, opt2, *tb(batch))
    params, _, _ = step(params, opt, *tb(batch))
    for a, b in zip(tensor_leaves(restored), tensor_leaves(params)):
        assert torch.equal(a, b)


# --- converters ---------------------------------------------------------------

def make_irse_backbone(rng) -> SD:
    """ir_se50.pth layout (TreB1eN Backbone) at 1/16 width, SE in every block."""
    d = SD(rng)
    d.conv("input_layer.0", 3, 16, 3, bias=False)
    d.bn("input_layer.1", 16)
    d.prelu("input_layer.2", 16)
    from hairfastgan_torch.models.e4e import _blocks_50

    for i, (ci, co, _) in enumerate(_blocks_50(width=1 / 16)):
        n = f"body.{i}"
        d.bn(f"{n}.res_layer.0", ci)
        d.conv(f"{n}.res_layer.1", ci, co, 3, bias=False)
        d.prelu(f"{n}.res_layer.2", co)
        d.conv(f"{n}.res_layer.3", co, co, 3, bias=False)
        d.bn(f"{n}.res_layer.4", co)
        d.conv(f"{n}.res_layer.5.fc1", co, 2, 1, bias=False)
        d.conv(f"{n}.res_layer.5.fc2", 2, co, 1, bias=False)
        if ci != co:
            d.conv(f"{n}.shortcut_layer.0", ci, co, 1, bias=False)
            d.bn(f"{n}.shortcut_layer.1", co)
    d.bn("output_layer.0", 32)
    d.linear("output_layer.3", 32 * 7 * 7, 16)
    d.bn("output_layer.4", 16)
    return d


def make_arcface(rng) -> SD:
    """insightface IResNet (conv1/bn1/prelu, layer1-4 of two blocks, bn2, fc,
    features) at narrow widths."""
    d = SD(rng)
    d.conv("conv1", 3, 4, 3, bias=False)
    d.bn("bn1", 4)
    d.prelu("prelu", 4)
    for st, (ci, co) in zip(("layer1", "layer2", "layer3", "layer4"),
                            ((4, 4), (4, 6), (6, 8), (8, 8))):
        d.ibasic(f"{st}.0", ci, co)
        d.ibasic(f"{st}.1", co, co)
    d.bn("bn2", 8)
    d.linear("fc", 8 * 7 * 7, 16)
    d.bn("features", 16, affine=False)
    return d


def test_convert_irse_backbone_matches_jax():
    sd = make_irse_backbone(np.random.default_rng(30))
    assert_same_tree(tid.convert_irse_backbone(sd), bridge_zoo(jid.convert_irse_backbone(sd)))


def test_convert_arcface_matches_jax():
    sd = make_arcface(np.random.default_rng(31))
    assert_same_tree(TC.convert_arcface(sd), bridge_zoo(JC.convert_arcface(sd)))


def test_converted_irse_embeds_like_jax():
    """The converted 1/16-width backbone embeds a 112^2 crop as the JAX one does."""
    sd = make_irse_backbone(np.random.default_rng(32))
    x = np.random.default_rng(33).uniform(-1, 1, (1, 112, 112, 3)).astype(np.float32)
    got = tid.irse_embed(tid.convert_irse_backbone(sd), torch.from_numpy(x))
    close(got.numpy(), np.asarray(jid.irse_embed(jid.convert_irse_backbone(sd), x)))
