"""The port's PostProcess training path (hairfastgan_torch/train/pp.py, the
train state with the discriminator, eval/fid.py and scripts/fid_metric.py)
against the JAX package's, f32 (and bf16 for the mixed-precision step), CPU.

One module-scoped micro setup below the JAX package's pp_micro_setup
(tests/test_losses_train.py): generator 128^2 at max_channels 32 (128^2 is
the least size with a G[5..8] pair), BiSeNet-16 and IR-SE-50 at width 0.25,
LPIPS-AlexNet at its widths, the discriminator at the generator's config.
Weights are the JAX init trees numpy-filled and made lively
(tests/test_torch_port_train.jfill), the discriminator's drawn N(0,1) as
the JAX init draws them, LPIPS' linear weights non-negative; IR-SE's
bn_feat centres and scales the embeddings (unit_irse). The JAX side runs once per
module: one compiled value_and_grad of pp_loss, called with the
adversarial weight 0.1 and 0 (0 gives the step without the discriminator),
its bf16 forward, and the disc loss's gradient.

Tolerances (tests/test_torch_port_train.py): losses 1e-5 relative,
gradients 1e-4 of the largest |grad|, params within lr/5 after one Adam
step, models 2e-4 of the output scale; bf16 against the JAX bf16 loss
within 5% + 0.05 (tests/test_losses_train.py's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from hairfastgan_tpu.config import HairFastConfig as JConfig
from hairfastgan_tpu.config import StyleGANConfig as JSG
from hairfastgan_tpu.eval import fid as jfid
from hairfastgan_tpu.losses import identity as jid
from hairfastgan_tpu.losses import perceptual as jper
from hairfastgan_tpu.models import bisenet as jbis
from hairfastgan_tpu.models import clip_vit as jclip
from hairfastgan_tpu.models import encoders as jenc
from hairfastgan_tpu.models import iresnet as jires
from hairfastgan_tpu.models import stylegan2 as jsg
from hairfastgan_tpu.models import stylegan2_discriminator as jdisc
from hairfastgan_tpu.train import common as jcommon
from hairfastgan_tpu.train import pp as jpp
from hairfastgan_torch.config import HairFastConfig, StyleGANConfig
from hairfastgan_torch.eval import fid as tfid
from hairfastgan_torch.params import checkpoint as tckpt
from hairfastgan_torch.params.bridge import bridge_zoo
from hairfastgan_torch.scripts import fid_metric as tfm
from hairfastgan_torch.train import pp as tpp
from hairfastgan_torch.train.common import tensor_leaves
from scripts import fid_metric as jfm
from tests.test_torch_port_pp_losses import normal_fill
from tests.test_torch_port_train import (GRAD_REL, LOSS_REL, LR, blocky, grads_close, jfill,
                                         port_grads, rel_close)
from tests.torch_port_util import close

KEY = jax.random.PRNGKey(0)
SIZE, MAXC = 128, 32
JCFG = JConfig(stylegan=JSG(size=SIZE, max_channels=MAXC))
TCFG = HairFastConfig(stylegan=StyleGANConfig(size=SIZE, max_channels=MAXC))
ALPHA = 0.7
# the steps run at 1e-3 of the loss weights: Adam's first step moves a
# coordinate by lr * g / (|g| + 1e-8), so at full scale the coordinates whose
# gradient is ~1e-8 move by up to lr on their f32 noise (one moved 0.4 lr
# here); at 1e-3 of it every coordinate's step stays linear in g
# (tests/test_torch_port_train.py's pose steps do the same)
STEP_SCALE = 1e-3
STEP_WEIGHTS = {k: v * STEP_SCALE for k, v in tpp.DEFAULT_WEIGHTS.items()}
TERMS = ("dice", "id", "feat_rec", "lpips_face", "lpips_hair", "inpaint")


def _pp_params():
    n, c64 = JCFG.stylegan.n_latent, JCFG.stylegan.channels(64)
    return {"encoder_face": jires.init_fs_encoder(KEY, n_styles=n, fs_layers=(9,), depth=18,
                                                  width=0.25, content_ch=c64),
            "latent_avg": jnp.zeros((n, 512), jnp.float32),
            "to_feature": jires.init_feature_iresnet(KEY, blocks=((c64, 1), (c64, 1)),
                                                     inplanes=2 * c64),
            "to_latent_1": [jenc.init_modulation_module(k, n) for k in jax.random.split(KEY, 5)],
            "to_latent_2": [jenc.init_modulation_module(k, n) for k in jax.random.split(KEY, 5)]}


def unit_irse(p, images256):
    """IR-SE-50 with bn_feat's shift set so that the embeddings of
    `images256` (NHWC [-1,1]) average to zero, and its scale and shift
    divided by their mean norm: a random backbone embeds every image along
    nearly one direction (norm ~115 here), so 1 - <a,b> would be ~-13000,
    drowning the other terms, or, normalized alone, a difference of nearly
    equal numbers. One scalar scale: per-component standardizing made the
    JAX package's own f32 gradient stray from float64 (tests/
    test_torch_port_train.py)."""
    e = np.asarray(jax.jit(jid.extract_id_feats)(p, jnp.asarray(images256)))
    m = e.mean(0)
    s = np.float32(np.linalg.norm(e - m, axis=1).mean())
    bn = p["bn_feat"]
    return dict(p, bn_feat=dict(bn, gamma=bn["gamma"] / s, beta=(bn["beta"] - m) / s))


@pytest.fixture(scope="module")
def pp_setup():
    """Both sides' weights and batch, and the JAX side's readings."""
    rng = np.random.default_rng(3)
    b = 2
    batch = (blocky(rng, b, 8), blocky(rng, b, 8),
             (blocky(rng, b, 8, 1, 0, 1) > 0.5).astype(np.float32),
             (blocky(rng, b, 16, 1, 0, 1) > 0.6).astype(np.float32))
    jfrozen = {"generator": jfill(lambda: jsg.init_generator_params(KEY, JCFG.stylegan), 1),
               "bisenet16": jfill(lambda: jbis.init_bisenet(KEY, n_classes=16, width=0.25), 2),
               "id_backbone": jfill(lambda: jid.init_irse_backbone(KEY, width=0.25), 3),
               "lpips": jfill(lambda: jper.init_lpips_alex(KEY), 4)}
    jfrozen["id_backbone"] = unit_irse(jfrozen["id_backbone"],
                                       np.concatenate([batch[0] * batch[2], batch[1]]))
    # LPIPS' learned linear weights are non-negative (the lpips package clamps them)
    jfrozen["lpips"]["lins"] = [{"w": np.abs(lin["w"])} for lin in jfrozen["lpips"]["lins"]]
    jparams = jfill(_pp_params, 5)
    jd = normal_fill(lambda: jdisc.init_discriminator(KEY, JCFG.stylegan), 6)

    # adv as a traced weight: one compile serves the step with (0.1) and
    # without (0: the same gradients as disc=None) the discriminator
    vg = jax.jit(jax.value_and_grad(
        lambda p, fr, d, adv: jpp.pp_loss(p, fr, batch, dict(jpp.DEFAULT_WEIGHTS, adv=adv),
                                          ALPHA, d, JCFG), has_aux=True))
    ref = {}
    for adv in (True, False):
        (loss, aux), g = vg(jparams, jfrozen, jd, jnp.float32(0.1 if adv else 0.0))
        ref[adv] = (float(loss), {k: np.asarray(v) for k, v in aux.items()}, g)
    ref["bf16"] = float(jax.jit(lambda p, fr: jpp.pp_loss(
        p, fr, batch, alpha=ALPHA, cfg=JCFG, compute_dtype=jnp.bfloat16)[0])(jparams, jfrozen))
    return jfrozen, jparams, jd, batch, ref


def tensors(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def port_side(setup):
    """Fresh port copies of the frozen nets, the params and the discriminator."""
    jfrozen, jparams, jd, batch, _ = setup
    return bridge_zoo(jfrozen), bridge_zoo(jparams), bridge_zoo(jd), tensors(batch)


@jax.jit
def _jax_adam_vec(p, g):
    tx = jcommon.adam_with_clip(LR)
    updates, _ = tx.update(g, tx.init(p), p)
    return optax.apply_updates(p, updates)


def jax_adam_step(jparams, grads, scale=STEP_SCALE):
    """The JAX fused step's update from the JAX gradients times `scale` (the
    loss's at STEP_WEIGHTS by default): optax's clip_by_global_norm(5) +
    adam (train/common.adam_with_clip), on the leaves concatenated into one
    vector (both are elementwise after the global norm; one small program
    instead of one over 361 leaves)."""
    leaves, treedef = jax.tree.flatten(jparams)
    vec = lambda xs: jnp.concatenate([jnp.ravel(x) for x in xs])  # noqa: E731
    new = np.asarray(_jax_adam_vec(vec(leaves), vec(jax.tree.leaves(grads)) * scale))
    out, i = [], 0
    for x in leaves:
        out.append(new[i:i + x.size].reshape(x.shape))
        i += x.size
    return tensor_leaves(bridge_zoo(jax.tree.unflatten(treedef, out)))


def params_close(got, ref, atol=LR / 5):
    got = tensor_leaves(got)
    assert len(got) == len(ref)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == torch.float32, i
        err = float((a.detach() - r).abs().max())
        assert err <= atol, (i, err)


@pytest.mark.parametrize("adv", [True, False], ids=["disc", "no_disc"])
def test_pp_loss_terms_and_grads(pp_setup, adv):
    """Every term, the total and the gradients of pp_loss; the renders in aux."""
    frozen, params, disc, batch = port_side(pp_setup)
    ref_loss, ref_aux, ref_g = pp_setup[4][adv]
    loss, aux, grads = port_grads(
        lambda p: tpp.pp_loss(p, frozen, batch, alpha=ALPHA, disc_params=disc if adv else None,
                              cfg=TCFG), params)
    rel_close(loss, ref_loss, LOSS_REL)
    for k in TERMS + (("adv",) if adv else ()):
        rel_close(aux[k], ref_aux[k], LOSS_REL)
    assert ("adv" in aux) == adv
    grads_close(grads, tensor_leaves(bridge_zoo(ref_g)))
    for k, shape in (("gen_f", (2, SIZE, SIZE, 3)), ("gen_f_256", (2, 256, 256, 3)),
                     ("gen_w_256", (2, 256, 256, 3))):
        assert tuple(aux[k].shape) == shape and not aux[k].requires_grad
        close(aux[k].numpy(), ref_aux[k])


@pytest.mark.parametrize("adv", [True, False], ids=["disc", "no_disc"])
def test_pp_fused_step(pp_setup, adv):
    """make_pp_train_steps' enc_step (JAX call contract: with use_adv the
    discriminator sits before alpha, None in the warm-up) against the JAX
    gradients through optax's clip + Adam; the discriminator's leaves get
    no gradient from the encoder step."""
    frozen, params, disc, batch = port_side(pp_setup)
    _, ref_aux, ref_g = pp_setup[4][adv]
    enc, _, _, tx, d_tx = tpp.make_pp_train_steps(frozen, STEP_WEIGHTS, cfg=TCFG, lr=LR,
                                                  use_adv=True)
    d_opt = d_tx.init(disc)  # trainable, as in the CLI
    p1, _, aux = enc(params, tx.init(params), *batch, disc if adv else None, ALPHA)
    params_close(p1, jax_adam_step(pp_setup[1], ref_g))
    rel_close(aux["grad_norm"], optax.global_norm(ref_g) * STEP_SCALE, GRAD_REL)
    assert all(t.grad is None for t in tensor_leaves(disc)) and d_opt is not None
    assert all(t.grad is None and not t.requires_grad for t in tensor_leaves(frozen))


def test_pp_split_step_matches_fused(pp_setup):
    """The segmented step ([dice | id+feat_rec | lpips+inpaint | adv],
    backpropagated in turn into the same .grad, one clip and Adam step)
    gives the fused step's terms, gradient norm and update."""
    frozen, params, disc, batch = port_side(pp_setup)
    params2 = bridge_zoo(pp_setup[1])
    fused, _, _, tx, _ = tpp.make_pp_train_steps(frozen, STEP_WEIGHTS, cfg=TCFG, lr=LR,
                                                 use_adv=True)
    split, stx = tpp.make_pp_split_train_step(frozen, STEP_WEIGHTS, cfg=TCFG, lr=LR,
                                              use_adv=True)
    pf, _, af = fused(params, tx.init(params), *batch, disc, ALPHA)
    ps, _, as_ = split(params2, stx.init(params2), *batch, disc, ALPHA)
    for k in TERMS + ("adv", "loss"):
        rel_close(as_[k], af[k], LOSS_REL)
    rel_close(as_["grad_norm"], af["grad_norm"], GRAD_REL)
    params_close(ps, [t.detach() for t in tensor_leaves(pf)])
    assert set(as_) == set(af)


def test_pp_remat_step(pp_setup):
    """Per-render torch.utils.checkpoint: the fused step's loss and update
    against the JAX package's (the recomputed renders are the same ones)."""
    frozen, params, _, batch = port_side(pp_setup)
    ref_loss, _, ref_g = pp_setup[4][False]
    enc, _, _, tx, _ = tpp.make_pp_train_steps(frozen, STEP_WEIGHTS, cfg=TCFG, lr=LR,
                                               remat=True)
    p1, _, aux = enc(params, tx.init(params), *batch, ALPHA)
    rel_close(aux["loss"], ref_loss * STEP_SCALE, LOSS_REL)
    params_close(p1, jax_adam_step(pp_setup[1], ref_g))


def test_pp_bf16(pp_setup):
    """compute_dtype=torch.bfloat16: the loss tracks the JAX bf16 loss (5% +
    0.05), the split step tracks the fused one, and the masters stay f32 and
    move (gradients reach them through the cast)."""
    frozen, params, _, batch = port_side(pp_setup)
    ref = pp_setup[4]["bf16"]
    before = [t.clone() for t in tensor_leaves(params)]
    enc, _, _, tx, _ = tpp.make_pp_train_steps(frozen, cfg=TCFG, lr=LR,
                                               compute_dtype=torch.bfloat16)
    p1, _, aux = enc(params, tx.init(params), *batch, ALPHA)
    l1 = float(aux["loss"])
    assert abs(l1 - ref) < 0.05 * abs(ref) + 0.05, (l1, ref)
    assert aux["loss"].dtype == torch.float32 and aux["gen_f"].dtype == torch.bfloat16
    leaves = tensor_leaves(p1)
    assert all(t.dtype == torch.float32 for t in leaves)
    assert sum(float((a - b).abs().sum()) for a, b in zip(leaves, before)) > 0
    _, params2, _, _ = port_side(pp_setup)
    split, stx = tpp.make_pp_split_train_step(frozen, cfg=TCFG, lr=LR,
                                              compute_dtype=torch.bfloat16)
    ps, _, axs = split(params2, stx.init(params2), *batch, ALPHA)
    assert abs(float(axs["loss"]) - l1) < 0.05 * abs(l1) + 0.05
    assert all(t.dtype == torch.float32 for t in tensor_leaves(ps))


def test_pp_disc_step_and_r1(pp_setup):
    """disc_step (softplus D loss on real vs the encoder step's fake) against
    the JAX gradients through optax's clip + Adam; r1_step's logged value
    against the JAX r1_step's."""
    _, _, jd, _, ref = pp_setup
    _, _, disc, _ = port_side(pp_setup)
    rng = np.random.default_rng(8)
    real = (rng.standard_normal((2, SIZE, SIZE, 3)) * 0.5).astype(np.float32)
    fake = np.array(ref[True][1]["gen_f"])
    (jl, _), jg = jax.jit(jax.value_and_grad(jpp.pp_disc_loss, has_aux=True))(jd, real, fake)
    _, dstep, r1_step, _, d_tx = tpp.make_pp_train_steps({}, cfg=TCFG, lr=LR, use_adv=True)
    _, _, jr1, _, _ = jpp.make_pp_train_steps({}, cfg=JCFG, use_adv=True)
    d_opt = d_tx.init(disc)
    r1 = r1_step(disc, torch.from_numpy(real))
    assert float(r1) > 0 and not r1.requires_grad
    rel_close(r1, jr1(jd, real), LOSS_REL)
    assert all(t.grad is None for t in tensor_leaves(disc))  # R1 is only logged
    d1, _, aux = dstep(disc, d_opt, torch.from_numpy(real), torch.from_numpy(fake))
    rel_close(aux["disc_adv"], jl, LOSS_REL)
    rel_close(aux["loss"], jl, LOSS_REL)
    params_close(d1, jax_adam_step(jd, jg, scale=1.0))


def test_train_state_with_disc_roundtrip(tmp_path, pp_setup):
    """save_train_state(..., disc_params) stores "disc" and restore gives it
    back leaf for leaf (its Adam state is not kept, as in the JAX package);
    without it there is no "disc" entry."""
    frozen, params, disc, batch = port_side(pp_setup)
    enc, _, _, tx, _ = tpp.make_pp_train_steps(frozen, cfg=TCFG, lr=LR)
    opt = tx.init(params)
    params, opt, _ = enc(params, opt, *batch, ALPHA)
    tckpt.save_train_state(tmp_path / "s", params, opt.state_dict(), 3, disc_params=disc)
    state = tckpt.restore_train_state(tmp_path / "s")
    assert state["step"] == 3 and set(state) == {"params", "opt_state", "step", "disc"}
    for name, tree in (("params", params), ("disc", disc)):
        got, want = tensor_leaves(state[name]), tensor_leaves(tree)
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)), name
    sd = opt.state_dict()["state"]
    assert all(torch.equal(state["opt_state"]["state"][i]["exp_avg"], sd[i]["exp_avg"])
               for i in sd)
    tckpt.save_train_state(tmp_path / "n", params, opt.state_dict(), 3)
    assert "disc" not in tckpt.restore_train_state(tmp_path / "n")


# --- FID ----------------------------------------------------------------------

def test_fid_stats_and_frechet(tmp_path):
    """FIDStats (streamed in two updates), save/load, frechet_distance and
    fid_from_features: numpy on both sides, so equal."""
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((300, 8)), rng.standard_normal((200, 8)) + 1.5
    ts = tfid.FIDStats().update(a[:120]).update(a[120:])
    js = jfid.FIDStats().update(a[:120]).update(a[120:])
    for x, y in zip(ts.finalize(), js.finalize()):
        np.testing.assert_array_equal(x, y)
    ts.save(tmp_path / "s.npz")
    for x, y in zip(tfid.FIDStats.load(tmp_path / "s.npz").finalize(), ts.finalize()):
        np.testing.assert_array_equal(x, y)
    sb = tfid.FIDStats().update(b).finalize()
    d = tfid.frechet_distance(*ts.finalize(), *sb)
    assert d == jfid.frechet_distance(*js.finalize(), *jfid.FIDStats().update(b).finalize())
    assert d > 8 * 1.5 ** 2 * 0.8 and tfid.frechet_distance(*ts.finalize(), *ts.finalize()) < 1e-6
    assert tfid.fid_from_features([a[:150], a[150:]], [b]) == jfid.fid_from_features(
        [a[:150], a[150:]], [b])


def test_real_stats_cache(tmp_path):
    """real_stats featurizes the directory once and reads the npz cache after
    (the directory is gone then); the stats equal the JAX real_stats'."""
    rng = np.random.default_rng(1)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 32, 3), dtype=np.uint8)).save(d / f"{i}.png")
    feat = lambda x: x.reshape(x.shape[0], -1)[:, :16].astype(np.float64)  # noqa: E731
    ref = jfm.real_stats(d, feat, size=32)
    assert tfm.load_dir(d, size=32).shape == (5, 32, 32, 3)
    cache = tmp_path / "fid_cache.npz"
    got = tfm.real_stats(d, feat, cache=cache, size=32, batch=2)
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-9)
    assert cache.exists()
    for p in d.iterdir():
        p.unlink()
    d.rmdir()
    again = tfm.real_stats(d, feat, cache=cache, size=32)
    for x, y in zip(again, got):
        np.testing.assert_array_equal(x, y)


def test_clip_feature_fn_and_datasets():
    """clip_feature_fn on the port's CLIP tower against the JAX one (models
    tolerance), and compute_fid_datasets through it."""
    clip = jfill(lambda: jclip.init_clip_image_tower(KEY, width=64, layers=2, heads=2,
                                                     embed_dim=512), 7)
    rng = np.random.default_rng(2)
    real = np.repeat(np.repeat(rng.random((6, 8, 8, 3)), 8, 1), 8, 2).astype(np.float32)
    fake = np.clip(real[::-1] + rng.standard_normal(real.shape).astype(np.float32) * 0.1, 0, 1)
    tf, jf = tfid.clip_feature_fn(bridge_zoo(clip)), jfid.clip_feature_fn(clip)
    got, ref = tf(real), jf(real)
    assert got.shape == (6, 512) and got.dtype == np.float32
    close(got, ref)
    d = tfid.compute_fid_datasets(real, fake, tf, batch=4)
    assert np.isfinite(d)
    np.testing.assert_allclose(d, jfid.compute_fid_datasets(real, fake, jf, batch=4), rtol=1e-3)
