"""PostProcess (refinement) encoder training (counterpart of
hairfastgan_tpu/train/pp.py; reference scripts/pp_train.py).

The loop of pp_train.py:121-183:
  model(source, target) -> (S, F)
  gen_im_W = G[0..8](S)           # W-path render
  F_w      = G[0..4](S)           # feature at pair 4 (64x64)
  gen_im_F = G[5..8](S, layer_in=F [alpha-annealed mix with F_w])
  losses   = LossBuilderMulti: dice over BiSeNet-16, masked ID, multi-scale
             LPIPS face/hair, feature reconstruction, optional inpaint +
             adversarial (softplus) with discriminator/R1 steps

Default loss weights from pp_train.py's argparse. The batch, the renders in
`aux` and the discriminator's images keep the JAX package's NHWC layout;
inside, the maps are NCHW. Gradients come from autograd through the port's
plain ops; the generator renders at zero noise.

With a data mesh `plan` (parallel/mesh.py) every loss runs per shard against
the device's replica of the trained parameters and the shards' losses are
reduced on the lead device before one backward, except where samples meet:
the discriminator's minibatch-stddev groups span the global batch
(models/stylegan2_discriminator.minibatch_stddev), in the adversarial
term, the discriminator step and R1 alike.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.losses.identity import id_loss
from hairfastgan_torch.losses.objectives import (adv_d_loss, adv_g_loss, dice_loss, dilated_mask,
                                                 feat_recon_loss, r1_penalty)
from hairfastgan_torch.losses.perceptual import lpips_scale
from hairfastgan_torch.models import bisenet, encoders, stylegan2
from hairfastgan_torch.models.stylegan2_discriminator import discriminator, discriminator_nchw
from hairfastgan_torch.ops.resample import resize
from hairfastgan_torch.parallel import mesh
from hairfastgan_torch.params.bridge import map_tree
from hairfastgan_torch.pipeline.embedding import to_res
from hairfastgan_torch.train.common import adam_with_clip, apply_update, freeze, make_train_step

Tensor = torch.Tensor

DEFAULT_WEIGHTS = {
    "landmark": 1.0, "id": 1.0, "feat_rec": 1.0,
    "lpips_scale": 1.0, "inpaint": 1.0, "adv": 0.1,
}


def _cast_floats(tree, dtype):
    """Float leaves -> `dtype` (a differentiable cast: gradients reach the
    f32 leaves through it); other leaves as they are."""
    return map_tree(tree, lambda _, t: t.to(dtype) if t.is_floating_point() else t)


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def _seg16_logits(frozen, img01: Tensor) -> Tensor:
    """BiSeNet-16 on the 512-downsampled [0,1] NCHW image -> NCHW logits
    (pp_losses.py:340-345)."""
    return bisenet.bisenet_logits_nchw(frozen["bisenet16"],
                                       bisenet.to_bisenet_input(to_res(img01, 512)))


def _make_synth(remat: bool, cfg: HairFastConfig):
    """Generator-render helper, NCHW, zero noise: synth(gen, s, start_layer,
    end_layer, layer_in) -> (features, rgb) in the dtype of S (the compute
    dtype). With `remat` each render runs under torch.utils.checkpoint: only
    its inputs (S, F) are saved and its forward is recomputed when the
    backward pass reaches it."""
    noise = stylegan2.make_noise(None, cfg.stylegan)

    def render(gen, s, layer_in, start_layer, end_layer):
        return stylegan2.synthesis_nchw(gen, s, noise=noise, start_layer=start_layer,
                                        end_layer=end_layer, layer_in=layer_in,
                                        cfg=cfg.stylegan, dtype=s.dtype)

    def synth(gen, s, start_layer=0, end_layer=8, layer_in=None):
        if remat:
            return checkpoint(render, gen, s, layer_in, start_layer, end_layer,
                              use_reentrant=False)
        return render(gen, s, layer_in, start_layer, end_layer)

    return synth


def _renders(params, frozen, source, target, alpha, synth, need_w: bool = True):
    """(F NCHW, F_w, gen_W or None, gen_F): the encoder and the generator
    renders of pp_train.py:125-137 (F_w enters the F mix detached)."""
    s, f = encoders.post_process_model(params, source, target)
    f = _nchw(f)
    gen = frozen["generator"]
    gen_w = synth(gen, s)[1] if need_w else None
    f_w, _ = synth(gen, s, start_layer=0, end_layer=4)
    f_in = alpha * f + (1.0 - alpha) * f_w.detach()
    _, gen_f = synth(gen, s, start_layer=5, end_layer=8, layer_in=f_in)
    return f, f_w, gen_w, gen_f


def _dice_term(frozen, weights, target, gen_f) -> Tensor:
    """Dice over BiSeNet-16 probabilities at 256; the target's parse carries
    no gradient. target: NCHW [-1,1] at 256, gen_f: the full-res render."""
    with torch.no_grad():
        tgt512 = resize((target + 1) / 2, (512, 512), "bilinear").clamp(0, 1)
        seg_t = resize(_seg16_logits(frozen, tgt512), (256, 256), "nearest")
    seg_g = resize(_seg16_logits(frozen, (gen_f + 1) / 2), (256, 256), "nearest")
    return weights["landmark"] * dice_loss(seg_g, seg_t)


def _id_term(frozen, weights, source, target_mask, gen_w_256, gen_f_256) -> Tensor:
    """Masked identity of both renders against the source (NCHW maps; the
    identity loss takes NHWC)."""
    src = _nhwc(source * target_mask)
    return weights["id"] * (id_loss(frozen["id_backbone"], _nhwc(gen_w_256 * target_mask), src)
                            + id_loss(frozen["id_backbone"], _nhwc(gen_f_256 * target_mask), src))


def _lpips_terms(frozen, weights, source, target, target_mask, ht_e, gen_w_256,
                 gen_f_256) -> Dict[str, Tensor]:
    """Multi-scale LPIPS over the face and hair regions and, with an
    `inpaint` weight, over the dilated rest (NCHW maps)."""
    lp, tm, ht = frozen["lpips"], target_mask, ht_e
    out = {"lpips_face": 0.5 * weights["lpips_scale"] * (
               lpips_scale(lp, source * tm, gen_w_256 * tm)
               + lpips_scale(lp, source * tm, gen_f_256 * tm)),
           "lpips_hair": 0.5 * weights["lpips_scale"] * (
               lpips_scale(lp, target * ht, gen_w_256 * ht)
               + lpips_scale(lp, target * ht, gen_f_256 * ht))}
    if weights.get("inpaint", 0.0):
        smooth = dilated_mask((1 - tm) * (1 - ht), 25)
        out["inpaint"] = 0.5 * weights["inpaint"] * (
            lpips_scale(lp, target * smooth, gen_f_256 * smooth)
            + lpips_scale(lp, gen_w_256.detach() * smooth * (1 - ht),
                          gen_f_256 * smooth * (1 - ht)))
    return out


def _adv_term(disc_params, weights, gen_f) -> Tensor:
    """The generator's adversarial term, in gen_f's dtype; no gradient
    reaches the discriminator's parameters (they are the disc step's)."""
    disc = map_tree(disc_params, lambda _, t: t.detach().to(gen_f.dtype))
    return weights["adv"] * adv_g_loss(discriminator_nchw(disc, gen_f))


def _mixed(compute_dtype, params, frozen, batch):
    """Cast the trainable params, the frozen nets and the batch to
    `compute_dtype` (bf16 activations, f32 masters); None keeps them."""
    if compute_dtype is None:
        return params, frozen, tuple(batch)
    return (_cast_floats(params, compute_dtype), _cast_floats(frozen, compute_dtype),
            tuple(x.to(compute_dtype) for x in batch))


def _total(terms: Dict[str, Tensor], renders: Dict[str, Tensor]):
    """(sum of the terms in f32, aux: the terms and the detached renders)."""
    terms = {k: v.float() for k, v in terms.items()}
    return sum(terms.values()), dict(terms, **renders)


def _run(plan, params, frozen, batch, terms_fn, disc_params, weights):
    """(total, aux) of terms_fn(params, frozen, batch) -> (terms, gen_f or
    None, renders), plus with `disc_params` the adversarial term of gen_f;
    on one device, or over the global batch on the data mesh `plan`: the
    terms per shard against the device's replica of `params` (`frozen` a
    Replicas or one tree), the discriminator's stddev groups across the
    shards, the shards' terms reduced on the lead device."""
    if plan is None:
        terms, gen_f, renders = terms_fn(params, frozen, batch)
        if disc_params is not None:
            terms["adv"] = _adv_term(disc_params, weights, gen_f)
        return _total(terms, renders)
    reps = mesh.replicate(plan, params)
    shards = [mesh.shard_batch(plan, x) for x in batch]
    parts = [terms_fn(mesh.on(reps, d), mesh.on(frozen, d), tuple(s[i] for s in shards))
             for i, d in enumerate(plan.data_devices)]
    if disc_params is not None:
        dtype = parts[0][1].dtype
        disc = mesh.replicate(plan, map_tree(disc_params, lambda _, t: t.detach().to(dtype)))
        logits = discriminator_nchw(disc, [gen_f for _, gen_f, _ in parts], plan)
        for (terms, _, _), lg in zip(parts, logits):
            terms["adv"] = weights["adv"] * adv_g_loss(lg)
    return mesh.reduce_shards(plan, [_total(t, r) for t, _, r in parts],
                              [x.shape[0] for x in shards[0]])


def _pp_terms(params, frozen, batch, weights, alpha, cfg, remat, compute_dtype):
    """Every term of pp_loss but the adversarial one, the full-res F render
    (in the graph) and the detached renders of its aux."""
    params, frozen, batch = _mixed(compute_dtype, params, frozen, batch)
    source, target, target_mask, ht_e = batch
    f, f_w, gen_w, gen_f = _renders(params, frozen, source, target, alpha,
                                    _make_synth(remat, cfg))
    gen_w_256, gen_f_256 = to_res(gen_w, 256), to_res(gen_f, 256)
    src, tgt, tm, ht = (_nchw(x) for x in batch)

    terms = {"dice": _dice_term(frozen, weights, tgt, gen_f),
             "id": _id_term(frozen, weights, src, tm, gen_w_256, gen_f_256),
             "feat_rec": weights["feat_rec"] * feat_recon_loss(f_w.detach(), f)}
    terms.update(_lpips_terms(frozen, weights, src, tgt, tm, ht, gen_w_256, gen_f_256))
    # the full-res F render is the discriminator step's fake (the reference
    # trains D on gen_im_F.detach(), not a 256 crop, pp_train.py:162)
    return terms, gen_f, dict(gen_f_256=_nhwc(gen_f_256.detach()),
                              gen_w_256=_nhwc(gen_w_256.detach()), gen_f=_nhwc(gen_f.detach()))


def pp_loss(params, frozen: Dict, batch: Tuple[Tensor, ...],
            weights: Dict[str, float] = DEFAULT_WEIGHTS, alpha: float = 1.0, disc_params=None,
            cfg: HairFastConfig = HairFastConfig(), remat: bool = False,
            compute_dtype=None, plan=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """batch: (source norm256, target norm256, target_mask [B,256,256,1],
    HT_E [B,256,256,1]), NHWC; `alpha` anneals the F injection
    (pp_train.py:133-137). remat: per-render rematerialization (see
    `_make_synth`).

    compute_dtype=torch.bfloat16 casts the trainable params, the frozen nets
    and the batch at entry, so every render and backbone activation is bf16
    while the Adam master params stay f32 (gradients reach them through the
    cast); norm statistics still fold in f32 (ops/basic.py) and the per-term
    scalars are cast back to f32 before the sum.

    plan: a data mesh; the loss is then the global batch's (`_run`), and
    `frozen` may be its Replicas.

    aux: every term, plus the detached renders gen_f (full res), gen_f_256
    and gen_w_256, NHWC [-1,1].
    """
    def terms_fn(p, fr, b):
        return _pp_terms(p, fr, b, weights, alpha, cfg, remat, compute_dtype)

    return _run(plan, params, frozen, tuple(batch), terms_fn, disc_params, weights)


def pp_disc_loss(disc_params, real: Tensor, fake: Tensor, plan=None) -> Tuple[Tensor, Dict]:
    """real, fake: NHWC [-1,1] at the generator's resolution. With a data
    mesh `plan` both are sharded and the minibatch-stddev groups of each
    span its global batch."""
    if plan is None:
        loss = adv_d_loss(discriminator(disc_params, real), discriminator(disc_params, fake))
        return loss, {"disc_adv": loss}
    reps = mesh.replicate(plan, disc_params)
    r, f = (discriminator(reps, mesh.shard_batch(plan, x), plan) for x in (real, fake))
    losses = [adv_d_loss(a, b) for a, b in zip(r, f)]
    return mesh.reduce_shards(plan, [(v, {"disc_adv": v}) for v in losses],
                              [x.shape[0] for x in r])


def _split_args(use_adv: bool, batch_and_disc):
    """(*batch, [disc,] alpha) -> (batch, disc or None, alpha)."""
    if use_adv:
        *batch, disc_params, alpha = batch_and_disc
    else:
        *batch, alpha = batch_and_disc
        disc_params = None
    return tuple(batch), disc_params, alpha


def make_pp_split_train_step(frozen: Dict, weights=DEFAULT_WEIGHTS,
                             cfg: HairFastConfig = HairFastConfig(), lr: float = 1e-4,
                             use_adv: bool = False, remat: bool = False, compute_dtype=None,
                             plan=None):
    """Segmented enc_step: the SAME update as `make_pp_train_steps`' fused
    step. The loss is a sum of terms, so grad(total) = sum of the grads of
    its groups: each segment [dice | id+feat_rec | lpips(+inpaint) | adv?]
    re-runs the encoder and the renders it needs, backpropagates into the
    same `.grad`, and frees its graph before the next starts; then one clip
    and one Adam step follow. What it buys in PyTorch is a lower peak of
    device memory (one segment's graph lives at a time) for about twice the
    forward work. (The JAX package split its step for a compile proxy's
    request-size cap, which has no counterpart here.) With a data mesh
    `plan` each segment runs over the global batch (`_run`: one reduction
    per segment).

    Returns (step, tx) with the fused step's call and aux contract.
    """
    tx = adam_with_clip(lr)
    freeze(frozen)
    frozen_arg = mesh.replicate(plan, frozen) if plan is not None else frozen
    synth = _make_synth(remat, cfg)

    # each segment: (params, frozen, batch, alpha) -> (terms, gen_f or None,
    # renders); the cast to compute_dtype is redone per segment, as each
    # segment's backward frees its graph, the cast's included
    def seg_dice(params, fr, batch, alpha):
        params, fr, batch = _mixed(compute_dtype, params, fr, batch)
        _, _, _, gen_f = _renders(params, fr, batch[0], batch[1], alpha, synth, need_w=False)
        return ({"dice": _dice_term(fr, weights, _nchw(batch[1]), gen_f)}, None,
                {"gen_f": _nhwc(gen_f.detach())})

    def seg_id_feat(params, fr, batch, alpha):
        params, fr, batch = _mixed(compute_dtype, params, fr, batch)
        f, f_w, gen_w, gen_f = _renders(params, fr, batch[0], batch[1], alpha, synth)
        gen_w_256, gen_f_256 = to_res(gen_w, 256), to_res(gen_f, 256)
        return ({"id": _id_term(fr, weights, _nchw(batch[0]), _nchw(batch[2]), gen_w_256,
                                gen_f_256),
                 "feat_rec": weights["feat_rec"] * feat_recon_loss(f_w.detach(), f)}, None,
                {"gen_w_256": _nhwc(gen_w_256.detach()), "gen_f_256": _nhwc(gen_f_256.detach())})

    def seg_lpips(params, fr, batch, alpha):
        params, fr, batch = _mixed(compute_dtype, params, fr, batch)
        _, _, gen_w, gen_f = _renders(params, fr, batch[0], batch[1], alpha, synth)
        return (_lpips_terms(fr, weights, *(_nchw(x) for x in batch), to_res(gen_w, 256),
                             to_res(gen_f, 256)), None, {})

    def seg_adv(params, fr, batch, alpha):  # _run adds the adversarial term of gen_f
        params, fr, batch = _mixed(compute_dtype, params, fr, batch)
        _, _, _, gen_f = _renders(params, fr, batch[0], batch[1], alpha, synth, need_w=False)
        return {}, gen_f, {}

    def step(params, opt: torch.optim.Optimizer, *batch_and_disc):
        batch, disc_params, alpha = _split_args(use_adv, batch_and_disc)
        segs = [(seg_dice, None), (seg_id_feat, None), (seg_lpips, None)]
        if disc_params is not None:
            segs.append((seg_adv, disc_params))
        loss, aux = 0.0, {}
        for seg, disc in segs:
            v, a = _run(plan, params, frozen_arg, batch,
                        lambda p, fr, b, seg=seg: seg(p, fr, b, alpha), disc, weights)
            v.backward()
            loss = loss + v.detach()
            aux.update({k: t.detach() for k, t in a.items()})
        norm = apply_update(tx, opt)
        return params, opt, dict(aux, loss=loss, grad_norm=norm.detach())

    return step, tx


def make_pp_train_steps(frozen: Dict, weights=DEFAULT_WEIGHTS,
                        cfg: HairFastConfig = HairFastConfig(), lr: float = 1e-4,
                        use_adv: bool = False, remat: bool = False, compute_dtype=None,
                        plan=None):
    """(enc_step, disc_step, r1_step, tx, d_tx):

        params, opt, aux = enc_step(params, opt, *batch, [disc,] alpha)
        disc, d_opt, d_aux = disc_step(disc, d_opt, real, fake)   # use_adv
        r1 = r1_step(disc, real)

    enc_step goes through train/common.make_train_step with `frozen`; with
    use_adv it takes the discriminator's params (None during the warm-up
    steps). r1_step evaluates the R1 penalty for the log, as the JAX
    package does; no gradient of it reaches the discriminator (ROADMAP §3).
    With a data mesh `plan` each runs over the global batch, sharded (the
    module docstring). The JAX package's `donate` has no counterpart
    (steps update in place).
    """
    tx = adam_with_clip(lr)
    freeze(frozen)
    frozen_arg = mesh.replicate(plan, frozen) if plan is not None else frozen

    def loss_fn(params, frozen_arg, *batch_and_disc):
        batch, disc_params, alpha = _split_args(use_adv, batch_and_disc)
        return pp_loss(params, frozen_arg, batch, weights, alpha, disc_params, cfg, remat=remat,
                       compute_dtype=compute_dtype, plan=plan)

    enc_step = make_train_step(loss_fn, tx, frozen=frozen_arg)
    disc_step = d_tx = None
    if use_adv:
        d_tx = adam_with_clip(lr)
        disc_step = make_train_step(lambda d, real, fake: pp_disc_loss(d, real, fake, plan), d_tx)

    def disc_fn(disc_params, real: Tensor) -> Tensor:
        if plan is None:
            return discriminator(disc_params, real)
        logits = discriminator(mesh.replicate(plan, disc_params), mesh.shard_batch(plan, real),
                               plan)
        return mesh.gather(logits, plan.lead)

    def r1_step(disc_params, real: Tensor) -> Tensor:
        return r1_penalty(disc_fn, disc_params, real).detach()

    return enc_step, disc_step, r1_step, tx, d_tx
