"""Blending (color) encoder training (counterpart of
hairfastgan_tpu/train/blending.py; reference scripts/blending_train.py).

Objective (blending_train.py:90-111): render the blended S through frozen
G[4..8] with the aligned F, then CLIP-cosine losses between the generated
256 image and (a) the face image inside the face mask, (b) the color image
inside the hair mask. The first 6 latent rows are ZEROS during training
(blending_train.py:109), unlike inference, which keeps S_face[:6].

Batch layout mirrors Blending_dataset (:210-252), NHWC as in the JAX package:
  (color_s [B,n,512], align_s [B,n,512], align_f [B,32,32,C],
   color_i [B,256,256,3] norm, face_i [B,256,256,3] norm,
   target_mask, HM_3E, HM_XE  [B,256,256,1])
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.models import encoders, stylegan2
from hairfastgan_torch.pipeline.embedding import to_res
from hairfastgan_torch.train.common import adam_with_clip, make_train_step

Tensor = torch.Tensor


def _cosine_loss(a: Tensor, b: Tensor) -> Tensor:
    an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return torch.mean(1.0 - torch.sum(an * bn, dim=-1))


def blend_render(model_params, frozen: Dict, color_s: Tensor, align_s: Tensor,
                 align_f: Tensor, color_i: Tensor, face_i: Tensor, target_mask: Tensor,
                 hm3e: Tensor, cfg: HairFastConfig = HairFastConfig()) -> Tensor:
    """Blend encoder -> G[4..8] at zero noise -> [B,3,256,256] in [-1,1]
    (NCHW); rows 0-5 of the latent are zeros."""
    params = dict(model_params, clip=frozen["clip"])
    blend_s = encoders.blending_model(params, align_s[:, 6:], color_s[:, 6:],
                                      face_i * target_mask, color_i * hm3e)
    b = blend_s.shape[0]
    latent_in = torch.cat([blend_s.new_zeros((b, 6, blend_s.shape[-1])), blend_s], dim=1)
    _, i_g = stylegan2.synthesis_nchw(
        frozen["generator"], latent_in, noise=stylegan2.make_noise(None, cfg.stylegan),
        start_layer=4, end_layer=8, layer_in=align_f.permute(0, 3, 1, 2), cfg=cfg.stylegan,
        dtype=blend_s.dtype)
    return to_res(i_g, 256)


def blending_loss(model_params, frozen: Dict, batch: Tuple[Tensor, ...],
                  cfg: HairFastConfig = HairFastConfig()) -> Tuple[Tensor, Dict[str, Tensor]]:
    color_s, align_s, align_f, color_i, face_i, target_mask, hm3e, _hmxe = batch
    # the reference masks BOTH hair terms with HM_3E; the HM_XE slot is
    # carried in the dataset but unused by calc_loss (blending_train.py:90-99,115)
    i_g256 = blend_render(model_params, frozen, color_s, align_s, align_f, color_i, face_i,
                          target_mask, hm3e, cfg)
    tm, h3 = target_mask.permute(0, 3, 1, 2), hm3e.permute(0, 3, 1, 2)
    b = i_g256.shape[0]
    gen = encoders.clip_image_embed_nchw(frozen["clip"], torch.cat([i_g256 * tm, i_g256 * h3]))
    with torch.no_grad():  # the targets do not depend on the trained weights
        gt = encoders.clip_image_embed(frozen["clip"],
                                       torch.cat([face_i * target_mask, color_i * hm3e]))
    face_loss = _cosine_loss(gen[:b], gt[:b])
    hair_loss = _cosine_loss(gen[b:], gt[b:])
    return face_loss + hair_loss, {"face_loss": face_loss, "hair_loss": hair_loss}


def make_blending_train_step(frozen: Dict, cfg: HairFastConfig = HairFastConfig(),
                             lr: float = 1e-4, plan=None):
    """(step, tx): step(params, opt, *batch) over {"mods": ...}; `frozen`
    holds the generator and the CLIP tower; `plan` (a data mesh) shards
    the batch (train/common.make_train_step)."""
    tx = adam_with_clip(lr)

    def loss_fn(params, frozen_arg, *batch):
        return blending_loss(params, frozen_arg, batch, cfg)

    return make_train_step(loss_fn, tx, frozen=frozen, plan=plan), tx
