"""Rotate (pose) encoder training (counterpart of
hairfastgan_tpu/train/rotate.py; reference scripts/rotate_train.py).

Two alternating objectives (rotate_train.py:128-198):
  * pose pairs: rotate W_from toward W_to, full G render, 256 downsample;
    keypoint MSE (76 2-D landmarks) + 20x ArcFace cosine identity loss
  * hair pairs: 300x latent MSE between rotate(W_from->W_to) and W_to[:6]

Loss magnitudes are balanced by MovingAverageLoss EMA targets
({'mse points to': 6, 'mse latents': 2}, rotate_train.py:98), whose
multipliers arrive as plain floats (None: the raw sums of validation).
The keypoint extractor is pluggable: any fn(frozen, images256) ->
[B,76,2], e.g. models/star.keypoints_256 on frozen["star"].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.losses.identity import irse_embed
from hairfastgan_torch.models import encoders, stylegan2
from hairfastgan_torch.pipeline.embedding import to_res
from hairfastgan_torch.train.common import adam_with_clip, make_train_step

Tensor = torch.Tensor


def _arcface_embed(frozen, x01: Tensor) -> Tensor:
    """NHWC [0,1] 256 image -> ArcFace embedding at 112 (rotate_train.py:71-74).
    The pool takes a contiguous NCHW copy: on the CPU, the pool's backward
    over a channels-last map lost ~0.3% of the gradient in f32."""
    x = F.adaptive_avg_pool2d(x01.permute(0, 3, 1, 2).contiguous(), (112, 112)) * 2.0 - 1.0
    return irse_embed(frozen["arcface"], x.permute(0, 2, 3, 1))


def _arcface_cosine(frozen, img256_01: Tensor, ref256_01: Tensor) -> Tensor:
    """20 * (1 - cos) identity loss at 112 (rotate_train.py:71-74,147-150);
    the reference's embedding is computed without a graph (stop-grad)."""
    a = _arcface_embed(frozen, img256_01)
    with torch.no_grad():
        b = _arcface_embed(frozen, ref256_01)
    an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return 20.0 * torch.mean(1.0 - torch.sum(an * bn, dim=-1))


def rotate_render(params, frozen: Dict, w_from: Tensor, w_to: Tensor,
                  cfg: HairFastConfig = HairFastConfig()) -> Tensor:
    """Rotate + full G at zero noise + 256 downsample -> NHWC [0,1]."""
    rot = encoders.rotate_model(params, w_from[:, :6], w_to[:, :6])
    latent_in = torch.cat([rot, w_from[:, 6:]], dim=1)
    _, i_g = stylegan2.synthesis_nchw(
        frozen["generator"], latent_in, noise=stylegan2.make_noise(None, cfg.stylegan),
        cfg=cfg.stylegan, dtype=latent_in.dtype)
    return to_res((i_g + 1.0) / 2.0, 256).clamp(0, 1).permute(0, 2, 3, 1)


def rotate_pose_loss(params, frozen: Dict, batch: Tuple[Tensor, ...],
                     keypoint_fn: Callable[[Dict, Tensor], Tensor],
                     cfg: HairFastConfig = HairFastConfig(),
                     mults: Optional[Sequence[float]] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """batch: (I_from 256 [0,1] NHWC, key_points_to [B,76,2], W_from, W_to).

    `mults` (points, arc_face) are the MovingAverageLoss per-term scalars
    (rotate_train.py:155-156 normalize=True); None sums the raw terms (the
    reference's validation normalize=False path).
    """
    i_from, kp_to, w_from, w_to = batch
    i_gen = rotate_render(params, frozen, w_from, w_to, cfg)
    kp_loss = torch.mean(torch.square(keypoint_fn(frozen, i_gen) - kp_to))
    id_loss = _arcface_cosine(frozen, i_gen, i_from)
    total = (kp_loss + id_loss if mults is None
             else mults[0] * kp_loss + mults[1] * id_loss)
    return total, {"mse_points": kp_loss, "arc_face": id_loss}


def rotate_hair_loss(params, batch: Tuple[Tensor, Tensor],
                     mults: Optional[Sequence[float]] = None) -> Tuple[Tensor, Dict]:
    """Same-pose pairs: 300x MSE(rotate(W_from, W_to), W_to[:6])."""
    w_from, w_to = batch
    rot = encoders.rotate_model(params, w_from[:, :6], w_to[:, :6])
    loss = 300.0 * torch.mean(torch.square(rot - w_to[:, :6]))
    total = loss if mults is None else mults[0] * loss
    return total, {"mse_latents": loss}


def make_rotate_train_steps(frozen: Dict, keypoint_fn,
                            cfg: HairFastConfig = HairFastConfig(), lr: float = 1e-4,
                            plan=None):
    """(pose_step, hair_step, tx); both steps share one optimizer
    (`tx.init(params)`) and take the MovingAverageLoss multipliers as their
    last batch argument: pose(params, opt, I_from, kp_to, W_from, W_to, m),
    hair(params, opt, W_from, W_to, m). `frozen` holds the generator, the
    ArcFace backbone and whatever keypoint_fn reads (e.g. "star"); `plan`
    (a data mesh) shards the batch (train/common.make_train_step)."""
    tx = adam_with_clip(lr)
    pose = make_train_step(
        lambda p, fr, i, kp, wf, wt, m: rotate_pose_loss(
            p, fr, (i, kp, wf, wt), keypoint_fn, cfg, mults=m), tx, frozen=frozen, plan=plan)
    hair = make_train_step(lambda p, wf, wt, m: rotate_hair_loss(p, (wf, wt), mults=m), tx,
                           plan=plan)
    return pose, hair, tx
