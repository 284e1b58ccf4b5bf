"""Adversarial / segmentation / reconstruction objectives (counterpart of
hairfastgan_tpu/losses/objectives.py).

Rebuilds reference losses/pp_losses.py:298-363,544-587:
  * softplus logistic GAN losses (EncoderAdvLoss :306, AdvLoss :311-328)
  * R1 gradient penalty by one torch.autograd.grad with respect to the real
    images (R1Loss :552-573; the reference's `*16` batch factor and coef/2
    are kept). As in the JAX package its value is only logged: no gradient
    of it reaches the discriminator's parameters (ROADMAP §3)
  * DiceLoss over softmaxed BiSeNet-16 logits with focal fn/fp terms (:330-363)
  * DilatedMask: disc-kernel smoothing ** 0.25 (:576-587), a convolution
  * FeatReconLoss: plain MSE (:298-303)
Maps are NCHW (the class axis of the dice logits is dim 1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def adv_g_loss(fake_preds: Tensor) -> Tensor:
    return torch.mean(F.softplus(-fake_preds))


def adv_d_loss(real_preds: Tensor, fake_preds: Tensor) -> Tensor:
    return (torch.mean(F.softplus(-real_preds)) + torch.mean(F.softplus(fake_preds))) / 2.0


def r1_penalty(disc_fn, params, real_images: Tensor, coef: float = 10.0) -> Tensor:
    """coef/2 * E||∇_x D(x)||^2 * 16 (pp_losses.py:560-573), detached: one
    first-order gradient with respect to a copy of `real_images`."""
    real = real_images.detach().requires_grad_(True)
    with torch.enable_grad():
        p = disc_fn(params, real)
        (grad,) = torch.autograd.grad(p.reshape(p.shape[0], -1).mean(dim=1).sum(), real)
    penalty = grad.square().reshape(grad.shape[0], -1).sum(dim=1).mean()
    return coef / 2.0 * penalty * 16.0


def feat_recon_loss(f1: Tensor, f2: Tensor) -> Tensor:
    return torch.mean(torch.square(f1 - f2))


def dice_loss(in_logit: Tensor, tg_logit: Tensor, gamma: float = 2.0,
              smooth: float = 1.0) -> Tensor:
    """Focal dice over softmax probabilities of NCHW logits [B,K,H,W]."""
    i = torch.softmax(in_logit, dim=1).reshape(in_logit.shape[0], -1)
    t = torch.softmax(tg_logit, dim=1).reshape(tg_logit.shape[0], -1)
    inter = torch.sum(i * t, dim=1)
    fn = torch.sum((t * (1 - i)) ** gamma, dim=1)
    fp = torch.sum(((1 - t) * i) ** gamma, dim=1)
    dice = 1 - (2 * inter + smooth) / (i.sum(dim=1) + t.sum(dim=1) + fn + fp + smooth)
    return torch.mean(dice)


@functools.lru_cache(maxsize=None)
def _disc_kernel(kernel_size: int) -> np.ndarray:
    c = np.arange(kernel_size) - kernel_size // 2
    xx, yy = np.meshgrid(c, c)
    k = ((xx ** 2 + yy ** 2) <= (kernel_size // 2) ** 2).astype(np.float32)
    return k / k.sum()


def dilated_mask(mask: Tensor, kernel_size: int = 25) -> Tensor:
    """Disc-kernel smoothing ** 0.25 of [B,1,H,W] masks (pp_losses.py:576-587).

    The smoothed map is clamped at 0 before the root: a convolution
    algorithm that sums in another order (FFT, Winograd) may give -1e-9
    where the sum is 0, and its fourth root would be NaN."""
    k = torch.from_numpy(_disc_kernel(kernel_size)).to(mask.device, mask.dtype)
    smooth = F.conv2d(mask, k[None, None], padding=kernel_size // 2)
    return smooth.clamp_min(0) ** 0.25
