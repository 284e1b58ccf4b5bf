"""Segmentation-region ops, NCHW (counterpart of hairfastgan_tpu/ops/segops.py)."""

from __future__ import annotations

import torch


def one_hot_mask(labels: torch.Tensor, num_classes: int,
                 dtype=torch.float32) -> torch.Tensor:
    """[B,H,W] int labels -> [B,K,H,W] one-hot; labels outside [0, K) give
    all-zero rows (as jax.nn.one_hot)."""
    classes = torch.arange(num_classes, device=labels.device).view(1, -1, 1, 1)
    return (labels[:, None] == classes).to(dtype)


def region_mean(feat: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Per-region masked average: feat [B,C,H,W], onehot [B,K,H,W] -> [B,K,C]
    (sums in f32; empty regions give 0, as Zencoder's zero-init codes)."""
    s = torch.einsum("bchw,bkhw->bkc", feat.float(), onehot.float())
    cnt = onehot.float().sum(dim=(2, 3))
    out = s / torch.where(cnt > 0, cnt, torch.ones_like(cnt))[..., None]
    return torch.where((cnt > 0)[..., None], out, torch.zeros_like(out)).to(feat.dtype)


def region_broadcast(codes: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Per-region vectors scattered back over the map: codes [B,K,C],
    onehot [B,K,H,W] -> [B,C,H,W]; pixels of no region get 0 (ACE's
    masked_scatter_ into zeros, normalization.py:119-154)."""
    return torch.einsum("bkc,bkhw->bchw", codes, onehot.to(codes.dtype))
