"""Fused bias + leaky ReLU + gain (counterpart of hairfastgan_tpu/ops/fused_act.py).

Reference: models/stylegan2/op/fused_act.py (CUDA fused_bias_act). Plain
PyTorch here; the hand kernel is later work (ROADMAP kernel queue item 4).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

SQRT2 = 1.4142135623730951


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2,
                     scale: float = SQRT2) -> torch.Tensor:
    """y = scale * lrelu(x + bias); bias is per-channel on dim 1 (NCHW / [B, C])."""
    if bias is not None:
        x = x + bias.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, negative_slope) * scale
