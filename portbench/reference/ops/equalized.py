"""Equalized-learning-rate linear + PixelNorm (counterpart of
hairfastgan_tpu/ops/equalized.py; reference models/stylegan2/model.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference.ops.basic import conv2d, fold_dtype
from portbench.reference.ops.fused_act import fused_leaky_relu


def pixel_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x * rsqrt(mean(x^2, dim) + 1e-8), computed in f32 (f64 for f64). RotateModel and the
    blending/PostProcess encoders normalize [B, rows, 512] over dim=1 (the
    rows), as torch's PixelNorm does on 3-D input."""
    xf = x.to(fold_dtype(x))
    n = xf * torch.rsqrt(xf.square().mean(dim=dim, keepdim=True) + 1e-8)
    return n.to(x.dtype)


def equal_conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """EqualConv2d (model.py:96-125) on NCHW: w OIHW scaled by
    1/sqrt(cin*kh*kw) at run time, optional bias."""
    _, cin, kh, kw = p["w"].shape
    return conv2d(x, p["w"] * (1.0 / math.sqrt(cin * kh * kw)), p.get("b"), stride=stride,
                  padding=padding)


def equal_linear(p, x: torch.Tensor, lr_mul: float = 1.0,
                 activation: Optional[str] = None) -> torch.Tensor:
    """EqualLinear: w [out, in] stored / lr_mul, scaled by lr_mul/sqrt(in) at run time."""
    scale = (1.0 / math.sqrt(p["w"].shape[1])) * lr_mul
    w = p["w"].to(x.dtype) * scale
    b = p.get("b")
    b = None if b is None else b.to(x.dtype) * lr_mul
    if activation == "fused_lrelu":
        return fused_leaky_relu(F.linear(x, w), b)
    return F.linear(x, w, b)
