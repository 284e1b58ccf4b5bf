"""CLIP ViT-B/32 image tower, PyTorch (counterpart of hairfastgan_tpu/models/clip_vit.py).

32x32 patch conv -> class token + positional embedding -> pre-LN -> residual
attention blocks (QuickGELU MLP) -> post-LN on the class token ->
projection. Attention is matmul + softmax (f32 logits), as the JAX package
writes it. `clip_preprocess` and `clip_encode_image` take NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hairfastgan_torch.models.layers import init_linear, init_ln, spec
from hairfastgan_torch.ops.basic import conv2d, layer_norm, linear

Tensor = torch.Tensor

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess_nchw(img01: Tensor) -> Tensor:
    """[0,1] NCHW (any square size) -> normalized [B,3,224,224]."""
    x = F.adaptive_avg_pool2d(img01, (224, 224))
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def clip_preprocess(img01: Tensor) -> Tensor:
    """[0,1] NHWC -> normalized NHWC [B,224,224,3]."""
    return clip_preprocess_nchw(img01.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def init_block(width: int):
    return {"ln1": init_ln(width),
            "attn": {"in_proj": init_linear(width, 3 * width),
                     "out_proj": init_linear(width, width)},
            "ln2": init_ln(width),
            "mlp": {"fc": init_linear(width, 4 * width), "proj": init_linear(4 * width, width)}}


def _attention(p, x: Tensor, h: int) -> Tensor:
    b, t, c = x.shape
    q, k, v = linear(p["in_proj"], x).split(c, dim=-1)
    q, k, v = (z.reshape(b, t, h, c // h).transpose(1, 2) for z in (q, k, v))
    logits = torch.matmul((q * (1.0 / math.sqrt(c // h))).float(), k.float().transpose(-1, -2))
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    y = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, c)
    return linear(p["out_proj"], y)


def block(p, x: Tensor) -> Tensor:
    heads = x.shape[-1] // 64  # CLIP convention: head_dim = 64
    x = x + _attention(p["attn"], layer_norm(x, -1, p["ln1"]["gamma"], p["ln1"]["beta"]), heads)
    h = layer_norm(x, -1, p["ln2"]["gamma"], p["ln2"]["beta"])
    h = linear(p["mlp"]["fc"], h)
    h = linear(p["mlp"]["proj"], h * torch.sigmoid(1.702 * h))  # QuickGELU
    return x + h


def init_clip_image_tower(width: int = 768, layers: int = 12, patch: int = 32,
                          image_size: int = 224, embed_dim: int = 512):
    grid = image_size // patch
    return {"patch_conv": {"w": spec(patch, patch, 3, width)},
            "class_emb": spec(width), "pos_emb": spec(grid * grid + 1, width),
            "ln_pre": init_ln(width), "blocks": [init_block(width) for _ in range(layers)],
            "ln_post": init_ln(width), "proj": spec(width, embed_dim)}


def clip_encode_image_nchw(p, x: Tensor) -> Tensor:
    """Preprocessed [B,3,224,224] -> [B,embed_dim]."""
    w = p["patch_conv"]["w"]
    y = conv2d(x, w, stride=w.shape[-1]).flatten(2).transpose(1, 2)  # [B, grid^2, C]
    cls = p["class_emb"].to(y.dtype).expand(y.shape[0], 1, -1)
    y = torch.cat([cls, y], dim=1) + p["pos_emb"].to(y.dtype)[None]
    y = layer_norm(y, -1, p["ln_pre"]["gamma"], p["ln_pre"]["beta"])
    for blk in p["blocks"]:
        y = block(blk, y)
    y = layer_norm(y[:, 0], -1, p["ln_post"]["gamma"], p["ln_post"]["beta"])
    return y @ p["proj"].to(y.dtype)


def clip_encode_image(p, x: Tensor) -> Tensor:
    """Preprocessed NHWC [B,224,224,3] -> [B,embed_dim] image embedding."""
    return clip_encode_image_nchw(p, x.permute(0, 3, 1, 2))
