"""StyleGAN2 discriminator (rosinality layout), NCHW (counterpart of
hairfastgan_tpu/models/stylegan2_discriminator.py).

Rebuilds reference models/stylegan2/model.py:597-725: ConvLayer stack of
blur-downsampled ResBlocks (skip branch /sqrt(2)), minibatch-stddev feature,
final conv + 2-layer EqualLinear head. Used by the PostProcess adversarial
phase (scripts/pp_train.py:59-63,144-178); params/nvlabs.py maps the
pretrained NVlabs discriminator onto this tree, params/convert.py the
rosinality one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hairfastgan_torch.models.layers import spec
from hairfastgan_torch.ops.equalized import equal_linear
from hairfastgan_torch.ops.fused_act import fused_leaky_relu
from hairfastgan_torch.ops.upfirdn2d import blur2d

Tensor = torch.Tensor


def _conv(k: int, cin: int, cout: int, bias: bool = True):
    p = {"conv": {"w": spec(k, k, cin, cout)}}
    if bias:
        p["bias"] = spec(cout)
    return p


def init_discriminator(cfg):
    """Shape tree (JAX layout, meta tensors; zoo.fill_random fills it)."""
    ch = cfg.channels
    c4 = ch(4)
    p = {"conv_in": _conv(1, 3, ch(cfg.size)), "blocks": [],
         "final_conv": _conv(3, c4 + 1, c4),
         "final_linear1": {"w": spec(c4 * 16, c4), "b": spec(c4)},
         "final_linear2": {"w": spec(c4, 1), "b": spec(1)}}
    in_ch = ch(cfg.size)
    for i in range(cfg.log_size, 2, -1):
        out_ch = ch(2 ** (i - 1))
        p["blocks"].append({"conv1": _conv(3, in_ch, in_ch), "conv2": _conv(3, in_ch, out_ch),
                            "skip": _conv(1, in_ch, out_ch, bias=False)})
        in_ch = out_ch
    return p


def _equal_conv(p, x: Tensor, *, stride: int = 1, padding: int = 0, bias=None,
                activate: bool = True) -> Tensor:
    """EqualConv2d (OIHW weight scaled by 1/sqrt(fan_in) at run time), then
    FusedLeakyReLU(bias) or the plain bias."""
    _, cin, kh, kw = p["w"].shape
    y = F.conv2d(x, p["w"].to(x.dtype) * (1.0 / math.sqrt(cin * kh * kw)), stride=stride,
                 padding=padding)
    if activate:
        return fused_leaky_relu(y, bias)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return y


def _down_blur(p, x: Tensor, blur_kernel=(1, 3, 3, 1)) -> Tensor:
    """The Blur before a stride-2 conv (ConvLayer downsample=True, model.py:601-627)."""
    pp = (len(blur_kernel) - 2) + (p["w"].shape[-1] - 1)
    return blur2d(x, blur_kernel, pad=((pp + 1) // 2, pp // 2))


def minibatch_stddev(x: Tensor) -> Tensor:
    """x [B,C,H,W] -> [B,C+1,H,W] (model.py:643-664): per group of min(B, 4)
    samples taken B // group apart, the population std over the group,
    averaged over C, H and W, appended as one channel."""
    b, c, h, w = x.shape
    group = min(b, 4)
    g = x.reshape(group, b // group, 1, c, h, w)
    std = torch.sqrt(torch.var(g, dim=0, unbiased=False) + 1e-8)
    std = std.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)  # [B//group,1,1,1]
    return torch.cat([x, std.repeat(group, 1, h, w)], dim=1)


def discriminator_nchw(p, img: Tensor) -> Tensor:
    """img [B,3,H,W] in [-1,1] -> logits [B,1] (model.py:697-725)."""
    x = _equal_conv(p["conv_in"]["conv"], img, bias=p["conv_in"]["bias"])
    for blk in p["blocks"]:
        h = _equal_conv(blk["conv1"]["conv"], x, padding=1, bias=blk["conv1"]["bias"])
        h = _equal_conv(blk["conv2"]["conv"], _down_blur(blk["conv2"]["conv"], h), stride=2,
                        bias=blk["conv2"]["bias"])
        s = _equal_conv(blk["skip"]["conv"], _down_blur(blk["skip"]["conv"], x), stride=2,
                        activate=False)
        x = (h + s) / math.sqrt(2)
    x = minibatch_stddev(x)
    x = _equal_conv(p["final_conv"]["conv"], x, padding=1, bias=p["final_conv"]["bias"])
    x = equal_linear(p["final_linear1"], x.reshape(x.shape[0], -1), activation="fused_lrelu")
    return equal_linear(p["final_linear2"], x)


def discriminator(p, img: Tensor) -> Tensor:
    """img [B,H,W,3] in [-1,1] (NHWC, as the JAX package) -> logits [B,1]."""
    return discriminator_nchw(p, img.permute(0, 3, 1, 2).contiguous())
