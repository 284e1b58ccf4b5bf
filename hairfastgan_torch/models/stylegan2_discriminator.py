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

from hairfastgan_torch.models.layers import spec
from hairfastgan_torch.ops.equalized import equal_conv2d, equal_linear
from hairfastgan_torch.ops.fused_act import fused_leaky_relu
from hairfastgan_torch.ops.upfirdn2d import blur2d
from hairfastgan_torch.parallel import mesh

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
    y = equal_conv2d({"w": p["w"].to(x.dtype)}, x, stride=stride, padding=padding)
    if activate:
        return fused_leaky_relu(y, bias)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return y


def _down_blur(p, x: Tensor, blur_kernel=(1, 3, 3, 1)) -> Tensor:
    """The Blur before a stride-2 conv (ConvLayer downsample=True, model.py:601-627)."""
    pp = (len(blur_kernel) - 2) + (p["w"].shape[-1] - 1)
    return blur2d(x, blur_kernel, pad=((pp + 1) // 2, pp // 2))


def _stddev_channel(x: Tensor) -> Tensor:
    """x [B,C,H,W] -> the [B,1,H,W] stddev channel: per group of min(B, 4)
    samples taken B // group apart, the population std over the group,
    averaged over C, H and W."""
    b, c, h, w = x.shape
    group = min(b, 4)
    g = x.reshape(group, b // group, 1, c, h, w)
    std = torch.sqrt(torch.var(g, dim=0, unbiased=False) + 1e-8)
    std = std.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)  # [B//group,1,1,1]
    return std.repeat(group, 1, h, w)


def minibatch_stddev(x, plan=None):
    """x [B,C,H,W] -> [B,C+1,H,W] (model.py:643-664): the stddev channel
    (`_stddev_channel`) appended.

    With a data mesh `plan`, x is the list of the global batch's shards,
    one per data device, and so is the result: the groups span the GLOBAL
    batch, as a jit over a batch-sharded array computes them in the JAX
    package (sample i is grouped with i + B/4, i + 2B/4, ..., which lie on
    other shards). The shards' maps are gathered on the lead device, the
    channel is computed there and its rows are scattered back; autograd
    carries both copies."""
    if plan is None:
        return torch.cat([x, _stddev_channel(x)], dim=1)
    std = _stddev_channel(mesh.gather(x, plan.lead))
    parts = mesh.move(list(std.split([s.shape[0] for s in x])), [s.device for s in x],
                      "scatter")
    return [torch.cat([s, p], dim=1) for s, p in zip(x, parts)]


def _trunk(p, img: Tensor) -> Tensor:
    """conv_in and the ResBlocks: [B,3,H,W] -> [B,C,4,4]."""
    x = _equal_conv(p["conv_in"]["conv"], img, bias=p["conv_in"]["bias"])
    for blk in p["blocks"]:
        h = _equal_conv(blk["conv1"]["conv"], x, padding=1, bias=blk["conv1"]["bias"])
        h = _equal_conv(blk["conv2"]["conv"], _down_blur(blk["conv2"]["conv"], h), stride=2,
                        bias=blk["conv2"]["bias"])
        s = _equal_conv(blk["skip"]["conv"], _down_blur(blk["skip"]["conv"], x), stride=2,
                        activate=False)
        x = (h + s) / math.sqrt(2)
    return x


def _head(p, x: Tensor) -> Tensor:
    """final conv and the two linears over the map with its stddev channel."""
    x = _equal_conv(p["final_conv"]["conv"], x, padding=1, bias=p["final_conv"]["bias"])
    x = equal_linear(p["final_linear1"], x.reshape(x.shape[0], -1), activation="fused_lrelu")
    return equal_linear(p["final_linear2"], x)


def discriminator_nchw(p, img, plan=None):
    """img [B,3,H,W] in [-1,1] -> logits [B,1] (model.py:697-725).

    With a data mesh `plan`: `img` is the list of shards, one per data
    device, `p` the Replicas of the parameters (parallel.mesh.replicate) or
    one tree when every data device holds it; the result is the list of the
    shards' logits. Only the minibatch-stddev layer crosses shards."""
    if plan is None:
        return _head(p, minibatch_stddev(_trunk(p, img)))
    devs = plan.data_devices
    xs = minibatch_stddev([_trunk(mesh.on(p, d), x) for d, x in zip(devs, img)], plan)
    return [_head(mesh.on(p, d), x) for d, x in zip(devs, xs)]


def discriminator(p, img, plan=None):
    """img [B,H,W,3] in [-1,1] (NHWC, as the JAX package) -> logits [B,1];
    with a data mesh `plan`, lists of shards as in `discriminator_nchw`."""
    if plan is None:
        return discriminator_nchw(p, img.permute(0, 3, 1, 2).contiguous())
    return discriminator_nchw(p, [x.permute(0, 3, 1, 2).contiguous() for x in img], plan)
