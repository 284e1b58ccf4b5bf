"""SEAN per-region style encoder + SPADE/ACE generator, PyTorch
(counterpart of hairfastgan_tpu/models/sean.py).

  * Zencoder: conv bottleneck -> [B,512,128,128] code map -> per-region
    masked average -> [B,19,512]
  * ACE: per-region style gamma/beta blended with SPADE gamma/beta through
    learned sigmoid gates; per-channel noise; affine-free BatchNorm
  * SPADEResnetBlock + SPADEGenerator, 256^2 'normal' config
  * decode_sean's fallback: all-zero region codes take the stored mean_codes
  * `pack_sean` (opt-in, through zoo.pack_zoo): each ACE's 19 fc_mu heads
    as one batched product and its gamma/beta conv pairs as one conv each

Spectral norm is already baked into the weights by the converter. NCHW
inside; `sean_encode`/`sean_decode` take NHWC images and [B,H,W] labels and
return NHWC, and a model-axis tree too (parallel/tensor.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from hairfastgan_torch.models.layers import init_bn, init_conv, init_linear, spec
from hairfastgan_torch.ops.basic import batch_norm, conv2d, conv2d_p, instance_norm
from hairfastgan_torch.ops.columns import by_columns, column_parallel, randn_rows
from hairfastgan_torch.ops.resample import resize
from hairfastgan_torch.ops.segops import one_hot_mask, region_mean
from hairfastgan_torch.utils import timing

Tensor = torch.Tensor

N_REGIONS = 19
STYLE_LEN = 512


def init_zencoder(ngf: int = 32):
    return {"conv_in": init_conv(3, 3, ngf), "down1": init_conv(3, ngf, ngf * 2),
            "down2": init_conv(3, ngf * 2, ngf * 4),
            # ConvTranspose(k3 s2 p1 outpad1) in forward (flipped) form
            "up": init_conv(3, ngf * 4, ngf * 8),
            "conv_out": init_conv(3, ngf * 8, STYLE_LEN)}


def _reflect_pad(x: Tensor, p: int = 1) -> Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


def zencoder_codes(p, img: Tensor, seg_onehot: Tensor) -> Tensor:
    """img [B,3,256,256] in [-1,1], seg_onehot [B,19,256,256] -> [B,19,512]."""
    x = F.leaky_relu(instance_norm(conv2d_p(p["conv_in"], _reflect_pad(img))), 0.2)
    x = F.leaky_relu(instance_norm(conv2d_p(p["down1"], x, stride=2, padding=1)), 0.2)
    x = F.leaky_relu(instance_norm(conv2d_p(p["down2"], x, stride=2, padding=1)), 0.2)
    x = conv2d(x, p["up"]["w"], p["up"].get("b"), padding=[(1, 2), (1, 2)], lhs_dilation=2)
    x = F.leaky_relu(instance_norm(x), 0.2)
    x = torch.tanh(conv2d_p(p["conv_out"], _reflect_pad(x)))  # [B,512,128,128]
    return region_mean(x, resize(seg_onehot, tuple(x.shape[-2:]), "nearest"))


def init_spade(norm_nc: int, label_nc: int = N_REGIONS, nhidden: int = 128):
    return {"shared": init_conv(3, label_nc, nhidden), "gamma": init_conv(3, nhidden, norm_nc),
            "beta": init_conv(3, nhidden, norm_nc)}


def init_ace(norm_nc: int, use_rgb: bool = True):
    p = {"spade": init_spade(norm_nc), "bn": init_bn(norm_nc), "noise_var": spec(norm_nc)}
    if use_rgb:
        p["blend_gamma"] = spec()
        p["blend_beta"] = spec()
        p["fc_mu"] = [init_linear(STYLE_LEN, STYLE_LEN) for _ in range(N_REGIONS)]
        p["conv_gamma"] = init_conv(3, STYLE_LEN, norm_nc)
        p["conv_beta"] = init_conv(3, STYLE_LEN, norm_nc)
    return p


def spade_gamma_beta(p, seg: Tensor) -> Tuple[Tensor, Tensor]:
    """SPADE's (gamma, beta) maps from the NCHW one-hot `seg` (the packed
    tree's "gb" conv gives both in one)."""
    a = torch.relu(conv2d_p(p["shared"], seg, padding=1))
    if "gb" in p:  # packed: one conv with [gamma|beta] output channels
        g, b = conv2d_p(p["gb"], a, padding=1).chunk(2, dim=1)
        return g, b
    return conv2d_p(p["gamma"], a, padding=1), conv2d_p(p["beta"], a, padding=1)


@by_columns
def _region_conv(conv_p, mu: Tensor, seg: Tensor) -> Tensor:
    """conv3x3(region_broadcast(mu)) without materializing the broadcast map.

    The broadcast map is sum_k onehot_k (x) mu_k and the conv is linear, so
    project the taps onto mu first (proj[b,o,k,u,v] = sum_c W[o,c,u,v]
    mu[b,k,c]) and convolve the 19-channel one-hot with it: one grouped
    conv with a per-sample kernel. mu [B,K,C]; seg [B,K,H,W] -> [B,O,H,W].
    """
    w = conv_p["w"].to(mu.dtype)  # [O, C, 3, 3]
    b, k = mu.shape[:2]
    o, _, kh, kw = w.shape
    proj = torch.einsum("bkc,ocuv->bokuv", mu, w).reshape(b * o, k, kh, kw)
    out = F.conv2d(seg.reshape(1, b * k, *seg.shape[-2:]), proj,
                   padding=(kh // 2, kw // 2), groups=b)
    out = out.reshape(b, o, *seg.shape[-2:])
    if "b" in conv_p:
        out = out + conv_p["b"].to(mu.dtype).view(1, -1, 1, 1)
    return out


def ace(p, x: Tensor, seg_onehot: Tensor, style_codes: Optional[Tensor],
        generator: Optional[torch.Generator] = None) -> Tensor:
    """ACE forward (normalization.py:108-191) on NCHW. No generator means
    zero noise; with one, fresh gaussian noise scaled by noise_var."""
    if generator is not None:
        z = randn_rows((x.shape[0], 1, x.shape[2], x.shape[3]), generator,
                       x.device).to(x.dtype)
        x = x + z * p["noise_var"].to(x.dtype).view(1, -1, 1, 1)
    normalized = batch_norm(p["bn"], x)
    seg = resize(seg_onehot, tuple(x.shape[-2:]), "nearest")
    gamma_spade, beta_spade = spade_gamma_beta(p["spade"], seg)
    if ("fc_mu" in p or "fc_mu_w" in p) and style_codes is not None:
        codes = style_codes.to(x.dtype)
        if "fc_mu_w" in p:  # packed: the 19 region heads as one batched product
            mu = torch.relu(torch.einsum("bks,kds->bkd", codes, p["fc_mu_w"].to(x.dtype))
                            + p["fc_mu_b"].to(x.dtype))
        else:
            mu = torch.relu(torch.stack([F.linear(codes[:, j], f["w"].to(x.dtype),
                                                  f["b"].to(x.dtype))
                                         for j, f in enumerate(p["fc_mu"])], dim=1))
        if "conv_gb" in p:  # packed: gamma|beta share one region conv
            gamma_avg, beta_avg = _region_conv(p["conv_gb"], mu, seg).chunk(2, dim=1)
        else:
            gamma_avg = _region_conv(p["conv_gamma"], mu, seg)
            beta_avg = _region_conv(p["conv_beta"], mu, seg)
        ga = torch.sigmoid(p["blend_gamma"].float()).to(x.dtype)
        ba = torch.sigmoid(p["blend_beta"].float()).to(x.dtype)
        gamma = ga * gamma_avg + (1 - ga) * gamma_spade
        beta = ba * beta_avg + (1 - ba) * beta_spade
    else:
        gamma, beta = gamma_spade, beta_spade
    return normalized * (1 + gamma) + beta


def init_spade_block(fin: int, fout: int, use_rgb: bool = True):
    fmid = min(fin, fout)
    p = {"ace0": init_ace(fin, use_rgb), "conv0": init_conv(3, fin, fmid),
         "ace1": init_ace(fmid, use_rgb), "conv1": init_conv(3, fmid, fout)}
    if fin != fout:
        p["ace_s"] = init_ace(fin, use_rgb)
        p["conv_s"] = init_conv(1, fin, fout, bias=False)
    return p


def spade_block(p, x: Tensor, seg_onehot: Tensor, style_codes: Tensor,
                generator: Optional[torch.Generator] = None) -> Tensor:
    if "conv_s" in p:
        xs = conv2d_p(p["conv_s"], ace(p["ace_s"], x, seg_onehot, style_codes, generator))
    else:
        xs = x
    dx = ace(p["ace0"], x, seg_onehot, style_codes, generator)
    dx = conv2d_p(p["conv0"], F.leaky_relu(dx, 0.2), padding=1)
    dx = ace(p["ace1"], dx, seg_onehot, style_codes, generator)
    dx = conv2d_p(p["conv1"], F.leaky_relu(dx, 0.2), padding=1)
    return xs + dx


def init_sean_generator(ngf: int = 64, z_ngf: int = 32):
    return {
        "zencoder": init_zencoder(ngf=z_ngf),
        "fc": init_conv(3, N_REGIONS, 16 * ngf),
        "head0": init_spade_block(16 * ngf, 16 * ngf),
        "mid0": init_spade_block(16 * ngf, 16 * ngf),
        "mid1": init_spade_block(16 * ngf, 16 * ngf),
        "up0": init_spade_block(16 * ngf, 8 * ngf),
        "up1": init_spade_block(8 * ngf, 4 * ngf),
        "up2": init_spade_block(4 * ngf, 2 * ngf),
        "up3": init_spade_block(2 * ngf, ngf, use_rgb=False),
        "conv_img": init_conv(3, ngf, 3),
        "mean_codes": spec(N_REGIONS, STYLE_LEN),
    }


def _cat_conv(a, b):
    return {"w": torch.cat([a["w"], b["w"]]), "b": torch.cat([a["b"], b["b"]])}


def _pack_ace(p):
    """One ACE packed (exact, idempotent): fc_mu -> 'fc_mu_w' [19,out,in] and
    'fc_mu_b' [19,out]; spade gamma/beta -> spade 'gb'; conv_gamma/conv_beta
    -> 'conv_gb' (output channels concatenated, gamma first). The JAX
    package's _pack_ace bridged."""
    if "fc_mu_w" in p or ("fc_mu" not in p and "gb" in p["spade"]):
        return p
    q = dict(p)
    sp = p["spade"]
    if "gamma" in sp:
        q["spade"] = {"shared": sp["shared"], "gb": _cat_conv(sp["gamma"], sp["beta"])}
    if "fc_mu" in p:
        q["fc_mu_w"] = torch.stack([f["w"] for f in p["fc_mu"]])
        q["fc_mu_b"] = torch.stack([f["b"] for f in p["fc_mu"]])
        q["conv_gb"] = _cat_conv(p["conv_gamma"], p["conv_beta"])
        for k in ("fc_mu", "conv_gamma", "conv_beta"):
            del q[k]
    return q


def pack_sean(p):
    """Every ACE of the SEAN generator packed (exact, idempotent)."""
    q = dict(p)
    for name in ("head0", "mid0", "mid1", "up0", "up1", "up2", "up3"):
        q[name] = {k: _pack_ace(v) if k in ("ace0", "ace1", "ace_s") else v
                   for k, v in q[name].items()}
    return q


@timing.span("sean")
@column_parallel
def sean_encode(p, img: Tensor, labels: Tensor) -> Tensor:
    """encode_sean (pix2pix_model.py:299-306): NHWC image + [B,H,W] labels
    -> [B,19,512] region codes."""
    onehot = one_hot_mask(labels, N_REGIONS, img.dtype)
    return zencoder_codes(p["zencoder"], img.permute(0, 3, 1, 2), onehot)


@timing.span("sean")
@column_parallel
def sean_decode(p, style_codes: Tensor, target_labels: Tensor,
                generator: Optional[torch.Generator] = None) -> Tensor:
    """decode_sean (pix2pix_model.py:309-325): render codes under a new mask
    -> NHWC image in [-1,1]. All-zero code rows take the stored mean_codes."""
    empty = torch.all(style_codes == 0, dim=-1, keepdim=True)  # [B,19,1]
    codes = torch.where(empty, p["mean_codes"][None].to(style_codes.dtype), style_codes)
    seg = one_hot_mask(target_labels, N_REGIONS, codes.dtype)
    x = conv2d_p(p["fc"], resize(seg, (8, 8), "nearest"), padding=1)
    for name in ("head0", "mid0", "mid1", "up0", "up1", "up2", "up3"):
        if name != "head0" and name != "mid1":  # 'normal': 5 nearest x2 upsamples
            x = resize(x, (x.shape[2] * 2, x.shape[3] * 2), "nearest")
        x = spade_block(p[name], x, seg, style_codes=codes, generator=generator)
    out = torch.tanh(conv2d_p(p["conv_img"], F.leaky_relu(x, 0.2), padding=1))
    return out.permute(0, 2, 3, 1)
