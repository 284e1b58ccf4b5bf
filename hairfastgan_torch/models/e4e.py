"""encoder4editing (e4e) W+ inverter, PyTorch (counterpart of hairfastgan_tpu/models/e4e.py).

IR-SE-50 backbone (bottleneck_IR / bottleneck_IR_SE), FPN c1/c2/c3 at body
indices 6/20/23, GradualStyleBlock heads (coarse 0-2 from c3, middle 3-6
from p2, fine 7.. from p1), w0 broadcast + per-layer deltas + latent_avg.
`pack_style_heads` (opt-in, through zoo.pack_zoo) re-lays the heads out
per FPN group; the forward dispatches on the layout it gets. NCHW inside;
`e4e_encode` takes NHWC. `e4e_encode_nchw` and `gradual_style_encode` also
take a model-axis tree (parallel/tensor.py).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from hairfastgan_torch.models.layers import (init_bn, init_conv, init_conv_bn,
                                             init_prelu, spec)
from hairfastgan_torch.ops.basic import avg_pool_global, batch_norm, conv2d_p, prelu
from hairfastgan_torch.ops.columns import column_parallel
from hairfastgan_torch.ops.equalized import equal_linear
from hairfastgan_torch.ops.resample import resize
from hairfastgan_torch.utils import timing

Tensor = torch.Tensor


def _blocks_50(width: float = 1.0) -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) per bottleneck of the 50-layer body."""
    c = lambda n: max(16, int(n * width))
    out = []
    for in_c, depth, n in ((64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)):
        out.append((c(in_c), c(depth), 2))
        out += [(c(depth), c(depth), 1)] * (n - 1)
    return out


def init_bottleneck_ir(in_c: int, depth: int, stride: int, se: bool):
    p = {"bn_in": init_bn(in_c), "conv1": init_conv(3, in_c, depth, bias=False),
         "prelu": init_prelu(depth), "conv2": init_conv(3, depth, depth, bias=False),
         "bn_out": init_bn(depth), "stride": stride}
    if in_c != depth:
        p["shortcut"] = init_conv_bn(1, in_c, depth)
    if se:
        p["se"] = {"fc1": init_conv(1, depth, depth // 16, bias=False),
                   "fc2": init_conv(1, depth // 16, depth, bias=False)}
    return p


def bottleneck_ir(p, x: Tensor) -> Tensor:
    s = p["stride"]
    res = batch_norm(p["bn_in"], x)
    res = prelu(p["prelu"], conv2d_p(p["conv1"], res, padding=1))
    res = batch_norm(p["bn_out"], conv2d_p(p["conv2"], res, stride=s, padding=1))
    if "se" in p:
        a = avg_pool_global(res)
        a = torch.sigmoid(conv2d_p(p["se"]["fc2"], torch.relu(conv2d_p(p["se"]["fc1"], a))))
        res = res * a
    if "shortcut" in p:
        short = batch_norm(p["shortcut"]["bn"], conv2d_p(p["shortcut"]["conv"], x, stride=s))
    else:
        short = x[:, :, ::s, ::s] if s > 1 else x  # MaxPool2d(1, s) == subsample
    return res + short


def init_irse_body(se: bool = True, width: float = 1.0):
    c = lambda n: max(16, int(n * width))
    return {"input": {"conv": init_conv(3, 3, c(64), bias=False), "bn": init_bn(c(64)),
                      "prelu": init_prelu(c(64))},
            "body": [init_bottleneck_ir(i, d, s, se) for i, d, s in _blocks_50(width)]}


def irse_stem(p, x: Tensor) -> Tensor:
    """conv3x3 -> BN -> PReLU of the IR-SE body's input layer."""
    return prelu(p["input"]["prelu"],
                 batch_norm(p["input"]["bn"], conv2d_p(p["input"]["conv"], x, padding=1)))


def irse_pyramid(p, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Stem + body, returning (c1, c2, c3) at body indices 6/20/23."""
    x = irse_stem(p, x)
    feats = {}
    for i, blk in enumerate(p["body"]):
        x = bottleneck_ir(blk, x)
        if i in (6, 20, 23):
            feats[i] = x
    return feats.get(6), feats.get(20), feats.get(23)


def init_gradual_style_block(in_c: int, out_c: int, spatial: int, mid: int):
    n = int(math.log2(spatial))
    return {"convs": [init_conv(3, in_c, mid)] + [init_conv(3, mid, mid) for _ in range(1, n)],
            "linear": {"w": spec(mid, out_c), "b": spec(out_c)}}


def gradual_style_block(p, x: Tensor) -> Tensor:
    for c in p["convs"]:
        x = F.leaky_relu(conv2d_p(c, x, stride=2, padding=1), 0.01)
    return equal_linear(p["linear"], x.reshape(x.shape[0], -1))


def _upsample_add(x: Tensor, y: Tensor) -> Tensor:
    """bilinear align_corners resize of x to y's size, plus y."""
    return resize(x, tuple(y.shape[-2:]), "bilinear", align_corners=True) + y


# Head groups by FPN source (psp_encoders.py:146-151): coarse 0-2 from c3,
# middle 3-6 from p2, fine 7.. from p1. Heads of a group read the same map
# and have the same conv-chain length.
_GROUP_BOUNDS = (0, 3, 7)


def _head_groups(n_styles: int):
    bounds = list(_GROUP_BOUNDS) + [n_styles]
    return [(min(a, n_styles), min(b, n_styles)) for a, b in zip(bounds[:-1], bounds[1:])]


def pack_style_heads(p):
    """The GradualStyleBlock heads packed per FPN group (exact, idempotent):
    the first 3x3 convs, which read the same map, as one conv with the
    heads' output channels concatenated ('conv0'); each later conv as one
    grouped conv over the heads ('chain': w [k,O,I,3,3], b [k,O]); the
    EqualLinears as one batched product ('lin_w' [k,out,in], 'lin_b').
    Layouts are the JAX package's pack_style_heads bridged."""
    if "styles_packed" in p or "styles" not in p:
        return p
    packed = []
    for a, b in _head_groups(len(p["styles"])):
        heads = p["styles"][a:b]
        if not heads:
            continue
        packed.append({
            "conv0": {"w": torch.cat([h["convs"][0]["w"] for h in heads]),
                      "b": torch.cat([h["convs"][0]["b"] for h in heads])},
            "chain": [{"w": torch.stack([h["convs"][i]["w"] for h in heads]),
                       "b": torch.stack([h["convs"][i]["b"] for h in heads])}
                      for i in range(1, len(heads[0]["convs"]))],
            "lin_w": torch.stack([h["linear"]["w"] for h in heads]),
            "lin_b": torch.stack([h["linear"]["b"] for h in heads])})
    q = {k: v for k, v in p.items() if k != "styles"}
    q["styles_packed"] = packed
    return q


def _packed_head_group(g, x: Tensor) -> Tensor:
    """One packed group: [B,Cin,H,W] -> [B,k,512] head outputs. The JAX
    package runs the chain as shift-slice einsums (a TPU lowering); here
    each link is one grouped conv with groups=k, its [k, O] biases added
    per head after it, as the JAX package adds them (on the model axis a
    split bias is added to its slice)."""
    k = g["lin_w"].shape[0]
    x = F.leaky_relu(conv2d_p(g["conv0"], x, stride=2, padding=1), 0.01)
    for c in g["chain"]:
        w = c["w"].to(x.dtype)
        y = F.conv2d(x, w.reshape(-1, *w.shape[2:]), stride=2, padding=1, groups=k)
        y = y.unflatten(1, (k, -1)) + c["b"].to(x.dtype)[:, :, None, None]
        x = F.leaky_relu(y, 0.01).flatten(1, 2)
    x = x.reshape(x.shape[0], k, -1)  # spatial is 1x1 here
    w = g["lin_w"].to(x.dtype) * (1.0 / math.sqrt(g["lin_w"].shape[2]))
    return torch.einsum("bkc,kdc->bkd", x, w) + g["lin_b"].to(x.dtype)


def _all_style_latents(p, c1: Tensor, c2: Tensor, c3: Tensor) -> Tensor:
    """All n_styles head outputs stacked [B, n, 512]."""
    if "styles_packed" in p:
        groups = p["styles_packed"]
        feats = [c3]
        if len(groups) > 1:
            feats.append(_upsample_add(c3, conv2d_p(p["latlayer1"], c2)))
        if len(groups) > 2:
            feats.append(_upsample_add(feats[1], conv2d_p(p["latlayer2"], c1)))
        return torch.cat([_packed_head_group(g, f) for g, f in zip(groups, feats)], dim=1)
    n = len(p["styles"])
    latents = [gradual_style_block(p["styles"][j], c3) for j in range(min(3, n))]
    if n > 3:
        p2 = _upsample_add(c3, conv2d_p(p["latlayer1"], c2))
        latents += [gradual_style_block(p["styles"][j], p2) for j in range(3, min(7, n))]
        if n > 7:
            p1 = _upsample_add(p2, conv2d_p(p["latlayer2"], c1))
            latents += [gradual_style_block(p["styles"][j], p1) for j in range(7, n)]
    return torch.stack(latents, dim=1)


def init_e4e(n_styles: int = 18, se: bool = True, width: float = 1.0):
    c = lambda n: max(16, int(n * width))
    styles = [init_gradual_style_block(c(512), 512, 16 if i < 3 else (32 if i < 7 else 64),
                                       mid=c(512)) for i in range(n_styles)]
    return {"backbone": init_irse_body(se=se, width=width), "styles": styles,
            "latlayer1": init_conv(1, c(256), c(512)),
            "latlayer2": init_conv(1, c(128), c(512)),
            "latent_avg": spec(n_styles, 512)}


@timing.span("e4e")
@column_parallel
def e4e_encode_nchw(p, x: Tensor, add_latent_avg: bool = True) -> Tensor:
    c1, c2, c3 = irse_pyramid(p["backbone"], x)
    lat = _all_style_latents(p, c1, c2, c3)  # [B, n, 512]: w0 then deltas
    w = torch.cat([lat[:, :1], lat[:, :1] + lat[:, 1:]], dim=1)
    if add_latent_avg:
        w = w + p["latent_avg"].to(w.dtype)[None]
    return w


@column_parallel
def gradual_style_encode(p, x: Tensor, add_latent_avg: bool = True) -> Tensor:
    """The pSp GradualStyleEncoder variant (psp_encoders.py:57-123) on the
    e4e tree (init_e4e): x NHWC [B,256,256,3] in [-1,1] -> W+ [B,n,512],
    each row its own FPN style (coarse 0-2 from c3, middle 3-6 from p2,
    fine 7.. from p1), no w0 broadcast or deltas."""
    c1, c2, c3 = irse_pyramid(p["backbone"], x.permute(0, 3, 1, 2))
    w = _all_style_latents(p, c1, c2, c3)
    if add_latent_avg:
        w = w + p["latent_avg"].to(w.dtype)[None]
    return w


def e4e_encode(p, x: Tensor, add_latent_avg: bool = True) -> Tensor:
    """x: [B,256,256,3] in [-1,1] (NHWC) -> W+ [B,n_styles,512]
    (psp_encoders.py:187-200 + model_utils.py:7-14)."""
    return e4e_encode_nchw(p, x.permute(0, 3, 1, 2), add_latent_avg)
