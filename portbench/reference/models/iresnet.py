"""ArcFace IR-ResNet trunk + FS-style encoders, PyTorch (counterpart of
hairfastgan_tpu/models/iresnet.py).

IBasicBlock: out = bn3(conv2_s(prelu(bn2(conv1(bn1(x)))))) + downsample(x).
`fs_encode` is fs_encoder_v2 / FeatureEncoderMult (S codes from the pooled
stage features + content maps); `feature_iresnet` is the PostProcess
F-fuser. `pack_fs_styles` (opt-in, through zoo.pack_zoo) stacks the style
heads into one product. NCHW inside; the public functions take and return
NHWC maps.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.models.layers import (init_bn, init_conv, init_conv_bn,
                                             init_linear, init_prelu)
from portbench.reference.ops.basic import batch_norm, conv2d_p, linear, prelu

Tensor = torch.Tensor

IRESNET_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 14, 3),
                  100: (3, 13, 30, 3), 200: (6, 26, 60, 6)}
STAGE_PLANES = (64, 128, 256, 512)
# content-head conv geometry per generator fs layer (reference Net.py:118-138)
FS_KERNELS = {0: (12, 12), 1: (12, 12), 2: (6, 6), 3: (6, 6),
              4: (3, 3), 5: (3, 3), 6: (3, 3), 7: (3, 3)}
FS_STRIDES = {0: (7, 7), 1: (7, 7), 2: (4, 4), 3: (4, 4),
              4: (2, 2), 5: (2, 2), 6: (1, 1), 7: (1, 1)}


def init_ibasic_block(inplanes: int, planes: int, stride: int):
    p = {"bn1": init_bn(inplanes), "conv1": init_conv(3, inplanes, planes, bias=False),
         "bn2": init_bn(planes), "prelu": init_prelu(planes),
         "conv2": init_conv(3, planes, planes, bias=False), "bn3": init_bn(planes)}
    if stride != 1 or inplanes != planes:
        p["downsample"] = init_conv_bn(1, inplanes, planes)
    return p


def ibasic_block(p, x: Tensor, stride: int) -> Tensor:
    out = conv2d_p(p["conv1"], batch_norm(p["bn1"], x), padding=1)
    out = prelu(p["prelu"], batch_norm(p["bn2"], out))
    out = batch_norm(p["bn3"], conv2d_p(p["conv2"], out, stride=stride, padding=1))
    if "downsample" in p:
        identity = batch_norm(p["downsample"]["bn"],
                              conv2d_p(p["downsample"]["conv"], x, stride=stride))
    else:
        identity = x
    return out + identity


def init_trunk(depth: int = 50, width: float = 1.0):
    c = lambda n: max(16, int(n * width))
    p = {"conv1": init_conv(3, 3, c(64), bias=False), "bn1": init_bn(c(64)),
         "prelu": init_prelu(c(64)), "stages": []}
    inplanes = c(64)
    for planes, n in zip([c(q) for q in STAGE_PLANES], IRESNET_LAYERS[depth]):
        blocks = [init_ibasic_block(inplanes, planes, 2)]
        blocks += [init_ibasic_block(planes, planes, 1) for _ in range(n - 1)]
        p["stages"].append(blocks)
        inplanes = planes
    return p


def trunk_features(p, x: Tensor) -> List[Tensor]:
    """Stem + 4 stages (each opening with a stride-2 block) -> [f1..f4]."""
    x = prelu(p["prelu"], batch_norm(p["bn1"], conv2d_p(p["conv1"], x, padding=1)))
    feats = []
    for blocks in p["stages"]:
        x = ibasic_block(blocks[0], x, stride=2)
        for b in blocks[1:]:
            x = ibasic_block(b, x, stride=1)
        feats.append(x)
    return feats


def init_arcface(depth: int = 50, num_features: int = 512):
    """The IResNet ArcFace identity model (112x112 -> num_features)."""
    # features_bn: BatchNorm1d, its weight frozen to 1 (Net.py:240-242)
    return {"trunk": init_trunk(depth), "bn2": init_bn(512),
            "fc": init_linear(512 * 7 * 7, num_features),
            "features_bn": init_bn(num_features)}


def arcface_embed(p, x: Tensor) -> Tensor:
    """x: NHWC [B,112,112,3] in [-1,1] -> [B,num_features] identity embedding
    (the trunk's last map batch-normed and flattened in NCHW order, as
    torch flattens it)."""
    f4 = trunk_features(p["trunk"], x.permute(0, 3, 1, 2))[-1]
    y = batch_norm(p["bn2"], f4).flatten(1)
    return batch_norm(p["features_bn"], linear(p["fc"], y))


def _init_content_layer(cin: int, kernel, stride, out_ch: int = 512):
    return {"bn0": init_bn(cin), "conv1": init_conv(3, cin, out_ch, bias=False),
            "bn1": init_bn(out_ch), "prelu": init_prelu(out_ch),
            "conv2": init_conv(kernel, out_ch, out_ch, bias=False),
            "bn2": init_bn(out_ch), "stride": stride}


def _content_layer(p, x: Tensor) -> Tensor:
    y = conv2d_p(p["conv1"], batch_norm(p["bn0"], x), padding=1)
    y = prelu(p["prelu"], batch_norm(p["bn1"], y))
    y = conv2d_p(p["conv2"], y, stride=p["stride"], padding=1)
    return batch_norm(p["bn2"], y)


def init_fs_encoder(n_styles: int = 18, fs_layers: Sequence[int] = (5,),
                    depth: int = 50, width: float = 1.0, content_ch: int = 512):
    """fs_layers <= 7 tap block_3 (256 ch); > 7 tap block_2 (128 ch) with the
    kernel table shifted by 2 (reference Net.py:396-420)."""
    c = lambda n: max(16, int(n * width))
    shift = 0 if max(fs_layers) <= 7 else 2
    cin = c(256) if max(fs_layers) <= 7 else c(128)
    style_in = sum(c(q) for q in STAGE_PLANES) * 9
    return {
        "trunk": init_trunk(depth, width),
        "styles": [init_linear(style_in, 512) for _ in range(n_styles)],
        "content": [_init_content_layer(cin, FS_KERNELS[l - shift], FS_STRIDES[l - shift],
                                        out_ch=content_ch) for l in fs_layers],
        "fs_layers": tuple(fs_layers),
    }


def pack_fs_styles(p):
    """The n_styles Linear(960*9 -> 512) heads stacked (exact, idempotent):
    'styles_w' [n,512,8640] and 'styles_b' [n,512], the JAX package's
    pack_fs_styles bridged. fs_encode then runs them as ONE [B,8640] x
    [8640, n*512] product."""
    if "styles_w" in p or "styles" not in p:
        return p
    q = {k: v for k, v in p.items() if k != "styles"}
    q["styles_w"] = torch.stack([h["w"] for h in p["styles"]])
    q["styles_b"] = torch.stack([h["b"] for h in p["styles"]])
    return q


def fs_encode_nchw(p, x: Tensor) -> Tuple[Tensor, List[Tensor]]:
    feats = trunk_features(p["trunk"], x)
    src = feats[1] if max(p["fs_layers"]) > 7 else feats[2]
    content = [_content_layer(cl, src) for cl in p["content"]]
    # style input: AdaptiveAvgPool(3,3) of every stage, concatenated over
    # channels and flattened channel-major (torch NCHW order)
    flat = torch.cat([F.adaptive_avg_pool2d(f, (3, 3)) for f in feats], dim=1).flatten(1)
    if "styles_w" in p:  # packed (pack_fs_styles): one product over the heads' rows,
        # then the [n, d] biases, as the JAX package writes it (on the model
        # axis a split styles_b is added to its slice of the product)
        n, d, f = p["styles_w"].shape
        styles = (F.linear(flat, p["styles_w"].to(flat.dtype).reshape(n * d, f)).reshape(-1, n, d)
                  + p["styles_b"].to(flat.dtype))
    else:
        styles = torch.stack([linear(h, flat) for h in p["styles"]], dim=1)
    return styles, content


def fs_encode(p, x: Tensor) -> Tuple[Tensor, List[Tensor]]:
    """x: [B,256,256,3] normalized (NHWC) -> (S [B,n_styles,512], [NHWC content maps])."""
    styles, content = fs_encode_nchw(p, x.permute(0, 3, 1, 2))
    return styles, [c.permute(0, 2, 3, 1) for c in content]


def init_feature_iresnet(blocks: Sequence[Tuple[int, int]] = ((1024, 2), (768, 2), (512, 2)),
                         inplanes: int = 1024):
    p = []
    for planes, n in blocks:
        for _ in range(n):
            p.append(init_ibasic_block(inplanes, planes, 1))
            inplanes = planes
    return p


def feature_iresnet_nchw(p, x: Tensor) -> Tensor:
    for block in p:
        x = ibasic_block(block, x, stride=1)
    return x


def feature_iresnet(p, x: Tensor) -> Tensor:
    """NHWC in, NHWC out (FeatureiResnet, reference Encoders.py:35-57)."""
    return feature_iresnet_nchw(p, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
