"""BiSeNet face parser, PyTorch (counterpart of hairfastgan_tpu/models/bisenet.py).

ResNet-18 context path, attention refinement on the 1/16 and 1/32
features, global context, feature fusion against 1/8, and the 3x3+1x1 main
head bilinearly upsampled (align_corners=True) to the input size. Labels
come out in the 19-class CelebAMask order (hair = 13): the argmax runs over
the channel-permuted logits. NCHW inside; public functions take NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.models.layers import init_bn, init_conv, init_conv_bn
from portbench.reference.ops.basic import avg_pool_global, batch_norm, conv2d_p
from portbench.reference.ops.resample import resize

Tensor = torch.Tensor

SEG_MEAN = (0.485, 0.456, 0.406)
SEG_STD = (0.229, 0.224, 0.225)
CELEBA_HAIR = 13
SEG16_HAIR = 10  # hair in the 16-class seg.pth parser's raw order (training masks)
# celeba[i] = raw[PERM[i]] (my_parsing_util.py:90-95 name matching)
FACE_PARSING_TO_CELEBA = (0, 1, 10, 6, 4, 5, 2, 3, 7, 8, 11, 12, 13, 17, 18, 9, 15, 14, 16)


def _cbr(p, x: Tensor, stride: int = 1, padding: int = 0) -> Tensor:
    """conv -> BN -> ReLU of an init_conv_bn dict."""
    return torch.relu(batch_norm(p["bn"], conv2d_p(p["conv"], x, stride=stride,
                                                   padding=padding)))


def init_basic_block(cin: int, cout: int, stride: int):
    p = {"conv1": init_conv_bn(3, cin, cout), "conv2": init_conv_bn(3, cout, cout),
         "stride": stride}
    if cin != cout or stride != 1:
        p["downsample"] = init_conv_bn(1, cin, cout)
    return p


def basic_block(p, x: Tensor) -> Tensor:
    s = p["stride"]
    r = _cbr(p["conv1"], x, stride=s, padding=1)
    r = batch_norm(p["conv2"]["bn"], conv2d_p(p["conv2"]["conv"], r, padding=1))
    short = x
    if "downsample" in p:
        short = batch_norm(p["downsample"]["bn"], conv2d_p(p["downsample"]["conv"], x, stride=s))
    return torch.relu(short + r)


def init_resnet18(width: float = 1.0):
    c = lambda n: max(16, int(n * width))
    layers = {"conv1": init_conv_bn(7, 3, c(64))}
    chans = [(c(64), c(64), 1), (c(64), c(128), 2), (c(128), c(256), 2), (c(256), c(512), 2)]
    for i, (cin, cout, s) in enumerate(chans, start=1):
        layers[f"layer{i}"] = [init_basic_block(cin, cout, s), init_basic_block(cout, cout, 1)]
    return layers


def resnet18_features(p, x: Tensor):
    x = F.max_pool2d(_cbr(p["conv1"], x, stride=2, padding=3), 3, 2, padding=1)
    for b in p["layer1"]:
        x = basic_block(b, x)
    feats = []
    for name in ("layer2", "layer3", "layer4"):
        for b in p[name]:
            x = basic_block(b, x)
        feats.append(x)
    return tuple(feats)  # f8, f16, f32


def init_arm(cin: int, cout: int):
    return {"conv": init_conv_bn(3, cin, cout), "atten": init_conv(1, cout, cout, bias=False),
            "bn_atten": init_bn(cout)}


def arm(p, x: Tensor) -> Tensor:
    feat = _cbr(p["conv"], x, padding=1)
    a = torch.sigmoid(batch_norm(p["bn_atten"], conv2d_p(p["atten"], avg_pool_global(feat))))
    return feat * a


def init_ffm(cin: int, cout: int):
    return {"convblk": init_conv_bn(1, cin, cout),
            "conv1": init_conv(1, cout, cout // 4, bias=False),
            "conv2": init_conv(1, cout // 4, cout, bias=False)}


def ffm(p, fsp: Tensor, fcp: Tensor) -> Tensor:
    feat = _cbr(p["convblk"], torch.cat([fsp, fcp], dim=1))
    a = avg_pool_global(feat)
    a = torch.sigmoid(conv2d_p(p["conv2"], torch.relu(conv2d_p(p["conv1"], a))))
    return feat * a + feat


def init_head(cin: int, mid: int, n_classes: int):
    return {"conv": init_conv_bn(3, cin, mid), "out": init_conv(1, mid, n_classes, bias=False)}


def head(p, x: Tensor) -> Tensor:
    return conv2d_p(p["out"], _cbr(p["conv"], x, padding=1))


def init_bisenet(n_classes: int = 19, width: float = 1.0):
    c = lambda n: max(16, int(n * width))
    return {
        "resnet": init_resnet18(width),
        "arm16": init_arm(c(256), c(128)),
        "arm32": init_arm(c(512), c(128)),
        "conv_head32": init_conv_bn(3, c(128), c(128)),
        "conv_head16": init_conv_bn(3, c(128), c(128)),
        "conv_avg": init_conv_bn(1, c(512), c(128)),
        "ffm": init_ffm(c(128) * 2, c(256)),
        "head": init_head(c(256), c(256), n_classes),
        "head16": init_head(c(128), c(64), n_classes),
        "head32": init_head(c(128), c(64), n_classes),
        "n_classes": n_classes,
    }


def bisenet_logits_nchw(p, x: Tensor) -> Tensor:
    """Normalized NCHW image -> main-head logits [B,K,H,W]."""
    h, w = x.shape[-2:]
    f8, f16, f32 = resnet18_features(p["resnet"], x)
    avg = _cbr(p["conv_avg"], avg_pool_global(f32))
    f32_up = resize(arm(p["arm32"], f32) + avg, tuple(f16.shape[-2:]), "nearest")
    f32_up = _cbr(p["conv_head32"], f32_up, padding=1)
    f16_up = resize(arm(p["arm16"], f16) + f32_up, tuple(f8.shape[-2:]), "nearest")
    f16_up = _cbr(p["conv_head16"], f16_up, padding=1)
    fused = ffm(p["ffm"], f8, f16_up)
    return resize(head(p["head"], fused), (h, w), "bilinear", align_corners=True)


def to_bisenet_input(img01: Tensor) -> Tensor:
    """[0,1] RGB NCHW -> normalized parser input."""
    mean = torch.tensor(SEG_MEAN, dtype=img01.dtype, device=img01.device).view(1, 3, 1, 1)
    std = torch.tensor(SEG_STD, dtype=img01.dtype, device=img01.device).view(1, 3, 1, 1)
    return (img01 - mean) / std


def bisenet_logits(p, x: Tensor) -> Tensor:
    """Normalized NHWC image -> main logits [B,H,W,K] (raw class order)."""
    return bisenet_logits_nchw(p, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def parse_to_celeba_nchw(p, img01: Tensor) -> Tensor:
    """[0,1] NCHW image -> int labels [B,H,W], CelebAMask order (argmax over
    the permuted logits; ties take the first index, as jnp.argmax)."""
    logits = bisenet_logits_nchw(p, to_bisenet_input(img01))
    perm = torch.tensor(FACE_PARSING_TO_CELEBA, device=logits.device)
    return torch.argmax(logits.index_select(1, perm), dim=1).to(torch.int32)


def parse_to_celeba(p, img01: Tensor) -> Tensor:
    """[0,1] NHWC image -> int labels [B,H,W] in CelebAMask order."""
    return parse_to_celeba_nchw(p, img01.permute(0, 3, 1, 2))


def segment_256_nchw(p, img01: Tensor) -> Tensor:
    labels = parse_to_celeba_nchw(p, img01)
    return resize(labels, (256, 256), "nearest")


def segment_256(p, img01_512: Tensor) -> Tensor:
    """NHWC parse -> 256 nearest-resized labels [B,256,256] (Net.py:108-115)."""
    return segment_256_nchw(p, img01_512.permute(0, 3, 1, 2))
