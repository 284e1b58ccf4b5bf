"""InceptionV3 feature extractor for classic FID, PyTorch (counterpart of
hairfastgan_tpu/models/inception.py).

The reference computes FID with torchmetrics' FrechetInceptionDistance
(scripts/fid_metric.py:24-50), which wraps the standard pt_inception
(InceptionV3 with the FID head: 2048-d pool3 features). This is that
architecture as functions over a param dict, NCHW inside; weights convert
from the torchvision `inception_v3` state_dict (`convert_inception`).

Structure (torchvision layout):
  stem: Conv 3x3/2 -> 3x3 -> 3x3 pad1, maxpool, 1x1, 3x3, maxpool
  3x InceptionA (pool features 32/64/64)
  InceptionB, 4x InceptionC (c7 = 128/160/160/192), InceptionD,
  2x InceptionE, global avgpool -> [B, 2048]

FID protocol: inputs [0,1], resized to 299^2 bilinear (ops/resample, the
JAX package's resize), normalized to [-1,1] (pt_inception convention).
BatchNorm eps is 1e-3; the branch avg pools count their padding; the max
pools are unpadded.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from hairfastgan_torch.models.layers import init_conv_bn
from hairfastgan_torch.ops.basic import avg_pool_global, batch_norm, conv2d_p, max_pool
from hairfastgan_torch.ops.resample import resize

Tensor = torch.Tensor

# asymmetric paddings of the 1x7 / 7x1 and 1x3 / 3x1 convs: [(top, bottom), (left, right)]
_P17, _P71 = [(0, 0), (3, 3)], [(3, 3), (0, 0)]
_P13, _P31 = [(0, 0), (1, 1)], [(1, 1), (0, 0)]


def _cbr(p, x: Tensor, stride: int = 1, padding=0) -> Tensor:
    return torch.relu(batch_norm(p["bn"], conv2d_p(p["conv"], x, stride=stride,
                                                   padding=padding), eps=1e-3))


def _avg_pool3(x: Tensor) -> Tensor:
    """3x3 stride-1 avg pool, pad 1, count_include_pad=True (torch default)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def inception_shapes() -> Dict:
    """Shape tree of the JAX package's init_inception (meta tensors, JAX layout)."""
    cbn = init_conv_bn

    def block_a(cin, pool_ch):
        return {"b1x1": cbn(1, cin, 64),
                "b5x5_1": cbn(1, cin, 48), "b5x5_2": cbn(5, 48, 64),
                "b3x3_1": cbn(1, cin, 64), "b3x3_2": cbn(3, 64, 96), "b3x3_3": cbn(3, 96, 96),
                "pool": cbn(1, cin, pool_ch)}

    def block_c(c7):
        cin = 768
        return {"b1x1": cbn(1, cin, 192),
                "b7_1": cbn(1, cin, c7), "b7_2": cbn((1, 7), c7, c7), "b7_3": cbn((7, 1), c7, 192),
                "b7d_1": cbn(1, cin, c7), "b7d_2": cbn((7, 1), c7, c7),
                "b7d_3": cbn((1, 7), c7, c7), "b7d_4": cbn((7, 1), c7, c7),
                "b7d_5": cbn((1, 7), c7, 192),
                "pool": cbn(1, cin, 192)}

    def block_e(cin):
        return {"b1x1": cbn(1, cin, 320),
                "b3_1": cbn(1, cin, 384), "b3_2a": cbn((1, 3), 384, 384),
                "b3_2b": cbn((3, 1), 384, 384),
                "b3d_1": cbn(1, cin, 448), "b3d_2": cbn(3, 448, 384),
                "b3d_3a": cbn((1, 3), 384, 384), "b3d_3b": cbn((3, 1), 384, 384),
                "pool": cbn(1, cin, 192)}

    return {
        "stem": {"c1": cbn(3, 3, 32), "c2": cbn(3, 32, 32), "c3": cbn(3, 32, 64),
                 "c4": cbn(1, 64, 80), "c5": cbn(3, 80, 192)},
        "a1": block_a(192, 32), "a2": block_a(256, 64), "a3": block_a(288, 64),
        "b": {"b3x3": cbn(3, 288, 384), "bd_1": cbn(1, 288, 64),
              "bd_2": cbn(3, 64, 96), "bd_3": cbn(3, 96, 96)},
        "c1": block_c(128), "c2": block_c(160), "c3": block_c(160), "c4": block_c(192),
        "d": {"b3_1": cbn(1, 768, 192), "b3_2": cbn(3, 192, 320),
              "b7_1": cbn(1, 768, 192), "b7_2": cbn((1, 7), 192, 192),
              "b7_3": cbn((7, 1), 192, 192), "b7_4": cbn(3, 192, 192)},
        "e1": block_e(1280), "e2": block_e(2048),
    }


def init_inception(seed: int = 0, device="cpu") -> Dict:
    """Random InceptionV3 params (port layout, f32 on `device`) from a numpy
    seed: conv weights He-scaled, N(0, 2 / fan_in), and identity
    BatchNorm (gamma 1, beta 0, mean 0, var 1), so that the features of
    random weights still vary with the input (the JAX package's 0.02 * N(0,1)
    shrinks them to ~1e-9 over the 48 convs). The converter fills real
    weights."""
    from hairfastgan_torch.params.bridge import map_tree, to_port

    rng = np.random.default_rng(seed)
    fixed = {"gamma": 1.0, "var": 1.0, "beta": 0.0, "mean": 0.0}

    def leaf(key, t):
        shape = tuple(t.shape)
        if key in fixed:
            a = np.full(shape, fixed[key], np.float32)
        else:  # conv 'w', HWIO
            a = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                np.sqrt(2.0 / np.prod(shape[:3])))
        return to_port(key, torch.from_numpy(a)).to(device).contiguous()

    return map_tree(inception_shapes(), leaf)


def _inception_a(p, x: Tensor) -> Tensor:
    b1 = _cbr(p["b1x1"], x)
    b5 = _cbr(p["b5x5_2"], _cbr(p["b5x5_1"], x), padding=2)
    b3 = _cbr(p["b3x3_3"], _cbr(p["b3x3_2"], _cbr(p["b3x3_1"], x), padding=1), padding=1)
    bp = _cbr(p["pool"], _avg_pool3(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, x: Tensor) -> Tensor:
    b3 = _cbr(p["b3x3"], x, stride=2)
    bd = _cbr(p["bd_3"], _cbr(p["bd_2"], _cbr(p["bd_1"], x), padding=1), stride=2)
    return torch.cat([b3, bd, max_pool(x, 3, 2)], dim=1)


def _inception_c(p, x: Tensor) -> Tensor:
    b1 = _cbr(p["b1x1"], x)
    b7 = _cbr(p["b7_1"], x)
    b7 = _cbr(p["b7_2"], b7, padding=_P17)
    b7 = _cbr(p["b7_3"], b7, padding=_P71)
    bd = _cbr(p["b7d_1"], x)
    bd = _cbr(p["b7d_2"], bd, padding=_P71)
    bd = _cbr(p["b7d_3"], bd, padding=_P17)
    bd = _cbr(p["b7d_4"], bd, padding=_P71)
    bd = _cbr(p["b7d_5"], bd, padding=_P17)
    bp = _cbr(p["pool"], _avg_pool3(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, x: Tensor) -> Tensor:
    b3 = _cbr(p["b3_2"], _cbr(p["b3_1"], x), stride=2)
    b7 = _cbr(p["b7_1"], x)
    b7 = _cbr(p["b7_2"], b7, padding=_P17)
    b7 = _cbr(p["b7_3"], b7, padding=_P71)
    b7 = _cbr(p["b7_4"], b7, stride=2)
    return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=1)


def _inception_e(p, x: Tensor) -> Tensor:
    b1 = _cbr(p["b1x1"], x)
    b3 = _cbr(p["b3_1"], x)
    b3 = torch.cat([_cbr(p["b3_2a"], b3, padding=_P13), _cbr(p["b3_2b"], b3, padding=_P31)], dim=1)
    bd = _cbr(p["b3d_2"], _cbr(p["b3d_1"], x), padding=1)
    bd = torch.cat([_cbr(p["b3d_3a"], bd, padding=_P13), _cbr(p["b3d_3b"], bd, padding=_P31)],
                   dim=1)
    bp = _cbr(p["pool"], _avg_pool3(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


def inception_features_nchw(p, img01: Tensor) -> Tensor:
    """[0,1] NCHW images of any size -> [B, 2048] pool3 features (FID protocol)."""
    x = resize(img01, (299, 299), "bilinear") * 2.0 - 1.0
    s = p["stem"]
    x = _cbr(s["c1"], x, stride=2)
    x = _cbr(s["c2"], x)
    x = _cbr(s["c3"], x, padding=1)
    x = max_pool(x, 3, 2)
    x = _cbr(s["c4"], x)
    x = _cbr(s["c5"], x)
    x = max_pool(x, 3, 2)
    for name in ("a1", "a2", "a3"):
        x = _inception_a(p[name], x)
    x = _inception_b(p["b"], x)
    for name in ("c1", "c2", "c3", "c4"):
        x = _inception_c(p[name], x)
    x = _inception_d(p["d"], x)
    x = _inception_e(p["e1"], x)
    x = _inception_e(p["e2"], x)
    return avg_pool_global(x)[:, :, 0, 0]


def inception_features(p, img01: Tensor) -> Tensor:
    """[0,1] NHWC images of any size -> [B, 2048] pool3 features."""
    return inception_features_nchw(p, img01.permute(0, 3, 1, 2))


# -- torchvision state_dict conversion ----------------------------------------

TV_MAP = {
    "stem.c1": "Conv2d_1a_3x3", "stem.c2": "Conv2d_2a_3x3",
    "stem.c3": "Conv2d_2b_3x3", "stem.c4": "Conv2d_3b_1x1",
    "stem.c5": "Conv2d_4a_3x3",
    "a1": "Mixed_5b", "a2": "Mixed_5c", "a3": "Mixed_5d",
    "b": "Mixed_6a",
    "c1": "Mixed_6b", "c2": "Mixed_6c", "c3": "Mixed_6d", "c4": "Mixed_6e",
    "d": "Mixed_7a", "e1": "Mixed_7b", "e2": "Mixed_7c",
}

BRANCH_MAP = {
    # our key -> torchvision branch module name, per block type (the first
    # letter of the block's TV_MAP key)
    "a": {"b1x1": "branch1x1", "b5x5_1": "branch5x5_1", "b5x5_2": "branch5x5_2",
          "b3x3_1": "branch3x3dbl_1", "b3x3_2": "branch3x3dbl_2",
          "b3x3_3": "branch3x3dbl_3", "pool": "branch_pool"},
    "b": {"b3x3": "branch3x3", "bd_1": "branch3x3dbl_1",
          "bd_2": "branch3x3dbl_2", "bd_3": "branch3x3dbl_3"},
    "c": {"b1x1": "branch1x1", "b7_1": "branch7x7_1", "b7_2": "branch7x7_2",
          "b7_3": "branch7x7_3", "b7d_1": "branch7x7dbl_1",
          "b7d_2": "branch7x7dbl_2", "b7d_3": "branch7x7dbl_3",
          "b7d_4": "branch7x7dbl_4", "b7d_5": "branch7x7dbl_5",
          "pool": "branch_pool"},
    "d": {"b3_1": "branch3x3_1", "b3_2": "branch3x3_2", "b7_1": "branch7x7x3_1",
          "b7_2": "branch7x7x3_2", "b7_3": "branch7x7x3_3",
          "b7_4": "branch7x7x3_4"},
    "e": {"b1x1": "branch1x1", "b3_1": "branch3x3_1", "b3_2a": "branch3x3_2a",
          "b3_2b": "branch3x3_2b", "b3d_1": "branch3x3dbl_1",
          "b3d_2": "branch3x3dbl_2", "b3d_3a": "branch3x3dbl_3a",
          "b3d_3b": "branch3x3dbl_3b", "pool": "branch_pool"},
}


def convert_inception(sd) -> Dict:
    """torchvision inception_v3 state_dict (numpy) -> the params tree, in
    the port's layout (the checkpoint's OIHW convs as they are)."""
    from hairfastgan_torch.params.convert import t_bn, t_conv

    def cbn(tv_name):
        return {"conv": t_conv(sd, f"{tv_name}.conv"), "bn": t_bn(sd, f"{tv_name}.bn")}

    out: Dict = {"stem": {}}
    for ours, tv in TV_MAP.items():
        if ours.startswith("stem."):
            out["stem"][ours.split(".")[1]] = cbn(tv)
        else:
            out[ours] = {k: cbn(f"{tv}.{v}") for k, v in BRANCH_MAP[ours[0]].items()}
    return out
