"""CtrlHair shape adaptor (mask autoencoder), PyTorch (counterpart of
hairfastgan_tpu/models/shape_adaptor.py).

MaskEncoder: positional encoding + 7 stride-2 conv/LN/lrelu blocks +
Linear (the hair encoder's VAE returns its mean); MaskDecoder: Linear ->
7x (nearest x2, conv3x3, LN, lrelu) -> conv3x3; recombination of 18 face
logits and the hair logit at HAIR_IDX=13, argmax over 19. The 'ln' norm is
CtrlHair's per-sample LayerNorm over (C,H,W) with torch's UNBIASED std and
eps added to the std. Functions take and return [B,256,256] int labels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.models.layers import init_conv, init_linear, spec
from portbench.reference.ops.basic import conv2d_p, linear
from portbench.reference.ops.segops import one_hot_mask

Tensor = torch.Tensor

HAIR_IDX = 13
N_CLASSES = 19
INPUT_SIZE = 256
LAYER_NUM = 7
HAIR_DIM = 16
FACE_DIM = 1024
POS_ORDER = 10


@functools.lru_cache(maxsize=None)
def pos_embedding(img_size: int = INPUT_SIZE, order: int = POS_ORDER) -> np.ndarray:
    """[4*order, H, W] positional table (model.py:19-33): sin(f0*x),
    sin(f0*y), sin(f1*x)... then cos likewise."""
    coords = np.linspace(0, 1, img_size, endpoint=False)
    xg, yg = np.meshgrid(coords, coords)
    bi = np.stack([xg, yg], 0)[None]  # [1, 2, H, W]
    freqs = (2.0 ** np.arange(order) * np.pi)[:, None, None, None]
    gamma = np.concatenate([np.sin(freqs * bi), np.cos(freqs * bi)], axis=0)
    return gamma.reshape(-1, img_size, img_size).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pos_on(device: torch.device, dtype: torch.dtype) -> Tensor:
    with torch.inference_mode(False):  # a normal tensor in the cache (ops/resample._on_device)
        return torch.from_numpy(pos_embedding()).to(device=device, dtype=dtype)


def ctrlhair_layer_norm(p, x: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-sample norm over all non-batch dims, unbiased std, channel affine (f32)."""
    xf = x.float()
    flat = xf.reshape(x.shape[0], -1)
    mean = flat.mean(dim=1)
    std = flat.var(dim=1, unbiased=True).sqrt()
    shape = (-1,) + (1,) * (x.ndim - 1)
    y = (xf - mean.reshape(shape)) / (std.reshape(shape) + eps)
    y = y * p["gamma"].float().view(1, -1, 1, 1) + p["beta"].float().view(1, -1, 1, 1)
    return y.to(x.dtype)


def _enc_channels(hidden: int = 32):
    return [min(2048, hidden * 2 ** i) for i in range(LAYER_NUM)]


def init_mask_encoder(in_ch: int, out_dim: int, vae: bool = False, hidden: int = 32):
    layers, cin = [], in_ch + 4 * POS_ORDER
    for cout in _enc_channels(hidden):
        layers.append({"conv": init_conv(4, cin, cout),
                       "ln": {"gamma": spec(cout), "beta": spec(cout)}})
        cin = cout
    fc_in = (INPUT_SIZE // 2 ** LAYER_NUM) ** 2 * cin
    p = {"layers": layers, "out": init_linear(fc_in, out_dim)}
    if vae:
        p["std_out"] = init_linear(fc_in, out_dim)
    return p


def mask_encode(p, mask: Tensor) -> Tensor:
    """mask [B,in_ch,256,256] -> mean code [B,out_dim] (test path)."""
    pos = _pos_on(mask.device, mask.dtype)
    x = torch.cat([mask, pos[None].expand(mask.shape[0], -1, -1, -1)], dim=1)
    for l in p["layers"]:
        x = F.leaky_relu(ctrlhair_layer_norm(l["ln"], conv2d_p(l["conv"], x, stride=2,
                                                              padding=1)), 0.2)
    return linear(p["out"], x.flatten(1))  # channel-major flatten, as torch


def init_mask_decoder(in_dim: int, out_ch: int, hidden: int = 32):
    in_channel = min(hidden * 2 ** LAYER_NUM, 2048)
    in_size = INPUT_SIZE // 2 ** LAYER_NUM
    layers, cin = [], in_channel
    for i in range(LAYER_NUM):
        cout = min(hidden * 2 ** (LAYER_NUM - 1 - i), 2048)
        layers.append({"conv": init_conv(3, cin, cout),
                       "ln": {"gamma": spec(cout), "beta": spec(cout)}})
        cin = cout
    return {"in": init_linear(in_dim, in_channel * in_size ** 2), "layers": layers,
            "out": init_conv(3, cin, out_ch)}


def mask_decode(p, code: Tensor) -> Tensor:
    x = linear(p["in"], code)
    in_channel = p["layers"][0]["conv"]["w"].shape[1]  # OIHW
    in_size = int(round((x.shape[-1] // in_channel) ** 0.5))
    x = x.reshape(-1, in_channel, in_size, in_size)
    for l in p["layers"]:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # nearest x2
        x = F.leaky_relu(ctrlhair_layer_norm(l["ln"], conv2d_p(l["conv"], x, padding=1)), 0.2)
    return conv2d_p(p["out"], x, padding=1)


def init_shape_adaptor(hidden: int = 32):
    return {
        "hair_encoder": init_mask_encoder(1, HAIR_DIM, vae=True, hidden=hidden),
        "face_encoder": init_mask_encoder(N_CLASSES - 1, FACE_DIM, hidden=hidden),
        "hair_decoder": init_mask_decoder(FACE_DIM + HAIR_DIM, 1, hidden=hidden),
        "face_decoder": init_mask_decoder(FACE_DIM, N_CLASSES - 1, hidden=hidden),
    }


def get_face_code(p, labels256: Tensor) -> Tensor:
    """labels [B,256,256] -> face code [B,1024] (the 18 non-hair channels).
    The one-hot masks are f32 whatever the compute dtype, as in the JAX
    package, so the adaptor always runs in f32."""
    onehot = one_hot_mask(labels256, N_CLASSES)
    face = torch.cat([onehot[:, :HAIR_IDX], onehot[:, HAIR_IDX + 1:]], dim=1)
    return mask_encode(p["face_encoder"], face)


def get_hair_code(p, labels256: Tensor) -> Tensor:
    """labels [B,256,256] -> hair code [B,16] (VAE mean, test path)."""
    onehot = one_hot_mask(labels256, N_CLASSES)
    return mask_encode(p["hair_encoder"], onehot[:, HAIR_IDX:HAIR_IDX + 1])


def get_hair_face_code(p, labels256: Tensor) -> Tuple[Tensor, Tensor]:
    """labels [B,256,256] -> (face code [B,1024], hair code [B,16])
    (solver.py:248-256); the pipeline needs only one of the two per mask
    and calls the two functions above."""
    return get_face_code(p, labels256), get_hair_code(p, labels256)


def get_new_shape(p, face_code: Tensor, hair_code: Tensor) -> Tensor:
    """codes [B,1024] x [k*B,16] -> recombined 19-class labels [k*B,256,256]
    (solver.py:259-262); argmax of the logits == argmax of their softmax.
    With k > 1 hair codes per face code (one face recombined with the shape
    and the color pair's hair) the face decoder runs once at B and its
    logits are tiled k times: exact, as they depend on the face code only."""
    return _new_shape(p, face_code, hair_code)


def _new_shape(p, face_code: Tensor, hair_code: Tensor) -> Tensor:
    k = hair_code.shape[0] // face_code.shape[0]
    hair_logit = mask_decode(p["hair_decoder"],
                             torch.cat([face_code.repeat(k, 1), hair_code], dim=-1))
    face_logit = mask_decode(p["face_decoder"], face_code).repeat(k, 1, 1, 1)
    logit = torch.cat([face_logit[:, :HAIR_IDX], hair_logit, face_logit[:, HAIR_IDX:]], dim=1)
    return torch.argmax(logit, dim=1).to(torch.int32)
