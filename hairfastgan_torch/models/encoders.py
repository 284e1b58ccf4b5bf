"""The trained glue encoders: Rotate, ClipBlending, PostProcess, PyTorch
(counterpart of hairfastgan_tpu/models/encoders.py; reference
models/Encoders.py:13-160).

All are stacks of ModulationModule, a FiLM block:
    x = LayerNorm_{rows,512}(Linear(x));  out = x*(1+gamma(e)) + beta(e)
    gamma/beta = Linear -> LayerNorm -> LeakyReLU(0.01) -> Linear
    (+ LeakyReLU(0.01) after every block but the last)
PixelNorm runs over dim=1, the rows of [B, rows, 512]. Image arguments are
NHWC, in [-1, 1]. The three models also take a model-axis tree
(parallel/tensor.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from hairfastgan_torch.models import iresnet
from hairfastgan_torch.models.clip_vit import clip_encode_image_nchw, clip_preprocess_nchw
from hairfastgan_torch.models.layers import init_linear, mlp_ln_lrelu
from hairfastgan_torch.ops.basic import layer_norm, linear
from hairfastgan_torch.ops.columns import column_parallel
from hairfastgan_torch.ops.equalized import pixel_norm
from hairfastgan_torch.ops.resample import resize
from hairfastgan_torch.utils import timing

Tensor = torch.Tensor


def init_modulation_module(inp: int = 512, middle: int = 512):
    return {"fc": init_linear(512, 512), "gamma": mlp_ln_lrelu(inp, middle, 512),
            "beta": mlp_ln_lrelu(inp, middle, 512)}


def _branch(p, e: Tensor) -> Tensor:
    h = layer_norm(linear(p["fc1"], e), -1, p["ln"]["gamma"], p["ln"]["beta"])
    return linear(p["fc2"], F.leaky_relu(h, 0.01))


def modulation_module(p, x: Tensor, embedding: Tensor, last: bool) -> Tensor:
    """x [B,rows,512]; embedding [B,rows,inp] (Encoders.py:24-32)."""
    y = layer_norm(linear(p["fc"], x), (-2, -1))  # LayerNorm([rows,512]), no affine
    out = y * (1 + _branch(p["gamma"], embedding)) + _branch(p["beta"], embedding)
    return out if last else F.leaky_relu(out, 0.01)


def modulation_stack(mods, x: Tensor, embedding: Tensor) -> Tensor:
    for i, m in enumerate(mods):
        x = modulation_module(m, x, embedding, last=(i == len(mods) - 1))
    return x


def init_rotate_model():
    return {"mods": [init_modulation_module() for _ in range(5)]}


@timing.span("rotate")
@column_parallel
def rotate_model(p, latent_from: Tensor, latent_to: Tensor) -> Tensor:
    """W[:, :6] of (shape source, face target) -> rotated W[:, :6]."""
    dt = modulation_stack(p["mods"], pixel_norm(latent_from, dim=1), latent_to)
    return latent_from + 0.1 * dt


def init_blending_model(clip_params):
    return {"mods": [init_modulation_module(inp=512 * 3, middle=1024) for _ in range(5)],
            "clip": clip_params}


def clip_image_embed_nchw(clip_params, img_norm: Tensor) -> Tensor:
    """[-1,1] NCHW image -> CLIP embedding (get_image_embed, Encoders.py:89-92)."""
    return clip_encode_image_nchw(clip_params, clip_preprocess_nchw(img_norm * 0.5 + 0.5))


def clip_image_embed(clip_params, img_norm: Tensor) -> Tensor:
    """[-1,1] NHWC image -> CLIP embedding (the JAX package's layout)."""
    return clip_image_embed_nchw(clip_params, img_norm.permute(0, 3, 1, 2))


@timing.span("blending")
@column_parallel
def blending_model(p, latent_face: Tensor, latent_color: Tensor,
                   target_face: Tensor, hair_color: Tensor) -> Tensor:
    """S1[:,6:], S3[:,6:], masked face image, masked color image (NHWC,
    [-1,1], 256^2) -> S_blend[:, 6:]. One batched CLIP pass for both crops."""
    rows, b = latent_color.shape[1], target_face.shape[0]
    crops = torch.cat([target_face, hair_color]).permute(0, 3, 1, 2)
    both = clip_image_embed_nchw(p["clip"], crops)
    both = both.to(latent_color.dtype)[:, None, :].expand(-1, rows, -1)
    emb = torch.cat([latent_color, both[:b], both[b:]], dim=-1)
    dt = modulation_stack(p["mods"], pixel_norm(latent_face, dim=1), emb)
    return latent_face + 0.1 * dt


def init_post_process_model(n_latent: int = 18):
    return {"encoder_face": iresnet.init_fs_encoder(n_styles=n_latent, fs_layers=(9,)),
            "latent_avg": torch.empty((n_latent, 512), device="meta"),
            "to_feature": iresnet.init_feature_iresnet(),
            "to_latent_1": [init_modulation_module() for _ in range(5)],
            "to_latent_2": [init_modulation_module() for _ in range(5)]}


def init_post_process_train_model(use_mod: bool = True, n_latent: int = 18):
    """The training variant's tree (scripts/pp_train.py:278-298): use_mod=False
    swaps the two modulation stacks for one Linear(1024,1024) + LN + LReLU +
    Linear(1024,512) head over cat(s_face, s_hair)."""
    p = init_post_process_model(n_latent)
    if not use_mod:
        del p["to_latent_1"], p["to_latent_2"]
        p["to_latent"] = mlp_ln_lrelu(1024, 1024, 512)
    return p


def post_process_model_train(p, source: Tensor, target: Tensor,
                             target_mask: Optional[Tensor] = None, *, pretrain: bool = False,
                             use_mod: bool = True, use_full: bool = True
                             ) -> Tuple[Tensor, Tensor]:
    """The training forward with the reference's variant flags
    (pp_train.py:299-327), NHWC images at 256: pretrain returns the
    single-image inversion (latent_avg + S_face, F_face); use_full=False
    blends the two F maps with the target mask [B,H,W,1] at 64x64
    (nearest); use_mod=False runs the `to_latent` head."""
    s_face, (f_face,) = iresnet.fs_encode(p["encoder_face"], source)
    avg = p["latent_avg"].to(s_face.dtype)[None]
    if pretrain:
        return avg + s_face, f_face
    s_hair, (f_hair,) = iresnet.fs_encode(p["encoder_face"], target)
    if use_mod:
        d_face = modulation_stack(p["to_latent_1"], pixel_norm(s_face, dim=1), s_hair)
        d_hair = modulation_stack(p["to_latent_2"], pixel_norm(s_hair, dim=1), s_face)
        s_final = avg + 0.1 * (d_face + d_hair)
    else:
        s_final = avg + _branch(p["to_latent"], torch.cat([s_face, s_hair], dim=-1))
    if use_full:
        cat_f = torch.cat([f_face, f_hair], dim=-1)
    else:
        tm = resize(target_mask.permute(0, 3, 1, 2), (64, 64), "nearest").permute(0, 2, 3, 1)
        cat_f = torch.cat([f_face * tm, f_hair * (1 - tm)], dim=-1)
    return s_final, iresnet.feature_iresnet(p["to_feature"], cat_f)


@timing.span("post_process")
@column_parallel
def post_process_model(p, source: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(I_face_norm256, I_blend_norm256), NHWC -> (S_final [B,n,512],
    F_final NHWC [B,64,64,512]); one batched trunk pass for both images."""
    x = torch.cat([source, target]).permute(0, 3, 1, 2)
    if x.shape[-1] != 256:  # FeatureEncoderMult resizes to 256 (Net.py:12-14)
        x = resize(x, (256, 256), "bilinear")
    b = source.shape[0]
    s_both, (f_both,) = iresnet.fs_encode_nchw(p["encoder_face"], x)
    s_face, s_hair = s_both[:b], s_both[b:]
    d_face = modulation_stack(p["to_latent_1"], pixel_norm(s_face, dim=1), s_hair)
    d_hair = modulation_stack(p["to_latent_2"], pixel_norm(s_hair, dim=1), s_face)
    s_final = p["latent_avg"].to(s_face.dtype)[None] + 0.1 * (d_face + d_hair)
    cat_f = torch.cat([f_both[:b], f_both[b:]], dim=1)  # face | hair channels
    f_final = iresnet.feature_iresnet_nchw(p["to_feature"], cat_f)
    return s_final, f_final.permute(0, 2, 3, 1)
