"""Embedding stage: images -> {W, F, S, mask, image_256, image_norm_256}
(counterpart of hairfastgan_tpu/pipeline/embedding.py; reference
models/Embedding.py:56-118).

  * PULSE bicubic 1024 -> 512 / 256
  * e4e W+ from the normalized 256 image
  * FSE S + 16x16 content from the normalized image halved to 256, S + latent_avg
  * F = G[3..3](S, layer_in=content) -> [B,32,32,512]
  * BiSeNet parse at 512 -> 256 labels
  * hair mixing: F += mixing * hairmask32 * (G[0..3](W) - F) unless mix=False
Generator slices here run with zero noise, as in the JAX package. Stage
signature layouts follow the JAX package: images NHWC, F [B,32,32,512],
masks [B,256,256] int.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.config import HairFastConfig
from portbench.reference.models import bisenet, e4e, iresnet, stylegan2
from portbench.reference.ops.resample import bicubic_downsample, resize

Tensor = torch.Tensor


def to_res(img: Tensor, out: int) -> Tensor:
    """NCHW resize to a fixed working resolution (256/512 spaces): integer
    downscales use the PULSE bicubic FIR, other ratios bicubic resize."""
    size = img.shape[-1]
    if size == out:
        return img
    if size % out == 0:
        return bicubic_downsample(img, size // out)
    return resize(img, (out, out), "bicubic")


def fse_downscale(img_norm: Tensor, out_size: int = 256) -> Tensor:
    """Iterated x0.5 bilinear (FSE trainer.py:61-64); sub-256 inputs are
    upsampled to keep the trunk's 16x16 content geometry."""
    x = img_norm
    while x.shape[-1] > out_size:
        x = resize(x, (x.shape[-2] // 2, x.shape[-1] // 2), "bilinear")
    if x.shape[-1] < out_size:
        x = resize(x, (out_size, out_size), "bilinear")
    return x


def add_latent_avg(latent_avg: Tensor, latent: Tensor) -> Tensor:
    """S + the FSE's stored latent average [n, 512] (a leaf that the model
    axis splits on its features)."""
    return latent + latent_avg.to(latent.dtype)[None]


def embed_images(zoo: Dict, images: Tensor, *, mix: bool = True,
                 cfg: HairFastConfig = HairFastConfig(),
                 dtype: torch.dtype = torch.float32) -> Dict[str, Tensor]:
    """images: [B,H,W,3] uint8 or [0,1] float (NHWC) -> embedding dict."""
    img = images.to(dtype) / 255.0 if images.dtype == torch.uint8 else images.to(dtype)
    img = img.permute(0, 3, 1, 2)
    im_512, im_256 = to_res(img, 512), to_res(img, 256)
    im_256_norm = im_256 * 2.0 - 1.0

    zero = stylegan2.make_noise(None, cfg.stylegan)  # the embedding renders noise-free
    latent_w = e4e.e4e_encode_nchw(zoo["e4e"], im_256_norm)
    latent_s, (content,) = iresnet.fs_encode_nchw(zoo["fse"], fse_downscale(img * 2.0 - 1.0))
    latent_s = add_latent_avg(zoo["fse_latent_avg"], latent_s)
    latent_f, _ = stylegan2.synthesis_nchw(
        zoo["generator"], latent_s, noise=zero, start_layer=3, end_layer=3,
        layer_in=content, cfg=cfg.stylegan, dtype=dtype)

    masks = bisenet.segment_256_nchw(zoo["bisenet"], im_512)
    if mix:
        hair32 = resize((masks == cfg.hair_label).to(dtype)[:, None], (32, 32), "bicubic")
        f_from_w, _ = stylegan2.synthesis_nchw(
            zoo["generator"], latent_w, noise=zero, start_layer=0, end_layer=3,
            cfg=cfg.stylegan, dtype=dtype)
        latent_f = latent_f + cfg.mixing * hair32 * (f_from_w - latent_f)

    return {"W": latent_w, "F": latent_f.permute(0, 2, 3, 1), "S": latent_s, "mask": masks,
            "image_256": im_256.permute(0, 2, 3, 1),
            "image_norm_256": im_256_norm.permute(0, 2, 3, 1)}


def e4e_embed(zoo: Dict, images_norm: Tensor, *, cfg: HairFastConfig = HairFastConfig(),
              dtype: torch.dtype = torch.float32) -> Dict[str, Tensor]:
    """get_e4e_embed (Embedding.py:44-54): W of NHWC [-1,1] 256 images and
    F = G[0..3](W), NHWC."""
    latent_w = e4e.e4e_encode(zoo["e4e"], images_norm.to(dtype))
    zero = stylegan2.make_noise(None, cfg.stylegan)
    latent_f, _ = stylegan2.synthesis_nchw(zoo["generator"], latent_w, noise=zero,
                                           start_layer=0, end_layer=3, cfg=cfg.stylegan,
                                           dtype=dtype)
    return {"W": latent_w, "F": latent_f.permute(0, 2, 3, 1)}
