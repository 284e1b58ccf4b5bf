"""Training-dataset generation by running the inference pipeline
(counterpart of hairfastgan_tpu/train/datagen.py; reference
scripts/{rotate,blending,pp}_gen.py).

The reference monkey-patches pipeline stages to cut the pipeline early;
here each generator calls the stages up to its cut. Everything runs under
torch.no_grad() at zero noise in the images' float dtype. Images are NHWC
[0,1] floats (or uint8) at the generator's resolution; rows come back with
the JAX package's keys, layouts and shapes. Every dilate/erode goes through
ops/morphology.dilate_erode, so a CUDA tensor launches the hand-written
kernel: the blending sample's three masks of one shape as one launch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.models import bisenet, encoders, stylegan2
from hairfastgan_torch.ops.morphology import dilate_erode
from hairfastgan_torch.ops.resample import resize
from hairfastgan_torch.pipeline.alignment import align_images, shape_module
from hairfastgan_torch.pipeline.embedding import embed_images, to_res

Tensor = torch.Tensor


def _render_4_8(zoo: Dict, latent: Tensor, f_align: Tensor, cfg: HairFastConfig) -> Tensor:
    """G[4..8](latent, layer_in=F) at zero noise -> NCHW [-1,1] image."""
    _, img = stylegan2.synthesis_nchw(
        zoo["generator"], latent, noise=stylegan2.make_noise(None, cfg.stylegan),
        start_layer=4, end_layer=8, layer_in=f_align.permute(0, 3, 1, 2),
        cfg=cfg.stylegan, dtype=latent.dtype)
    return img


@torch.no_grad()
def generate_blending_sample(zoo: Dict, face: Tensor, shape: Tensor, color: Tensor,
                             cfg: HairFastConfig = HairFastConfig(),
                             seg16_params: Optional[Dict] = None) -> Dict[str, Tensor]:
    """One Blending_dataset row (blending_gen.py:43-69 + blending_train.py
    :210-252): aligned S/F latents + images + masks, blend left untrained.

    With `seg16_params` (the seg.pth 16-class parser), HM_XD/HM_XE come from
    the rendered aligned image like the reference's Blending_dataset
    (:224-235 renders G[4..8](align latents), then generate_mask); otherwise
    the pipeline's 19-class target-hair mask is used. The three masks
    (face hair, color hair, target hair) are dilated in one launch.
    """
    dtype = torch.float32 if face.dtype == torch.uint8 else face.dtype
    b = face.shape[0]
    emb = embed_images(zoo, torch.cat([face, shape, color]), mix=True, cfg=cfg, dtype=dtype)
    e_face, e_shape, e_color = ({k: v[i * b:(i + 1) * b] for k, v in emb.items()}
                                for i in range(3))

    align_shape = align_images(zoo, e_face, e_shape, same=False, cfg=cfg, dtype=dtype)
    hair1 = (e_face["mask"] == cfg.hair_label).to(dtype)[..., None]
    hair3 = (e_color["mask"] == cfg.hair_label).to(dtype)[..., None]
    if seg16_params is not None:
        i_align = _render_4_8(zoo, e_face["S"], align_shape["latent_F_align"], cfg)
        hm_x = _hair16_256(seg16_params, i_align)
    else:
        hm_x = shape_module(zoo, e_face, e_color, same=False, cfg=cfg, dtype=dtype)["HM_X"]
    dil, ero = dilate_erode(torch.cat([hair1, hair3, hm_x]), cfg.smooth)
    hm_1d, hm_3d, hm_xd = dil[:b], dil[b:2 * b], dil[2 * b:]
    target_mask = (1 - hm_1d) * (1 - hm_3d) * (1 - hm_xd)

    return {"color_s": e_color["S"], "align_s": e_face["S"],
            "align_f": align_shape["latent_F_align"], "color_i": e_color["image_norm_256"],
            "face_i": e_face["image_norm_256"], "target_mask": target_mask,
            "HM_3E": ero[b:2 * b], "HM_XE": ero[2 * b:]}


@torch.no_grad()
def generate_pp_sample(zoo: Dict, face: Tensor, shape: Tensor, color: Tensor,
                       cfg: HairFastConfig = HairFastConfig()) -> Dict[str, Tensor]:
    """One PP_dataset row (pp_gen.py:86-118): the blended-but-unrefined
    render plus source image and masks."""
    blend = generate_blending_sample(zoo, face, shape, color, cfg)
    s_blend_6 = encoders.blending_model(
        zoo["blending"], blend["align_s"][:, 6:], blend["color_s"][:, 6:],
        blend["face_i"] * blend["target_mask"], blend["color_i"] * blend["HM_3E"])
    s_blend = torch.cat([blend["align_s"][:, :6], s_blend_6], dim=1)
    i_blend = _render_4_8(zoo, s_blend, blend["align_f"], cfg)
    face01 = face.float() / 255.0 if face.dtype == torch.uint8 else face
    return {"source": blend["face_i"], "target": to_res(i_blend, 256).permute(0, 2, 3, 1),
            "target_mask": blend["target_mask"], "HT_E": blend["HM_XE"],
            # full-res source, normed: the adversarial discriminator's real
            # images (the reference feeds source_1024, pp_train.py:125,162)
            "source_full": face01 * 2.0 - 1.0}


def _hair16_256(bisenet16_params, images_norm: Tensor) -> Tensor:
    """[-1,1] NCHW render -> [B,256,256,1] hair mask of the 16-class parser
    (blending_train.py:66-75 generate_mask before its dilate/erode: parse
    the 512-downsampled render, hair = class 10, nearest-resize to 256)."""
    im512 = to_res((images_norm + 1.0) / 2.0, 512)
    logits = bisenet.bisenet_logits_nchw(bisenet16_params, bisenet.to_bisenet_input(im512))
    hair = (torch.argmax(logits, dim=1) == bisenet.SEG16_HAIR).to(images_norm.dtype)
    return resize(hair, (256, 256), "nearest")[..., None]


@torch.no_grad()
def generate_mask16(bisenet16_params, images_norm: Tensor,
                    smooth: int = 5) -> Tuple[Tensor, Tensor]:
    """(HM_XD, HM_XE) [B,256,256,1] from the 16-class parser on [-1,1] NHWC
    images (training-time mask generation, blending_train.py:66-75)."""
    return dilate_erode(_hair16_256(bisenet16_params, images_norm.permute(0, 3, 1, 2)), smooth)


@torch.no_grad()
def generate_rotate_pair(zoo: Dict, img_a: Tensor, img_b: Tensor,
                         cfg: HairFastConfig = HairFastConfig()) -> Dict[str, Tensor]:
    """Rotate training pair (rotate_gen.py): e4e W+ codes of both images and
    the 256 targets in [0,1]; keypoints are added by the caller."""
    dtype = torch.float32 if img_a.dtype == torch.uint8 else img_a.dtype
    b = img_a.shape[0]
    emb = embed_images(zoo, torch.cat([img_a, img_b]), mix=False, cfg=cfg, dtype=dtype)
    return {"W_from": emb["W"][b:], "W_to": emb["W"][:b],
            "I_from": (emb["image_norm_256"][b:] + 1) / 2,
            "I_to": (emb["image_norm_256"][:b] + 1) / 2}
