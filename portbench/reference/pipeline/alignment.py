"""Alignment stage: pose rotation, target hair shape, F-space blending
(counterpart of hairfastgan_tpu/pipeline/alignment.py; reference
models/Alignment.py:43-181).

shape_module: RotateModel on W2[:, :6] given W1[:, :6] -> G render ->
BiSeNet re-segmentation -> shape adaptor (face code of mask1 + hair code of
the rotated mask) -> 256^2 target mask.
shape_module_pair: a swap's two shape modules, (face, shape) and (face,
color), as one batch of 2b (cfg.pair_shape_modules).
align_images: SEAN encode both images, decode both under the target mask,
e4e re-embed, then three soft-mask lerps at 32x32 from dilate/erode masks
(one dilate/erode call for all 3b masks).
`generator` draws fresh noise for the render and SEAN; None is zero noise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from portbench.reference.config import HairFastConfig
from portbench.reference.models import bisenet, encoders, sean, shape_adaptor, stylegan2
from portbench.reference.ops.morphology import dilate_erode
from portbench.reference.ops.resample import resize
from portbench.reference.pipeline.embedding import e4e_embed, to_res

Tensor = torch.Tensor


def _hair_mask(labels: Tensor, hair_label: int, dtype) -> Tensor:
    """[B,256,256] int -> [B,256,256,1] float hair mask."""
    return (labels == hair_label).to(dtype)[..., None]


def _rotate_and_segment(zoo, w2: Tensor, w1_6: Tensor, *, cfg: HairFastConfig, dtype,
                        generator: Optional[torch.Generator]) -> Tensor:
    """RotateModel -> G render -> BiSeNet 256 labels of the rotated image.

    The render feeds only the re-segmentation, so the two rotate-render
    options apply here: cfg.rot_render_pairs stops the synthesis at that
    pair (the partial ToRGB skip sum at its resolution) and cfg.rot_seg_size
    parses a render larger than it at that size. The defaults are the
    reference's full render parsed at full resolution (Alignment.py:63-67).
    """
    rot6 = encoders.rotate_model(zoo["rotate"], w2[:, :6].to(dtype), w1_6.to(dtype))
    rotate_to = torch.cat([rot6, w2[:, 6:].to(dtype)], dim=1)
    end = (cfg.rot_render_pairs if cfg.rot_render_pairs is not None
           else cfg.stylegan.log_size - 2)
    noise = stylegan2.make_noise(generator, cfg.stylegan, w2.shape[0], w2.device)
    _, i_rot = stylegan2.synthesis_nchw(zoo["generator"], rotate_to, noise=noise,
                                        end_layer=end, cfg=cfg.stylegan, dtype=dtype)
    return parse_render(zoo["bisenet"], i_rot, cfg.rot_seg_size)


def parse_render(bisenet_p, rgb: Tensor, seg_size: int) -> Tensor:
    """A [-1,1] NCHW render -> BiSeNet 256 labels, parsed at seg_size when
    the render is larger."""
    img01 = ((rgb + 1.0) / 2.0).clamp(0.0, 1.0)
    if img01.shape[2] > seg_size:  # NCHW: dim 2 is H
        img01 = to_res(img01, seg_size)
    return bisenet.segment_256_nchw(bisenet_p, img01)


def shape_module(zoo: Dict, embed1: Dict[str, Tensor], embed2: Dict[str, Tensor], *,
                 same: bool = False, cfg: HairFastConfig = HairFastConfig(),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
    """Target-mask prediction for the (face=1, other=2) pair."""
    mask1, mask2 = embed1["mask"], embed2["mask"]
    if same:
        target_mask, rot_mask = mask1, mask2
    else:
        rot_mask = _rotate_and_segment(zoo, embed2["W"], embed1["W"][:, :6], cfg=cfg,
                                       dtype=dtype, generator=generator)
        face_1 = shape_adaptor.get_face_code(zoo["shape_adaptor"], mask1)
        hair_2 = shape_adaptor.get_hair_code(zoo["shape_adaptor"], rot_mask)
        target_mask = shape_adaptor.get_new_shape(zoo["shape_adaptor"], face_1, hair_2)
    return {"target_mask": target_mask,
            "HM_X": _hair_mask(target_mask, cfg.hair_label, dtype),
            "hair_mask1": _hair_mask(mask1, cfg.hair_label, dtype),
            "hair_mask2": _hair_mask(mask2, cfg.hair_label, dtype),
            "rot_mask": rot_mask}


def shape_module_pair(zoo: Dict, e_face: Dict[str, Tensor], e_shape: Dict[str, Tensor],
                      e_color: Dict[str, Tensor], *, cfg: HairFastConfig = HairFastConfig(),
                      dtype: torch.dtype = torch.float32,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """A swap's two shape modules, (face, shape) and (face, color), as ONE
    batch of 2b (hair_swap.py:49-57 runs them one after the other).

    The rotation, the render, the re-segmentation and the hair code and
    decoder differ per pair and run batched; the face code and the face
    decoder depend on `e_face` only and run once at b. Returns (sm_shape,
    sm_color), each as `shape_module(..., same=False)` returns it. Equal to
    the two separate calls at zero noise (generator None); with a generator
    the one [2b,...] noise draw cannot match two [b,...] draws.
    """
    mask1 = e_face["mask"]
    b = mask1.shape[0]
    w2 = torch.cat([e_shape["W"], e_color["W"]])
    rot_mask = _rotate_and_segment(zoo, w2, e_face["W"][:, :6].repeat(2, 1, 1), cfg=cfg,
                                   dtype=dtype, generator=generator)
    face_1 = shape_adaptor.get_face_code(zoo["shape_adaptor"], mask1)
    hair_2 = shape_adaptor.get_hair_code(zoo["shape_adaptor"], rot_mask)
    target_mask = shape_adaptor.get_new_shape(zoo["shape_adaptor"], face_1, hair_2)
    hm1 = _hair_mask(mask1, cfg.hair_label, dtype)
    out = []
    for i, e2 in enumerate((e_shape, e_color)):
        tm = target_mask[i * b:(i + 1) * b]
        out.append({"target_mask": tm, "HM_X": _hair_mask(tm, cfg.hair_label, dtype),
                    "hair_mask1": hm1, "hair_mask2": _hair_mask(e2["mask"], cfg.hair_label, dtype),
                    "rot_mask": rot_mask[i * b:(i + 1) * b]})
    return out[0], out[1]


def align_images(zoo: Dict, embed1: Dict[str, Tensor], embed2: Dict[str, Tensor], *,
                 same: bool = False, cfg: HairFastConfig = HairFastConfig(),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 sm: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
    """F-space alignment of (face, shape) -> {latent_F_align [B,32,32,512], HM_X}.
    `sm` is a shape-module result computed beforehand (shape_module_pair);
    without it the module runs here (Alignment.py:120)."""
    if sm is None:
        sm = shape_module(zoo, embed1, embed2, same=same, cfg=cfg, dtype=dtype,
                          generator=generator)
    if same:
        return {"latent_F_align": embed1["F"], "HM_X": sm["HM_X"]}

    images = torch.cat([embed1["image_256"], embed2["image_256"]]).to(dtype)
    labels = torch.cat([embed1["mask"], embed2["mask"]])
    codes = sean.sean_encode(zoo["sean"], images, labels)
    target = sm["target_mask"]
    gens = sean.sean_decode(zoo["sean"], codes, torch.cat([target, target]), generator)

    enc = e4e_embed(zoo, gens, cfg=cfg, dtype=dtype)
    b = embed1["F"].shape[0]
    intermediate_align, latent_f_out_new = enc["F"][:b], enc["F"][b:]

    hm1, hm2, hmx = sm["hair_mask1"], sm["hair_mask2"], sm["HM_X"]
    masks = torch.cat([1.0 - (1.0 - hm1) * (1.0 - hmx), hmx, hm2 * hmx])
    dil, ero = dilate_erode(masks, cfg.smooth)
    free_mask = torch.cat([dil[:b], ero[b:2 * b], ero[2 * b:]])
    low = 1.0 - resize(free_mask.permute(0, 3, 1, 2), (32, 32), "bicubic").permute(0, 2, 3, 1)
    low0, low1, low2 = low[:b], low[b:2 * b], low[2 * b:]

    f_align = intermediate_align + low0 * (embed1["F"] - intermediate_align)
    f_align = latent_f_out_new + low1 * (f_align - latent_f_out_new)
    f_align = embed2["F"] + low2 * (f_align - embed2["F"])
    return {"latent_F_align": f_align, "HM_X": sm["HM_X"]}
