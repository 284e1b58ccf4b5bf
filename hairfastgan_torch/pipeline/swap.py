"""Full hair-transfer pipeline (counterpart of hairfastgan_tpu/pipeline/swap.py;
reference hair_swap.py:39-61).

Embedding -> Alignment -> Blending -> PostProcess over a batch of (face,
shape, color) triples. The reference's object-identity dedup fast paths
are the `case` argument:

  'distinct'        all three images differ (the general path)
  'shape_eq_color'  shape is color        -> one shape module, reuse HM_X
  'face_eq_shape'   face is shape         -> F_align = F_face fast path
  'face_eq_color'   face is color         -> color shape-module same path
  'same'            all equal             -> reconstruction-only path
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_torch.pipeline.alignment import align_images, shape_module
from hairfastgan_torch.pipeline.blending import blend_images
from hairfastgan_torch.pipeline.embedding import embed_images

Tensor = torch.Tensor

CASES = ("distinct", "shape_eq_color", "face_eq_shape", "face_eq_color", "same")


def swap_cases(face, shape, color) -> str:
    """Pick the case from host-side object identity."""
    if face is shape and shape is color:
        return "same"
    if shape is color:
        return "shape_eq_color"
    if face is shape:
        return "face_eq_shape"
    if face is color:
        return "face_eq_color"
    return "distinct"


def check_config(cfg: HairFastConfig) -> None:
    """The JAX package's measured-negative opt-ins are not ported."""
    if (cfg.pair_shape_modules or cfg.rot_render_pairs is not None
            or cfg.rot_seg_size < cfg.stylegan.size):
        raise NotImplementedError("pair_shape_modules / rot_render_pairs / reduced "
                                  "rot_seg_size are not part of the port")


def hair_fast(zoo: Dict, face: Tensor, shape: Tensor, color: Tensor, *,
              case: str = "distinct", cfg: HairFastConfig = HairFastConfig(),
              dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None) -> Tensor:
    """One batched hair transfer: NHWC [B,H,W,3] (uint8 or [0,1] float) ->
    [B,H,W,3] in [0,1]. `generator` draws fresh noise (the reference's
    randomize_noise); None is deterministic zero noise, the parity mode."""
    if case not in CASES:
        raise ValueError(f"case must be one of {CASES}, got {case!r}")
    check_config(cfg)
    b = face.shape[0]

    def split(emb, i):
        return {k: v[i * b:(i + 1) * b] for k, v in emb.items()}

    if case == "same":
        e_face = e_shape = e_color = embed_images(zoo, face, mix=False, cfg=cfg, dtype=dtype)
    else:
        second = {"shape_eq_color": shape, "face_eq_shape": color,
                  "face_eq_color": shape, "distinct": shape}[case]
        parts = [face, second] + ([color] if case == "distinct" else [])
        emb = embed_images(zoo, torch.cat(parts), mix=True, cfg=cfg, dtype=dtype)
        e_face = split(emb, 0)
        if case == "distinct":
            e_shape, e_color = split(emb, 1), split(emb, 2)
        elif case == "shape_eq_color":
            e_shape = e_color = split(emb, 1)
        elif case == "face_eq_shape":
            e_shape, e_color = e_face, split(emb, 1)
        else:  # face_eq_color
            e_shape, e_color = split(emb, 1), e_face

    align_shape = align_images(zoo, e_face, e_shape, same=case in ("face_eq_shape", "same"),
                               cfg=cfg, dtype=dtype, generator=generator)
    if case in ("shape_eq_color", "same"):
        align_color = align_shape
    else:
        align_color = shape_module(zoo, e_face, e_color, same=(case == "face_eq_color"),
                                   cfg=cfg, dtype=dtype, generator=generator)
    return blend_images(zoo, align_shape, align_color, e_face, e_color,
                        all_same=(case == "same"), cfg=cfg, dtype=dtype, generator=generator)
