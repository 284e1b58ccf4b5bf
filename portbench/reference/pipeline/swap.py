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

from portbench.reference.config import HairFastConfig
from portbench.reference.pipeline.alignment import (align_images, shape_module,
                                                  shape_module_pair)
from portbench.reference.pipeline.blending import blend_images
from portbench.reference.pipeline.embedding import embed_images

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


def hair_fast(zoo: Dict, face: Tensor, shape: Tensor, color: Tensor, *,
              case: str = "distinct", cfg: HairFastConfig = HairFastConfig(),
              dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None,
              return_intermediate: bool = False):
    """One batched hair transfer: NHWC [B,H,W,3] (uint8 or [0,1] float) ->
    [B,H,W,3] in [0,1]. `generator` draws fresh noise (the reference's
    randomize_noise); None is deterministic zero noise, the parity mode.

    return_intermediate=True also returns the per-stage artifacts that
    save_all dumps, under the JAX package's keys and layouts (W/S/F of
    face, shape and color, mask_*, latent_F_align, HM_X, I_blend, S_blend,
    S_final, F_final).

    cfg.pair_shape_modules runs the distinct case's two shape modules as one
    batch; cfg.rot_render_pairs and cfg.rot_seg_size cut the
    rotate render and its parse (alignment._rotate_and_segment). All three
    are off by default. The paired path gives the sequential path's output
    at zero noise; with a generator its one [2b,...] render draws other
    noise than two [b,...] renders do."""
    if case not in CASES:
        raise ValueError(f"case must be one of {CASES}, got {case!r}")
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

    if case == "distinct" and cfg.pair_shape_modules:
        # both shape modules as one batch of 2b (opt-in; equal to the
        # sequential calls at zero noise only, see shape_module_pair)
        sm_shape, align_color = shape_module_pair(zoo, e_face, e_shape, e_color, cfg=cfg,
                                                  dtype=dtype, generator=generator)
        align_shape = align_images(zoo, e_face, e_shape, cfg=cfg, dtype=dtype,
                                   generator=generator, sm=sm_shape)
    else:
        align_shape = align_images(zoo, e_face, e_shape,
                                   same=case in ("face_eq_shape", "same"), cfg=cfg,
                                   dtype=dtype, generator=generator)
        if case in ("shape_eq_color", "same"):
            align_color = align_shape
        else:
            align_color = shape_module(zoo, e_face, e_color, same=(case == "face_eq_color"),
                                       cfg=cfg, dtype=dtype, generator=generator)
    out = blend_images(zoo, align_shape, align_color, e_face, e_color,
                       all_same=(case == "same"), cfg=cfg, dtype=dtype, generator=generator,
                       return_intermediate=return_intermediate)
    if not return_intermediate:
        return out
    final, blend_inter = out
    inter = {f"{k}_{name}": e[k] for name, e in (("face", e_face), ("shape", e_shape),
                                                 ("color", e_color)) for k in ("W", "S", "F")}
    inter.update({f"mask_{name}": e["mask"] for name, e in (("face", e_face), ("shape", e_shape),
                                                             ("color", e_color))})
    inter.update(latent_F_align=align_shape["latent_F_align"], HM_X=align_color["HM_X"],
                 **blend_inter)
    return final, inter
