"""Final Poisson composite: restore the original photo outside the hair
(counterpart of hairfastgan_tpu/pipeline/composite.py; reference
utils/image_utils.py:58-94).

Parse the swap result and the original face photo with BiSeNet at their
native resolution, take the union of their hair regions, dilate it 30
rounds (the dilate/erode kernel at [B,1024,1024,1] on the card), and
seamless-clone the original photo back into the result outside that mask.
Inputs and output are NHWC in [0,1]; the caller passes f32 images, so
BiSeNet computes in f32 (ops/basic.conv2d casts the weights to the input's
dtype) whatever the zoo's dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from hairfastgan_torch.models import bisenet
from hairfastgan_torch.ops.morphology import dilate_erode
from hairfastgan_torch.ops.poisson import poisson_blend_multigrid

Tensor = torch.Tensor


def hair_union_mask(zoo: Dict, final01: Tensor, face01: Tensor, dilate_iters: int = 30) -> Tensor:
    """Dilated union of both images' hair regions, [B,H,W,1] in {0,1}."""
    lab_final = bisenet.parse_to_celeba(zoo["bisenet"], final01)
    lab_face = bisenet.parse_to_celeba(zoo["bisenet"], face01)
    hair = (lab_final == bisenet.CELEBA_HAIR) | (lab_face == bisenet.CELEBA_HAIR)
    dilated, _ = dilate_erode(hair[..., None].to(final01.dtype).contiguous(), dilate_iters)
    return dilated


def poisson_composite(zoo: Dict, final01: Tensor, face01: Tensor, *, dilate_iters: int = 30,
                      n_iters: int = 115, levels: int = 4) -> Tensor:
    """Seamless-clone `face01` into `final01` outside the dilated hair union
    (fpie's maxn=115 sweeps at each of `levels` pyramid levels)."""
    hair = hair_union_mask(zoo, final01, face01, dilate_iters=dilate_iters)
    return poisson_blend_multigrid(face01, final01, 1.0 - hair, n_iters=n_iters, levels=levels)
