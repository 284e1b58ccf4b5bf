"""FFHQ face alignment with STAR landmarks computed by the port (counterpart
of hairfastgan_tpu/utils/face_align.py:143-225).

The crop geometry, the coarse and refine passes, the two confidence gates
(mean radial spread over `max_spread`; refine landmarks far from the coarse
ones) and their `AlignmentError`s are the JAX package's own, which is
jax-free apart from its STAR forward: this module hands that provider a
PyTorch forward for its 256^2 pass. The dlib route is the JAX package's
`align_faces` unchanged (import dlib, or raise with guidance).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import hairfastgan_tpu.utils.face_align as _fa
from hairfastgan_tpu.utils.face_align import AlignmentError  # noqa: F401
from hairfastgan_torch.models.star import star_landmarks_nchw
from hairfastgan_torch.ops.resample import resize


def star_landmark_provider(star_params: Dict, n_points: int = 98, refine: bool = True,
                           check: bool = True,
                           max_spread: float = 0.45) -> Callable[[np.ndarray], np.ndarray]:
    """[H,W,3] float [0,1] photo -> [n_points, 2] pixel coords (x, y).

    Each pass resizes the photo (or the refine crop) to 256^2 bilinearly on
    the weights' device and runs STAR there in f32."""
    device = star_params["e2h_w"].device

    def run_256(img01: np.ndarray):
        x = torch.from_numpy(np.asarray(img01, np.float32)).to(device).permute(2, 0, 1)[None]
        with torch.inference_mode():
            lm, spread = star_landmarks_nchw(star_params, resize(x, (256, 256), "bilinear")
                                             * 2.0 - 1.0, with_spread=True)
        return ((lm[0, :n_points].cpu().numpy().astype(np.float64) + 1.0) / 2.0,
                float(spread[0, :n_points].mean()))

    return _fa.star_landmark_provider(None, n_points=n_points, refine=refine, check=check,
                                      max_spread=max_spread, _run_override=run_256)


def align_faces(images: List[np.ndarray], output_size: int = 1024,
                star_params: Optional[Dict] = None) -> List[np.ndarray]:
    """[H,W,3] float [0,1] photos of any size -> aligned [output_size,
    output_size, 3] crops in [0,1]: STAR landmarks on the weights' device
    when `star_params` is given, else dlib."""
    if star_params is None:
        return _fa.align_faces(images, output_size=output_size)
    return _fa.align_faces(images, output_size=output_size,
                           landmark_fn=star_landmark_provider(star_params),
                           landmark_layout="wflw98")
