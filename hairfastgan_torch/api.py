"""HairFast public API on PyTorch (counterpart of hairfastgan_tpu/api.py:29-296).

`HairFast(cfg, zoo=None, device="cuda").swap(face, shape, color, seed=None)`
takes paths, PIL images or uint8 ndarrays and returns [H,W,3] float32 in
[0,1]. The zoo is the port's parameter tree (zoo.init_zoo, or
params/bridge.bridge_zoo of a JAX zoo); without one, a random zoo is drawn
from seed 0 on the device. With cfg.compute_dtype == "bfloat16" the zoo is
cast to bf16 and every stage computes in bf16.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hairfastgan_torch.config import HairFastConfig
from hairfastgan_tpu.utils.images import equal_replacer, to_image_u8
from hairfastgan_torch.params.bridge import map_tree
from hairfastgan_torch.pipeline.swap import check_config, hair_fast, swap_cases
from hairfastgan_torch.zoo import cast_zoo, init_zoo

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class HairFast:
    """Hairstyle transfer interface (reference hair_swap.py:27-105)."""

    def __init__(self, cfg: HairFastConfig = HairFastConfig(), zoo: Optional[Dict] = None,
                 device="cuda"):
        check_config(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.compute_dtype]
        if zoo is None:
            zoo = init_zoo(cfg, seed=0, device=self.device)
        else:
            zoo = map_tree(zoo, lambda _, t: t.to(self.device))
        self.zoo = cast_zoo(zoo, self.dtype) if self.dtype != torch.float32 else zoo

    def swap_tensor(self, face_img, shape_img, color_img,
                    seed: Optional[int] = None) -> torch.Tensor:
        """Like `swap`, but returns the [H,W,3] result where it was computed
        (on the device, in the compute dtype), without the host copy."""
        size = self.cfg.stylegan.size
        imgs = equal_replacer([to_image_u8(im, size) for im in (face_img, shape_img, color_img)])
        case = swap_cases(*imgs)
        on_device = {}
        for im in imgs:  # equal images share one device tensor
            if id(im) not in on_device:
                on_device[id(im)] = torch.from_numpy(im)[None].to(self.device)
        face, shape, color = (on_device[id(im)] for im in imgs)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.cfg.seed if seed is None else seed)
        with torch.inference_mode():
            out = hair_fast(self.zoo, face, shape, color, case=case, cfg=self.cfg,
                            dtype=self.dtype, generator=generator)
        return out[0]

    def swap(self, face_img, shape_img, color_img, seed: Optional[int] = None) -> np.ndarray:
        """face/shape/color (path | PIL | ndarray) -> [H,W,3] float32 in [0,1].
        `seed` seeds the fresh noise of the generator slices and SEAN
        (cfg.seed when None), as the JAX API's noise key does."""
        out = self.swap_tensor(face_img, shape_img, color_img, seed=seed)
        return out.float().cpu().numpy()

    __call__ = swap
